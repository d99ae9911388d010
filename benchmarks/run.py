"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as one JSON object on the last line of standard
output, and the numbers compared with their limits as the last lines of
standard error. Exits non-zero, printing no result, when the cell's
configuration does not set a mesh of one shard a card, when CUDA is
missing, when the cell needs more cards than there are, or when JAX or
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    try:
        cell = harness.Cell(args.workload)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    # one card: the session pinned to it; more: the port's mesh takes
    # cuda:0 to cuda:N-1
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace),
                         device="cuda:0" if cell.chips == 1 else None,
                         t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded forbidden modules: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
