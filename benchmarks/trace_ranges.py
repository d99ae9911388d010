"""Run one cell traced, as `run.py --trace 1` does, and print what the
harness reduced from the program's own ranges in the profile
(`program_ranges.py`): the device time of each operator class, the idle
inside `dispatch`, the idle by the innermost range, host syncs, and the
offsets between the spans as the harness's anchor maps them and the
same ranges on the trace.

    python benchmarks/trace_ranges.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]

Prints the reductions as one JSON object, then the run's result line
last, as `run.py` does; `--out` also writes both to a file. Exits
non-zero without CUDA.
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


def run_traced(cell: str, seed: int, seconds: float, **kwargs):
    """`harness.run` traced, keeping what its call of
    `program_ranges.reduce_events` returned and the busy time its call
    of `tracing.reduce_events` found. Returns (result line,
    reductions)."""
    import harness
    import program_ranges
    import tracing
    found: dict = {}
    plain_device, plain_ranges = tracing.reduce_events, \
        program_ranges.reduce_events

    def reduce_device(*args):
        out = plain_device(*args)
        found["reduce_profile_busy_s"] = out["busy_s"]
        return out

    def reduce_ranges(*args):
        out = plain_ranges(*args)
        found.update(out)
        return out

    tracing.reduce_events = reduce_device
    program_ranges.reduce_events = reduce_ranges
    try:
        result = harness.run(cell, seed, seconds, True, **kwargs)
    finally:
        tracing.reduce_events = plain_device
        program_ranges.reduce_events = plain_ranges
    return result, found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this measures the card", file=sys.stderr)
        return 2
    result, found = run_traced(args.workload, args.seed, args.seconds,
                               device="cuda:0", t_start=T_START)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"ranges": found, "result": result}, f, indent=1)
    sys.stderr.flush()
    print(json.dumps({"ranges": found}))
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
