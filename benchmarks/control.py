"""The control of the check that decides `correct`: each query's plain
reference computed with its decimals in float64 (the nearest precision
below the configuration's exact decimals) and in float32, held to the
exact answer by the same comparison as the program.

    python benchmarks/control.py --workload <cell> --seeds 1,2,3 \
        [--scale SF]

Prints one line a seed: the wrong values of the control per query, each
beside the limit the program is held to. Runs on the host's CPU; at a
cell's own scale it needs the cell's tables in memory (SF10: about
10 GB).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def control_readings(cell_name: str, seed: int, scale=None, workers=None,
                     dtypes=("float64", "float32")) -> dict:
    """{precision: {query: wrong values of the control}} at one seed."""
    import datagen
    import harness
    from yardstick import Tables, wrong_values
    cell = harness.Cell(cell_name)
    sf = float(scale if scale is not None else cell.config["scale_factor"])
    params = cell.params(seed)
    t = Tables(datagen.generate(sf, seed, cell.columns(), workers))
    out = {d: {} for d in dtypes}
    for q in cell.queries:
        want = cell.refs[q].answer(t, params[q])
        for d in dtypes:
            got = cell.refs[q].control(t, params[q], getattr(np, d))
            out[d][q] = wrong_values(got.rows, want)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--scale", type=float, default=None)
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        readings = control_readings(args.workload, seed, args.scale)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_wrong_values": readings, "limit": 0,
                          "fails": {d: any(v > 0 for v in r.values())
                                    for d, r in readings.items()},
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
