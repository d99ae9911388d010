"""Runs of one cell in a row, one process at a time, and the spread of
each metric: the distance between the first and third quartile
(`statistics.quantiles(values, n=4)`) as a share of the median.

    python benchmarks/spread.py --workload <cell> --seeds 1,2,3 \
        --seconds 30 [--trace 0|1] [--out FILE]

Each run is `benchmarks/run.py` as the benchmark's command runs it. Every
run's result line, exit code and wall time go to `--out` (JSON lines);
the summary is printed.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(HERE / "run.py"), "--workload",
               args.workload, "--seed", seed, "--seconds",
               str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        run = {"workload": args.workload, "seed": int(seed),
               "trace": args.trace, "rc": proc.returncode,
               "wall_s": wall, "result": result,
               "stderr_tail": proc.stderr[-3000:]}
        runs.append(run)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(run) + "\n")
        metrics = {k: v["value"] for k, v in
                   (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": int(seed), "rc": proc.returncode,
                          "wall_s": round(wall, 1),
                          "correct": (result or {}).get("correct"),
                          "metrics": metrics}), flush=True)
        if result is None:
            print(proc.stderr[-2000:], flush=True)
    names = sorted({k for r in runs if r["result"]
                    for k in r["result"]["metrics"]})
    summary = {}
    for n in names:
        vals = [r["result"]["metrics"][n]["value"] for r in runs
                if r["result"] and n in r["result"]["metrics"]]
        summary[n] = {"median": statistics.median(vals),
                      "spread": spread(vals), "n": len(vals)}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
