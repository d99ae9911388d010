"""Time the 22 pandas golden answers of `golden.py` on the host CPU.

    python3 -m spark_tpu_torch.tpch.time_goldens --sf 1

Generates TPC-H at `--sf` with the port's datagen (seed 42) into a
temporary directory, or uses `--data DIR`, then computes every golden
once per read mode and prints one JSON line per mode: each query's
seconds and the total. The modes, in the order they run:

- `decimal-objects`: each golden reads its tables from Parquet on every
  call and converts decimal columns through Python `Decimal` objects
  (`to_pandas()`, then `normalize_decimals`), as `golden._read` did
  before it kept the tables;
- `arrow`: `golden._read` as it is, decimals cast to float64 in Arrow
  and each table read once per directory (the first golden that needs
  a table pays for its read).

Imports nothing of JAX and needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import pyarrow.parquet as pq

from . import golden as G
from .datagen import write_parquet


def _read_decimal_objects(path: str, name: str):
    df = pq.read_table(os.path.join(path, f"{name}.parquet")).to_pandas()
    return G.normalize_decimals(df)


def time_all(path: str, mode: str) -> dict:
    """Seconds of each golden at `path` under read mode `mode`."""
    kept = G._read
    G._FRAMES.clear()
    G._FRAMES_PATH[0] = None
    if mode == "decimal-objects":
        G._read = _read_decimal_objects
    try:
        seconds = {}
        for q in sorted(G.GOLDEN, key=lambda name: int(name[1:])):
            t0 = time.perf_counter()
            G.GOLDEN[q](path)
            seconds[q] = time.perf_counter() - t0
    finally:
        G._read = kept
        G._FRAMES.clear()
        G._FRAMES_PATH[0] = None
    return seconds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--data", help="a TPC-H directory to use or fill")
    ap.add_argument("--modes", default="decimal-objects,arrow")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = write_parquet(args.data or os.path.join(tmp, "tpch"), args.sf)
        print(f"[goldens] TPC-H SF{args.sf} ready in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for mode in args.modes.split(","):
            seconds = time_all(path, mode)
            print(json.dumps({"mode": mode, "sf": args.sf,
                              "cpus": os.cpu_count(),
                              "total_s": sum(seconds.values()),
                              "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
