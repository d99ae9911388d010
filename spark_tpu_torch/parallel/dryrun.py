"""`dryrun_mesh(n)`: run the whole distributed path on an n-shard mesh at
small shapes and hold each result to the one-device run (the port's
counterpart of `__graft_entry__.dryrun_multichip`): sharded leaves,
partial/final aggregates over hash exchanges, gathers for broadcasts
and global aggregates, shuffle and broadcast joins, a sampled-bounds
range sort with a distributed limit, windows and the SQL frontend. The
mesh's streamed aggregate and its per-shard telemetry belong to later
slices and are not run.

    python -m spark_tpu_torch.parallel.dryrun [n] [device]

runs it with n shards (default 8) on `device` (default: n distinct
CUDA cards; `cpu` or `cuda:0` places every shard there).
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

import numpy as np
import pandas as pd

MESH_KEY = "spark_tpu.sql.mesh.size"


def _compare(name: str, got: pd.DataFrame, want: pd.DataFrame) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows vs {len(want)}")
    for c in want.columns:
        g, w = got[c], want[c]
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            ok = np.allclose(g.astype(float), w.astype(float),
                             equal_nan=True)
        else:
            ok = g.fillna(-999).tolist() == w.fillna(-999).tolist()
        if not ok:
            raise AssertionError(f"{name}: column {c} diverged\n"
                                 f"got:\n{got}\nwant:\n{want}")


def dryrun_mesh(n_shards: int = 8, device=None) -> List[str]:
    """Run every case at mesh `n_shards` and at mesh 0 on a session over
    `device` (None: distinct CUDA cards) and raise on a divergence;
    returns the names of the cases that held."""
    from .. import SparkTpuSession
    from .. import functions as F
    from ..functions import col
    from ..window import Window

    builder = SparkTpuSession.builder()
    if device is not None:
        builder = builder.device(device)
    spark = builder.get_or_create()
    done: List[str] = []

    def at(n: int, build: Callable) -> pd.DataFrame:
        spark.conf.set(MESH_KEY, n)
        try:
            return build().to_pandas()
        finally:
            spark.conf.set(MESH_KEY, 0)

    def parity(name: str, build: Callable,
               sort_cols: Optional[List[str]]) -> None:
        want, got = at(0, build), at(n_shards, build)
        if sort_cols:
            want = want.sort_values(sort_cols).reset_index(drop=True)
            got = got.sort_values(sort_cols).reset_index(drop=True)
        _compare(name, got, want)
        done.append(name)

    parity("groupby-direct (partial/all_to_all/final)",
           lambda: spark.range(4096)
           .group_by((col("id") % 37).alias("k"))
           .agg(F.count().alias("c"), F.sum(col("id")).alias("s")), ["k"])
    wide = pd.DataFrame({
        "k": (np.arange(500, dtype=np.int64) % 83) * 1_000_003,
        "v": np.arange(500, dtype=np.int64)})
    parity("groupby-sort-path",
           lambda: spark.create_dataframe(wide).group_by(col("k"))
           .agg(F.sum(col("v")).alias("s"), F.min(col("v")).alias("mn")),
           ["k"])
    parity("global-aggregate (all_gather collapse)",
           lambda: spark.range(1234).agg(
               F.sum(col("id")).alias("s"), F.count().alias("c"),
               F.avg(col("id")).alias("a")), None)
    lt = pd.DataFrame({"k": np.arange(300, dtype=np.int64) % 50,
                       "lv": np.arange(300, dtype=np.int64)})
    rt = pd.DataFrame({"k": np.arange(50, dtype=np.int64),
                       "rv": np.arange(50, dtype=np.int64) * 10})
    big_rt = pd.DataFrame({
        "k": np.repeat(np.arange(200, dtype=np.int64), 2),
        "rv": np.arange(400, dtype=np.int64)})
    parity("join-broadcast (all_gather build)",
           lambda: spark.create_dataframe(lt).join(
               spark.create_dataframe(rt), on="k"), ["lv"])
    parity("join-shuffle many-to-many outer (all_to_all both sides)",
           lambda: spark.create_dataframe(lt).join(
               spark.create_dataframe(big_rt, "big"), on="k", how="outer"),
           ["lv", "rv"])
    strs = pd.DataFrame({"s": [f"g{i % 11}" for i in range(700)],
                         "v": np.arange(700, dtype=np.int64)})
    parity("string-groupby (dictionary value-hash partitioning)",
           lambda: spark.create_dataframe(strs).group_by(col("s"))
           .agg(F.sum(col("v")).alias("sv")), ["s"])
    parity("global sort + limit (range partition + distributed top-k)",
           lambda: spark.range(777).sort(col("id").desc()).limit(5), None)
    rs = np.random.RandomState(5)
    sort_pdf = pd.DataFrame({"k": rs.randint(-500, 500, 900)
                             .astype(np.int64)})
    parity("sampled-bounds range sort (all_to_all, exact order)",
           lambda: spark.create_dataframe(sort_pdf, "rsort").sort(col("k")),
           None)
    wspec = Window.partition_by(col("g")).order_by(col("v"))
    win_pdf = pd.DataFrame({"g": np.arange(400, dtype=np.int64) % 7,
                            "v": rs.randint(0, 100, 400).astype(np.int64)})
    parity("window row_number+sum (hash exchange + segmented scans)",
           lambda: spark.create_dataframe(win_pdf, "wdry")
           .with_column("rn", F.row_number().over(wspec))
           .with_column("sv", F.sum(col("v")).over(wspec)),
           ["g", "v", "rn"])
    spark.register_table("sqldry", pd.DataFrame(
        {"a": np.arange(300, dtype=np.int64)}))
    parity("sql frontend (parse -> plan -> mesh execute)",
           lambda: spark.sql("SELECT a % 5 AS k, count(*) AS c, sum(a) AS s "
                             "FROM sqldry GROUP BY k"), ["k"])
    fspec = (Window.partition_by(col("g")).order_by(col("v"))
             .rows_between(-2, 0))
    parity("window ROWS BETWEEN frame (sliding prefix sums)",
           lambda: spark.create_dataframe(win_pdf, "fdry")
           .select(col("g"), col("v"),
                   F.sum(col("v")).over(fspec).alias("sw")), ["g", "v"])
    return done


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = sys.argv[2] if len(sys.argv) > 2 else None
    for case in dryrun_mesh(n, dev):
        print(f"  ok: {case}")
