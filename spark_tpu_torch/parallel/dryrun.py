"""`dryrun_mesh(n)`: run the whole distributed path on an n-shard mesh at
small shapes and hold each result to the one-device run (the port's
counterpart of `__graft_entry__.dryrun_multichip`): sharded leaves,
partial/final aggregates over hash exchanges, gathers for broadcasts
and global aggregates, shuffle and broadcast joins, a sampled-bounds
range sort with a distributed limit, windows and the SQL frontend. The
mesh's streamed aggregate and its per-shard telemetry belong to later
slices and are not run. Under the `spark_tpu.sql.cluster.*` keys each
process of a cluster runs it (`dryrun_mesh(n, device, confs)`), the
mesh spanning the processes.

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


def dryrun_cases():
    """The cases: (name, build, sort columns or None). `build(spark, ns)`
    makes the case's DataFrame on `spark` with `ns.F`, `ns.col` and
    `ns.Window` (this package's, or another package's of the same API,
    so a test can hold a case to the JAX package's run)."""
    rs = np.random.RandomState(5)
    wide = pd.DataFrame({
        "k": (np.arange(500, dtype=np.int64) % 83) * 1_000_003,
        "v": np.arange(500, dtype=np.int64)})
    lt = pd.DataFrame({"k": np.arange(300, dtype=np.int64) % 50,
                       "lv": np.arange(300, dtype=np.int64)})
    rt = pd.DataFrame({"k": np.arange(50, dtype=np.int64),
                       "rv": np.arange(50, dtype=np.int64) * 10})
    big_rt = pd.DataFrame({
        "k": np.repeat(np.arange(200, dtype=np.int64), 2),
        "rv": np.arange(400, dtype=np.int64)})
    strs = pd.DataFrame({"s": [f"g{i % 11}" for i in range(700)],
                         "v": np.arange(700, dtype=np.int64)})
    sort_pdf = pd.DataFrame({"k": rs.randint(-500, 500, 900)
                             .astype(np.int64)})
    win_pdf = pd.DataFrame({"g": np.arange(400, dtype=np.int64) % 7,
                            "v": rs.randint(0, 100, 400).astype(np.int64)})
    sql_pdf = pd.DataFrame({"a": np.arange(300, dtype=np.int64)})

    def wspec(ns):
        return ns.Window.partition_by(ns.col("g")).order_by(ns.col("v"))

    def sql(spark, ns):
        spark.register_table("sqldry", sql_pdf)
        return spark.sql("SELECT a % 5 AS k, count(*) AS c, sum(a) AS s "
                         "FROM sqldry GROUP BY k")

    return [
        ("groupby-direct (partial/all_to_all/final)",
         lambda spark, ns: spark.range(4096)
         .group_by((ns.col("id") % 37).alias("k"))
         .agg(ns.F.count().alias("c"), ns.F.sum(ns.col("id")).alias("s")),
         ["k"]),
        ("groupby-sort-path",
         lambda spark, ns: spark.create_dataframe(wide)
         .group_by(ns.col("k")).agg(ns.F.sum(ns.col("v")).alias("s"),
                                    ns.F.min(ns.col("v")).alias("mn")),
         ["k"]),
        ("global-aggregate (all_gather collapse)",
         lambda spark, ns: spark.range(1234).agg(
             ns.F.sum(ns.col("id")).alias("s"), ns.F.count().alias("c"),
             ns.F.avg(ns.col("id")).alias("a")), None),
        ("join-broadcast (all_gather build)",
         lambda spark, ns: spark.create_dataframe(lt).join(
             spark.create_dataframe(rt), on="k"), ["lv"]),
        ("join-shuffle many-to-many outer (all_to_all both sides)",
         lambda spark, ns: spark.create_dataframe(lt).join(
             spark.create_dataframe(big_rt, "big"), on="k", how="outer"),
         ["lv", "rv"]),
        ("string-groupby (dictionary value-hash partitioning)",
         lambda spark, ns: spark.create_dataframe(strs)
         .group_by(ns.col("s")).agg(ns.F.sum(ns.col("v")).alias("sv")),
         ["s"]),
        ("global sort + limit (range partition + distributed top-k)",
         lambda spark, ns: spark.range(777).sort(ns.col("id").desc())
         .limit(5), None),
        ("sampled-bounds range sort (all_to_all, exact order)",
         lambda spark, ns: spark.create_dataframe(sort_pdf, "rsort")
         .sort(ns.col("k")), None),
        ("window row_number+sum (hash exchange + segmented scans)",
         lambda spark, ns: spark.create_dataframe(win_pdf, "wdry")
         .with_column("rn", ns.F.row_number().over(wspec(ns)))
         .with_column("sv", ns.F.sum(ns.col("v")).over(wspec(ns))),
         ["g", "v", "rn"]),
        ("sql frontend (parse -> plan -> mesh execute)", sql, ["k"]),
        ("window ROWS BETWEEN frame (sliding prefix sums)",
         lambda spark, ns: spark.create_dataframe(win_pdf, "fdry")
         .select(ns.col("g"), ns.col("v"), ns.F.sum(ns.col("v")).over(
             wspec(ns).rows_between(-2, 0)).alias("sw")), ["g", "v"]),
    ]


def dryrun_mesh(n_shards: int = 8, device=None, confs=(),
                tables: Optional[dict] = None) -> List[str]:
    """Run every case at mesh `n_shards` and at mesh 0 on a session over
    `device` (None: distinct CUDA cards) and raise on a divergence;
    returns the names of the cases that held. `confs` are (key, value)
    pairs the session sets first: under the `spark_tpu.sql.cluster.*`
    keys every process of a cluster runs this same function, each
    holding every case to its own one-device run. `tables`, when given,
    receives each case's mesh result (Arrow) by name."""
    from types import SimpleNamespace

    from .. import SparkTpuSession
    from .. import functions as F
    from ..window import Window

    builder = SparkTpuSession.builder()
    if device is not None:
        builder = builder.device(device)
    for key, value in confs:
        builder = builder.config(key, value)
    spark = builder.get_or_create()
    ns = SimpleNamespace(F=F, col=F.col, Window=Window)
    done: List[str] = []

    def at(n: int, name: str, build: Callable) -> pd.DataFrame:
        spark.conf.set(MESH_KEY, n)
        try:
            table = build(spark, ns).collect()
        finally:
            spark.conf.set(MESH_KEY, 0)
        if n > 1 and tables is not None:
            tables[name] = table
        return table.to_pandas()

    for name, build, sort_cols in dryrun_cases():
        want, got = at(0, name, build), at(n_shards, name, build)
        if sort_cols:
            want = want.sort_values(sort_cols).reset_index(drop=True)
            got = got.sort_values(sort_cols).reset_index(drop=True)
        _compare(name, got, want)
        done.append(name)
    return done


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = sys.argv[2] if len(sys.argv) > 2 else None
    for case in dryrun_mesh(n, dev):
        print(f"  ok: {case}")
