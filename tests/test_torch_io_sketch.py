"""The port's CSV and JSON readers (`io/sources.py` `CsvSource`,
`JsonSource`) and sketches (`sketch.py`, `DataFrame.stat`) against the
JAX package, on the CPU.

The cases of the reference's `tests/test_io_sketch.py`: a CSV file read
with a filter, with another delimiter and without a header; line JSON
grouped and counted; a Bloom filter and a Count-Min sketch built from a
column. Files and values come from a numpy seed; each file goes through
both packages' readers and the same query, whose Arrow results must be
equal (floats within rtol 1e-12: a CSV money column is float64, as
pyarrow infers it). The Bloom filter's bits and the Count-Min counters
must equal the reference's bit for bit; the sketches' contracts (no
false negatives; estimates never below the count, within eps·N) are held
too.
"""

import json

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from torch_sql_parity import assert_tables_match

SEED = 21


@pytest.fixture(scope="module")
def both():
    return (SparkTpuSession.builder().device("cpu").get_or_create(),
            RefSession(register_active=False))


def _frame(n=300):
    rng = np.random.default_rng(SEED)
    return pd.DataFrame({
        "a": rng.integers(0, 50, n),
        "b": rng.choice(["x", "y", "zz"], n),
        "c": np.round(rng.uniform(0, 1000, n), 2),
        "d": pd.to_datetime(rng.integers(0, 3000, n), unit="D",
                            origin="1992-01-01").strftime("%Y-%m-%d"),
    })


def both_read(both, reader, path, text, **options):
    """Register the file `path` as `t` through each package's `reader`,
    run `text` in both; equal results; the port's."""
    port, ref = both
    outs = []
    for s in both:
        df = getattr(s, reader)(str(path), **options)
        s.register_table("t", df.plan.source)
        outs.append(s.sql(text).collect())
    assert_tables_match(*outs)
    return outs[0]


def test_read_csv(both, tmp_path):
    p = tmp_path / "t.csv"
    pdf = _frame()
    pdf.to_csv(p, index=False)
    got = both_read(both, "read_csv", p,
                    "SELECT a, b, c FROM t WHERE a >= 20 ORDER BY a, b, c")
    want = pdf[pdf["a"] >= 20].sort_values(["a", "b", "c"])
    assert got.column("a").to_pylist() == want["a"].tolist()
    assert got.column("b").to_pylist() == want["b"].tolist()
    assert got.schema.field("c").type == pa.float64()


def test_read_csv_aggregate_with_dates(both, tmp_path):
    p = tmp_path / "agg.csv"
    pdf = _frame()
    pdf.to_csv(p, index=False)
    got = both_read(both, "read_csv", p, """
        SELECT b, sum(c) AS sc, avg(c) AS ac, count(*) AS n,
               max(d) AS md FROM t WHERE d < date '1995-06-01'
        GROUP BY b ORDER BY b""")
    sub = pdf[pdf["d"] < "1995-06-01"].groupby("b")
    np.testing.assert_allclose(got.column("sc").to_numpy(),
                               sub["c"].sum().to_numpy(), rtol=1e-9)
    assert got.column("n").to_pylist() == sub.size().tolist()


def test_read_csv_delimiter(both, tmp_path):
    p = tmp_path / "t2.csv"
    p.write_text("a|b\n1|x\n2|y\n")
    got = both_read(both, "read_csv", p, "SELECT * FROM t", sep="|")
    assert got.column("a").to_pylist() == [1, 2]


def test_read_csv_without_header(both, tmp_path):
    p = tmp_path / "t3.csv"
    p.write_text("1,x,0.5\n2,y,1.5\n3,x,2.5\n")
    got = both_read(both, "read_csv", p, "SELECT * FROM t", header=False)
    assert got.column_names == ["f0", "f1", "f2"]
    assert got.column("f2").to_pylist() == [0.5, 1.5, 2.5]


def test_read_json(both, tmp_path):
    p = tmp_path / "t.jsonl"
    rng = np.random.default_rng(SEED)
    with open(p, "w") as f:
        for i in range(200):
            row = {"k": i, "s": f"v{int(rng.integers(0, 3))}",
                   "x": float(np.round(rng.normal(), 3))}
            if i % 13 == 0:
                row["x"] = None
            f.write(json.dumps(row) + "\n")
    got = both_read(both, "read_json", p, """
        SELECT s, count(*) AS c, sum(x) AS sx, count(x) AS cx FROM t
        GROUP BY s ORDER BY s""")
    assert sum(got.column("c").to_pylist()) == 200


def test_read_json_default_name(both, tmp_path):
    p = tmp_path / "named.json"
    p.write_text('{"a": 1}\n{"a": 2}\n')
    port, ref = both
    df = port.read_json(str(p))
    assert df.plan.source.name == "named"
    assert df.collect().equals(ref.read_json(str(p)).collect())


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    keys[: n // 10] = rng.integers(0, 20, n // 10)  # heavy hitters
    return keys


@pytest.mark.parametrize("with_nulls", [False, True])
def test_bloom_filter(both, with_nulls):
    keys = _keys(2000, SEED)
    mask = np.zeros(len(keys), bool)
    if with_nulls:
        mask[::7] = True
    table = pa.table({"k": pa.array(keys, mask=mask)})
    port, ref = both
    for s in both:
        s.register_table("bf_t", table)
    bf = port.table("bf_t").stat.bloom_filter("k", 2000, fpp=0.01)
    rbf = ref.table("bf_t").stat.bloom_filter("k", 2000, fpp=0.01)
    assert bf.num_hashes == rbf.num_hashes
    np.testing.assert_array_equal(bf.bits.numpy(), np.asarray(rbf.bits))
    present = torch.from_numpy(keys[~mask])
    assert bool(bf.might_contain(present).all())  # no false negatives
    absent = torch.arange(1 << 41, (1 << 41) + 5000, dtype=torch.int64)
    assert float(bf.might_contain(absent).float().mean()) < 0.05


@pytest.mark.parametrize("eps,confidence", [(0.001, 0.99), (0.01, 0.9)])
def test_count_min_sketch(both, eps, confidence):
    keys = _keys(5000, SEED + 1)
    port, ref = both
    for s in both:
        s.register_table("cms_t", pd.DataFrame({"k": keys}))
    cms = port.table("cms_t").stat.count_min_sketch("k", eps, confidence)
    rcms = ref.table("cms_t").stat.count_min_sketch("k", eps, confidence)
    assert (cms.depth, cms.width) == (rcms.depth, rcms.width)
    np.testing.assert_array_equal(cms.table.numpy(), np.asarray(rcms.table))
    uniq, true = np.unique(keys, return_counts=True)
    est = cms.estimate(torch.from_numpy(uniq)).numpy()
    import jax.numpy as jnp
    np.testing.assert_array_equal(
        est, np.asarray(rcms.estimate(jnp.asarray(uniq))))
    # never underestimates; slack bounded by eps * N with the confidence
    assert (est >= true).all()
    within = (est <= true + eps * keys.size).mean()
    assert within >= confidence


def test_stat_over_a_filtered_frame(both):
    keys = _keys(1000, SEED + 2)
    port, ref = both
    for s in both:
        s.register_table("f_t", pd.DataFrame({"k": keys}))
    from spark_tpu.functions import col as rcol
    from spark_tpu_torch.functions import col
    cms = port.table("f_t").filter(col("k") >= 0) \
        .stat.count_min_sketch("k")
    rcms = ref.table("f_t").filter(rcol("k") >= 0) \
        .stat.count_min_sketch("k")
    np.testing.assert_array_equal(cms.table.numpy(), np.asarray(rcms.table))
    assert int(cms.table[0].sum()) == int((keys >= 0).sum())
