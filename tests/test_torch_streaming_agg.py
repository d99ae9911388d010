"""The port's streamed aggregates (`spark_tpu_torch/execution/
streaming_agg.py`) against the JAX package's, on the CPU.

Each case runs through both packages with the streams engaged (chunks of
at most 1,024 rows, the device table cache off) and must give the same
Arrow result and run the same spliced plan: `InputExec(streamed_agg,...)`
where the aggregate streamed, the whole-input plan where it fell back.
Covered: the range stream, the scan stream over a Parquet file whose
row groups grow a string key's dictionary from chunk to chunk, streamed
first/last across chunks (the row base), the dictionary-growth guard and
the derived-string-key fallback, prefetch on and off, and TPC-H Q1/Q6
against their goldens.
"""

import itertools

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_tpu import functions as RF
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.io.sources import ChunkIterator, DictUnifier

import torch_ooc_parity as H

_NAMES = itertools.count()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return H.Pair(H.write_data(tmp_path_factory, "stream"), "stream")


@pytest.fixture(autouse=True)
def streaming(pair):
    pair.reset()
    yield
    pair.reset()


def F(session):
    return PF if isinstance(session, SparkTpuSession) else RF


def run_checked(pair, make, streamed=True):
    """Both packages' result and spliced plan must agree; returns the
    port's result and QueryExecution."""
    with H.spliced() as seen:
        got, pqe, want, rqe, _, _ = pair.run(make)
    H.assert_same(got, want)
    assert pqe.spliced_plan.tree_string() == seen[-1].tree_string()
    assert ("InputExec(streamed_agg," in pqe.spliced_plan.tree_string()) \
        == streamed
    return got, pqe


@pytest.fixture
def grow_file(tmp_path):
    """A Parquet file of 6 row groups of 500 rows: a string key whose
    values grow from 2 in the first row group to 9, a long and a double
    with NULLs."""
    rs = np.random.RandomState(3)
    groups = []
    for g in range(6):
        names = [f"s{i}" for i in range(2 + (g * 7) // 5)]
        v = rs.randint(-10 ** 12, 10 ** 12, 500).astype(np.int64)
        x = rs.randn(500)
        groups.append(pa.table({
            "s": pa.array(rs.choice(names, 500)),
            "k": pa.array(rs.randint(0, 5, 500).astype(np.int64)),
            "v": pa.array(v, mask=rs.rand(500) < 0.1),
            "x": pa.array(x, mask=rs.rand(500) < 0.1)}))
    path = str(tmp_path / "grow.parquet")
    pq.write_table(pa.concat_tables(groups), path, row_group_size=500)
    return path


def test_range_stream_matches_reference(pair):
    """range(5000) in chunks of 1,024 by id % 7: count, sum, avg and the
    row-based first/last."""
    def make(s):
        f, c = F(s), F(s).col
        return s.range(5000).group_by((c("id") % 7).alias("k")).agg(
            f.count().alias("n"), f.sum(c("id")).alias("s"),
            f.avg(c("id")).alias("a"), f.first(c("id")).alias("f"),
            f.last(c("id")).alias("l"))
    got, pqe = run_checked(pair, make)
    assert len(pqe.stream_stats[0]["chunks"]) == 5
    pdf = got.to_pandas().sort_values("k")
    assert pdf["f"].tolist() == list(range(7))
    assert pdf["l"].tolist() == [4998, 4999, 4993, 4994, 4995, 4996, 4997]


def test_scan_stream_grows_dictionary(pair, grow_file):
    """A string key whose dictionary grows across chunks (DictUnifier),
    with sums over NULLable columns and first/last of a long and a
    double across chunks."""
    pair.set((H.CHUNK_KEY, 512))
    name = f"grow_{next(_NAMES)}"

    def make(s):
        f, c = F(s), F(s).col
        return s.read_parquet(grow_file, name).group_by(
            c("s")).agg(f.count().alias("n"), f.sum(c("v")).alias("sv"),
                        f.sum(c("x")).alias("sx"),
                        f.first(c("v")).alias("fv"),
                        f.last(c("x")).alias("lx"),
                        f.first(c("x"), True).alias("fx"))
    got, pqe = run_checked(pair, make)
    assert len(pqe.stream_stats[0]["chunks"]) == 6
    assert got.num_rows == 9


def test_streamed_first_last_against_pandas(pair, grow_file):
    """first/last by a dense key across chunks are the first and last
    rows of each group in file order (the row base keeps chunk positions
    apart)."""
    import pandas as pd
    pair.set((H.CHUNK_KEY, 256))
    name = f"grow_{next(_NAMES)}"
    got, _ = run_checked(pair, lambda s: s.read_parquet(
        grow_file, name).group_by((F(s).col("k") % 5).alias("k")).agg(
            F(s).first(F(s).col("v")).alias("f"),
            F(s).last(F(s).col("v")).alias("l")))
    pdf = pd.read_parquet(grow_file)
    want = pdf.groupby("k")["v"].agg(
        f=lambda x: x.iloc[0], l=lambda x: x.iloc[-1])
    out = got.to_pandas().set_index("k").sort_index()
    for name in ("f", "l"):
        assert [None if pd.isna(a) else int(a) for a in out[name]] == \
            [None if pd.isna(a) else int(a) for a in want[name]]


def test_dictionary_growth_guard_raises_in_both(pair, tmp_path):
    """A dense key whose dictionary outgrows the domain padded at the
    first chunk (16 slots for one value) fails loudly, the same way in
    both packages."""
    path = str(tmp_path / "burst.parquet")
    vals = ["a"] * 1024 + [f"v{i}" for i in range(40)] * 26
    pq.write_table(pa.table({"s": vals, "x": np.arange(len(vals))}), path,
                   row_group_size=1024)

    def make(s):
        c = F(s).col
        return s.read_parquet(path, "burst").group_by(
            c("s")).agg(F(s).sum(c("x")).alias("sx"))
    got, _, want, _, _, _ = pair.run(make)
    assert isinstance(got, RuntimeError) and isinstance(want, RuntimeError)
    assert str(got) == str(want)
    assert "grew past the padded direct domain (41 > 16)" in str(got)


def test_derived_string_key_falls_back_whole(pair, grow_file):
    """A derived string key has no stable codes across chunks: the
    aggregate runs whole-input in both packages, with the same plan."""
    name = f"grow_{next(_NAMES)}"
    run_checked(pair, lambda s: s.read_parquet(
        grow_file, name).group_by(
            F(s).upper(F(s).col("s")).alias("u")).agg(
            F(s).count().alias("n")), streamed=False)


@pytest.mark.parametrize("prefetch", [True, False])
def test_prefetch_on_off_same_bytes(pair, prefetch):
    """Q1 with the prefetch worker on and off: the same bytes as the JAX
    package's, and no worker thread left behind."""
    import threading
    pair.set(("spark_tpu.sql.ingest.prefetch", prefetch))
    got, pqe = run_checked(pair, H.query("q1"))
    H.check_golden(got, "q1", pair.path)
    stats = pqe.stream_stats[0]["chunks"]
    assert len(stats) >= 10
    assert all(r["decode_s"] >= 0 and r["copy_s"] >= 0 for r in stats)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spark-tpu-torch-ingest")]


@pytest.mark.parametrize("qname", ["q1", "q6"])
def test_tpch_streamed_matches_reference_and_golden(pair, qname):
    got, pqe = run_checked(pair, H.query(qname))
    H.check_golden(got, qname, pair.path)
    assert pqe.fault_summary == {}


def test_chunk_iterator_uniform_capacity_and_skip():
    """Every chunk has the capacity of the chunk size; skip_chunks cuts
    the same boundaries; the unifier keeps earlier codes."""
    t = pa.table({"s": ["a", "b"] * 50 + ["c"] * 30, "v": list(range(130))})
    it = ChunkIterator(iter(t.to_batches(max_chunksize=7)), 40, "cpu")
    caps = [b.capacity for b in it]
    assert caps == [64, 64, 64, 64]
    it2 = ChunkIterator(iter(t.to_batches(max_chunksize=7)), 40, "cpu")
    assert it2.skip_chunks(3) == 3
    last = next(it2)
    assert int(last.selection.sum()) == 10
    u = DictUnifier()
    a = u.unify(pa.table({"s": pa.array(["x", "y"]).dictionary_encode()}))
    b = u.unify(pa.table({"s": pa.array(["z", "x"]).dictionary_encode()}))
    assert a.column("s").chunk(0).indices.to_pylist() == [0, 1]
    assert b.column("s").chunk(0).indices.to_pylist() == [2, 0]


def test_count_star_stream_prunes_every_column(pair):
    """count(*) over a streamed scan reads no column: its chunks carry
    row counts alone, and the stream must end with the table's row
    count. (The JAX package's chunk iterator loses those counts and never
    ends, so this case is held to pandas alone.)"""
    import pandas as pd
    pair.set((H.BUDGET_KEY, 1))
    n = len(pd.read_parquet(pair.path + "/lineitem.parquet"))
    assert pair.port.table("lineitem").count() == n
    qe = pair.port.table("lineitem").agg(PF.count().alias("n"))._qe()
    assert qe.collect().column("n").to_pylist() == [n]
    assert "InputExec(streamed_agg," in qe.spliced_plan.tree_string()
