"""The port's deviceBudget-gated out-of-core paths against the JAX
package's, on the CPU: the eight cases of `tests/test_spill.py`.

- the partial spill of an aggregate whose keys have no static domain
  (partial-mode chunks -> host Arrow -> a final re-reduce), with string
  and derived keys, and through a probe-side join (TPC-H Q3's shape);
- external collect: the plain chain, LIMIT, ORDER BY + LIMIT (a top-n
  per chunk, then a final sort) and ORDER BY (a host merge);
- TPC-H Q3 and Q5 under a budget small enough to stream.

Each case runs in both packages with a 1-byte budget, 1,000-row chunks
and the device table cache off; the results must be the JAX package's
(the same Arrow bytes, or, for a plain LIMIT whose rows are unordered,
the same count drawn from the input), the spliced plans must agree, and
each result must equal the same query's whole-input result (budget 0).
"""

import numpy as np
import pandas as pd
import pytest

from spark_tpu import functions as RF
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF

import torch_ooc_parity as H

SPILL = ((H.BUDGET_KEY, 1), (H.CHUNK_KEY, 1000), (H.CACHE_KEY, 0))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = H.Pair(H.write_data(tmp_path_factory, "spill"), "spill")
    rs = np.random.RandomState(7)
    n = 5237
    pdf = pd.DataFrame({
        "k": rs.randint(0, 10_000_000, n).astype(np.int64),
        "g": rs.randint(0, 7, n).astype(np.int64),
        "v": rs.randn(n),
        "s": rs.choice(["aa", "bb", "cc", "dd"], n)})
    dim = pd.DataFrame({"g": np.arange(7, dtype=np.int64),
                        "w": np.arange(7, dtype=np.float64) * 2.0})
    for s in (p.port, p.ref):
        s.register_table("spill_t", pdf)
        s.register_table("spill_dim", dim)
    p.pdf = pdf
    return p


@pytest.fixture(autouse=True)
def spill(pair):
    pair.reset(SPILL)
    yield
    pair.reset()


def F(session):
    return PF if isinstance(session, SparkTpuSession) else RF


def run_both(pair, make, sort_by=None):
    """The query spilled in both packages (same bytes, same spliced plan
    where an aggregate streamed), then whole-input in the port, which
    must give the same rows. Returns the port's spilled result and qe."""
    with H.spliced() as seen:
        got, pqe, want, rqe, _, _ = pair.run(make)
    H.assert_same(got, want)
    if seen:
        assert pqe.spliced_plan.tree_string() == seen[-1].tree_string()
    assert pqe.spilled_partial_rows == rqe.spilled_partial_rows
    pair.set((H.BUDGET_KEY, 0))
    whole = make(pair.port)._qe().collect()
    pair.set((H.BUDGET_KEY, 1))
    a, b = got.to_pandas(), whole.to_pandas()
    if sort_by:
        a = a.sort_values(sort_by).reset_index(drop=True)
        b = b.sort_values(sort_by).reset_index(drop=True)
    pd.testing.assert_frame_equal(a, b, check_exact=False, rtol=1e-12)
    return got, pqe


def test_aggregate_spill_unbounded_keys(pair):
    got, pqe = run_both(pair, lambda s: s.table("spill_t").group_by(
        F(s).col("k")).agg(F(s).sum(F(s).col("v")).alias("sv"),
                           F(s).count().alias("c")), sort_by=["k"])
    assert pqe.spilled_partial_rows is not None
    assert "InputExec(spilled_partials," in pqe.spliced_plan.tree_string()


def test_aggregate_spill_string_keys(pair):
    run_both(pair, lambda s: s.table("spill_t").group_by(
        F(s).col("s"), (F(s).col("k") % 1000).alias("kb")).agg(
        F(s).sum(F(s).col("v")).alias("sv")), sort_by=["s", "kb"])


def test_aggregate_spill_through_join(pair):
    c = lambda s: F(s).col
    run_both(pair, lambda s: s.table("spill_t").join(
        s.table("spill_dim"), left_on=c(s)("g"), right_on=c(s)("g"))
        .group_by(c(s)("k")).agg(
            F(s).sum(c(s)("v") * c(s)("w")).alias("sv")), sort_by=["k"])


def test_external_collect_plain_chain(pair):
    run_both(pair, lambda s: s.table("spill_t")
             .filter(F(s).col("v") > 0.5)
             .select(F(s).col("k"), (F(s).col("v") * 2).alias("v2")),
             sort_by=["k", "v2"])


def test_external_collect_order_by_limit(pair):
    got, pqe = run_both(pair, lambda s: s.table("spill_t")
                        .sort(F(s).col("v").desc(), F(s).col("k"))
                        .limit(17))
    assert got.num_rows == 17
    assert "external" in pqe.phase_times


def test_external_collect_order_by_host_merge(pair):
    run_both(pair, lambda s: s.table("spill_t").sort(F(s).col("v").desc()))


def test_external_collect_plain_limit(pair):
    """A plain LIMIT stops streaming once enough rows spilled: the rows
    come from the input, as many as asked for, in both packages."""
    make = lambda s: s.table("spill_t").limit(123)
    got, pqe, want, _, _, _ = pair.run(make)
    assert got.num_rows == want.num_rows == 123
    assert set(got.column("k").to_pylist()) <= set(pair.pdf["k"])
    assert len(pqe.stream_stats[0]["chunks"]) == 1


def test_tpch_q3_q5_parity_under_budget(pair):
    """Q3 (unbounded l_orderkey keys: partial spill) and Q5 (dictionary
    keys: the direct stream, through its joins) with the scans out of
    core: the JAX package's bytes and the goldens."""
    pair.set((H.BUDGET_KEY, 1 << 16), (H.CHUNK_KEY, 10_000))
    for qname in ("q3", "q5"):
        with H.spliced() as seen:
            got, pqe, want, _, _, _ = pair.run(H.query(qname))
        H.assert_same(got, want)
        assert pqe.spliced_plan.tree_string() == seen[-1].tree_string()
        assert "InputExec(" in pqe.spliced_plan.tree_string()
        H.check_golden(got, qname, pair.path)
