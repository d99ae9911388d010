"""The port's joins, runtime filters and sort aggregate against the JAX
package, on the CPU.

Every case builds the same tables from a numpy seed, runs the same
DataFrame program through both engines and holds the port's Arrow result
against the reference's: ints, decimals, strings and validity exactly
(`pa.Table.equals`), floats within rtol 1e-12. The join cases also
compare the executed plan after the run, so the node state the re-plan
loop leaves behind (grown capacities, the unique-build and hash
fallbacks, grown group estimates) matches too. The last cases hold the
join expansion's outputs, the Bloom filter's bits and the runtime
filter's keep mask against the reference's.
"""

import itertools

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_tpu import functions as RF
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF

MODE_KEY = "spark_tpu.sql.join.kernelMode"
MAX_PROBE_KEY = "spark_tpu.sql.join.hashMaxProbe"
EST_GROUPS_KEY = "spark_tpu.sql.aggregate.estimatedGroups"
JOIN_TYPES = ["inner", "left", "right", "full", "left_semi", "left_anti"]
FLOAT_RTOL = 1e-12


def assert_tables_match(got: pa.Table, want: pa.Table) -> None:
    """Exact for every non-float column; floats within FLOAT_RTOL with
    NaN equal to NaN and the same validity."""
    assert got.schema == want.schema
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type):
            assert g.is_null().equals(w.is_null()), name
            gv = g.to_numpy(zero_copy_only=False)
            wv = w.to_numpy(zero_copy_only=False)
            np.testing.assert_allclose(gv, wv, rtol=FLOAT_RTOL, atol=0,
                                       equal_nan=True, err_msg=name)
        else:
            assert g.equals(w), name


_TABLE_IDS = itertools.count()


class Engines:
    """One port session on the CPU and the reference session, fed the
    same tables and conf. Tables register under fresh names, so that no
    two cases print the same plan: the reference keeps state across
    queries of one session keyed on the plan (its compiled stages), and
    a shared plan string would let one case's state reach another."""

    def __init__(self, ref):
        self.port = SparkTpuSession.builder().device("cpu").get_or_create()
        self.ref = ref
        self.names = {}

    def set_conf(self, conf) -> None:
        for k, v in conf.items():
            self.port.conf.set(k, v)
            self.ref.conf.set(k, v)

    def register(self, name: str, table: pa.Table) -> None:
        self.names[name] = f"{name}_{next(_TABLE_IDS)}"
        self.port.register_table(self.names[name], table)
        self.ref.register_table(self.names[name], table)

    def table(self, session, name: str):
        return session.table(self.names[name])

    def check(self, query):
        """Run `query(session, F)` in both engines: the Arrow results
        must match and the executed plans after the run print the same.
        Returns the port's table and QueryExecution."""
        pqe, rqe = query(self.port, PF)._qe(), query(self.ref, RF)._qe()
        got, want = pqe.collect(), rqe.collect()
        assert_tables_match(got, want)
        assert pqe.executed_plan.tree_string() == \
            rqe.executed_plan.tree_string()
        return got, pqe


@pytest.fixture
def fact_dim(session):
    """A fact table over a dimension with every build key twice (the
    many-to-many expansion path), some keys on neither side, and NULL
    keys and values on both (the fixture of the reference's
    `test_hash_join.py`, at a tenth of its size)."""
    rs = np.random.RandomState(11)
    n = 2000
    k = rs.randint(0, 70, n).astype(np.int64)
    fact = pa.table({
        "k": pa.array(k, mask=rs.rand(n) < 0.05),
        "v": pa.array(np.arange(n, dtype=np.int64)),
        "x": pa.array(rs.standard_normal(n), mask=rs.rand(n) < 0.1)})
    dim = pa.table({
        "k2": pa.array(np.repeat(np.arange(50, dtype=np.int64), 2),
                       mask=np.arange(100) == 7),
        "w": pa.array(np.arange(100, dtype=np.int64)),
        "s": pa.array([f"d{i % 9}" for i in range(100)])})
    e = Engines(session)
    e.register("fact", fact)
    e.register("dim", dim)
    return e


def _fact_join(e, how):
    return lambda s, F: e.table(s, "fact").join(
        e.table(s, "dim"), how=how, left_on=F.col("k"),
        right_on=F.col("k2"))


@pytest.mark.parametrize("mode", ["sort", "hash"])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_join_matrix_matches_reference(fact_dim, how, mode):
    fact_dim.set_conf({MODE_KEY: mode})
    got, pqe = fact_dim.check(_fact_join(fact_dim, how))
    assert got.num_rows > 0
    # the duplicate build keys sent the unique-build joins to expansion
    if how in ("inner", "left", "left_semi", "left_anti"):
        assert "uniq=False" in pqe.executed_plan.tree_string()


def _keys_table(values, pa_type, name, payload):
    return pa.table({name: pa.array(values, type=pa_type),
                     payload: pa.array(np.arange(len(values),
                                                 dtype=np.int64))})


@pytest.mark.parametrize("mode", ["sort", "hash"])
@pytest.mark.parametrize("case", ["nulls", "nan_unique", "nan_duplicate",
                                  "signed_zero", "empty_build"])
def test_edge_keys_match_reference(session, case, mode):
    nan = float("nan")
    probe, build, ptype = {
        "nulls": ([1, None, 3, 4, None, 2], [2, 3, None, 3], pa.int64()),
        "nan_unique": ([1.5, nan, nan, 2.5, -0.0], [nan, 2.5, 9.0],
                       pa.float64()),
        "nan_duplicate": ([1.5, nan, nan, 2.5], [nan, nan, 2.5],
                          pa.float64()),
        "signed_zero": ([-0.0, 0.0, 1.0, -1.0], [0.0, -1.0], pa.float64()),
        "empty_build": ([1, 2, 3], [], pa.int64()),
    }[case]
    e = Engines(session)
    e.set_conf({MODE_KEY: mode})
    e.register("probe", _keys_table(probe, ptype, "k", "v"))
    e.register("build", _keys_table(build, ptype, "k2", "w"))
    for how in JOIN_TYPES:
        e.check(lambda s, F: e.table(s, "probe").join(
            e.table(s, "build"), how=how, left_on=F.col("k"),
            right_on=F.col("k2")))


def test_overflow_grows_the_join_capacity(session):
    """A hot key: 16 probe rows x 40 build rows overflow the probe
    capacity the expansion is seeded with, so the executor runs again
    with the real row total."""
    e = Engines(session)
    e.register("probe", _keys_table([0] * 16 + [1, 2], pa.int64(), "k", "v"))
    e.register("build", _keys_table([0] * 40 + [2], pa.int64(), "k2", "w"))
    got, pqe = e.check(lambda s, F: e.table(s, "probe").join(
        e.table(s, "build"), left_on=F.col("k"), right_on=F.col("k2")))
    assert got.num_rows == 16 * 40 + 1
    assert "cap=1024" in pqe.executed_plan.tree_string()
    assert pqe.attempts == 3  # unique build fails, then the overflow


def test_saturated_hash_table_falls_back_to_sort(fact_dim):
    fact_dim.set_conf({MODE_KEY: "hash", MAX_PROBE_KEY: 1})
    _, pqe = fact_dim.check(_fact_join(fact_dim, "inner"))
    assert "hash_fallback" in pqe.executed_plan.tree_string()


@pytest.mark.parametrize("mode", ["sort", "hash"])
@pytest.mark.parametrize("case", ["packed", "hashed", "strings"])
def test_multi_key_joins_match_reference(session, case, mode):
    """Two keys: int16 + int32 pack exactly into one int64; two int64
    keys are hashed and each pair re-verified; string keys come with
    dictionaries that differ between the two sides."""
    rs = np.random.RandomState(5)
    n, m = 300, 40
    if case == "packed":
        a, b = pa.int16(), pa.int32()
        pa_, pb = rs.randint(-3, 3, n), rs.randint(-5, 5, n)
        ba, bb = rs.randint(-3, 3, m), rs.randint(-5, 5, m)
    elif case == "hashed":
        a = b = pa.int64()
        pa_, pb = rs.randint(0, 4, n) << 40, rs.randint(-5, 5, n)
        ba, bb = rs.randint(0, 4, m) << 40, rs.randint(-5, 5, m)
    else:
        a, b = pa.string(), pa.int32()
        pa_ = [f"s{i}" for i in rs.randint(0, 6, n)]
        ba = [f"s{i}" for i in rs.randint(2, 9, m)]
        pb, bb = rs.randint(0, 3, n), rs.randint(0, 3, m)
    e = Engines(session)
    e.set_conf({MODE_KEY: mode})
    e.register("probe", pa.table({
        "a": pa.array(pa_, type=a), "b": pa.array(pb, type=b),
        "v": pa.array(np.arange(n, dtype=np.int64))}))
    e.register("build", pa.table({
        "a2": pa.array(ba, type=a), "b2": pa.array(bb, type=b),
        "w": pa.array(np.arange(m, dtype=np.int64))}))
    for how in ("inner", "left", "full", "left_semi"):
        e.check(lambda s, F: e.table(s, "probe").join(
            e.table(s, "build"), how=how, left_on=[F.col("a"), F.col("b")],
            right_on=[F.col("a2"), F.col("b2")]))


@pytest.mark.parametrize("how", JOIN_TYPES)
def test_residual_condition_matches_reference(fact_dim, how):
    e = fact_dim
    e.check(lambda s, F: e.table(s, "fact").join(
        e.table(s, "dim"), how=how, left_on=F.col("k"),
        right_on=F.col("k2"), condition=F.col("v") > F.col("w") * 10))


def test_null_aware_anti_join_matches_reference(session):
    """NOT IN semantics: a NULL build key empties the result; without
    one, NULL probe keys are dropped."""
    from spark_tpu.dataframe import DataFrame as RDataFrame
    from spark_tpu.plan import logical as RL
    from spark_tpu_torch.dataframe import DataFrame as PDataFrame
    from spark_tpu_torch.plan import logical as PL
    e = Engines(session)
    e.register("probe", _keys_table([1, None, 3, 4], pa.int64(), "k", "v"))
    for name, build in (("build", [3, 5]), ("build_null", [3, None])):
        e.register(name, _keys_table(build, pa.int64(), "k2", "w"))

        def query(s, F, name=name):
            D, L = (PDataFrame, PL) if F is PF else (RDataFrame, RL)
            join = L.Join(e.table(s, "probe").plan, e.table(s, name).plan,
                          [F.col("k")], [F.col("k2")], "left_anti",
                          null_aware=True)
            return D(s, join)

        got, _ = e.check(query)
        assert got.num_rows == (2 if name == "build" else 0)


@pytest.fixture
def groups_table(session):
    """Keys without a dense domain (int64, a nullable date, float64
    with NaN and signed zeros, a string) and int, decimal and float
    values with NULLs."""
    import decimal
    rs = np.random.RandomState(7)
    n = 3000
    vals = [decimal.Decimal(int(x)).scaleb(-2)
            for x in rs.randint(-10**6, 10**6, n)]
    fk = rs.choice([0.0, -0.0, 1.5, float("nan"), 2.25], n)
    e = Engines(session)
    e.register("groups", pa.table({
        "g": pa.array(rs.randint(0, 400, n).astype(np.int64) * 1000003),
        "d": pa.array(rs.randint(8000, 8040, n).astype(np.int32),
                      mask=rs.rand(n) < 0.1).cast(pa.date32()),
        "f": pa.array(fk),
        "s": pa.array([f"k{i}" for i in rs.randint(0, 30, n)]),
        "i": pa.array(rs.randint(-1000, 1000, n).astype(np.int64),
                      mask=rs.rand(n) < 0.05),
        "m": pa.array(vals, type=pa.decimal128(12, 2)),
        "x": pa.array(rs.standard_normal(n), mask=rs.rand(n) < 0.05)}))
    return e


def _aggs(F):
    return (F.sum(F.col("i")).alias("si"), F.sum(F.col("m")).alias("sm"),
            F.sum(F.col("x")).alias("sx"), F.min(F.col("x")).alias("nx"),
            F.max(F.col("i")).alias("mi"), F.min(F.col("m")).alias("nm"),
            F.avg(F.col("x")).alias("ax"), F.count().alias("c"))


@pytest.mark.parametrize("keys", [["g"], ["g", "d"], ["f"], ["s", "g"]])
def test_sort_aggregate_matches_reference(groups_table, keys):
    e = groups_table
    got, _ = e.check(lambda s, F: e.table(s, "groups").filter(
        F.col("i") > F.lit(-900)).group_by(
            *[F.col(k) for k in keys]).agg(*_aggs(F)))
    assert got.num_rows > 30


def test_sort_aggregate_overflow_grows_the_estimate(groups_table):
    e = groups_table
    e.set_conf({EST_GROUPS_KEY: 64})
    got, pqe = e.check(lambda s, F: e.table(s, "groups").group_by(
        F.col("g")).agg(*_aggs(F)))
    assert 256 < got.num_rows <= 400
    assert pqe.attempts == 2
    assert "est=512" in pqe.executed_plan.tree_string()


def _expansion_inputs(case: str):
    """(lo, cnt_key, cnt_eff, perm, out_cap) of one expansion case, from
    a numpy seed: probe rows' build match ranges over a shuffled build
    side, as `match_ranges` gives them."""
    rs = np.random.RandomState(sum(map(ord, case)))
    n_build = 64
    cap = 1 if case == "probe_capacity_1" else 200
    if case == "fk_single":
        cnt = (rs.rand(cap) < 0.7).astype(np.int64)
    elif case == "no_emitting_row":
        cnt = np.zeros(cap, dtype=np.int64)
    else:
        cnt = rs.choice([0, 0, 1, 2, 3, 5, 9], cap).astype(np.int64)
    if case == "zero_rows_at_both_ends":
        cnt[:7] = 0
        cnt[-9:] = 0
    if case in ("unselected_rows", "outer_null_extension"):
        cnt[rs.rand(cap) < 0.3] = 0  # the probe selection's zeros
    lo = np.array([rs.randint(0, n_build - c + 1) for c in cnt],
                  dtype=np.int64)
    eff = cnt.copy()
    if case == "outer_null_extension":
        selected = rs.rand(cap) < 0.85
        eff = np.where(selected, np.maximum(cnt, 1), 0)
        cnt = np.where(selected, cnt, 0)
    perm = rs.permutation(n_build).astype(np.int64)
    total = int(eff.sum())
    out_cap = {"out_cap_above_total": total + 37,
               "out_cap_below_total": max(1, total // 3),
               "no_emitting_row": 16}.get(case, max(1, total))
    return lo, cnt, eff, perm, out_cap


@pytest.mark.parametrize("case", [
    "many_to_many", "fk_single", "outer_null_extension", "no_emitting_row",
    "zero_rows_at_both_ends", "unselected_rows", "out_cap_above_total",
    "out_cap_below_total", "probe_capacity_1"])
def test_expansion_matches_reference(case):
    """The port's `expand` and the JAX package's give the same probe row,
    build row, pair and valid flags for every output row, and the same
    total, as integers (the JAX package's p is int32)."""
    import jax.numpy as jnp
    from spark_tpu.execution import join as RJ
    from spark_tpu_torch.execution import join as PJ
    lo, cnt, eff, perm, out_cap = _expansion_inputs(case)
    got = PJ.expand(*(torch.from_numpy(a) for a in (lo, cnt, eff, perm)),
                    out_cap)
    want = RJ.expand(*(jnp.asarray(a) for a in (lo, cnt, eff, perm)),
                     out_cap)
    for name, g, w in zip(["p", "build_idx", "is_pair", "valid", "total"],
                          got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), name
    total = int(got[4])
    assert total == int(eff.sum())
    assert (total > out_cap) == (case == "out_cap_below_total")
    assert (total == 0) == (case == "no_emitting_row")


def test_mix64_and_bloom_bits_match_reference():
    import jax.numpy as jnp
    from spark_tpu import sketch as R
    from spark_tpu_torch import sketch as S
    rs = np.random.RandomState(3)
    info = np.iinfo(np.int64)
    x = np.concatenate([rs.randint(info.min, info.max, 4000, dtype=np.int64),
                        np.array([0, -1, 1, info.max, info.min],
                                 dtype=np.int64)])
    for seed in (0, 1, 5, 0xCC9E2D51):
        want = np.asarray(R._mix64(jnp.asarray(x), seed)).view(np.int64)
        assert np.array_equal(S._mix64(torch.from_numpy(x), seed).numpy(),
                              want)
    mask = rs.rand(len(x)) < 0.5
    got = S.BloomFilter.build(torch.from_numpy(x), expected_items=1500,
                              mask=torch.from_numpy(mask))
    want = R.BloomFilter.build(jnp.asarray(x), expected_items=1500,
                               mask=jnp.asarray(mask))
    assert got.num_hashes == want.num_hashes
    assert np.array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert np.array_equal(got.might_contain(torch.from_numpy(x)).numpy(),
                          np.asarray(want.might_contain(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", ["int64", "int32", "float64", "string"])
def test_runtime_filter_keep_mask_matches_reference(dtype):
    """Build a filter from a selective build column and probe with
    another table; NULL keys on both sides, differing dictionaries for
    strings."""
    from spark_tpu.columnar import Batch as RBatch
    from spark_tpu.execution import join as RJ
    from spark_tpu.expr import ColumnRef as RCol
    from spark_tpu.plan.physical import ExecContext
    from spark_tpu.config import Conf
    from spark_tpu_torch.columnar import Batch as PBatch
    from spark_tpu_torch.execution import join as PJ
    from spark_tpu_torch.expr import ColumnRef as PCol
    rs = np.random.RandomState(9)

    def column(values, n):
        if dtype == "string":
            return pa.array([f"v{v}" for v in values])
        arr = pa.array(values.astype(dtype), mask=rs.rand(n) < 0.05)
        return arr
    build = pa.table({"k": column(rs.randint(0, 50, 200) * 3, 200)})
    probe = pa.table({"k": column(rs.randint(-20, 400, 3000), 3000)})
    rb, rp = RBatch.from_arrow(build), RBatch.from_arrow(probe)
    pb, pp = PBatch.from_arrow(build, "cpu"), PBatch.from_arrow(probe, "cpu")
    rf = RJ.build_runtime_filter(rb, RCol("k"), ExecContext(Conf()),
                                 expected_items=256)
    pf = PJ.build_runtime_filter(pb, PCol("k"), expected_items=256)
    assert np.array_equal(pf.bloom.bits.numpy(), np.asarray(rf.bloom.bits))
    want = np.asarray(RJ.apply_runtime_filter(rf, rp, RCol("k")))
    got = PJ.apply_runtime_filter(pf, pp, PCol("k")).numpy()
    assert np.array_equal(got, want)
    assert 0 < got.sum() < len(got)
