"""The port's dense group-by against the JAX package's Pallas kernels.

The same seeded numpy inputs go through `spark_tpu.execution.pallas_groupby
.dense_groupby_sums` (Pallas interpret mode, as the JAX package's own CPU
tests run it) and through `spark_tpu_torch.execution.dense_groupby`, whose
wrapper runs its plain `index_add_` version on CPU tensors. Int sums must
be equal; float sums agree within rtol 1e-9 on float inputs whose float32
partial sums are exact. On general float64 inputs the reference is only
float32-accurate (its per-tile sums of the hi/lo pairs round in float32:
1.3e-7 relative on this test's inputs), which `test_reference_float_sums_are_float32_accurate`
pins down. The CUDA kernels themselves run
only on the card: the test marked `cuda` holds them against the plain
version there and skips elsewhere.
"""

import numpy as np
import pytest
import torch

from spark_tpu.execution import aggregate as ref_agg
from spark_tpu.execution import pallas_groupby as ref_pg
from spark_tpu_torch.execution import aggregate as port_agg
from spark_tpu_torch.execution import dense_groupby as D

FLOAT_RTOL = 1e-9


def _inputs(seed, n, domain, n_int, n_float, big=False, out_of_range=0.0,
            dyadic=True):
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, domain, n).astype(np.int32)
    if out_of_range:
        drop = rs.rand(n) < out_of_range
        idx[drop] = np.where(rs.rand(int(drop.sum())) < 0.5, domain + 5, -3)
    lo, hi = (-(1 << 62), 1 << 62) if big else (-10**6, 10**6)
    ints = [rs.randint(lo, hi, n, dtype=np.int64) for _ in range(n_int)]
    if dyadic:
        # multiples of 1/8 below 2^10: every partial sum the reference
        # forms in float32 stays exact, so only the summation order differs
        floats = [rs.randint(-8000, 8000, n) / 8.0 for _ in range(n_float)]
    else:
        floats = [rs.standard_normal(n) * 1e3 + 5e3 for _ in range(n_float)]
    return idx, ints, floats


def _reference(idx, ints, floats, domain):
    import jax.numpy as jnp
    i_out, f_out = ref_pg.dense_groupby_sums(
        jnp.asarray(idx), [jnp.asarray(r) for r in ints],
        [jnp.asarray(r) for r in floats], domain, interpret=True)
    return [np.asarray(r) for r in i_out], [np.asarray(r) for r in f_out]


def _port(idx, ints, floats, domain):
    i_out, f_out = D.dense_groupby_sums(
        torch.from_numpy(idx), [torch.from_numpy(r) for r in ints],
        [torch.from_numpy(r) for r in floats], domain)
    return [r.numpy() for r in i_out], [r.numpy() for r in f_out]


CASES = {
    # name: (seed, n, domain, int rows, float rows, big values, out of range)
    "domain1_q6": (1, 3000, 1, 2, 0, True, 0.0),
    "domain12_q1_wrapping": (2, 5000, 12, 9, 0, True, 0.0),
    "domain512_with_floats": (3, 5000, 512, 2, 2, False, 0.0),
    "domain2000_factored": (4, 3000, 2000, 2, 0, True, 0.0),
    "out_of_range_dropped": (5, 4000, 64, 2, 1, False, 0.05),
    "domain25_q5_nations": (9, 5000, 25, 4, 1, True, 0.0),
    "domain_above_private_cutoff": (10, 5000, D.PRIVATE_DOMAIN + 1, 3, 2,
                                    False, 0.02),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas(case):
    seed, n, domain, n_int, n_float, big, oor = CASES[case]
    idx, ints, floats = _inputs(seed, n, domain, n_int, n_float, big, oor)
    want_i, want_f = _reference(idx, ints, floats, domain)
    got_i, got_f = _port(idx, ints, floats, domain)
    assert len(got_i) == n_int and len(got_f) == n_float
    for g, w in zip(got_i, want_i):
        assert g.dtype == np.int64 and g.shape == (domain,)
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got_f, want_f):
        np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0)


def test_reference_float_sums_are_float32_accurate():
    """General float64 rows: the port sums in float64; the reference's
    Pallas path keeps float32 hi/lo pairs whose tile sums round in
    float32, so the two agree to float32 accuracy only."""
    idx, ints, floats = _inputs(3, 5000, 512, 0, 2, dyadic=False)
    _, want_f = _reference(idx, ints, floats, 512)
    _, got_f = _port(idx, ints, floats, 512)
    exact = [np.bincount(idx, weights=r, minlength=512) for r in floats]
    for g, w, e in zip(got_f, want_f, exact):
        np.testing.assert_allclose(g, e, rtol=1e-12, atol=0)
        np.testing.assert_allclose(w, e, rtol=1e-6, atol=0)


def test_plain_matches_numpy_loop():
    """The plain version against a per-row Python loop (wrapping int64
    adds, float adds in row order)."""
    idx, ints, floats = _inputs(7, 500, 10, 2, 1, big=True,
                                out_of_range=0.1)
    got_i, got_f = _port(idx, ints, floats, 10)
    want_i = [[0] * 10 for _ in ints]
    want_f = [np.zeros(10) for _ in floats]
    for row, k in enumerate(idx):
        if 0 <= k < 10:
            for w, r in zip(want_i, ints):
                w[k] = (w[k] + int(r[row])) % (1 << 64)
            for w, r in zip(want_f, floats):
                w[k] += r[row]
    for g, w in zip(got_i, want_i):
        np.testing.assert_array_equal(
            g, np.array(w, dtype=np.uint64).view(np.int64))
    for g, w in zip(got_f, want_f):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


def test_wrapper_contract_errors():
    idx = torch.zeros(4, dtype=torch.int32)
    rows = [torch.ones(4, dtype=torch.float64)]
    with pytest.raises(ValueError, match="float rows unsupported"):
        D.dense_groupby_sums(idx, [], rows, 513)
    with pytest.raises(ValueError, match="domain"):
        D.dense_groupby_sums(idx, [torch.ones(4, dtype=torch.int64)], [],
                             (1 << 20) + 1)


def test_cpu_tensors_never_launch():
    before = dict(D.LAUNCHES)
    idx, ints, floats = _inputs(8, 300, 12, 1, 1)
    _port(idx, ints, floats, 12)
    assert D.LAUNCHES == before


def _ref_direct(keys, contribs, specs, domain, **kw):
    import jax.numpy as jnp
    from spark_tpu import types as RT
    from spark_tpu.expr import Vec
    vec = Vec(jnp.asarray(keys), RT.LONG, None, None)
    _, _, accs, occ = ref_agg.direct_aggregate(
        [vec], [(domain, 0)], [domain],
        [[jnp.asarray(c) for c in row] for row in contribs], specs, None,
        **kw)
    return [[np.asarray(a) for a in row] for row in accs], np.asarray(occ)


def _port_direct(keys, contribs, specs, domain, **kw):
    from spark_tpu_torch import types as PT
    from spark_tpu_torch.expr import Vec
    vec = Vec(torch.from_numpy(keys), PT.LONG, None, None)
    _, _, accs, occ = port_agg.direct_aggregate(
        [vec], [(domain, 0)], [domain],
        [[torch.from_numpy(c) for c in row] for row in contribs], specs,
        None, torch.device("cpu"), **kw)
    return [[a.numpy() for a in row] for row in accs], occ.numpy()


def _specs(pkg):
    AccSpec = pkg.AccSpec
    return [[AccSpec("count", np.dtype(np.int64), "sum", width=8)],
            [AccSpec("sum", np.dtype(np.int64), "sum", width=16),
             AccSpec("cnt", np.dtype(np.int64), "sum", width=8)],
            [AccSpec("sum", np.dtype(np.float64), "sum"),
             AccSpec("cnt", np.dtype(np.int64), "sum", width=8)]]


def test_merge_full_width_above_2_40():
    """merge=True folds partial accumulators: partial counts of 1000 and
    partial sums of 2^40 + k must come back whole (the JAX package's
    width-bounded limbs once truncated them)."""
    import spark_tpu.expr_agg as ref_ea
    import spark_tpu_torch.expr_agg as port_ea
    n = 160
    keys = np.arange(n, dtype=np.int64) % 4
    contribs = [[np.full(n, 1000, np.int64)],
                [(1 << 40) + np.arange(n, dtype=np.int64),
                 np.full(n, 3, np.int64)],
                [np.arange(n) / 8.0, np.ones(n, np.int64)]]
    want, want_occ = _ref_direct(keys, contribs, _specs(ref_ea), 4,
                                 kernel_mode="matmul", merge=True)
    got, got_occ = _port_direct(keys, contribs, _specs(port_ea), 4,
                                kernel_mode="matmul", merge=True)
    assert got[0][0].tolist() == [1000 * 40] * 4
    assert got[1][0].tolist() == [
        (1 << 40) * 40 + int(np.arange(k, n, 4).sum()) for k in range(4)]
    for gr, wr in zip(got[:2], want[:2]):
        for g, w in zip(gr, wr):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[2][0], want[2][0], rtol=FLOAT_RTOL)
    np.testing.assert_array_equal(got_occ, want_occ)


@pytest.mark.parametrize("mode", ["auto", "matmul", "scatter"])
def test_direct_update_modes_match_reference(mode):
    """Every kernelMode gives the reference's tables, with the occupancy
    count riding a count row (reuse_count) and unselected rows dropped."""
    import spark_tpu.expr_agg as ref_ea
    import spark_tpu_torch.expr_agg as port_ea
    rs = np.random.RandomState(11)
    n, domain = 700, 24
    keys = rs.randint(0, domain, n).astype(np.int64)
    sel = rs.rand(n) < 0.8
    contribs = [[sel.astype(np.int64)],
                [np.where(sel, rs.randint(0, 1 << 16, n), 0).astype(np.int64),
                 sel.astype(np.int64)],
                [np.where(sel, rs.randint(0, 800, n) / 8.0, 0.0),
                 sel.astype(np.int64)]]
    import jax.numpy as jnp
    from spark_tpu import types as RT
    from spark_tpu.expr import Vec as RVec
    from spark_tpu_torch import types as PT
    from spark_tpu_torch.expr import Vec as PVec
    r_idx, total, _ = ref_agg.direct_index(
        [RVec(jnp.asarray(keys), RT.LONG)], [(domain, 0)], [domain],
        jnp.asarray(sel))
    p_idx, p_total, _ = port_agg.direct_index(
        [PVec(torch.from_numpy(keys), PT.LONG)], [(domain, 0)], [domain],
        torch.from_numpy(sel))
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(r_idx))
    assert p_total == total == domain
    r_cnt, r_accs = ref_agg.direct_update(
        ref_agg.direct_init([domain], _specs(ref_ea)), r_idx, total,
        [[jnp.asarray(c) for c in row] for row in contribs], _specs(ref_ea),
        kernel_mode=mode, reuse_count=(0, 0))
    p_cnt, p_accs = port_agg.direct_update(
        port_agg.direct_init([domain], _specs(port_ea), "cpu"), p_idx,
        p_total, [[torch.from_numpy(c) for c in row] for row in contribs],
        _specs(port_ea), kernel_mode=mode, reuse_count=(0, 0))
    np.testing.assert_array_equal(p_cnt.numpy(), np.asarray(r_cnt))
    for pr, rr in zip(p_accs, r_accs):
        for p, r in zip(pr, rr):
            if p.dtype == torch.float64:
                np.testing.assert_allclose(p.numpy(), np.asarray(r),
                                           rtol=FLOAT_RTOL)
            else:
                np.testing.assert_array_equal(p.numpy(), np.asarray(r))


PLAN_DOMAINS = [1, 2, 12, 25, D.PRIVATE_DOMAIN, D.PRIVATE_DOMAIN + 1, 512]


@pytest.mark.parametrize("domain", PLAN_DOMAINS)
@pytest.mark.parametrize("n_int,n_float", [(15, 0), (2, 2), (33, 0), (20, 13)])
def test_plan_covers_each_row_once(domain, n_int, n_float):
    """Every int and float row lands in exactly one launch, in order, and
    every launch fits a block's shared memory and pointer slots."""
    plan = D.plan_launches(domain, n_int, n_float)
    assert [k for launch in plan for k in launch.ints] == list(range(n_int))
    assert [k for launch in plan for k in launch.floats] == \
        list(range(n_float))
    for launch in plan:
        rows = len(launch.ints) + len(launch.floats)
        assert 1 <= rows <= D.MAX_ROWS_PER_LAUNCH
        assert 0 < launch.smem_bytes <= D.SMEM_BUDGET
        assert launch.smem_bytes == D.smem_bytes(launch.variant, domain,
                                                 rows, launch.warps)
        if launch.variant == "shared":
            assert launch.warps == D.SHARED_WARPS
        else:
            assert launch.warps % rows == 0
            assert launch.warps <= D.PRIVATE_WARPS
    if n_int + n_float > D.MAX_ROWS_PER_LAUNCH:
        assert len(plan) > 1
    sizes = [len(x.ints) + len(x.floats) for x in plan]
    assert max(sizes) - min(sizes) <= 1


def test_plan_variant_changes_at_cutoffs():
    def variants(domain, n_float=1):
        return {launch.variant for launch in D.plan_launches(domain, 4, n_float)}

    assert variants(1) == variants(D.PRIVATE_DOMAIN) == {"private"}
    assert variants(D.PRIVATE_DOMAIN + 1) == {"shared"}
    assert variants(D.SMEM_DOMAIN) == {"shared"}
    assert variants(D.SMEM_DOMAIN + 1, n_float=0) == {"global"}
    assert D.PRIVATE_DOMAIN <= D.VARIANT_MAX_DOMAIN["private"]


@pytest.mark.parametrize("variant", ["private", "shared"])
def test_every_variant_fits_at_every_domain(variant):
    """`plan_variant` lays out any domain a variant is built for, at any
    row count, within the shared-memory budget."""
    for domain in range(1, D.VARIANT_MAX_DOMAIN[variant] + 1):
        for n_int, n_float in ((1, 0), (0, 1), (7, 0), (16, 16), (40, 3)):
            plan = D.plan_variant(variant, domain, n_int, n_float)
            assert sum(len(x.ints) for x in plan) == n_int
            assert sum(len(x.floats) for x in plan) == n_float
            assert all(0 < x.smem_bytes <= D.SMEM_BUDGET for x in plan)


def test_plan_rejects_what_no_kernel_takes():
    assert D.plan_launches(12, 0, 0) == []
    with pytest.raises(ValueError, match="int rows only"):
        D.plan_variant("global", 1000, 1, 1)
    with pytest.raises(ValueError, match="domains up to"):
        D.plan_variant("shared", D.SMEM_DOMAIN + 1, 1, 0)
    with pytest.raises(ValueError, match="domains up to"):
        D.plan_variant("private", D.VARIANT_MAX_DOMAIN["private"] + 1, 1, 0)
    with pytest.raises(ValueError, match="unknown variant"):
        D.plan_variant("matmul", 12, 1, 0)
    with pytest.raises(ValueError, match="not CUDA"):
        D.run_plan(D.plan_launches(12, 1, 0), torch.zeros(4, dtype=torch.int32),
                   [torch.ones(4, dtype=torch.int64)], [], 12)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Every kernel and variant against the plain version on the card:
    ints equal (including wrapping sums), floats within rtol 1e-12 and
    equal bit for bit across two runs; odd row counts and value rows that
    do not start on a 16-byte boundary included. The CUDA source's own
    count of a block's shared memory agrees with the planner's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    for seed, n, domain, n_int, n_float, big, oor in [
            (1, 100_000, 1, 3, 0, True, 0.0),
            (2, 100_000, 12, 9, 0, True, 0.0),
            (3, 100_000, 512, 2, 2, False, 0.01),
            (4, 200_000, 65536, 3, 0, True, 0.01),
            (5, 100_001, 3, 2, 2, True, 0.05),
            (6, 100_001, 25, 15, 1, True, 0.05),
            (7, 100_001, D.PRIVATE_DOMAIN + 1, 33, 3, True, 0.05),
            (8, 3, 12, 2, 1, False, 0.0)]:
        idx, ints, floats = _inputs(seed, n, domain, n_int, n_float, big, oor)
        want = D.dense_groupby_sums_plain(
            torch.from_numpy(idx), [torch.from_numpy(r) for r in ints],
            [torch.from_numpy(r) for r in floats], domain)
        c_idx = torch.from_numpy(idx).to(dev)
        # every other int row starts 8 bytes into its allocation
        c_ints = [torch.from_numpy(np.concatenate([[0], r])).to(dev)[1:]
                  if k % 2 else torch.from_numpy(r).to(dev)
                  for k, r in enumerate(ints)]
        c_floats = [torch.from_numpy(r).to(dev) for r in floats]
        plans = [D.plan_launches(domain, n_int, n_float)]
        if domain <= D.SMEM_DOMAIN:
            plans += [D.plan_variant(v, domain, n_int, n_float)
                      for v in ("private", "shared")
                      if domain <= D.VARIANT_MAX_DOMAIN[v]]
        lib = D._load()
        for plan in plans:
            for launch in plan:
                if launch.variant != "global":
                    rows = len(launch.ints) + len(launch.floats)
                    assert lib.dense_sums_smem_bytes(
                        D._VARIANT_CODE[launch.variant], domain, rows,
                        launch.warps) == launch.smem_bytes
            got = D.run_plan(plan, c_idx, c_ints, c_floats, domain)
            again = D.run_plan(plan, c_idx, c_ints, c_floats, domain)
            torch.cuda.synchronize()
            for g, w in zip(got[0], want[0]):
                assert torch.equal(g.cpu(), w)
            for g, a, w in zip(got[1], again[1], want[1]):
                assert torch.allclose(g.cpu(), w, rtol=1e-12, atol=0)
                assert torch.equal(g, a)
        got = D.dense_groupby_sums(c_idx, c_ints, c_floats, domain)
        for g, w in zip(got[0], want[0]):
            assert torch.equal(g.cpu(), w)
