"""Window functions of the port against the JAX package, on the CPU.

The single-device cases of `tests/test_window.py` (the mesh cases wait
for the port's multi-device slice) run the same program over the same
seeded table through both packages: the Arrow results must be equal
(floats within rtol 1e-12) and the executed plans must print the same.
Each also keeps its original check against pandas. Then the primitives
of `execution/window.py` are held against the JAX package's on seeded
sorted inputs with ties, NULLs and filtered rows: segment starts, peer
ends, ranks, `shift_in_segment`, `windowed_agg`, `frame_bounds`,
`framed_agg`, and ROWS and RANGE frames (live rows compared exactly,
floats within rtol 1e-12).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_tpu import functions as RF
from spark_tpu import window as RW
from spark_tpu.execution import window as rwin
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch import window as PW
from spark_tpu_torch.execution import window as pwin
from spark_tpu_torch.expr import AnalysisError
from spark_tpu_torch.sql.lexer import ParseError
from torch_sql_parity import FLOAT_RTOL, assert_tables_match

PKGS = {"port": (PF, PW), "ref": (RF, RW)}


def run_both(pdf: pd.DataFrame, name: str, build):
    """`build(session, F, Window)` in each package over `pdf` registered
    as `name`; asserts equal results and plans, returns the port's
    result as pandas."""
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    out = {}
    for label, session in (("port", port), ("ref", ref)):
        session.register_table(name, pdf)
        F, W = PKGS[label]
        out[label] = build(session, F, W)._qe()
    assert out["port"].executed_plan.tree_string() == \
        out["ref"].executed_plan.tree_string()
    got, want = out["port"].collect(), out["ref"].collect()
    assert_tables_match(got, want)
    return got.to_pandas()


def sql_both(pdf: pd.DataFrame, name: str, text: str):
    return run_both(pdf, name, lambda s, F, W: s.sql(text))


@pytest.fixture(scope="module")
def wdata():
    rs = np.random.RandomState(11)
    return pd.DataFrame({
        "g": rs.randint(0, 6, 200).astype(np.int64),
        "o": rs.randint(0, 50, 200).astype(np.int64),  # has ties
        "v": rs.randint(-100, 100, 200).astype(np.int64),
    })


def test_row_number(wdata):
    def build(s, F, W):
        w = W.Window.partition_by(F.col("g")).order_by(F.col("o"),
                                                       F.col("v"))
        return s.table("wd_rn").with_column("rn", F.row_number().over(w))
    got = run_both(wdata, "wd_rn", build)
    want = (wdata.sort_values(["o", "v"]).groupby("g").cumcount() + 1)
    assert got["rn"].tolist() == want.sort_index().tolist()


def test_rank_dense_rank(wdata):
    def build(s, F, W):
        w = W.Window.partition_by(F.col("g")).order_by(F.col("o"))
        return (s.table("wd_rank")
                .with_column("r", F.rank().over(w))
                .with_column("dr", F.dense_rank().over(w)))
    got = run_both(wdata, "wd_rank", build)
    want_r = wdata.groupby("g")["o"].rank(method="min").astype(int)
    want_dr = wdata.groupby("g")["o"].rank(method="dense").astype(int)
    assert got["r"].tolist() == want_r.tolist()
    assert got["dr"].tolist() == want_dr.tolist()


def test_lag_lead(wdata):
    def build(s, F, W):
        w = W.Window.partition_by(F.col("g")).order_by(F.col("o"),
                                                       F.col("v"))
        return (s.table("wd_lag")
                .with_column("lg", F.lag(F.col("v")).over(w))
                .with_column("ld", F.lead(F.col("v"), 2).over(w))
                .with_column("lgd", F.lag(F.col("v"), 1, 0).over(w)))
    got = run_both(wdata, "wd_lag", build)
    s = wdata.sort_values(["g", "o", "v"], kind="stable")
    want_lg = s.groupby("g")["v"].shift(1).sort_index()
    want_ld = s.groupby("g")["v"].shift(-2).sort_index()
    assert np.array_equal(got["lg"].fillna(-9999).to_numpy(),
                          want_lg.fillna(-9999).to_numpy())
    assert np.array_equal(got["ld"].fillna(-9999).to_numpy(),
                          want_ld.fillna(-9999).to_numpy())
    assert np.array_equal(got["lgd"].to_numpy(),
                          want_lg.fillna(0).to_numpy())


def test_sum_over_whole_partition(wdata):
    def build(s, F, W):
        w = W.Window.partition_by(F.col("g"))
        return (s.table("wd_whole")
                .with_column("sv", F.sum(F.col("v")).over(w))
                .with_column("cv", F.count(F.col("v")).over(w))
                .with_column("mx", F.max(F.col("v")).over(w))
                .with_column("mn", F.min(F.col("v")).over(w))
                .with_column("av", F.avg(F.col("v")).over(w)))
    got = run_both(wdata, "wd_whole", build)
    want = wdata.groupby("g")["v"]
    assert got["sv"].tolist() == want.transform("sum").tolist()
    assert got["cv"].tolist() == want.transform("count").tolist()
    assert got["mx"].tolist() == want.transform("max").tolist()
    assert got["mn"].tolist() == want.transform("min").tolist()
    assert np.allclose(got["av"], want.transform("mean"), rtol=1e-12)


def test_running_sum_range_frame(wdata):
    """Spark default frame with ORDER BY: RANGE UNBOUNDED PRECEDING ..
    CURRENT ROW — peer rows (order-key ties) are included."""
    def build(s, F, W):
        w = W.Window.partition_by(F.col("g")).order_by(F.col("o"))
        return (s.table("wd_run")
                .with_column("rs", F.sum(F.col("v")).over(w))
                .with_column("rmx", F.max(F.col("v")).over(w)))
    got = run_both(wdata, "wd_run", build)
    per_o = wdata.groupby(["g", "o"])["v"].sum().groupby(level=0).cumsum()
    want = wdata.set_index(["g", "o"]).index.map(per_o)
    assert got["rs"].tolist() == list(want)


def test_global_window_no_partition(wdata):
    def build(s, F, W):
        w = W.Window.order_by(F.col("o"), F.col("v"))
        return s.table("wd_glob").with_column("rn", F.row_number().over(w))
    got = run_both(wdata, "wd_glob", build)
    s = wdata.sort_values(["o", "v"], kind="stable")
    rn = pd.Series(np.arange(1, len(s) + 1), index=s.index).sort_index()
    assert got["rn"].tolist() == rn.tolist()


def test_sql_window_functions(wdata):
    got = sql_both(wdata, "wd_sql", """
        SELECT g, o, v,
               row_number() OVER (PARTITION BY g ORDER BY o, v) AS rn,
               sum(v) OVER (PARTITION BY g) AS sv,
               lag(v, 1) OVER (PARTITION BY g ORDER BY o, v) AS lg
        FROM wd_sql
    """)
    s = wdata.sort_values(["o", "v"]).groupby("g")
    want_rn = (s.cumcount() + 1).sort_index()
    assert got["rn"].tolist() == want_rn.tolist()
    assert got["sv"].tolist() == \
        wdata.groupby("g")["v"].transform("sum").tolist()
    s2 = wdata.sort_values(["g", "o", "v"], kind="stable")
    want_lg = s2.groupby("g")["v"].shift(1).sort_index()
    assert np.array_equal(got["lg"].fillna(-9).to_numpy(),
                          want_lg.fillna(-9).to_numpy())


def test_sql_rank_requires_over(wdata):
    session = SparkTpuSession.builder().device("cpu").get_or_create()
    session.register_table("wd_over", wdata)
    with pytest.raises(ParseError, match="OVER"):
        session.sql("SELECT rank() FROM wd_over")


# -- ROWS/RANGE BETWEEN frames (reference: WindowExec.scala:36) -------------

def _frame_pdf():
    rs = np.random.RandomState(11)
    n = 500
    return pd.DataFrame({
        "g": rs.randint(0, 7, n).astype(np.int64),
        "t": rs.permutation(n).astype(np.int64),
        "v": rs.randn(n)})


def test_rows_between_sliding_parity_with_pandas():
    """sum/avg/min/max/count over ROWS BETWEEN 2 PRECEDING AND CURRENT
    ROW vs pandas rolling(3, min_periods=1) per partition."""
    pdf = _frame_pdf()

    def build(s, F, W):
        w = (W.Window.partition_by(F.col("g")).order_by(F.col("t"))
             .rows_between(-2, 0))
        return s.table("wf_rows").select(
            F.col("g"), F.col("t"),
            F.sum(F.col("v")).over(w).alias("s"),
            F.avg(F.col("v")).over(w).alias("a"),
            F.min(F.col("v")).over(w).alias("mn"),
            F.max(F.col("v")).over(w).alias("mx"),
            F.count(F.col("v")).over(w).alias("c"))
    out = run_both(pdf, "wf_rows", build) \
        .sort_values(["g", "t"]).reset_index(drop=True)
    want = pdf.sort_values(["g", "t"]).reset_index(drop=True)
    roll = want.groupby("g")["v"].rolling(3, min_periods=1)
    for name, series in (("s", roll.sum()), ("a", roll.mean()),
                         ("mn", roll.min()), ("mx", roll.max()),
                         ("c", roll.count())):
        exp = (want.assign(x=series.reset_index(level=0, drop=True))
               .sort_values(["g", "t"])["x"].to_numpy())
        assert np.allclose(out[name].to_numpy().astype(float), exp), name


def test_rows_between_following_and_unbounded():
    pdf = pd.DataFrame({"g": [0, 0, 0, 1, 1], "t": [1, 2, 3, 1, 2],
                        "v": [1.0, 2.0, 4.0, 8.0, 16.0]})

    def build(s, F, W):
        base = W.Window.partition_by(F.col("g")).order_by(F.col("t"))
        w1 = base.rows_between(0, 1)       # current + next
        w2 = base.rows_between(0, W.Window.unboundedFollowing)
        w3 = base.rows_between(W.Window.unboundedPreceding, -1)
        return s.table("wf_fol").select(
            F.col("g"), F.col("t"),
            F.sum(F.col("v")).over(w1).alias("nxt"),
            F.sum(F.col("v")).over(w2).alias("suf"),
            F.max(F.col("v")).over(w3).alias("before"))
    out = run_both(pdf, "wf_fol", build) \
        .sort_values(["g", "t"]).reset_index(drop=True)
    assert out["nxt"].tolist() == [3.0, 6.0, 4.0, 24.0, 16.0]
    assert out["suf"].tolist() == [7.0, 6.0, 4.0, 24.0, 16.0]
    assert out["before"].fillna(-1).tolist() == [-1, 1.0, 2.0, -1, 8.0]


def test_range_between_value_offsets():
    """RANGE BETWEEN 10 PRECEDING AND CURRENT ROW: value-space frame
    incl. peers and gaps."""
    pdf = pd.DataFrame({"g": [0, 0, 0, 0, 0],
                        "t": np.array([0, 5, 14, 15, 40], np.int64),
                        "v": [1.0, 2.0, 4.0, 8.0, 16.0]})

    def build(s, F, W):
        w = W.Window.partition_by(F.col("g")).order_by(F.col("t")) \
            .range_between(-10, 0)
        return s.table("wf_range").select(
            F.col("t"), F.sum(F.col("v")).over(w).alias("s"))
    out = run_both(pdf, "wf_range", build) \
        .sort_values("t").reset_index(drop=True)
    assert out["s"].tolist() == [1.0, 3.0, 6.0, 14.0, 16.0]


def test_sql_window_frame_clause():
    pdf = pd.DataFrame({"g": [0, 0, 0, 1, 1], "t": [1, 2, 3, 1, 2],
                        "v": [1.0, 2.0, 4.0, 8.0, 16.0]})
    out = sql_both(
        pdf, "wf_sql",
        "SELECT g, t, sum(v) OVER (PARTITION BY g ORDER BY t "
        "ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) AS s, "
        "avg(v) OVER (PARTITION BY g ORDER BY t "
        "RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING) AS a "
        "FROM wf_sql ORDER BY g, t")
    assert out["s"].tolist() == [1.0, 3.0, 6.0, 8.0, 24.0]
    assert out["a"].tolist() == [1.5, 7 / 3, 3.0, 12.0, 12.0]


def test_computed_partition_key_projects_a_column():
    """A computed PARTITION BY key is projected into a named column
    below the Window node, so the WindowExec clusters on it."""
    from spark_tpu_torch.plan import physical as P
    pdf = _frame_pdf()

    def build(s, F, W):
        w = W.Window.partition_by((F.col("g") % 3).alias("gb")) \
            .order_by(F.col("t"))
        return s.table("wf_ck").select(
            F.col("g"), F.col("t"), F.sum(F.col("v")).over(w).alias("s"))
    run_both(pdf, "wf_ck", build)
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    port.register_table("wf_ck", pdf)
    root = build(port, PF, PW)._qe().executed_plan
    wx = root
    while not isinstance(wx, P.WindowExec):
        wx = wx.children[0]
    from spark_tpu_torch.expr import plain_column_name
    keys = wx._spec()._partition
    assert keys and all(plain_column_name(k) is not None for k in keys), keys
    dists = wx.required_child_distributions()
    assert not isinstance(dists[0], P.AllTuples), dists


def test_range_frame_with_filtered_rows_and_nulls():
    """The RANGE-frame binary search must survive dead (filtered) rows at
    the sorted tail and NULL order keys."""
    pdf = pd.DataFrame({"g": [0, 0, 0, 0, 0, 0],
                        "t": np.array([1, 2, 5, 14, 15, 40], np.float64),
                        "v": [100.0, 200.0, 1.0, 2.0, 4.0, 8.0]})
    pdf.loc[5, "t"] = np.nan  # NULL order key row (t=40 -> NULL)

    def build(s, F, W):
        w = W.Window.partition_by(F.col("g")).order_by(F.col("t")) \
            .range_between(-10, 0)
        return (s.table("wf_dead")
                .filter(F.col("v") < 50.0)  # drops t=1,2 -> dead rows
                .select(F.col("t"), F.sum(F.col("v")).over(w).alias("s")))
    out = run_both(pdf, "wf_dead", build)
    by_t = {None if pd.isna(t) else t: s
            for t, s in zip(out["t"], out["s"])}
    assert by_t[5.0] == 1.0
    assert by_t[14.0] == 3.0
    assert by_t[15.0] == 7.0
    assert by_t[None] == 8.0


def test_decimal_window_avg_and_sum():
    """avg over a decimal rounds HALF_UP at its result scale
    (expr_agg.decimal_avg_halfup); sums stay exact int64."""
    import decimal
    rs = np.random.RandomState(5)
    vals = [decimal.Decimal(int(x)) / 100 for x in
            rs.randint(-10**6, 10**6, 60)]
    import pyarrow as pa
    table = pa.table({"g": pa.array(rs.randint(0, 4, 60), pa.int64()),
                      "t": pa.array(np.arange(60), pa.int64()),
                      "d": pa.array(vals, pa.decimal128(9, 2))})

    def build(s, F, W):
        w = W.Window.partition_by(F.col("g")).order_by(F.col("t"))
        return s.table("wf_dec").select(
            F.col("g"), F.col("t"),
            F.avg(F.col("d")).over(w).alias("a"),
            F.sum(F.col("d")).over(W.Window.partition_by(F.col("g")))
            .alias("s"),
            F.avg(F.col("d")).over(w.rows_between(-3, 0)).alias("a3"))
    run_both(table.to_pandas(), "wf_dec", build)


@pytest.mark.parametrize("case", ["string min", "lag default on string",
                                  "frame without order",
                                  "range offsets on two keys",
                                  "range offsets descending"])
def test_reference_errors(case):
    """The JAX package's analysis errors stay errors in the port."""
    from spark_tpu.expr import AnalysisError as RefAnalysisError
    pdf = pd.DataFrame({"g": [0, 0, 1], "s": ["a", "b", "c"],
                        "t": [1, 2, 3], "v": [1.0, 2.0, 4.0]})
    for label, session, error in (
            ("port", SparkTpuSession.builder().device("cpu").get_or_create(),
             AnalysisError),
            ("ref", RefSession(register_active=False), RefAnalysisError)):
        F, W = PKGS[label]
        session.register_table("wf_err", pdf)
        base = W.Window.partition_by(F.col("g"))
        by_t = base.order_by(F.col("t"))
        fn = {"string min": lambda: F.min(F.col("s")).over(base),
              "lag default on string":
                  lambda: F.lag(F.col("s"), 1, "x").over(by_t),
              "frame without order":
                  lambda: F.sum(F.col("v")).over(base.rows_between(-1, 0)),
              "range offsets on two keys":
                  lambda: F.sum(F.col("v")).over(base.order_by(
                      F.col("t"), F.col("v")).range_between(-1, 0)),
              "range offsets descending":
                  lambda: F.sum(F.col("v")).over(base.order_by(
                      F.col("t").desc()).range_between(-1, 0))}[case]
        with pytest.raises(error):
            session.table("wf_err").select(fn().alias("x")).to_pandas()


# -- primitive-level parity of execution/window.py --------------------------

CAP = 96


def _sorted_inputs(seed: int):
    """Sorted partition and order operands with ties, a dead tail of
    filtered rows, values with NULLs: (numpy dict)."""
    rs = np.random.RandomState(seed)
    n_valid = CAP - 13
    p = np.sort(rs.randint(0, 7, CAP)).astype(np.int64)
    o = np.zeros(CAP, np.int64)
    for k in np.unique(p):  # ascending order key with ties per segment
        at = p == k
        o[at] = np.sort(rs.randint(0, 6, at.sum()))
    valid = np.arange(CAP) < n_valid
    p[~valid] = rs.randint(0, 7, (~valid).sum())  # garbage in dead rows
    return {"p": p, "o": o, "valid": valid, "n_valid": n_valid,
            "ints": rs.randint(-1000, 1000, CAP).astype(np.int64),
            "floats": rs.randn(CAP),
            "vmask": rs.rand(CAP) > 0.2}


def _both(seed):
    d = _sorted_inputs(seed)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in d.items()}
    j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
         for k, v in d.items()}
    pst = pwin._segment_starts([t["p"]], CAP, t["valid"])
    rst = rwin._segment_starts([j["p"]], CAP, j["valid"])
    pch = pwin._peer_change(pst, [t["o"]], CAP)
    rch = rwin._peer_change(rst, [j["o"]], CAP)
    return d, t, j, (pst, pch), (rst, rch)


def _eq(port, ref, live=None, floats=False):
    a = port.numpy()
    b = np.asarray(ref)
    if live is not None:
        a, b = a[live], b[live]
    if floats:
        np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL)
    else:
        np.testing.assert_array_equal(a, b.astype(a.dtype))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primitive_segments_peers_and_ranks(seed):
    d, t, j, (pst, pch), (rst, rch) = _both(seed)
    _eq(pst, rst)
    _eq(pch, rch)
    _eq(pwin._seg_start_pos(pst, CAP), rwin._seg_start_pos(rst, CAP))
    _eq(pwin._last_peer_pos(pch, CAP), rwin._last_peer_pos(rch, CAP))
    _eq(pwin._seg_end_pos(pst, CAP), rwin._seg_end_pos(rst, CAP))
    _eq(pwin._first_peer_pos(pch, CAP), rwin._first_peer_pos(rch, CAP))
    _eq(pwin.row_number(pst, CAP), rwin.row_number(rst, CAP))
    _eq(pwin.rank(pst, pch, CAP), rwin.rank(rst, rch, CAP))
    _eq(pwin.dense_rank(pst, pch, CAP), rwin.dense_rank(rst, rch, CAP))


def _gid(starts, valid):
    g = np.cumsum(starts) - 1
    return np.where(valid, g, CAP)


@pytest.mark.parametrize("seed,offset,default",
                         [(0, 1, None), (1, 2, None), (2, -1, None),
                          (0, -3, 7), (1, 1, -5)])
def test_primitive_shift_in_segment(seed, offset, default):
    d, t, j, (pst, _), (rst, _) = _both(seed)
    gid = _gid(pst.numpy(), d["valid"])
    pv, pm = pwin.shift_in_segment(t["ints"], t["vmask"],
                                   torch.from_numpy(gid), offset, default,
                                   CAP)
    rv, rm = rwin.shift_in_segment(j["ints"], j["vmask"], jnp.asarray(gid),
                                   offset, default, CAP)
    live = d["valid"]
    _eq(pm, rm, live)
    _eq(pv, rv, live & np.asarray(rm))


@pytest.mark.parametrize("kind,values,ordered", list(itertools.product(
    ["sum", "count", "min", "max"], ["ints", "floats"], [False, True])))
def test_primitive_windowed_agg(kind, values, ordered):
    d, t, j, (pst, pch), (rst, rch) = _both(3)
    gid = _gid(pst.numpy(), d["valid"])
    mask = d["vmask"] & d["valid"]
    pout, pcnt = pwin.windowed_agg(kind, t[values], torch.from_numpy(mask),
                                   torch.from_numpy(gid), CAP, pst, pch,
                                   ordered, CAP)
    rout, rcnt = rwin.windowed_agg(kind, j[values], jnp.asarray(mask),
                                   jnp.asarray(gid), CAP, rst, rch,
                                   ordered, CAP)
    live = d["valid"]
    _eq(pcnt, rcnt, live)
    present = live & (np.asarray(rcnt) > 0)
    _eq(pout, rout, present, floats=(values == "floats"))


def _range_key(d, t, j, nulls_first):
    kv = d["vmask"].copy()
    pk = pwin.sanitize_range_key(t["o"], torch.from_numpy(kv), t["valid"],
                                 nulls_first)
    rk = rwin.sanitize_range_key(j["o"], jnp.asarray(kv), j["valid"],
                                 nulls_first)
    return kv, pk, rk


FRAMES = [None, ("rows", -2, 0), ("rows", 0, 3), ("rows", -1, 1),
          ("rows", RW.UNBOUNDED_PRECEDING, 0),
          ("rows", 0, RW.UNBOUNDED_FOLLOWING), ("rows", 2, 5),
          ("range", -1, 0), ("range", 0, 2), ("range", -2, 1),
          ("range", RW.UNBOUNDED_PRECEDING, 1)]


@pytest.mark.parametrize("frame", FRAMES, ids=str)
def test_primitive_frame_bounds(frame):
    d, t, j, (pst, pch), (rst, rch) = _both(4)
    live = d["valid"]
    kw_p, kw_r = {}, {}
    if frame is not None and frame[0] == "range":
        kv, pk, rk = _range_key(d, t, j, nulls_first=True)
        _eq(pk, rk, live)
        kw_p = {"range_key": pk, "range_key_valid": torch.from_numpy(kv)}
        kw_r = {"range_key": rk, "range_key_valid": jnp.asarray(kv)}
    plo, phi = pwin.frame_bounds(frame, pst, pch, CAP, True,
                                 n_valid=torch.tensor(d["n_valid"]), **kw_p)
    rlo, rhi = rwin.frame_bounds(frame, rst, rch, CAP, True,
                                 n_valid=jnp.asarray(d["n_valid"]), **kw_r)
    _eq(plo, rlo, live)
    _eq(phi, rhi, live)


@pytest.mark.parametrize("kind,values,frame", list(itertools.product(
    ["sum", "count", "min", "max"], ["ints", "floats"],
    [("rows", -2, 0), ("rows", -5, 3), ("rows", RW.UNBOUNDED_PRECEDING, 0),
     ("range", -2, 1)])), ids=str)
def test_primitive_framed_agg(kind, values, frame):
    d, t, j, (pst, pch), (rst, rch) = _both(5)
    live = d["valid"]
    kw_p, kw_r = {}, {}
    if frame[0] == "range":
        kv, pk, rk = _range_key(d, t, j, nulls_first=False)
        kw_p = {"range_key": pk, "range_key_valid": torch.from_numpy(kv)}
        kw_r = {"range_key": rk, "range_key_valid": jnp.asarray(kv)}
    plo, phi = pwin.frame_bounds(frame, pst, pch, CAP, True,
                                 n_valid=torch.tensor(d["n_valid"]), **kw_p)
    rlo, rhi = rwin.frame_bounds(frame, rst, rch, CAP, True,
                                 n_valid=jnp.asarray(d["n_valid"]), **kw_r)
    max_len = None
    if frame[0] == "rows" and frame[1] > RW.UNBOUNDED_PRECEDING:
        max_len = frame[2] - frame[1] + 1
    mask = d["vmask"] & live
    pout, pcnt = pwin.framed_agg(kind, t[values], torch.from_numpy(mask),
                                 plo, phi, CAP, max_len=max_len)
    rout, rcnt = rwin.framed_agg(kind, j[values], jnp.asarray(mask),
                                 rlo, rhi, CAP, max_len=max_len)
    _eq(pcnt, rcnt, live)
    present = live & (np.asarray(rcnt) > 0)
    _eq(pout, rout, present, floats=(values == "floats"))


def test_float_window_sum_is_fixed_order_and_matches_reference():
    """The whole-partition float sum reduces each segment in a fixed
    order: repeated runs give the same bits, and 100,000 normal float64
    values in 1,000 partitions match the JAX package within 1e-12."""
    rs = np.random.RandomState(2024)
    n, parts = 100_000, 1_000
    keys = np.sort(rs.randint(0, parts, n))
    vals = rs.randn(n)
    valid = np.ones(n, bool)
    pst = pwin._segment_starts([torch.from_numpy(keys)], n,
                               torch.from_numpy(valid))
    gid = torch.cumsum(pst.to(torch.int64), 0) - 1
    runs = [pwin.windowed_agg("sum", torch.from_numpy(vals),
                              torch.from_numpy(valid), gid, n, pst, pst,
                              False, n)[0] for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r.view(torch.int64), runs[0].view(torch.int64))
    rst = rwin._segment_starts([jnp.asarray(keys)], n, jnp.asarray(valid))
    ref, _ = rwin.windowed_agg("sum", jnp.asarray(vals), jnp.asarray(valid),
                               jnp.asarray(gid.numpy()), n, rst, rst,
                               False, n)
    np.testing.assert_allclose(runs[0].numpy(), np.asarray(ref),
                               rtol=FLOAT_RTOL)
    want = pd.Series(vals).groupby(keys).transform("sum").to_numpy()
    np.testing.assert_allclose(runs[0].numpy(), want, rtol=1e-9)


def test_float_window_sum_through_the_session():
    """The same 100,000 values through `sum(v) OVER (PARTITION BY k)` in
    both packages."""
    rs = np.random.RandomState(7)
    pdf = pd.DataFrame({"k": rs.randint(0, 1000, 100_000).astype(np.int64),
                        "v": rs.randn(100_000)})

    def build(s, F, W):
        w = W.Window.partition_by(F.col("k"))
        return s.table("wf_fsum").select(
            F.col("k"), F.sum(F.col("v")).over(w).alias("s"))
    got = run_both(pdf, "wf_fsum", build)
    want = pdf.groupby("k")["v"].transform("sum")
    np.testing.assert_allclose(got["s"], want, rtol=1e-9)
