"""`spark_tpu_torch.graph` against `spark_tpu.graph`: every case of
`tests/test_graph.py`, each run through both packages on the same
graph (the port's tensors on the CPU device, the JAX package's on its
CPU backend), with the JAX test's assertions made on each and the two
packages' outputs held together: Pregel shortest paths and component
labels exactly, PageRank within rtol 1e-12. `vprog` and `send` are each
package's own array functions (torch against jnp). Also: a Pregel
`min` over a graph whose vertex has no in-edge (an empty segment keeps
the dtype's extreme in both, so that vertex keeps its state), the
`max` and `sum` combines, and a larger seeded graph against numpy and
scipy.
"""

import types

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spark_tpu.graph as ref_graph
from spark_tpu.session import SparkTpuSession as RefSession

import spark_tpu_torch.graph as port_graph
from spark_tpu_torch import SparkTpuSession

PR_RTOL = 1e-12

PORT = types.SimpleNamespace(
    name="port", g=port_graph, xp=torch,
    Graph=lambda v, e: port_graph.Graph(v, e, device="cpu"),
    session=lambda: SparkTpuSession.builder().device("cpu").get_or_create())
REF = types.SimpleNamespace(
    name="ref", g=ref_graph, xp=jnp, Graph=ref_graph.Graph,
    session=lambda: RefSession(register_active=False))


def _chain(P):
    v = pd.DataFrame({"id": [10, 20, 30, 40]})
    e = pd.DataFrame({"src": [10, 20, 30], "dst": [20, 30, 40]})
    return P.Graph(v, e)


def test_degrees():
    for P in (PORT, REF):
        g = _chain(P)
        assert g.out_degrees().tolist() == [1, 1, 1, 0]
        assert g.in_degrees().tolist() == [0, 1, 1, 1]


def test_pregel_shortest_path():
    """Single-source shortest hop count via min-plus Pregel."""
    def case(P):
        INF = np.int64(1 << 40)
        init = np.full(4, INF)
        init[0] = 0  # source = vertex 10
        dist = P.g.pregel(_chain(P), init,
                          vprog=lambda s, m: P.xp.minimum(s, m),
                          send=lambda s_src, s_dst: s_src + 1,
                          combine="min", max_iter=10)
        assert dist.tolist() == [0, 1, 2, 3]
        return dist

    p, r = case(PORT), case(REF)
    assert p.dtype == r.dtype and np.array_equal(p, r)


def test_pagerank_star():
    """A star (everyone links to hub): the hub's rank dominates, ranks
    sum to n (reference normalization)."""
    n_leaves = 9
    v = pd.DataFrame({"id": np.arange(n_leaves + 1)})
    e = pd.DataFrame({"src": np.arange(1, n_leaves + 1),
                      "dst": np.zeros(n_leaves, np.int64)})

    def case(P):
        pr = P.g.page_rank(P.Graph(v, e), num_iter=30).sort_values(
            "pagerank", ascending=False).reset_index(drop=True)
        assert pr["id"][0] == 0
        assert np.isclose(pr["pagerank"].sum(), n_leaves + 1, rtol=1e-6)
        leaf_ranks = pr[pr["id"] != 0]["pagerank"]
        assert np.allclose(leaf_ranks, leaf_ranks.iloc[0])
        return pr.sort_values("id")

    p, r = case(PORT), case(REF)
    np.testing.assert_array_equal(p["id"], r["id"])
    np.testing.assert_allclose(p["pagerank"], r["pagerank"], rtol=PR_RTOL)


def test_pagerank_two_cycle_uniform():
    v = pd.DataFrame({"id": [0, 1]})
    e = pd.DataFrame({"src": [0, 1], "dst": [1, 0]})
    got = []
    for P in (PORT, REF):
        pr = P.g.page_rank(P.Graph(v, e), num_iter=50)
        assert np.allclose(pr["pagerank"], [1.0, 1.0])
        got.append(pr["pagerank"].to_numpy())
    np.testing.assert_allclose(got[0], got[1], rtol=PR_RTOL)


def test_connected_components():
    v = pd.DataFrame({"id": [1, 2, 3, 7, 8, 9]})
    e = pd.DataFrame({"src": [1, 2, 7, 8], "dst": [2, 3, 8, 9]})
    got = []
    for P in (PORT, REF):
        cc = P.g.connected_components(P.Graph(v, e)).sort_values("id")
        by_id = dict(zip(cc["id"], cc["component"]))
        assert by_id[1] == by_id[2] == by_id[3]
        assert by_id[7] == by_id[8] == by_id[9]
        assert by_id[1] != by_id[7]
        got.append(cc)
    pd.testing.assert_frame_equal(got[0], got[1])


def test_graph_from_dataframes():
    got = []
    for P in (PORT, REF):
        s = P.session()
        vdf = s.create_dataframe(pd.DataFrame({"id": [0, 1, 2]}))
        edf = s.create_dataframe(pd.DataFrame(
            {"src": [0, 1], "dst": [1, 2]}))
        g = P.g.Graph(vdf, edf)
        assert g.num_vertices == 3 and g.num_edges == 2
        cc = P.g.connected_components(g)
        assert cc["component"].nunique() == 1
        got.append(cc)
        if P is PORT:  # a graph built from DataFrames takes their device
            assert g.device == torch.device("cpu")
            assert g.src.dtype == torch.int64
    pd.testing.assert_frame_equal(got[0], got[1])


def test_unknown_vertex_raises():
    v = pd.DataFrame({"id": [0, 1]})
    e = pd.DataFrame({"src": [0], "dst": [5]})
    for P in (PORT, REF):
        with pytest.raises(ValueError, match="unknown vertex ids"):
            P.Graph(v, e)


def test_graph_without_device_raises_when_cuda_is_absent(monkeypatch):
    """Built from pandas with no device, a graph needs CUDA, as a
    session does; it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = pd.DataFrame({"id": [0, 1]})
    e = pd.DataFrame({"src": [0], "dst": [1]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_graph.Graph(v, e)
    assert port_graph.Graph(v, e, device="cpu").src.device.type == "cpu"


@pytest.mark.parametrize("combine", ["min", "max", "sum"])
def test_pregel_empty_segment_keeps_state(combine):
    """Vertex 0 has no in-edge. jax.ops.segment_min/max fill its
    segment with the dtype's top/bottom, which the vertex program's
    min/max then ignores; the port starts scatter_reduce_ from the same
    extreme (include_self=False), so vertex 0 keeps its state and every
    superstep matches. The same for a float state, and for sum (an
    empty segment sums to 0)."""
    v = pd.DataFrame({"id": [5, 6, 7, 8]})
    e = pd.DataFrame({"src": [5, 6, 7, 8, 6], "dst": [6, 7, 8, 6, 8]})
    ints = np.array([3, 9, 1, 4], np.int64)
    floats = np.array([-2.5, 7.0, 0.25, 3.0])
    out = {}
    for P in (PORT, REF):
        op = {"min": P.xp.minimum, "max": P.xp.maximum,
              "sum": lambda s, m: s + m}[combine]
        g = P.Graph(v, e)
        out[P.name] = [
            P.g.pregel(g, init, vprog=op,
                       send=lambda s_src, s_dst: s_src,
                       combine=combine, max_iter=3)
            for init in (ints, floats)]
    for p, r, init in zip(out["port"], out["ref"], (ints, floats)):
        assert p.dtype == r.dtype
        np.testing.assert_array_equal(p, r)
        assert p[0] == init[0]  # no in-edge: the state never moves
    if combine == "min":
        assert out["port"][0].tolist() == [3, 1, 1, 1]


def test_seeded_graph_against_numpy_and_scipy():
    """A seeded graph of 400 vertices and 1,500 edges: PageRank against
    a float64 numpy run of the same iteration and the JAX package
    (rtol 1e-12, summing to n), components against scipy's and the JAX
    package's exactly, and the supersteps the port counted."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as sp_cc
    rs = np.random.RandomState(3)
    n, m = 400, 1500
    ids = rs.permutation(10 * n)[:n] + 1000
    src = rs.randint(0, n, m)
    dst = rs.randint(0, n // 2, m)  # half the vertices get no in-edge
    v = pd.DataFrame({"id": ids})
    e = pd.DataFrame({"src": ids[src], "dst": ids[dst]})
    # numpy PageRank, the reference's iteration
    deg = np.bincount(src, minlength=n).astype(np.float64)
    safe = np.where(deg == 0, 1.0, deg)
    r = np.full(n, 1.0 / n)
    for _ in range(20):
        inflow = np.zeros(n)
        np.add.at(inflow, dst, (r / safe)[src])
        r = 0.15 / n + 0.85 * (inflow + r[deg == 0].sum() / n)
    ncomp, lab = sp_cc(coo_matrix((np.ones(m), (src, dst)),
                                  shape=(n, n)), directed=False)
    g = PORT.Graph(v, e)
    pr = port_graph.page_rank(g, num_iter=20)
    ref_pr = ref_graph.page_rank(REF.Graph(v, e), num_iter=20)
    np.testing.assert_allclose(pr["pagerank"], r * n, rtol=PR_RTOL)
    np.testing.assert_allclose(pr["pagerank"], ref_pr["pagerank"],
                               rtol=PR_RTOL)
    assert np.isclose(pr["pagerank"].sum(), n, rtol=1e-12)
    cc = port_graph.connected_components(g)
    ref_cc = ref_graph.connected_components(REF.Graph(v, e))
    np.testing.assert_array_equal(cc["component"], ref_cc["component"])
    # the same partition as scipy's, labelled by the smallest member
    smallest = {}
    for i, c in enumerate(lab):
        smallest.setdefault(c, ids[i])
    assert cc["component"].nunique() == ncomp
    np.testing.assert_array_equal(
        cc["component"], [smallest[c] for c in lab])
    steps = g.pregel_stats
    assert steps["host_reads"] == steps["supersteps"] >= 2
