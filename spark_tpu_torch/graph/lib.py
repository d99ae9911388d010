"""Built-in graph algorithms (the port of `spark_tpu/graph/lib.py`;
reference: graphx/lib/PageRank.scala, ConnectedComponents.scala)."""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from .graph import Graph, pregel


def page_rank(graph: Graph, num_iter: int = 20,
              reset_prob: float = 0.15) -> pd.DataFrame:
    """Iterative PageRank (PageRank.scala `run`): rank flows along out-
    edges weighted 1/outDegree; dangling mass redistributes uniformly.
    A fixed count of iterations on the graph's device in float64, each
    a gather and an `index_add_`; no host read until the end."""
    n = graph.num_vertices
    src, dst = graph.src, graph.dst
    deg = torch.bincount(src, minlength=n).to(torch.float64)
    dangling = deg == 0
    safe_deg = torch.where(dangling, torch.ones_like(deg), deg)
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=graph.device)
    for _ in range(num_iter):
        contrib = (r / safe_deg).index_select(0, src)
        inflow = torch.zeros(n, dtype=torch.float64, device=graph.device) \
            .index_add_(0, dst, contrib)
        lost = torch.sum(torch.where(dangling, r, torch.zeros_like(r)))
        r = reset_prob / n + (1.0 - reset_prob) * (inflow + lost / n)
    ranks = r.cpu().numpy() * n  # reference normalization (sum = n)
    return pd.DataFrame({"id": graph.vertex_ids, "pagerank": ranks})


def connected_components(graph: Graph, max_iter: int = 100
                         ) -> pd.DataFrame:
    """Label propagation: every vertex converges to the smallest vertex
    index in its (weakly) connected component
    (ConnectedComponents.scala via Pregel min-messages)."""
    n = graph.num_vertices
    # undirected propagation: add reversed edges
    both = Graph(graph.vertices,
                 pd.concat([
                     graph.edges[["src", "dst"]],
                     graph.edges[["src", "dst"]].rename(
                         columns={"src": "dst", "dst": "src"})],
                     ignore_index=True), device=graph.device)
    labels = pregel(
        both,
        initial=torch.arange(n, dtype=torch.int64, device=graph.device),
        vprog=lambda s, m: torch.minimum(s, m),
        send=lambda s_src, s_dst: s_src,
        combine="min",
        max_iter=max_iter)
    graph.pregel_stats = both.pregel_stats
    # map dense indices back to user vertex ids
    comp = np.asarray(graph.vertex_ids)[labels]
    return pd.DataFrame({"id": graph.vertex_ids, "component": comp})
