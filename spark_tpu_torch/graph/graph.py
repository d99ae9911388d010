"""Graph container + Pregel loop (the port of `spark_tpu/graph/graph.py`).

Reference: `graphx/.../Graph.scala` (vertex/edge RDD views),
`Pregel.scala:59` (iterate: send messages along edges, combine per
vertex, run the vertex program until no messages / max iterations).

Design: vertex ids map to dense [0, n) indices once on the host at
construction (the `VertexRDD` routing-table seat), and the edge
endpoints go to the device as int64 index tensors; each superstep is
device work -- `index_select` along edge endpoints, an `index_add_` or
`scatter_reduce_` message combine, the caller's vectorized vertex
program. A graph lives on the device of the DataFrame it was built
from, or on `device`; built from pandas with neither, it needs CUDA.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import pandas as pd
import torch

from ..columnar import resolve_device


def _graph_device(device, *frames) -> torch.device:
    """`device` when given, else the first DataFrame's session's device,
    else the current CUDA card (raising without CUDA)."""
    if device is not None:
        return torch.device(device)
    for f in frames:
        session = getattr(f, "session", None)
        if session is not None:
            return session.device
    return resolve_device(None)


class Graph:
    """vertices: DataFrame/pandas with an `id` column (+ attrs);
    edges: DataFrame/pandas with `src`, `dst` (+ attrs)."""

    def __init__(self, vertices, edges, device=None):
        self.device = _graph_device(device, vertices, edges)
        v = vertices.to_pandas() if hasattr(vertices, "to_pandas") \
            else pd.DataFrame(vertices)
        e = edges.to_pandas() if hasattr(edges, "to_pandas") \
            else pd.DataFrame(edges)
        ids = v["id"].to_numpy()
        self.vertex_ids = ids
        self.num_vertices = len(ids)
        self.vertices = v.reset_index(drop=True)
        self.edges = e.reset_index(drop=True)
        # dense index map (the VertexRDD routing table)
        lookup = pd.Series(np.arange(len(ids)), index=ids)
        missing = ~e["src"].isin(lookup.index) | \
            ~e["dst"].isin(lookup.index)
        if missing.any():
            raise ValueError("edges reference unknown vertex ids")
        self.src = torch.from_numpy(np.require(
            lookup[e["src"]].to_numpy(np.int64), requirements="W")) \
            .to(self.device)
        self.dst = torch.from_numpy(np.require(
            lookup[e["dst"]].to_numpy(np.int64), requirements="W")) \
            .to(self.device)
        #: the last `pregel` run's supersteps and device reads
        self.pregel_stats = {"supersteps": 0, "host_reads": 0}

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def out_degrees(self) -> np.ndarray:
        return torch.bincount(self.src, minlength=self.num_vertices) \
            .cpu().numpy().astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return torch.bincount(self.dst, minlength=self.num_vertices) \
            .cpu().numpy().astype(np.int64)


def _extreme(dtype: torch.dtype, high: bool):
    """The value `jax.ops.segment_min` (high) or `segment_max` gives a
    segment no message reaches: the dtype's top or bottom."""
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def _combine(m: torch.Tensor, dst: torch.Tensor, n: int,
             combine: str) -> torch.Tensor:
    """Per-destination reduce of the edge messages `m` into n rows."""
    shape = (n,) + tuple(m.shape[1:])
    if combine == "sum":
        return torch.zeros(shape, dtype=m.dtype, device=m.device) \
            .index_add_(0, dst, m)
    # an empty segment keeps the start value (include_self=False), which
    # must be the extreme the JAX package fills it with
    reduce = {"min": "amin", "max": "amax"}[combine]
    out = torch.full(shape, _extreme(m.dtype, combine == "min"),
                     dtype=m.dtype, device=m.device)
    index = dst.view((-1,) + (1,) * (m.dim() - 1)).expand_as(m)
    return out.scatter_reduce_(0, index, m, reduce, include_self=False)


def pregel(graph: Graph, initial, vprog: Callable,
           send: Callable, combine: str = "sum",
           max_iter: int = 20, initial_msg=None):
    """Pregel.scala:59 as an eager loop on the graph's device.

    - ``initial``: [n] (or [n, d]) initial vertex state array;
    - ``vprog(state, msg) -> state`` -- vectorized over all vertices
      (torch tensors in, a tensor out);
    - ``send(src_state, dst_state) -> msg`` -- vectorized over all
      edges (messages flow src -> dst);
    - ``combine``: 'sum' | 'min' | 'max' per-destination reduce;
    - stops when the state reaches a fixed point or after max_iter.

    Each superstep reads one flag (did the state change?) back to the
    host; `graph.pregel_stats` counts the supersteps and those reads.
    Returns the final state as a numpy array.
    """
    if combine not in ("sum", "min", "max"):
        raise KeyError(combine)
    n = graph.num_vertices
    src, dst = graph.src, graph.dst
    state = torch.as_tensor(np.asarray(initial) if not isinstance(
        initial, torch.Tensor) else initial).to(graph.device)
    if initial_msg is not None:
        state = vprog(state, torch.as_tensor(
            initial_msg, dtype=state.dtype,
            device=state.device).expand(state.shape))
    i, changed, reads = 0, True, 0
    while i < max_iter and changed:
        m = send(state.index_select(0, src), state.index_select(0, dst))
        new = vprog(state, _combine(m, dst, n, combine))
        changed = bool(torch.any(new != state))
        reads += 1
        state = new
        i += 1
    graph.pregel_stats = {"supersteps": i, "host_reads": reads}
    return state.cpu().numpy()
