"""Sort: multi-key ordering as stable `torch.sort` passes.

The port of `spark_tpu/execution/sort.py` (reference: `SortExec.scala:40`).
`lax.sort` with several keys has no torch counterpart, so
`sort_permutation` runs one stable sort per key operand, least
significant first (an LSD radix order over whole keys). Orders follow
Spark semantics: ASC -> NULLS FIRST, DESC -> NULLS LAST by default;
strings sort by a host-computed dictionary rank (codes are not ordered).
Unselected rows sort to the end, so a sort also compacts the selection.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from .. import types as T
from ..columnar import Batch, Column
from ..expr import SortOrder, Vec


def _rank_table(dictionary: pa.Array):
    """code -> lexicographic rank, computed once on host."""
    order = pc.array_sort_indices(dictionary)
    ranks = np.empty(len(dictionary), dtype=np.int32)
    ranks[order.to_numpy(zero_copy_only=False)] = np.arange(
        len(dictionary), dtype=np.int32)
    return torch.from_numpy(ranks)


def sort_key_operand(vec: Vec, ascending: bool):
    """Map a key column to an ascending-sortable operand of its dtype."""
    data = vec.data
    if isinstance(vec.dtype, T.StringType):
        if vec.dictionary is None:
            raise ValueError("sort on string requires dictionary")
        table = _rank_table(vec.dictionary).to(data.device)
        if len(table) == 0:
            # all-null column: every row is masked by the null-rank
            # operand, so any constant key works
            data = torch.zeros(data.shape, dtype=torch.int32,
                               device=data.device)
        else:
            data = table[data.clamp(0, len(table) - 1).long()]
    if isinstance(vec.dtype, T.BooleanType):
        data = data.to(torch.int8)
    if not ascending:
        if data.is_floating_point():
            data = -data
        else:
            data = ~data  # bitwise complement reverses integer order
    return data


def sort_operands(batch: Batch, orders: Sequence[SortOrder]) -> List:
    """Ascending-comparable operand tensors for the sort keys (null-rank
    int8 operands before nullable keys); comparing two rows' operand
    tuples lexicographically == comparing them under `orders`."""
    operands = []
    for o in orders:
        vec = o.eval(batch)
        if vec.validity is not None:
            nulls = (~vec.validity).to(torch.int8)
            # ASC+NULLS FIRST: null rank 0; NULLS LAST: null rank 1
            rank = nulls if not o.nulls_first else (1 - nulls)
            operands.append(rank.to(torch.int8))
        operands.append(sort_key_operand(vec, o.ascending))
    return operands


def sort_permutation(batch: Batch, orders: Sequence[SortOrder]):
    """Returns (perm, num_valid): perm puts rows in order with unselected
    rows last; gathering all columns by perm and selecting iota<num_valid
    yields the sorted, compacted batch."""
    cap = batch.capacity
    device = batch.device
    sel = batch.selection
    invalid = torch.zeros((cap,), dtype=torch.int8, device=device) \
        if sel is None else (~sel).to(torch.int8)
    operands = [invalid] + sort_operands(batch, orders)
    n_valid = (invalid == 0).sum().to(torch.int32)
    return stable_permutation(operands, cap, device), n_valid


def stable_permutation(operands: Sequence, cap: int, device):
    """The permutation that orders rows by the operand tuples
    lexicographically, ties kept in row order: one stable sort per
    operand, least significant first (`lax.sort` with `num_keys`)."""
    perm = torch.arange(cap, device=device)
    for op in reversed(operands):
        if op.dim() == 0:
            continue  # a constant key orders nothing
        _, order = torch.sort(op[perm], stable=True)
        perm = perm[order]
    return perm


def apply_permutation(batch: Batch, perm, n_valid) -> Batch:
    cols = {}
    for name, col in batch.columns.items():
        if col.offsets is not None:
            cols[name] = _permute_list_column(col, perm)
            continue
        validity = None if col.validity is None else col.validity[perm]
        cols[name] = Column(col.data[perm], col.dtype, validity,
                            col.dictionary)
    sel = torch.arange(batch.capacity, device=batch.device) < n_valid
    return Batch(cols, sel, batch.device)


def _permute_list_column(col: Column, perm) -> Column:
    """Row-permute an offsets-encoded array column: offsets rebuilt from
    the permuted row lengths, then each value slot gathered from its
    source slice (the flattened values keep their capacity)."""
    old_off = col.offsets.to(torch.int64)
    starts = old_off[:-1][perm]
    lengths = (old_off[1:] - old_off[:-1])[perm]
    new_off = torch.cat([torch.zeros((1,), dtype=torch.int64,
                                     device=perm.device),
                         torch.cumsum(lengths, 0)])
    vcap = col.data.shape[0]
    iota = torch.arange(vcap, device=perm.device)
    out_row = (torch.searchsorted(new_off, iota, right=True) - 1) \
        .clamp(0, lengths.shape[0] - 1)
    intra = iota - new_off[out_row]
    src = (starts[out_row] + intra).clamp(0, max(vcap - 1, 0))
    ev = None if col.elem_validity is None else col.elem_validity[src]
    validity = None if col.validity is None else col.validity[perm]
    return Column(col.data[src], col.dtype, validity, col.dictionary,
                  offsets=new_off.to(torch.int32), elem_validity=ev)
