"""Collective exchanges: the shuffle among the shards of a mesh (the port
of `spark_tpu/parallel/shuffle.py`).

The JAX package replaces Spark's shuffle stack (sort-shuffle writer,
block files, Netty fetch, MapOutputTracker) with on-device partitioning
plus one `lax.all_to_all`. The port keeps the layout and swaps the
collective for the shard group's rendezvous (`parallel/mesh.py`):

1. hash each row's key columns to a target shard (value-stable for
   dictionary strings: codes hash through a per-dictionary value-hash
   table, so two tables with different dictionaries still co-partition
   equal strings);
2. stable-sort rows by target shard and scatter them into an [n, block]
   send layout (`block` slots per destination);
3. every shard deposits its send buffers at the rendezvous, and shard j
   takes block j of every shard in shard order, each moved onto its own
   device by a peer copy; the received rows form a new local batch whose
   selection marks the live slots.

Every function runs on a shard's thread with the shard's `ExecContext`.
Before rows cross shards the shards agree on what the JAX package gets
from static shapes: the receive block (the largest seed) and each string
column's dictionary (`agree_dictionaries`), so codes mean the same on
every shard. Overflow is never silent: the largest bucket is the
`exch_max_<tag>` metric and `exch_overflow_<tag>` flags a bucket past
`block`, which the executor's re-plan loop grows.

On a mesh that spans engine processes (`parallel/cluster.py`) the same
functions run unchanged on each process's shards: the send buffers go
through `ctx.all_to_all`, which moves to each process only the blocks
its shards receive; samples and gathered batches through
`ctx.gather_tensors`; and dictionaries are first agreed by digest, so
that equal dictionaries (every process read the same scan) never cross.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from .. import types as T
from ..columnar import Batch, Column, bucket_capacity
from ..expr import AnalysisError

_NULL_HASH = -7046029254386353131

# id(dict) -> (dictionary, hashes). The strong reference to the
# dictionary keeps its id from being reused while the entry lives, and
# the identity check guards against a stale entry anyway; bounded size.
_DICT_HASH_CACHE: Dict[int, Tuple[object, torch.Tensor]] = {}
_DICT_HASH_CACHE_MAX = 64


def _mix64(x):
    """splitmix64 finalizer (wrapping 64-bit arithmetic, unsalted)."""
    from ..sketch import _finalize64
    return _finalize64(x.to(torch.int64))


def _dict_value_hashes(dictionary) -> torch.Tensor:
    """Stable 64-bit hash per dictionary VALUE (host CPU tensor, cached
    per dictionary): blake2b-64 of the UTF-8 bytes, as the JAX package
    hashes. Hashing codes would mis-partition: equal strings in two
    tables carry different codes."""
    key = id(dictionary)
    cached = _DICT_HASH_CACHE.get(key)
    if cached is not None and cached[0] is dictionary:
        return cached[1]
    hs = np.empty(len(dictionary), dtype=np.int64)
    for i, s in enumerate(dictionary.to_pylist()):
        b = (s if s is not None else "\0").encode("utf-8", "surrogatepass")
        hs[i] = int.from_bytes(
            hashlib.blake2b(b, digest_size=8).digest(), "little", signed=True)
    out = torch.from_numpy(hs)
    if len(_DICT_HASH_CACHE) >= _DICT_HASH_CACHE_MAX:
        _DICT_HASH_CACHE.pop(next(iter(_DICT_HASH_CACHE)), None)
    _DICT_HASH_CACHE[key] = (dictionary, out)
    return out


# id(dict) -> (dictionary, content digest), as _DICT_HASH_CACHE
_DIGESTS: Dict[int, Tuple[object, str]] = {}


def digest(dictionary) -> str:
    """A content digest of a pyarrow dictionary (its type, length,
    offset and buffers), cached by object: equal digests mean equal
    dictionaries, so processes agree on one without sending it."""
    key = id(dictionary)
    hit = _DIGESTS.get(key)
    if hit is not None and hit[0] is dictionary:
        return hit[1]
    arr = dictionary.combine_chunks() \
        if isinstance(dictionary, pa.ChunkedArray) else dictionary
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{arr.type}|{len(arr)}|{arr.offset}|{arr.null_count}".encode())
    for b in arr.buffers():
        h.update(b"|" if b is None else memoryview(b))
    out = h.hexdigest()
    if len(_DIGESTS) >= _DICT_HASH_CACHE_MAX:
        _DIGESTS.pop(next(iter(_DIGESTS)), None)
    _DIGESTS[key] = (dictionary, out)
    return out


def _resolve(batch: Batch, name: str) -> Column:
    if name in batch.columns:
        return batch.columns[name]
    for n, c in batch.columns.items():
        if n.lower() == name.lower():
            return c
    raise KeyError(f"exchange key {name!r} not in {batch.names}")


def hash_rows(batch: Batch, key_names: Sequence[str]):
    """Combined value-hash of the key columns, int64 per row."""
    h = torch.zeros((batch.capacity,), dtype=torch.int64,
                    device=batch.device)
    for name in key_names:
        col = _resolve(batch, name)
        if isinstance(col.dtype, T.StringType) and col.dictionary is not None:
            table = _dict_value_hashes(col.dictionary).to(col.data.device)
            if table.shape[0] == 0:
                x = torch.zeros_like(h)
            else:
                x = table[col.data.to(torch.int64).clamp(
                    0, table.shape[0] - 1)]
        else:
            # floats truncate toward zero, as the JAX package's astype
            x = col.data.to(torch.int64)
        if col.validity is not None:
            x = torch.where(col.validity, x, torch.full_like(x, _NULL_HASH))
        h = _mix64(h ^ _mix64(x))
    return h


# ---------------------------------------------------------------------------
# Dictionary agreement
# ---------------------------------------------------------------------------

def merge_dictionaries(dicts: Sequence) -> Tuple[object, List]:
    """One dictionary for string columns that carry `dicts`: the
    distinct values in first-seen order over `dicts` in order, and for
    each input a CPU int32 remap (old code -> merged code), None where
    that input already is the merged dictionary."""
    import pyarrow.compute as pc
    first = dicts[0]
    if all(d is first or d.equals(first) for d in dicts):
        return first, [None] * len(dicts)
    arrs = [d.combine_chunks() if isinstance(d, pa.ChunkedArray) else d
            for d in dicts]
    merged = pc.unique(pa.concat_arrays([a.cast(pa.string())
                                         for a in arrs]))
    remaps = []
    for a in arrs:
        r = pc.index_in(a.cast(pa.string()), value_set=merged)
        remaps.append(torch.from_numpy(
            r.cast(pa.int32()).to_numpy(zero_copy_only=False).copy()))
    return merged, remaps


def _remap_codes(codes, remap):
    if remap is None:
        return codes
    if remap.shape[0] == 0:
        return torch.zeros_like(codes)
    remap = remap.to(codes.device)
    return remap[codes.to(torch.int64).clamp(0, remap.shape[0] - 1)].to(
        codes.dtype)


def agree_dictionaries(batch: Batch, ctx) -> Batch:
    """The batch with every dictionary column on the dictionary all
    shards agree on (`merge_dictionaries` over the shards in order). A
    collective: every shard calls it at the same point. Shards striped
    from one loaded table share their dictionary objects, so this is
    usually one host rendezvous and no device work."""
    names = [n for n, c in batch.columns.items() if c.dictionary is not None]
    if ctx.on_cluster:
        # across processes the shards first agree on digests: equal
        # dictionaries (each process read the same scan) never cross
        digests = ctx.exchange({n: digest(batch.columns[n].dictionary)
                                for n in names})
        for n in names:
            if any(d.get(n) is None for d in digests):
                raise AnalysisError(f"column {n!r} carries a dictionary on "
                                    f"some shards only")
        names = [n for n in names
                 if len({d[n] for d in digests}) > 1]
        if not names:
            return batch
    seen = ctx.exchange({n: batch.columns[n].dictionary for n in names})
    cols = dict(batch.columns)
    for n in names:
        dicts = [s.get(n) for s in seen]
        if any(d is None for d in dicts):
            raise AnalysisError(f"column {n!r} carries a dictionary on some "
                                f"shards only")
        merged, remaps = merge_dictionaries(dicts)
        c = cols[n]
        if merged is c.dictionary:
            continue
        cols[n] = Column(_remap_codes(c.data, remaps[ctx.axis_index()]),
                         c.dtype, c.validity, merged, bits=None,
                         offsets=c.offsets, elem_validity=c.elem_validity)
    return Batch(cols, batch.selection, batch.device)


def _flat_columns(batch: Batch) -> None:
    for name, col in batch.columns.items():
        if col.offsets is not None:
            raise AnalysisError(
                f"array column {name!r} cannot cross a mesh exchange "
                f"(explode and the collect aggregates run before it)")


# ---------------------------------------------------------------------------
# Hash and range exchanges
# ---------------------------------------------------------------------------

def _scatter_to_buckets(tgt, n: int, block: int):
    """Stable-sort rows by target shard and map each to a slot of the
    [n*block] send layout (`block` slots per destination). Returns
    (flat_idx, perm, max_count): row perm[r] goes to slot flat_idx[r];
    rows past a full bucket (and dead rows, target n) go to slot n*block,
    which is dropped."""
    L = tgt.shape[0]
    tgt_s, perm = torch.sort(tgt, stable=True)
    # a scatter-add, not bincount: its output size needs no device sync
    counts = torch.zeros((n + 1,), dtype=torch.int64,
                         device=tgt.device).scatter_add_(
        0, tgt, torch.ones_like(tgt))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(L, device=tgt.device) - starts[tgt_s]
    flat = torch.where((tgt_s < n) & (pos < block), tgt_s * block + pos,
                       torch.full_like(pos, n * block))
    return flat, perm, counts[:n].max()


def default_block(capacity: int, n: int) -> int:
    """The receive block's seed: 2x a uniform hash spread, 2*ceil(L/n)
    rows bucketed, at most L (the MapOutputTracker-style size guess)."""
    return min(capacity, bucket_capacity(-(-2 * capacity // n)))


def exchange_hash(batch: Batch, key_names: Sequence[str], ctx,
                  block_cap: Optional[int] = None,
                  tag: str = "e0") -> Batch:
    """HashPartitioning exchange: partition by key hash + all_to_all.

    `block_cap` is the per-(source, destination) slot count, so each
    shard receives at most n*block_cap rows. None seeds 2*ceil(L/n)
    (`default_block`), agreed as the largest seed over the shards; the
    executor's re-plan loop grows it when a bucket overflows."""
    n = ctx.n_shards
    if block_cap is None:
        block_cap = max(ctx.exchange(default_block(batch.capacity, n)))
    sel = batch.selection_mask()
    h = hash_rows(batch, key_names)
    from ..sketch import _umod
    tgt = _umod(h, n)
    tgt = torch.where(sel, tgt, torch.full_like(tgt, n))  # dead rows drop
    return _exchange_by_target(batch, tgt, ctx, block_cap, tag)


def _exchange_by_target(batch: Batch, tgt, ctx, block: int,
                        tag: str) -> Batch:
    """Route each selected row to shard `tgt[row]` with one rendezvous:
    each shard deposits its [n, block] send buffers and takes its block
    of every shard's. Surfaces the largest bucket for the executor's
    capacity loop."""
    from ..testing import faults
    if ctx.axis_index() == 0:
        # fault seam, once per exchange per run (the JAX package fires it
        # once when it lowers the exchange)
        faults.fire("shuffle")
    n = ctx.n_shards
    _flat_columns(batch)
    batch = agree_dictionaries(batch, ctx)
    sel = batch.selection_mask()
    flat, perm, max_count = _scatter_to_buckets(tgt, n, block)
    ctx.add_metric(f"exch_max_{tag}", max_count)
    # total live rows routed (summed over shards): max/(rows/n) is the
    # skew factor the adaptive re-planner reads
    live_rows = sel.sum()
    ctx.add_metric(f"exch_rows_{tag}", live_rows)
    row_width = sum(c.data.element_size()
                    + (1 if c.validity is not None else 0)
                    for c in batch.columns.values())
    ctx.add_metric(f"exch_bytes_{tag}", live_rows * row_width)
    ctx.add_flag(f"exch_overflow_{tag}", max_count > block)

    def send(x, fill=0):
        buf = torch.full((n * block + 1,), fill, dtype=x.dtype,
                         device=x.device)
        buf[flat] = x[perm]
        return buf[:n * block].view(n, block)

    mine = {"__live__": send(sel, False)}
    for name, col in batch.columns.items():
        mine[name] = send(col.data)
        if col.validity is not None:
            mine["__valid__" + name] = send(col.validity, False)
    everyone = ctx.all_to_all(mine, f"all_to_all {tag}")
    me = ctx.axis_index()
    dev = ctx.device

    def recv(key, fill):
        parts = []
        for src, bufs in enumerate(everyone):
            b = bufs.get(key)
            if b is None:  # this shard had no validity: all valid
                parts.append(torch.full((block,), fill, dtype=torch.bool,
                                        device=dev))
            else:
                parts.append(b[me])
        from .mesh import gather_to
        return torch.cat(gather_to(parts, dev, f"all_to_all {tag}"))

    live = recv("__live__", False)
    cols: Dict[str, Column] = {}
    for name, col in batch.columns.items():
        data = recv(name, 0)
        vkey = "__valid__" + name
        validity = recv(vkey, True) if any(vkey in b for b in everyone) \
            else None
        if validity is not None:
            # empty slots are not live: their validity never matters,
            # but keep the JAX package's False there
            validity = validity & live
        cols[name] = Column(data, col.dtype, validity, col.dictionary,
                            bits=col.bits)
    return Batch(cols, live, dev)


RANGE_SAMPLES_PER_SHARD = 64


def _lexsort(keys: Sequence):
    """Permutation ordering rows by `keys` lexicographically (first key
    most significant), stable."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(list(keys)):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def exchange_range(batch: Batch, orders, ctx,
                   block_cap: Optional[int] = None,
                   tag: str = "e0") -> Batch:
    """RangePartitioning exchange: sampled bounds + all_to_all.

    The distributed global-sort layout (reference: `Partitioner.scala:140`
    RangePartitioner): each shard contributes a strided sample of its
    live sort-key tuples, weighted by its live rows; the samples are
    gathered, sorted identically on every shard, and n-1 weighted
    quantile bounds picked; rows route to the shard whose key range
    holds them. Shard i then holds keys <= shard i+1's, so locally
    sorted shards concatenate into the global order. Sampling skew only
    unbalances buckets; the exch_overflow loop keeps it correct."""
    from ..execution.sort import sort_operands
    n = ctx.n_shards
    L = batch.capacity
    if block_cap is None:
        block_cap = max(ctx.exchange(default_block(L, n)))
    batch = agree_dictionaries(batch, ctx)
    dev = ctx.device
    sel = batch.selection_mask()
    ops = [op.expand((L,)) if op.dim() == 0 else op
           for op in sort_operands(batch, orders)]

    s = min(RANGE_SAMPLES_PER_SHARD, L)
    live = sel.to(torch.int64).sum()
    rank = torch.cumsum(sel.to(torch.int64), 0)  # 1-based rank per slot
    targets = (torch.arange(s, dtype=torch.int64, device=dev)
               * torch.clamp(live, min=1)) // s + 1
    pos = torch.searchsorted(rank, targets, side="left").clamp(0, L - 1)
    samp_invalid = ~sel[pos]
    samp_ops = [op[pos] for op in ops]
    samp_w = torch.where(samp_invalid,
                         torch.zeros((), dtype=torch.float32, device=dev),
                         live.to(torch.float32) / s)

    from .mesh import gather_to
    gathered = ctx.gather_tensors((samp_invalid, samp_ops, samp_w),
                                  f"samples {tag}")

    def cat(pick):
        return torch.cat(gather_to([pick(g) for g in gathered], dev,
                                   f"samples {tag}"))

    g_invalid = cat(lambda g: g[0])
    g_ops = [cat(lambda g, k=k: g[1][k]) for k in range(len(ops))]
    g_w = cat(lambda g: g[2])
    order = _lexsort([g_invalid.to(torch.int8)] + g_ops)
    w_sorted = g_w[order]
    cumw = torch.cumsum(w_sorted, 0)
    total_w = cumw[-1]
    qtargets = torch.arange(1, n, dtype=torch.float32, device=dev) \
        * total_w / n
    qpos = torch.searchsorted(cumw, qtargets, side="left").clamp(
        0, n * s - 1)
    bounds = [op[order][qpos] for op in g_ops]

    # target shard = number of bounds strictly below the row's key tuple
    tgt = torch.zeros((L,), dtype=torch.int64, device=dev)
    for b in range(n - 1):
        gt = torch.zeros((L,), dtype=torch.bool, device=dev)
        eq = torch.ones((L,), dtype=torch.bool, device=dev)
        for op, bound in zip(ops, bounds):
            bv = bound[b]
            gt = gt | (eq & (op > bv))
            eq = eq & (op == bv)
        tgt = tgt + gt.to(torch.int64)
    tgt = torch.where(sel, tgt, torch.full_like(tgt, n))
    return _exchange_by_target(batch, tgt, ctx, block_cap, tag)


# ---------------------------------------------------------------------------
# Gathers and stripes
# ---------------------------------------------------------------------------

def all_gather_batch(batch: Batch, ctx, tag: str = "e0") -> Batch:
    """SinglePartition / Replicated exchange: every shard gets all rows,
    in shard order."""
    from .mesh import gather_to
    _flat_columns(batch)
    batch = agree_dictionaries(batch, ctx)
    dev = ctx.device
    mine = {"__sel__": batch.selection_mask()}
    for name, col in batch.columns.items():
        mine[name] = col.data
        if col.validity is not None:
            mine["__valid__" + name] = col.validity
    everyone = ctx.gather_tensors(mine, f"all_gather {tag}")

    def cat(key, fill):
        parts = []
        for bufs in everyone:
            t = bufs.get(key)
            if t is None:
                cap = bufs["__sel__"].shape[0]
                t = torch.full((cap,), fill, dtype=torch.bool, device=dev)
            parts.append(t)
        return torch.cat(gather_to(parts, dev, f"all_gather {tag}"))

    cols: Dict[str, Column] = {}
    for name, col in batch.columns.items():
        vkey = "__valid__" + name
        validity = cat(vkey, True) if any(vkey in b for b in everyone) \
            else None
        cols[name] = Column(cat(name, 0), col.dtype, validity,
                            col.dictionary, bits=col.bits)
    return Batch(cols, cat("__sel__", False), dev)


def _slice_rows(col: Column, lo: int, hi: int) -> Column:
    """Rows [lo, hi) of a column (an array column slices its offsets and
    the elements they cover)."""
    validity = None if col.validity is None else col.validity[lo:hi]
    if col.offsets is None:
        return Column(col.data[lo:hi], col.dtype, validity, col.dictionary,
                      bits=col.bits)
    offs = col.offsets[lo:hi + 1]
    a, b = int(offs[0]), int(offs[-1])
    ev = None if col.elem_validity is None else col.elem_validity[a:b]
    return Column(col.data[a:b], col.dtype, validity, col.dictionary,
                  offsets=offs - offs[0], elem_validity=ev)


def stripe_batch(batch: Batch, ctx) -> Batch:
    """This shard's contiguous stripe of a replicated batch, so the
    shards' stripes in order reassemble exactly the full batch (order
    preserved — sorted output stays sorted)."""
    n = ctx.n_shards
    padded = pad_batch_to_multiple(batch, n)
    local = padded.capacity // n
    lo = ctx.axis_index() * local
    cols = {name: _slice_rows(col, lo, lo + local)
            for name, col in padded.columns.items()}
    return Batch(cols, padded.selection_mask()[lo:lo + local], ctx.device)


def shard_stripes(batch: Batch, n: int) -> List[Batch]:
    """The n contiguous stripes of a (host-loaded) batch padded to a
    multiple of n: what each shard of a mesh receives for a leaf."""
    padded = pad_batch_to_multiple(batch, n)
    local = padded.capacity // n
    sel = padded.selection_mask()
    return [Batch({name: _slice_rows(col, i * local, (i + 1) * local)
                   for name, col in padded.columns.items()},
                  sel[i * local:(i + 1) * local], padded.device)
            for i in range(n)]


def move_batch(batch: Batch, device) -> Batch:
    """The batch's tensors on `device` (the batch itself when they are
    there already)."""
    device = torch.device(device)
    if batch.device == device:
        return batch

    def mv(t):
        return None if t is None else t.to(device)

    cols = {name: Column(mv(c.data), c.dtype, mv(c.validity), c.dictionary,
                         bits=c.bits, offsets=mv(c.offsets),
                         elem_validity=mv(c.elem_validity))
            for name, c in batch.columns.items()}
    return Batch(cols, mv(batch.selection), device)


def pad_batch_to_multiple(batch: Batch, n: int) -> Batch:
    """Pad capacity so it divides the mesh axis (dead rows at the end)."""
    cap = batch.capacity
    pad = (-cap) % n
    if pad == 0:
        return batch
    dev = batch.device
    cols: Dict[str, Column] = {}
    for name, col in batch.columns.items():
        validity = None if col.validity is None else torch.cat(
            [col.validity, torch.zeros((pad,), dtype=torch.bool,
                                       device=dev)])
        if col.offsets is not None:
            offs = torch.cat([col.offsets, col.offsets[-1:].expand(pad)])
            cols[name] = Column(col.data, col.dtype, validity,
                                col.dictionary, offsets=offs,
                                elem_validity=col.elem_validity)
            continue
        data = torch.cat([col.data, torch.zeros((pad,), dtype=col.data.dtype,
                                                device=dev)])
        cols[name] = Column(data, col.dtype, validity, col.dictionary,
                            bits=col.bits)
    sel = torch.cat([batch.selection_mask(),
                     torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return Batch(cols, sel, dev)


def batch_to_tree(batch: Batch) -> dict:
    """A batch as a tree of tensors and host values, the form a batch
    crosses processes in (`Cluster.merge`); `batch_from_tree` inverts
    it."""
    return {"sel": batch.selection_mask(), "cols": [
        (name, c.data, c.validity, c.offsets, c.elem_validity, c.dtype,
         c.dictionary, c.bits) for name, c in batch.columns.items()]}


def batch_from_tree(tree: dict) -> Batch:
    sel = tree["sel"]
    cols = {name: Column(data, dtype, validity, dictionary, bits=bits,
                         offsets=offsets, elem_validity=ev)
            for name, data, validity, offsets, ev, dtype, dictionary, bits
            in tree["cols"]}
    return Batch(cols, sel, sel.device)


def concat_batches(batches: Sequence[Batch], device) -> Batch:
    """The shards' output batches as one batch on `device`, in shard
    order (the counterpart of an out_spec sharded on the data axis):
    dictionaries merge where the shards' differ, array columns shift
    their offsets."""
    from .mesh import gather_to
    device = torch.device(device)
    first = batches[0]
    cols: Dict[str, Column] = {}
    for name, col in first.columns.items():
        parts = [b.columns[name] for b in batches]
        dictionary = col.dictionary
        datas = gather_to([c.data for c in parts], device, "gather")
        if dictionary is not None:
            dictionary, remaps = merge_dictionaries(
                [c.dictionary for c in parts])
            datas = [_remap_codes(d, r) for d, r in zip(datas, remaps)]
        if any(c.validity is not None for c in parts):
            validity = torch.cat(gather_to(
                [c.validity if c.validity is not None else
                 torch.ones((c.capacity,), dtype=torch.bool,
                            device=c.data.device) for c in parts],
                device, "gather"))
        else:
            validity = None
        if col.offsets is None:
            # merged codes may pass the columns' static bound
            bits = col.bits if dictionary is col.dictionary else None
            cols[name] = Column(torch.cat(datas), col.dtype, validity,
                                dictionary, bits=bits)
            continue
        offs, base, end = [], 0, 0
        for c, d in zip(parts, datas):
            o = c.offsets.to(device)
            offs.append(o[:-1] + base)
            end = int(o[-1]) + base
            base += d.shape[0]  # the elements, padding included
        offs.append(torch.tensor([end], dtype=parts[0].offsets.dtype,
                                 device=device))
        ev = None
        if any(c.elem_validity is not None for c in parts):
            ev = torch.cat(gather_to(
                [c.elem_validity if c.elem_validity is not None else
                 torch.ones((c.data.shape[0],), dtype=torch.bool,
                            device=c.data.device) for c in parts],
                device, "gather"))
        cols[name] = Column(torch.cat(datas), col.dtype, validity,
                            dictionary, offsets=torch.cat(offs),
                            elem_validity=ev)
    sel = torch.cat(gather_to([b.selection_mask() for b in batches],
                              device, "gather"))
    return Batch(cols, sel, device)
