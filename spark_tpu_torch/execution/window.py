"""Window function kernels: segmented scans over one sorted permutation.

The port of `spark_tpu/execution/window.py` (reference: the
`execution/window/WindowExec.scala` package). WindowExec orders rows by
(live first, partition keys, order keys) with the stable passes of
`sort.py`, and every window function lowers to whole-column torch ops
over that order; outputs are written back through the permutation.

Supported (the reference's most-used set):
- row_number, rank, dense_rank
- lag/lead with literal offset + default
- sum/count/min/max/avg over the partition: whole-partition frame when
  no ORDER BY, the Spark default `RANGE UNBOUNDED PRECEDING .. CURRENT
  ROW` (peer rows included) when ordered, and ROWS/RANGE BETWEEN frames.

Where the JAX package takes a running maximum (`lax.cummax`/`cummin`) to
find each row's segment start or peer end, this module ranks the flag
positions with a cumulative sum and looks the position up in a table of
flag positions by rank: the same integers, without PyTorch's one-row
scan kernel behind `torch.cummax`, and without a host sync. The
whole-partition float sum reduces each (contiguous) segment in a fixed
order (`torch.segment_reduce`), where the JAX package scatters with
`segment_sum`: a float scatter-add on CUDA adds in no fixed order.
Integer sums take prefix-sum differences, exact mod 2^64, and the
whole-partition min/max the segmented running scan, so no path adds
with atomics.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..window import UNBOUNDED_FOLLOWING, UNBOUNDED_PRECEDING


def _iota(cap: int, device):
    return torch.arange(cap, dtype=torch.int64, device=device)


def _segment_starts(sorted_key_ops: List, cap: int, valid_sorted):
    """Boolean: row i starts a new partition segment (first valid row or
    any partition-key operand differs from the previous row)."""
    diff = torch.zeros((cap,), dtype=torch.bool, device=valid_sorted.device)
    for op in sorted_key_ops:
        diff = diff | (op != torch.roll(op, 1))
    first = _iota(cap, valid_sorted.device) == 0
    return (first | diff) & valid_sorted


def _flag_positions_by_rank(flag, cap: int, fill: int):
    """(rank, table): rank[i] = number of flagged rows at or before i;
    table[r] = position of the r-th flagged row (0-based), `fill` for
    ranks past the last flag. Unflagged rows write to a spare last slot,
    so each real slot is written once."""
    rank = torch.cumsum(flag.to(torch.int64), 0)
    table = torch.full((cap + 2,), fill, dtype=torch.int64,
                       device=flag.device)
    slot = torch.where(flag, rank - 1, torch.full_like(rank, cap + 1))
    table[slot] = _iota(cap, flag.device)
    return rank, table


def _last_flag_pos(flag, cap: int):
    """For each row, the position of the latest flagged row at or before
    it, 0 when none (the JAX package's cummax of flagged positions)."""
    rank, table = _flag_positions_by_rank(flag, cap, 0)
    return torch.where(rank > 0, table[(rank - 1).clamp(min=0)],
                       torch.zeros_like(rank))


def _seg_start_pos(starts, cap):
    """For each row, the position of its segment's first row."""
    return _last_flag_pos(starts, cap)


def _peer_change(starts, sorted_order_ops, cap):
    """Row i begins a new peer group (segment start or any order-key
    operand differs from the previous row)."""
    change = starts
    for op in sorted_order_ops:
        change = change | (op != torch.roll(op, 1))
    return change


def _last_peer_pos(change, cap):
    """For each row, the position of the LAST row of its peer group:
    one before the next change point (cap-1 when none follows)."""
    rank, table = _flag_positions_by_rank(change, cap, cap)
    # the first flag after i has rank rank[i] (0-based)
    return table[rank].clamp(max=cap) - 1


def row_number(starts, cap):
    iota = _iota(cap, starts.device)
    return iota - _seg_start_pos(starts, cap) + 1


def rank(starts, change, cap):
    last_change = _last_flag_pos(change, cap)
    return last_change - _seg_start_pos(starts, cap) + 1


def dense_rank(starts, change, cap):
    cum = torch.cumsum(change.to(torch.int64), 0)
    at_start = cum[_seg_start_pos(starts, cap)]
    return cum - at_start + 1


def _full_scalar(value, like):
    return torch.tensor(value).to(like.dtype).to(like.device).expand(
        like.shape)


def shift_in_segment(values, validity, seg_id, offset: int, default,
                     cap: int):
    """lag (offset>0) / lead (offset<0) within the partition segment."""
    shifted = torch.roll(values, offset)
    seg_shifted = torch.roll(seg_id, offset)
    iota = _iota(cap, values.device)
    in_range = (iota >= offset) if offset > 0 else (iota < cap + offset)
    same = (seg_shifted == seg_id) & in_range
    if validity is not None:
        v_shifted = torch.roll(validity, offset)
    else:
        v_shifted = torch.ones((cap,), dtype=torch.bool, device=values.device)
    if default is None:
        out_valid = same & v_shifted
        out = torch.where(same, shifted, torch.zeros_like(shifted))
    else:
        out = torch.where(same, shifted, _full_scalar(default, shifted))
        out_valid = ~same | v_shifted
    return out, out_valid


def _neutral(kind: str, dtype: torch.dtype, device):
    if kind == "min":
        v = _max_of(dtype)
    else:
        v = _min_of(dtype)
    return torch.tensor(v, dtype=dtype, device=device)


def _segment_float_sums(contrib, starts, cap: int):
    """Per-row sum of its segment's float contributions, each segment
    reduced in a fixed order (rows sorted by segment: each segment is a
    contiguous run starting at a `starts` flag)."""
    rank, table = _flag_positions_by_rank(starts, cap, cap)
    # segment k spans [table[k], table[k+1]); a leading block of rows
    # before the first start (no live row at all) is segment -1
    lengths = torch.cat([table[:1], table[1:cap + 1] - table[:cap]])
    sums = torch.segment_reduce(contrib, "sum", lengths=lengths,
                                unsafe=True)
    return sums[rank]


def _segment_int_sums(contrib, start_pos, end_pos):
    """Per-row sum of its segment's integer contributions: differences
    of one int64 prefix sum, exact mod 2^64."""
    acc = contrib.to(torch.int64)
    pref = torch.cumsum(acc, 0)
    return pref[end_pos] - pref[start_pos] + acc[start_pos]


def windowed_agg(kind: str, values, validity, gid, num_segments: int,
                 starts, change, ordered: bool, cap: int):
    """sum/count/min/max/avg over the frame. Unordered -> whole
    partition; ordered -> running up to the last PEER row (the Spark
    default RANGE frame). `gid` and `num_segments` keep the JAX package's
    signature; the segments come from `starts` alone."""
    dev = values.device
    mask = validity if validity is not None else \
        torch.ones((cap,), dtype=torch.bool, device=dev)
    x = values
    if kind in ("sum", "avg"):
        contrib = torch.where(mask, x, torch.zeros_like(x))
    elif kind == "count":
        contrib = mask.to(torch.int64)
    else:
        contrib = torch.where(mask, x, _neutral(kind, x.dtype, dev))
    cnt_contrib = mask.to(torch.int64)

    start_pos = _seg_start_pos(starts, cap)
    if not ordered:
        # dead rows (after the last segment) contribute nothing, so the
        # last segment may run on to the end
        end_pos = _seg_end_pos(starts, cap)
        cnt = _segment_int_sums(cnt_contrib, start_pos, end_pos)
        if kind in ("min", "max"):
            run = _segmented_running(contrib, start_pos, cap, kind)
            return run[end_pos], cnt
        if contrib.is_floating_point():
            return _segment_float_sums(contrib, starts, cap), cnt
        return _segment_int_sums(contrib, start_pos, end_pos), cnt

    last_peer = _last_peer_pos(change, cap)
    runc = torch.cumsum(cnt_contrib, 0)
    cnt_at_start = runc[start_pos] - cnt_contrib[start_pos]
    cnt = runc[last_peer] - cnt_at_start
    if kind in ("min", "max"):
        run = _segmented_running(contrib, start_pos, cap, kind)
        return run[last_peer], cnt
    acc = contrib.to(torch.float64 if contrib.is_floating_point()
                     else torch.int64)
    run = torch.cumsum(acc, 0)
    at_start = run[start_pos] - acc[start_pos]
    frame = run[last_peer] - at_start
    return frame.to(contrib.dtype), cnt


def _segmented_running(contrib, start_pos, cap: int, kind: str):
    """Running min/max since the segment start, via a log-step scan
    (Hillis-Steele) that refuses to look past start_pos."""
    op = torch.minimum if kind == "min" else torch.maximum
    iota = _iota(cap, contrib.device)
    acc = contrib
    shift = 1
    while shift < cap:
        prev = torch.roll(acc, shift)
        ok = iota - shift >= start_pos
        acc = torch.where(ok, op(acc, prev), acc)
        shift <<= 1
    return acc


def _max_of(dt: torch.dtype):
    if dt == torch.bool:
        return True
    return torch.finfo(dt).max if dt.is_floating_point else \
        torch.iinfo(dt).max


def _min_of(dt: torch.dtype):
    if dt == torch.bool:
        return False
    return torch.finfo(dt).min if dt.is_floating_point else \
        torch.iinfo(dt).min


# ---------------------------------------------------------------------------
# Specified frames: ROWS/RANGE BETWEEN (reference: WindowExec.scala:36
# frame processors — prefix sums and sparse-table range queries over the
# whole column instead of per-row loops)
# ---------------------------------------------------------------------------

def _seg_end_pos(starts, cap):
    """Position of the LAST row of each row's partition segment."""
    return _last_peer_pos(starts, cap)


def _first_peer_pos(change, cap):
    return _last_flag_pos(change, cap)


def _searchsorted_seg(keys, seg_lo, seg_hi, targets, side: str, cap: int):
    """Vectorized per-row binary search WITHIN each row's segment:
    first position p in [seg_lo, seg_hi+1] with keys[p] >= target
    (side='left') or > target (side='right'). keys must be ascending
    within every segment (they are: rows sort by partition then key)."""
    lo = seg_lo.to(torch.int64)
    hi = (seg_hi + 1).to(torch.int64)
    steps = max(1, int(np.ceil(np.log2(max(cap, 2)))) + 1)
    for _ in range(steps):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        kv = keys[mid.clamp(0, cap - 1)]
        go_right = (kv < targets) if side == "left" else (kv <= targets)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def frame_bounds(frame, starts, change, cap,
                 ordered: bool, n_valid=None,
                 range_key=None, range_key_valid=None):
    """Per-row INCLUSIVE sorted-position bounds [lo, hi] of the frame.

    frame: None | ("rows"|"range", start, end) with UNBOUNDED sentinels.
    `n_valid` is the live-row count: dead (filtered) rows sort to the
    global tail, so the LAST segment's end must clamp to n_valid-1 or
    frames would span garbage rows. For "range", `range_key` is the
    single ascending numeric order key in sorted order, SANITIZED to be
    monotone (NULL-key and dead rows carry ±sentinels — see
    sanitize_range_key); NULL-key rows take their peer group as the
    frame (nulls sort together)."""
    iota = _iota(cap, starts.device)
    seg_lo = _seg_start_pos(starts, cap)
    seg_hi = _seg_end_pos(starts, cap)
    if n_valid is not None:
        seg_hi = torch.minimum(seg_hi, (n_valid - 1).clamp(min=0)
                               .to(seg_hi.dtype))
    if frame is None:
        if not ordered:
            return seg_lo, seg_hi
        return seg_lo, torch.minimum(_last_peer_pos(change, cap), seg_hi)
    kind, a, b = frame
    if kind == "rows":
        # offsets past the capacity behave as unbounded (they clamp to
        # the partition anyway), keeping arbitrary user offsets out of
        # the index arithmetic
        a = max(a, -cap - 1)
        b = min(b, cap + 1)
        lo = seg_lo if a <= UNBOUNDED_PRECEDING else \
            torch.maximum(seg_lo, iota + a)
        hi = seg_hi if b >= UNBOUNDED_FOLLOWING else \
            torch.minimum(seg_hi, iota + b)
        return lo, hi
    # RANGE: value-space offsets on the (ascending, sanitized) order key
    key = range_key
    if a <= UNBOUNDED_PRECEDING:
        lo = seg_lo
    else:
        lo = _searchsorted_seg(key, seg_lo, seg_hi, key + a, "left", cap)
    if b >= UNBOUNDED_FOLLOWING:
        hi = seg_hi
    else:
        hi = _searchsorted_seg(key, seg_lo, seg_hi, key + b,
                               "right", cap) - 1
    if range_key_valid is not None:
        # NULL order keys: the frame is the row's peer group
        fp = _first_peer_pos(change, cap)
        lp = torch.minimum(_last_peer_pos(change, cap), seg_hi)
        lo = torch.where(range_key_valid, lo, fp)
        hi = torch.where(range_key_valid, hi, lp)
    return lo, hi


def sanitize_range_key(key, key_valid, valid_sorted, nulls_first: bool):
    """Make the sorted order key monotone over every [seg_lo, seg_hi]
    search range: NULL-key rows (which sort to the segment's head for
    NULLS FIRST, tail for NULLS LAST) and dead rows (global tail) carry
    raw garbage values that would break the binary search. Replace them
    with the matching ±extreme sentinel; the searched targets (finite
    key ± offset) never land inside the sentinel regions, and NULL rows'
    own bounds are overridden to their peer group afterwards."""
    if key.is_floating_point():
        key = key.to(torch.float64)
        lo_s, hi_s = -float("inf"), float("inf")
    else:
        key = key.to(torch.int64)
        lo_s = torch.iinfo(torch.int64).min
        hi_s = torch.iinfo(torch.int64).max
    dead_or_null = ~valid_sorted if key_valid is None else \
        (~valid_sorted | ~key_valid)
    null_sentinel = lo_s if nulls_first else hi_s
    key = torch.where(dead_or_null & valid_sorted,
                      torch.full_like(key, null_sentinel), key)
    key = torch.where(~valid_sorted, torch.full_like(key, hi_s), key)
    return key


def _prefix_frame(contrib, lo, hi, cap):
    """sum over inclusive positions [lo, hi] via one prefix scan."""
    acc = contrib.to(torch.float64 if contrib.is_floating_point()
                     else torch.int64)
    pref = torch.cumsum(acc, 0)
    hi_c = hi.clamp(0, cap - 1)
    lo_c = lo.clamp(0, cap - 1)
    total = pref[hi_c] - pref[lo_c] + acc[lo_c]
    return torch.where(hi < lo, torch.zeros_like(total), total)


def _floor_log2(length):
    """floor(log2(length)) for int64 length >= 1, exact."""
    lv = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    lv = lv - ((torch.ones_like(lv) << lv) > length).to(torch.int64)
    return lv + ((torch.ones_like(lv) << (lv + 1)) <= length).to(torch.int64)


def _rmq_frame(contrib, lo, hi, cap: int, kind: str,
               max_len: Optional[int] = None):
    """min/max over inclusive [lo, hi] via a sparse table: O(1) per-row
    query — the vectorized seat of the reference's sliding frame
    processors. `max_len` (known for finite ROWS frames) caps the table
    at log2(max_len)+1 levels, so a small sliding window costs O(n)
    memory instead of O(n log n)."""
    op = torch.minimum if kind == "min" else torch.maximum
    iota = _iota(cap, contrib.device)
    bound = cap if max_len is None else min(cap, max(max_len, 1))
    levels = [contrib]
    k = 1
    while (1 << k) <= bound:
        half = 1 << (k - 1)
        prev = levels[-1]
        levels.append(op(prev, prev[(iota + half).clamp(0, cap - 1)]))
        k += 1
    flat = torch.stack(levels).reshape(-1)            # [L * cap]
    length = (hi - lo + 1).clamp(min=1)
    lv = _floor_log2(length).clamp(0, len(levels) - 1)
    lo_c = lo.clamp(0, cap - 1)
    right = (hi - (torch.ones_like(lv) << lv) + 1).clamp(0, cap - 1)
    x1 = flat[lv * cap + lo_c]
    x2 = flat[lv * cap + right]
    return op(x1, x2)


def framed_agg(kind: str, values, validity, lo, hi, cap: int,
               max_len: Optional[int] = None):
    """sum/count/min/max over explicit per-row frame bounds. Returns
    (value, count-in-frame); empty frames report count 0 (NULL)."""
    dev = values.device
    mask = validity if validity is not None else \
        torch.ones((cap,), dtype=torch.bool, device=dev)
    cnt = _prefix_frame(mask.to(torch.int64), lo, hi, cap)
    if kind == "count":
        return cnt, cnt
    if kind in ("sum",):
        contrib = torch.where(mask, values, torch.zeros_like(values))
        return _prefix_frame(contrib, lo, hi, cap).to(values.dtype), cnt
    contrib = torch.where(mask, values, _neutral(kind, values.dtype, dev))
    return _rmq_frame(contrib, lo, hi, cap, kind, max_len), cnt
