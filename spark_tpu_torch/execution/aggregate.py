"""Group-by aggregation: the dense-domain (direct) strategy.

The port of the direct half of `spark_tpu/execution/aggregate.py`
(reference: Tungsten hash aggregation, `HashAggregateExec.scala:46`).
When every group key has a statically known small integer domain
(dictionary-encoded strings -> |dict|, `x % c` -> c, bool -> 2, byte ->
256), the combined domain is a dense table and aggregation is a
per-slot sum — no hash table. TPC-H Q1 (two dictionary keys, 12 slots),
Q6 (no key, 1 slot), Q5 (`n_name`, 25 slots) and
`range(n).group_by(id % m)` take this path, and its sums run in the
hand-written CUDA kernels of `dense_groupby.py`.

Keys without such a domain (Q3's `l_orderkey`) take the sort-based
general strategy, `sort_aggregate`: one stable sort by the keys, then
per-segment reductions read off prefix sums and segmented scans.
Percentile and median sort by (keys, value) instead and gather
(`positional_sort`, `positional_percentile`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..expr import Alias, Expression, Literal, Mod, Pmod, Vec
from ..expr_agg import AccSpec


def key_domain(expr: Expression, vec: Vec) -> Optional[Tuple[int, int]]:
    """Statically-known integer key range as (domain, lo) with value in
    [lo, lo+domain), or None.

    `lo` matters for signed ranges: truncated `%` yields (-m, m) and BYTE
    is [-128, 128)."""
    while isinstance(expr, Alias):
        expr = expr.child
    if vec.dictionary is not None:
        return len(vec.dictionary), 0
    if isinstance(vec.dtype, T.BooleanType):
        return 2, 0
    if isinstance(vec.dtype, T.ByteType):
        return 256, -128
    if isinstance(expr, Mod):
        div = expr.children[1]
        while hasattr(div, "child") and div.children:
            div = div.children[0]
        if isinstance(div, Literal) and isinstance(div.value, int) and div.value > 0:
            m = int(div.value)
            if isinstance(expr, Pmod):
                return m, 0
            # truncated %: result in (-m, m)
            return 2 * m - 1, -(m - 1)
    return None


def _key_index(vec: Vec, domain: int, lo: int):
    idx = vec.data.to(torch.int32) - lo
    return idx.clamp(0, domain - 1)


def key_spans(nullables: Sequence[bool],
              domains: Sequence[Tuple[int, int]]) -> List[int]:
    """Per-key slot count: the value domain plus one NULL slot for
    SCHEMA-nullable keys (SQL groups NULL keys together)."""
    return [d + (1 if nullable else 0)
            for nullable, (d, _lo) in zip(nullables, domains)]


def direct_index(key_vecs: Sequence[Vec], domains: Sequence[Tuple[int, int]],
                 spans: Sequence[int], sel, device=None):
    """Combined dense-domain int32 index per row; unselected rows get the
    out-of-range index `total` (the group-by drops them); NULL key values
    map to the key's dedicated null slot."""
    total = 1
    strides = []
    for span in spans:
        strides.append(total)
        total *= span
    if sel is not None:
        device = sel.device
    elif key_vecs:
        device = key_vecs[0].data.device
    idx = torch.zeros((), dtype=torch.int32, device=device)
    for vec, (d, lo), span, s in zip(key_vecs, domains, spans, strides):
        ki = _key_index(vec, d, lo)
        if vec.validity is not None and span > d:
            ki = torch.where(vec.validity, ki, torch.full_like(ki, d))
        idx = idx + ki * s
    if sel is not None:
        idx = torch.where(sel, idx, torch.full_like(idx, total))
    return idx, total, strides


def direct_init(spans: Sequence[int], specs: List[List[AccSpec]], device):
    """Fresh accumulator tables: (occupied_cnt, [[acc,...],...])."""
    total = int(np.prod(list(spans) or [1]))
    cnt = torch.zeros((total,), dtype=torch.int64, device=device)
    accs = [[torch.full((total,), spec.neutral.item(),
                        dtype=T.torch_dtype(spec.np_dtype), device=device)
             for spec in row]
            for row in specs]
    return cnt, accs


def _is_float(spec: AccSpec) -> bool:
    return np.issubdtype(spec.np_dtype, np.floating)


def direct_update(tables, idx, total, contribs: List[List],
                  specs: List[List[AccSpec]], kernel_mode: str = "auto",
                  merge: bool = False,
                  reuse_count: Optional[Tuple[int, int]] = None):
    """Merge one chunk's contributions into carried tables (associative).

    kernel_mode: 'auto' and 'matmul' send the sums through
    `dense_groupby.dense_groupby_sums` — the hand-written CUDA kernel on
    CUDA tensors, its plain version on CPU tensors ('matmul' is the JAX
    package's name for forcing the kernel); 'scatter' takes the plain
    `index_add_` path below. The kernel path runs for sum-only
    aggregates with total <= 2^20 and at least 128 rows (any row count
    under 'matmul'); float rows above 512 slots always scatter.

    merge=True means the contributions are partial accumulators (a final
    aggregate folding per-shard tables), not raw per-row values: the
    occupancy row is then counted separately, never reused.

    reuse_count=(i, j): the caller promises contribs[i][j] equals the
    selection indicator, so the occupancy counts ride that row's sums
    instead of a row of ones of their own. Ignored in merge mode.
    """
    cnt, accs = tables
    n_rows = None
    for row in contribs:
        for c in row:
            if c.dim() == 1:
                n_rows = c.shape[0]
                break
        if n_rows is not None:
            break
    if idx.dim() == 0:
        idx = idx.expand((n_rows if n_rows is not None else 1,))
    n = idx.shape[0]
    contribs = [[c.expand((n,)) if c.dim() == 0 else c for c in row]
                for row in contribs]

    all_sum = all(spec.reduce == "sum" for row in specs for spec in row)
    use_kernel = kernel_mode in ("matmul", "auto")
    has_float = any(_is_float(spec) for row in specs for spec in row)
    if has_float and total > 512:
        # the shared-memory kernel holds floats only up to 512 slots
        use_kernel = False
    if all_sum and use_kernel and total <= (1 << 20) and \
            (n >= 128 or kernel_mode == "matmul"):
        from .dense_groupby import dense_groupby_sums
        reuse = reuse_count if not merge else None
        ones = torch.ones((n,), dtype=torch.int64, device=idx.device)
        int_rows = [] if reuse is not None else [ones]
        float_rows = []
        layout = []  # (row_kind, index) per (i, j)
        reuse_pos = None
        for i, (contrib_row, spec_row) in enumerate(zip(contribs, specs)):
            for j, (contrib, spec) in enumerate(zip(contrib_row, spec_row)):
                if _is_float(spec):
                    layout.append(("f", len(float_rows)))
                    float_rows.append(contrib.to(torch.float64).contiguous())
                else:
                    layout.append(("i", len(int_rows)))
                    if reuse == (i, j):
                        reuse_pos = len(int_rows)
                    int_rows.append(contrib.to(torch.int64).contiguous())
        if reuse is not None and reuse_pos is None:
            # promised row turned out to be a float row: count separately
            int_rows = [ones] + int_rows
            layout = [(k, p + 1) if k == "i" else (k, p)
                      for (k, p) in layout]
            reuse_pos = 0
        int_sums, float_sums = dense_groupby_sums(
            idx.to(torch.int32).contiguous(), int_rows, float_rows, total)
        cnt = cnt + int_sums[reuse_pos if reuse_pos is not None else 0]
        new_accs = []
        k = 0
        for table_row, spec_row in zip(accs, specs):
            new_row = []
            for table, spec in zip(table_row, spec_row):
                kind, pos = layout[k]
                k += 1
                sums = float_sums[pos] if kind == "f" else int_sums[pos]
                new_row.append(table + sums.to(table.dtype))
            new_accs.append(new_row)
        return cnt, new_accs

    # plain path: index_add_/scatter_reduce_ into total + 1 slots, the
    # last one catching the unselected rows (index `total`), then dropped
    slot = idx.long()

    def into(table, contrib, reduce: str):
        ext = torch.cat([table, table[:1]])
        if reduce == "sum":
            ext.index_add_(0, slot, contrib.to(table.dtype))
        else:
            ext.scatter_reduce_(0, slot, contrib.to(table.dtype),
                                "amin" if reduce == "min" else "amax")
        return ext[:total]

    cnt = into(cnt, torch.ones((n,), dtype=torch.int64, device=idx.device),
               "sum")
    new_accs = []
    for table_row, contrib_row, spec_row in zip(accs, contribs, specs):
        new_accs.append([into(table, contrib, spec.reduce)
                         for table, contrib, spec
                         in zip(table_row, contrib_row, spec_row)])
    return cnt, new_accs


def direct_keys(domains: Sequence[Tuple[int, int]],
                spans: Sequence[int], strides: Sequence[int],
                key_dtypes: Sequence[T.DataType], device) -> Tuple[List, List]:
    """Reconstruct key column (values, validities) from the dense domain
    index. A key's null slot (index == domain) decodes to validity False;
    keys without a null slot get validity None."""
    total = int(np.prod(list(spans) or [1]))
    rem = torch.arange(total, dtype=torch.int32, device=device)
    key_arrays = []
    key_valids = []
    for (d, lo), span, s, dt in zip(reversed(list(domains)),
                                    reversed(list(spans)),
                                    reversed(strides),
                                    reversed(list(key_dtypes))):
        k = torch.div(rem, s, rounding_mode="floor")
        rem = rem - k * s
        if span > d:  # has a null slot
            key_valids.append(k != d)
            k = k.clamp(max=d - 1)
        else:
            key_valids.append(None)
        key_arrays.append((k + lo).to(T.torch_dtype(dt.np_dtype)))
    key_arrays.reverse()
    key_valids.reverse()
    return key_arrays, key_valids


def direct_aggregate(key_vecs: Sequence[Vec],
                     domains: Sequence[Tuple[int, int]],
                     spans: Sequence[int],
                     contribs: List[List], specs: List[List[AccSpec]],
                     sel, device, kernel_mode: str = "auto",
                     merge: bool = False,
                     reuse_count: Optional[Tuple[int, int]] = None
                     ) -> Tuple[List, List, List, object]:
    """One-shot dense-domain aggregation.
    Returns (key_arrays, key_valids, acc_arrays, occupied)."""
    idx, total, strides = direct_index(key_vecs, domains, spans, sel, device)
    tables = direct_init(spans, specs, device)
    cnt, accs = direct_update(tables, idx, total, contribs, specs,
                              kernel_mode=kernel_mode, merge=merge,
                              reuse_count=reuse_count)
    key_arrays, key_valids = direct_keys(domains, spans, strides,
                                         [v.dtype for v in key_vecs], device)
    return key_arrays, key_valids, accs, cnt > 0


def _segmented_scan(values, starts, op):
    """Inclusive scan of `op` that restarts at every `starts` row
    (Hillis-Steele doubling: log2(n) whole-column steps)."""
    n = values.shape[0]
    shift = 1
    while shift < n:
        cur_v, cur_f = values[shift:], starts[shift:]
        new_v = torch.where(cur_f, cur_v, op(values[:-shift], cur_v))
        values = torch.cat([values[:shift], new_v])
        starts = torch.cat([starts[:shift], cur_f | starts[:-shift]])
        shift *= 2
    return values


_SCAN_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _sorted_segment_reduce(contrib_sorted, reduce: str, starts_rows,
                           start_pos, end_pos, present):
    """Per-segment reduce over rows SORTED by segment, without a
    colliding scatter.

    integer sum: prefix-sum difference csum[end] - ex[start] — int64
    wraps mod 2^64, so the difference is exact. float sum and min/max:
    a SEGMENTED scan (reset at `starts_rows`) read at segment ends, so
    each segment's float error is at the ulp of its own magnitude, not
    of the whole column's running total. Its add order differs from the
    JAX package's `associative_scan`, so float sums agree within
    rounding, not bit for bit. That scan interleaves its halves by adding
    zero-padded copies, so every float it returns is `x + 0.0`: a -0.0
    sum, min or max comes out as +0.0, and so it does here (the JAX
    package's dense path keeps -0.0 for min and max, as the port's
    does). start_pos/end_pos index each segment's first/last sorted row;
    `present` masks empty segments."""
    if reduce == "sum" and not contrib_sorted.is_floating_point():
        csum = torch.cumsum(contrib_sorted, 0)
        ex = csum - contrib_sorted  # exclusive prefix
        out = csum[end_pos] - ex[start_pos]
        return torch.where(present, out, torch.zeros_like(out))
    scanned = _segmented_scan(contrib_sorted, starts_rows, _SCAN_OPS[reduce])
    out = scanned[end_pos]
    if out.is_floating_point():
        out = out + 0.0  # -0.0 -> +0.0, as the JAX package's scan gives
    if reduce == "sum":
        out = torch.where(present, out, torch.zeros_like(out))
    return out


def _sort_operand(data):
    """Ascending-sortable int64 for a key operand in `lax.sort`'s order:
    floats by the sign flip of their bits, with -0.0 tied to +0.0 and
    every NaN tied above +inf."""
    from .join import canon_key_data, order_image
    if data.dtype == torch.bool:
        return data.to(torch.int8)
    return order_image(canon_key_data(data))


def sort_aggregate(key_vecs: Sequence[Vec],
                   contribs: List[List], specs: List[List[AccSpec]],
                   sel, capacity: int, num_segments: Optional[int] = None
                   ) -> Tuple[List, List, List, object, object]:
    """General sort-based aggregation.

    Returns (key_arrays, key_validities, acc_arrays, occupied,
    total_groups). Groups come out in key order. Groups beyond
    `num_segments` are dropped — the caller flags
    `total_groups > num_segments` and the executor runs again with a
    larger estimate.
    """
    num_segments = num_segments or capacity
    device = sel.device if sel is not None else key_vecs[0].data.device
    invalid = torch.zeros((capacity,), dtype=torch.int8, device=device) \
        if sel is None else (~sel).to(torch.int8)
    operands = [invalid]
    for vec in key_vecs:
        data = vec.data
        if data.dim() == 0:
            data = data.expand((capacity,))
        if vec.validity is not None:
            valid = vec.validity
            if valid.dim() == 0:
                valid = valid.expand((capacity,))
            operands.append((~valid).to(torch.int8))
            # neutralize data under NULL: two NULL keys must land in ONE
            # group even when their dead payloads differ
            data = torch.where(valid, data, torch.zeros_like(data))
        operands.append(data)
    # stable passes, least significant operand first
    perm = torch.arange(capacity, device=device)
    for op in reversed(operands):
        _, order = torch.sort(_sort_operand(op)[perm], stable=True)
        perm = perm[order]
    sorted_ops = [op[perm] for op in operands]
    valid_sorted = sorted_ops[0] == 0

    # group starts: first valid row, or any key component differing
    # from the previous row (IEEE !=, as the reference compares)
    pos = torch.arange(capacity, device=device)
    diff = torch.zeros((capacity,), dtype=torch.bool, device=device)
    for op in sorted_ops[1:]:
        diff = diff | (op != torch.roll(op, 1))
    starts = ((pos == 0) | diff) & valid_sorted
    total_groups = starts.sum()
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1
    in_seg = valid_sorted & (gid < num_segments)
    gid = torch.where(in_seg, gid, torch.full_like(gid, num_segments))

    # per-segment first/last sorted-row positions via non-colliding
    # scatters into num_segments + 1 slots (the last one drops)
    drop = torch.full_like(gid, num_segments)
    sidx = torch.where(starts & in_seg, gid, drop)
    nxt_gid = torch.cat([gid[1:], gid.new_full((1,), num_segments)])
    eidx = torch.where(in_seg & (nxt_gid != gid), gid, drop)

    def scatter(idx, values, fill, dtype):
        out = torch.full((num_segments + 1,), fill, dtype=dtype,
                         device=device)
        out[idx] = values
        return out[:num_segments]

    start_pos = scatter(sidx, pos, 0, torch.int64)
    end_pos = scatter(eidx, pos, 0, torch.int64)
    present = scatter(sidx, True, False, torch.bool)
    occupied_cnt = torch.where(present, end_pos - start_pos + 1,
                               torch.zeros_like(end_pos))

    accs = []
    for row_contribs, row_specs in zip(contribs, specs):
        fn_accs = []
        for contrib, spec in zip(row_contribs, row_specs):
            if contrib.dim() == 0:
                contrib = contrib.expand((capacity,))
            out = _sorted_segment_reduce(contrib[perm], spec.reduce, starts,
                                         start_pos, end_pos, present)
            tdt = T.torch_dtype(spec.np_dtype)
            if spec.reduce != "sum":
                out = torch.where(occupied_cnt > 0, out.to(tdt),
                                  torch.full((num_segments,),
                                             spec.neutral.item(), dtype=tdt,
                                             device=device))
            fn_accs.append(out.to(tdt))
        accs.append(fn_accs)

    # first-of-group key values into the output slots
    key_arrays = []
    key_valids = []
    first = torch.where(starts, gid, drop)
    oi = 1
    for vec in key_vecs:
        null_sorted = None
        if vec.validity is not None:
            null_sorted = sorted_ops[oi] != 0
            oi += 1
        data_sorted = sorted_ops[oi]
        oi += 1
        key_arrays.append(scatter(first, data_sorted, 0, data_sorted.dtype))
        key_valids.append(None if null_sorted is None else
                          scatter(first, ~null_sorted, True, torch.bool))
    return key_arrays, key_valids, accs, occupied_cnt > 0, total_groups


# ---------------------------------------------------------------------------
# Positional aggregates: percentile/median/collect_list/collect_set
# (reference: Percentile.scala, ApproximatePercentile.scala:1,
# collect.scala — ObjectHashAggregate's serialized per-group state
# becomes ONE device sort by (group keys, value) and positional gathers;
# list outputs compact into offsets-encoded array columns)
# ---------------------------------------------------------------------------

def positional_sort(key_vecs: Sequence[Vec], value_vec: Vec, sel,
                    capacity: int):
    """Sort rows by (liveness, group keys, value-null-last, value), the
    value in `lax.sort`'s float order (-0.0 tied to +0.0, NaN above
    +inf). Returns (values_sorted, value_valid_sorted, gid, gstart):
    each sorted row's group id (`capacity` for dead rows) and each
    group's first sorted row. Group ORDER depends only on the keys, so
    several positional sorts (different value children) and a
    sort_aggregate over the same keys align group for group."""
    from .sort import stable_permutation
    device = sel.device if sel is not None else value_vec.data.device

    def full(t):
        return t.expand((capacity,)) if t.dim() == 0 else t

    invalid = torch.zeros((capacity,), dtype=torch.int8, device=device) \
        if sel is None else (~sel).to(torch.int8)
    operands = [invalid]
    for vec in key_vecs:
        data = full(vec.data)
        if vec.validity is not None:
            valid = full(vec.validity)
            operands.append((~valid).to(torch.int8))
            data = torch.where(valid, data, torch.zeros_like(data))
        operands.append(data)
    vinvalid = torch.zeros((capacity,), dtype=torch.int8, device=device) \
        if value_vec.validity is None else \
        (~full(value_vec.validity)).to(torch.int8)
    operands.append(vinvalid)  # null values sort to the group tail
    operands.append(full(value_vec.data))
    perm = stable_permutation([_sort_operand(op) for op in operands],
                              capacity, device)
    sorted_ops = [op[perm] for op in operands]
    valid_sorted = sorted_ops[0] == 0
    values_sorted = sorted_ops[-1]
    vvalid_sorted = (sorted_ops[-2] == 0) & valid_sorted

    # group starts: IEEE != on the key operands, as the JAX package
    # compares them
    diff = torch.zeros((capacity,), dtype=torch.bool, device=device)
    for op in sorted_ops[1:-2]:
        diff = diff | (op != torch.roll(op, 1))
    pos = torch.arange(capacity, device=device)
    starts = ((pos == 0) | diff) & valid_sorted
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1
    gid = torch.where(valid_sorted, gid, torch.full_like(gid, capacity))
    # GROUP-indexed first-row position (slot g -> group g's start)
    sidx = torch.where(starts, gid.clamp(0, capacity),
                       torch.full_like(gid, capacity))
    gstart = torch.zeros((capacity + 1,), dtype=torch.int64, device=device)
    gstart[sidx] = pos
    return values_sorted, vvalid_sorted, gid, gstart[:capacity]


def positional_percentile(values_sorted, vvalid_sorted, gid, gstart,
                          num_segments: int, q: float, capacity: int):
    """Exact per-group percentile with linear interpolation (the
    reference's Percentile): each group's values sit contiguously with
    nulls at the tail, so the q-quantile is two gathers and a lerp.
    `gstart` is GROUP-indexed. Returns (values, valid)."""
    device = values_sorted.device
    cnt = torch.zeros((num_segments + 1,), dtype=torch.int64, device=device)
    cnt.index_add_(0, gid.clamp(0, num_segments),
                   vvalid_sorted.to(torch.int64))
    cnt = cnt[:num_segments]
    gstart = gstart[:num_segments]
    vals = values_sorted.to(torch.float64)
    idx = (cnt - 1).to(torch.float64) * q
    lo = torch.floor(idx).to(torch.int64).clamp_min(0)
    hi = torch.ceil(idx).to(torch.int64).clamp_min(0)
    safe = gstart.clamp(0, capacity - 1)
    v_lo = vals[(safe + lo).clamp(0, capacity - 1)]
    v_hi = vals[(safe + hi).clamp(0, capacity - 1)]
    frac = idx - lo.to(torch.float64)
    return v_lo + (v_hi - v_lo) * frac, cnt > 0


def positional_collect(values_sorted, vvalid_sorted, gid, gstart,
                       num_segments: int, distinct: bool, capacity: int):
    """collect_list / collect_set: compact each group's valid values, in
    the sort's order, into an offsets-encoded list column; `distinct`
    drops a value equal to the one before it in its group (adjacent
    after the value sort). `gstart` is GROUP-indexed. Returns
    (data[capacity], offsets[num_segments+1] int32)."""
    device = values_sorted.device
    pos = torch.arange(capacity, device=device)
    keep = vvalid_sorted
    if distinct:
        same_prev = (torch.roll(values_sorted, 1) == values_sorted) & \
            (torch.roll(gid, 1) == gid) & (pos != 0)
        keep = keep & ~(same_prev & vvalid_sorted
                        & torch.roll(vvalid_sorted, 1))
    keep_i = keep.to(torch.int64)
    gseg = gid.clamp(0, num_segments)
    kcnt = torch.zeros((num_segments + 1,), dtype=torch.int64, device=device)
    kcnt.index_add_(0, gseg, keep_i)
    new_off = torch.cat([torch.zeros((1,), dtype=torch.int64, device=device),
                         torch.cumsum(kcnt[:num_segments], 0)])
    ck = torch.cumsum(keep_i, 0)
    # kept rows before each row's group start: a row's rank among its
    # group's kept values is the kept count since then
    start = gstart[gid.clamp(0, capacity - 1)]
    rank = ck - (ck[start] - keep_i[start]) - 1
    target = torch.where(keep, new_off[gseg] + rank,
                         torch.full_like(rank, capacity))
    data = torch.zeros((capacity + 1,), dtype=values_sorted.dtype,
                       device=device)
    data[target] = values_sorted
    return data[:capacity], new_off.to(torch.int32)
