"""Reductions of the program's own ranges in a traced run.

While a torch.profiler is active the port opens a profiler range over
each of its spans, named `spark_tpu/<span>`: the phases (`parse`,
`plan`, `dispatch`, ...), the host work between them and one
`spark_tpu/op:<PhysicalClass>` range an operator computes, nested inside
`dispatch`. The harness wraps each window query in a `bench:<i>:<q>`
range. Spans and kernels then share the profiler's clock.

A piece of device work (a kernel, copy or memset) belongs to the
innermost program range that encloses the CPU call that launched it, on
the launching thread: the torch op its linked correlation id names, or
else the CUDA runtime call with its correlation id. The GPU-side
annotation events Kineto writes for each range are never device work.
Busy time is the union of intervals, as `tracing.reduce_events` counts
it on one card; on a mesh this is the union over every card.

`reduce_events(evs, records, dispatch_starts(...))` takes the events
`tracing.events` read once for both reductions and returns the figures
by name; it finds nothing, and returns no figure, in a trace without
the program's ranges.
"""

from __future__ import annotations

import bisect
import collections
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

from tracing import PREFIX as BENCH, Ev, _covered, _merge

RANGE = "spark_tpu/"
#: operators whose attributed device time the join and aggregate
#: figures sum
JOIN_OPS = ("op:JoinExec", "op:RuntimeFilterExec")
AGG_OPS = ("op:HashAggregateExec",)
#: CUDA runtime calls that make the host wait for the card
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize")


def is_runtime(ev: Ev) -> bool:
    """A CUDA API call on the host (`cudaLaunchKernel`, `cuLaunchKernel`,
    ...): its correlation id is the one its device work carries, in an id
    space apart from the torch ops'."""
    return not ev.device and ev.name.startswith("cu")


def is_work(ev: Ev) -> bool:
    """Device work: a kernel, copy or memset on the card, never an
    annotation (whatever its name)."""
    return (ev.device and ev.end > ev.start and not ev.annotation
            and not ev.name.startswith((RANGE, BENCH)))


def _innermost(ranges: List[Ev], points: List[Tuple[int, int]]
               ) -> Dict[int, Ev]:
    """For each (time, key) of `points`, the innermost of the nested
    `ranges` (one thread's) that encloses the time, by one sweep."""
    ranges = sorted(ranges, key=lambda r: (r.start, -r.end))
    found: Dict[int, Ev] = {}
    stack: List[Ev] = []
    j = 0
    for t, key in sorted(points):
        while j < len(ranges) and ranges[j].start <= t:
            while stack and stack[-1].end <= ranges[j].start:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        if stack:
            found[key] = stack[-1]
    return found


def attribute(evs: List[Ev]) -> Dict[int, Optional[Ev]]:
    """Index of each piece of device work in `evs` -> the innermost
    program range enclosing its launch on the launching thread (None
    where no program range does)."""
    ops = {e.corr: e for e in evs if not e.device and not is_runtime(e)}
    runtime = {e.corr: e for e in evs if is_runtime(e)}
    by_tid: Dict[int, List[Ev]] = collections.defaultdict(list)
    for e in evs:
        if not e.device and e.name.startswith(RANGE):
            by_tid[e.tid].append(e)
    points: Dict[Optional[int], List[Tuple[int, int]]] = \
        collections.defaultdict(list)
    for i, e in enumerate(evs):
        if not is_work(e):
            continue
        launch = ops.get(e.linked) if e.linked else None
        if launch is None:
            launch = runtime.get(e.corr)
        if launch is not None:
            # a launching thread numbered apart from the ranges' threads
            # (a runtime call's system id) is looked up on every thread
            tid = launch.tid if launch.tid in by_tid else None
            points[tid].append((launch.start, i))
    out: Dict[int, Optional[Ev]] = {i: None for i, e in enumerate(evs)
                                    if is_work(e)}
    for tid, pts in points.items():
        if tid is not None:
            out.update(_innermost(by_tid[tid], pts))
            continue
        for ranges in by_tid.values():
            for key, r in _innermost(ranges, pts).items():
                if out[key] is None or r.start > out[key].start:
                    out[key] = r
    return out


class _Union:
    """A disjoint sorted union of intervals, and how much of it lies in
    any interval."""

    def __init__(self, spans: Iterable[Tuple[int, int]]):
        self.union = _merge(list(spans))
        self.starts = [s for s, _ in self.union]
        self.prefix = [0]
        for s, e in self.union:
            self.prefix.append(self.prefix[-1] + e - s)

    def within(self, a: int, b: int) -> int:
        return _covered(self.union, self.starts, self.prefix, a, b)

    def total(self) -> int:
        return self.prefix[-1]


def _clip(spans, w0: int, w1: int):
    return [(max(s, w0), min(e, w1)) for s, e in spans if e > w0 and s < w1]


def reduce_events(evs: List[Ev], records: List[dict],
                  span_starts: Optional[List[List[int]]] = None) -> dict:
    """The program-range figures of one traced window. `records` are the
    harness's window queries, in order; `span_starts`, when given, each
    window query's `dispatch` span starts as the anchor maps them (ns),
    for the offsets against the trace's own ranges."""
    bench = {}
    for e in evs:
        if not e.device and e.name.startswith(BENCH):
            bench[int(e.name.split(":")[1])] = e
    ranges = [e for e in evs if not e.device and e.name.startswith(RANGE)]
    if not bench or not ranges:
        return {}
    w0 = min(e.start for e in bench.values())
    w1 = max(e.end for e in bench.values())
    work = [i for i, e in enumerate(evs) if is_work(e)]
    busy = _Union(_clip([(evs[i].start, evs[i].end) for i in work], w0, w1))
    done = max(1, sum(1 for r in records if r.get("ok")))
    owner = attribute(evs)

    # the query each range belongs to: the bench range enclosing it
    bench_sorted = sorted(bench.items(), key=lambda kv: kv[1].start)
    b_starts = [b.start for _, b in bench_sorted]

    def query_of(r: Ev) -> Optional[int]:
        k = bisect.bisect_right(b_starts, r.start) - 1
        if k >= 0 and bench_sorted[k][1].end >= r.end:
            return bench_sorted[k][0]
        return None

    dispatch = [r for r in ranges if r.name == RANGE + "dispatch"
                and w0 <= r.start < w1]
    inside = [r for r in dispatch if query_of(r) is not None]
    d_union = _Union((r.start, r.end) for r in dispatch)
    out = {"window_queries": done,
           "traced_window_s": (w1 - w0) / 1e9,
           "dispatch_ranges": len(dispatch),
           "dispatch_in_bench_share": len(inside) / max(1, len(dispatch))}
    if busy.total() == 0:
        return out   # no device work traced (a CPU run): no device figure

    # device time of each operator class, and the share of the busy time
    # inside dispatch ranges that some operator range owns
    by_op: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
    for i in work:
        r = owner.get(i)
        if r is not None and r.name.startswith(RANGE + "op:"):
            by_op[r.name[len(RANGE):]].append((evs[i].start, evs[i].end))
    op_busy = {op: _Union(_clip(s, w0, w1)) for op, s in by_op.items()}
    all_op = _Union(_clip([s for v in by_op.values() for s in v], w0, w1))
    in_dispatch = sum(busy.within(a, b) for a, b in d_union.union)
    op_in_dispatch = sum(all_op.within(a, b) for a, b in d_union.union)

    # host time and host syncs inside each operator class's ranges
    launch_ns: Dict[str, int] = collections.defaultdict(int)
    for r in ranges:
        if r.name.startswith(RANGE + "op:") and w0 <= r.start < w1:
            launch_ns[r.name[len(RANGE):]] += r.end - r.start
    syncs: Dict[str, int] = collections.defaultdict(int)
    sync_points = [(e.start, k) for k, e in enumerate(evs)
                   if not e.device and e.name in SYNCS and w0 <= e.start < w1]
    per_tid: Dict[int, List[Ev]] = collections.defaultdict(list)
    for r in ranges:
        per_tid[r.tid].append(r)
    for tid_ranges in per_tid.values():
        for k, r in _innermost(tid_ranges, sync_points).items():
            if r.name.startswith(RANGE + "op:"):
                syncs[r.name[len(RANGE):]] += 1

    # idle gaps by the innermost range over their midpoint
    gaps, cursor = [], w0
    for s, e in busy.union + [(w1, w1)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    mids = [((a + b) // 2, k) for k, (a, b) in enumerate(gaps)]
    labels: Dict[int, str] = {}
    for tid_ranges in list(per_tid.values()) + [list(bench.values())]:
        for k, r in _innermost(tid_ranges, mids).items():
            name = "host" if r.name.startswith(BENCH) \
                else r.name[len(RANGE):]
            if k not in labels or name != "host":
                labels[k] = name
    idle: Dict[str, int] = collections.defaultdict(int)
    for k, (a, b) in enumerate(gaps):
        idle[labels.get(k, "between queries")] += b - a
    d_idle = sum(b - a for a, b in gaps
                 if d_union.within((a + b) // 2, (a + b) // 2 + 1))

    def union_ms(ops) -> Optional[float]:
        spans = [s for op in ops for s in by_op.get(op, [])]
        if not spans:
            return None
        return _Union(_clip(spans, w0, w1)).total() / 1e6 / done

    out.update({
        "busy_s": busy.total() / 1e9,
        "dispatch_idle_ms": d_idle / 1e6 / done,
        "op_share_of_dispatch_busy": (op_in_dispatch / in_dispatch
                                      if in_dispatch else None),
        "operators": {op: {
            "device_ms": op_busy[op].total() / 1e6 / done,
            "launch_ms": launch_ns.get(op, 0) / 1e6 / done,
            "syncs": syncs.get(op, 0) / done}
            for op in sorted(op_busy, key=lambda o: -op_busy[o].total())},
        "idle_by_range_s": {n: t / 1e9 for n, t in sorted(
            idle.items(), key=lambda x: -x[1])},
    })
    join, agg = union_ms(JOIN_OPS), union_ms(AGG_OPS)
    if join is not None:
        out["join_device_ms"] = join
    if agg is not None:
        out["agg_device_ms"] = agg
    if span_starts is not None:
        offsets = []
        for i, starts in enumerate(span_starts):
            b = bench.get(i)
            if b is None:
                continue
            got = sorted(r.start for r in inside
                         if b.start <= r.start and r.end <= b.end)
            offsets += [abs(a - g) / 1e3 for a, g in zip(starts, got)]
        if offsets:
            out["dispatch_offset_us"] = {
                "median": statistics.median(offsets), "max": max(offsets),
                "n": len(offsets)}
    return out


def dispatch_starts(records: List[dict], anchor: Tuple[int, float],
                    timeline) -> Optional[List[List[int]]]:
    """Each window query's `dispatch` span starts from the program's end
    events, mapped through the harness's anchor (ns); None without a
    timeline."""
    if timeline is None:
        return None
    anchor_ns, anchor_perf = anchor
    return [[anchor_ns + int((t0 - anchor_perf) * 1e9)
             for name, t0, _ in ev["spans"] if name == "dispatch"]
            for ev in timeline.events[:len(records)]]
