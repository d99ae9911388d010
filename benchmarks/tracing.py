"""Reductions of the traced run: the profiler's device intervals per
query, the device's busy time, the idle gaps by the program's phase, and
each operator type's time from a synchronised pass over the converged
plan.

The operator pass is a frozen copy of `chip_smoke.breakdown`'s visitor:
each physical operator computed under `run_plan(..., visit=...)` with the
card synchronised around it, the host clock read on either side.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple

PREFIX = "bench:"
TOP = 10


def _ns(event, which: str) -> int:
    """An event's start or duration in ns, across the profiler's APIs."""
    if hasattr(event, f"{which}_ns"):
        return int(getattr(event, f"{which}_ns")())
    return int(getattr(event, f"{which}_us")() * 1000)


def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _covered(union: List[Tuple[int, int]], starts: List[int],
             prefix: List[int], a: int, b: int) -> int:
    """Nanoseconds of the disjoint sorted `union` inside [a, b]."""
    if b <= a or not union:
        return 0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    j = bisect.bisect_left(starts, b)
    total = prefix[j] - prefix[i]
    s, e = union[i]
    total -= max(0, min(e, a) - s)          # the part of span i before a
    if j - 1 >= i:
        s, e = union[j - 1]
        total -= max(0, e - max(s, b))      # the part of span j-1 after b
    return max(total, 0)


def raw_events(prof):
    """The profiler's raw events, without building its event tree."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        return list(results.events())
    return list(prof.events())


def reduce_profile(prof, records: List[dict], anchor: Tuple[int, float],
                   timeline) -> dict:
    """Busy time of the window and of each query, the device operations
    that took most time, and the idle gaps by what the host was doing."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device_spans: List[Tuple[int, int]] = []
    by_name: Dict[str, int] = collections.defaultdict(int)
    queries: Dict[int, Tuple[int, int]] = {}
    for ev in raw_events(prof):
        name = ev.name()
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        if name.startswith(PREFIX):
            if ev.device_type() != cuda:
                queries[int(name.split(":")[1])] = (start, start + dur)
            continue
        if ev.device_type() != cuda or dur <= 0:
            continue
        if getattr(ev, "is_user_annotation", lambda: False)():
            continue
        device_spans.append((start, start + dur))
        by_name[name[:200]] += dur
    union = _merge(device_spans)
    starts = [s for s, _ in union]
    prefix = [0]
    for s, e in union:
        prefix.append(prefix[-1] + e - s)
    anchor_ns, anchor_perf = anchor

    def to_ns(t_perf: float) -> int:
        return anchor_ns + int((t_perf - anchor_perf) * 1e9)

    # each query's interval on the profiler's clock: its annotation, or
    # the host clock mapped through the anchor
    intervals = [queries.get(i, (to_ns(r["t0"]), to_ns(r["t1"])))
                 for i, r in enumerate(records)]
    busy_by_query = [_covered(union, starts, prefix, a, b) / 1e9
                     for a, b in intervals]
    w0 = min((a for a, _ in intervals), default=0)
    w1 = max((b for _, b in intervals), default=0)
    busy_s = _covered(union, starts, prefix, w0, w1) / 1e9

    # idle gaps inside the window, labelled by the program's spans
    labels: List[Tuple[int, int, str]] = []
    events = list(timeline.events) if timeline is not None else []
    for (a, b), r in zip(intervals, records):
        labels.append((a, b, f"{r['q']}.host"))
    for ev, r in zip(events, records):
        for name, t0, t1 in ev["spans"]:
            if t1 is not None:
                labels.append((to_ns(t0), to_ns(t1), f"{r['q']}.{name}"))
    idle: Dict[str, int] = collections.defaultdict(int)
    gaps = []
    cursor = w0
    for s, e in union + [(w1, w1)]:
        s, e = max(s, w0), min(e, w1)
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    # the innermost label (latest start) that covers a gap's midpoint
    labels.sort()
    label_starts = [a for a, _, _ in labels]
    for a, b in gaps:
        mid = (a + b) // 2
        k = bisect.bisect_right(label_starts, mid) - 1
        name = "between queries"
        while k >= 0:
            la, lb, ln = labels[k]
            if la <= mid < lb:
                name = ln
                break
            if ln.endswith(".host"):
                break   # a query's own label encloses its spans
            k -= 1
        idle[name] += b - a
    breakdown = {
        "device_ops": [[n, t / 1e9] for n, t in sorted(
            by_name.items(), key=lambda x: -x[1])[:TOP]],
        "idle_gaps": [[n, t / 1e9] for n, t in sorted(
            idle.items(), key=lambda x: -x[1])[:TOP]]}
    return {"busy_s": busy_s, "busy_by_query": busy_by_query,
            "traced_window_s": (w1 - w0) / 1e9, "breakdown": breakdown}


def operator_times(session, sqls: Dict[str, str], device
                   ) -> Dict[str, Dict[str, float]]:
    """Seconds by physical operator type of one run of each query: the
    query runs once through the program (its re-plan loop converged, its
    scans cached), then its executed plan runs again with the card
    synchronised around every operator."""
    import torch
    from spark_tpu_torch.execution.executor import run_plan
    from spark_tpu_torch.plan import physical as P

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out: Dict[str, Dict[str, float]] = {}
    for q, text in sqls.items():
        qe = session.sql(text)._qe()
        qe.collect()
        ctx = P.ExecContext(session.conf, session.device)
        times: Dict[str, float] = collections.defaultdict(float)

        def visit(node, compute):
            sync()
            t0 = time.perf_counter()
            result = compute()
            sync()
            times[type(node).__name__] += time.perf_counter() - t0
            return result

        batch = run_plan(qe.executed_plan, ctx, visit)
        t0 = time.perf_counter()
        batch.to_arrow()
        times["egress"] += time.perf_counter() - t0
        out[q] = dict(times)
    return out
