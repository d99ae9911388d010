"""Reductions of the traced run: the profiler's device intervals per
query, the device's busy time, the idle gaps by the program's phase, and
each operator type's time from a synchronised pass over the converged
plan.

Device intervals are merged per card (the event's device index). A
query's busy time is the sum over the cards, in card-seconds; the
window's busy time is the mean over the cards; idle gaps are found on
each card, labelled, summed and divided by the number of cards, so that
they add up to the mean idle. With one card these are the union of its
intervals and its own gaps.

The operator pass on one card is a frozen copy of
`chip_smoke.breakdown`'s visitor: each physical operator computed under
`run_plan(..., visit=...)` with the card synchronised around it, the
host clock read on either side. On a mesh it is a frozen copy of
`chip_smoke.mesh_breakdown`'s timed `run_plan` (`mesh_operator_times`).
"""

from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

PREFIX = "bench:"
TOP = 10
_ANNOTATION = ("user_annotation", "gpu_user_annotation")
#: host events kept whatever launched: the harness's and the program's
#: ranges and the CUDA runtime calls
_KEPT = (PREFIX, "spark_tpu/", "cu")


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


@dataclass(slots=True)
class Ev:
    """One profiler event, in the fields the reductions read."""
    name: str
    device: bool            # on the card (else on the host)
    start: int              # ns, the profiler's clock
    end: int
    tid: int
    kind: str               # Kineto's activity type, where it gives one
    corr: int = 0
    linked: int = 0
    annotation: bool = False
    card: int = 0           # the device index of an event on a card


def events(prof) -> List[Ev]:
    """The profiler's raw events as `Ev`s, read once for every reduction:
    a 51 s window holds millions of events, and each field is a call
    into the profiler. Every device event is kept. A host event is kept
    when a reduction can use it: a range (`bench:`, `spark_tpu/`), a
    CUDA runtime call (`cu...`), or a torch op that launched device work
    (its correlation id is some device event's linked id); it reads no
    kind, annotation, linked id or card."""
    import torch
    # compared as ints: an enum comparison costs a call of its own
    cuda = int(torch.autograd.DeviceType.CUDA)
    raw = raw_events(prof)
    if raw and hasattr(raw[0], "start_ns"):
        def span(ev):
            start = ev.start_ns()
            return start, start + ev.duration_ns()
    else:
        def span(ev):
            start = _ns(ev, "start")
            return start, start + _ns(ev, "duration")
    if raw and not hasattr(raw[0], "start_thread_id"):
        def tid(ev):
            return 0
    else:
        def tid(ev):
            return int(ev.start_thread_id())
    on_card = [int(ev.device_type()) == cuda for ev in raw]
    out = []
    for ev, device in zip(raw, on_card):
        if not device:
            continue
        start, end = span(ev)
        kind = str(getattr(ev, "activity_type", lambda: "")())
        out.append(Ev(
            ev.name(), True, start, end, 0, kind, int(ev.correlation_id()),
            int(ev.linked_correlation_id()),
            bool(getattr(ev, "is_user_annotation", lambda: False)())
            or kind in _ANNOTATION, int(ev.device_index())))
    launched = {e.linked for e in out if e.linked}
    for ev, device in zip(raw, on_card):
        if device:
            continue
        name = ev.name()
        corr = int(ev.correlation_id())
        if not name.startswith(_KEPT) and corr not in launched:
            continue
        start, end = span(ev)
        out.append(Ev(name, False, start, end, tid(ev), "", corr))
    return out


def reduce_profile(prof, records: List[dict], anchor: Tuple[int, float],
                   timeline, cards: Sequence[int] = (0,)) -> dict:
    """`reduce_events` of a profile."""
    return reduce_events(events(prof), records, anchor, timeline, cards)


def reduce_events(evs: List[Ev], records: List[dict],
                  anchor: Tuple[int, float], timeline,
                  cards: Sequence[int] = (0,)) -> dict:
    """Busy time of the window and of each query, the device operations
    that took most time, and the idle gaps by what the host was doing.
    `cards` are the device indices of the run's cards: a card on which
    nothing ran still counts in the mean. With one card every device
    interval is that card's, whatever index the profiler gives it."""
    device_spans: Dict[int, List[Tuple[int, int]]] = {c: [] for c in cards}
    by_name: Dict[str, int] = collections.defaultdict(int)
    queries: Dict[int, Tuple[int, int]] = {}
    for ev in evs:
        if not ev.device:
            if ev.name.startswith(PREFIX):
                queries[int(ev.name.split(":")[1])] = (ev.start, ev.end)
            continue
        if ev.name.startswith(PREFIX) or ev.end <= ev.start \
                or ev.annotation:
            continue
        card = ev.card if len(cards) > 1 else cards[0]
        device_spans.setdefault(card, []).append((ev.start, ev.end))
        by_name[ev.name[:200]] += ev.end - ev.start
    unions = []
    for card in sorted(device_spans):
        union = _merge(device_spans[card])
        prefix = [0]
        for s, e in union:
            prefix.append(prefix[-1] + e - s)
        unions.append((union, [s for s, _ in union], prefix))
    n = len(unions)
    anchor_ns, anchor_perf = anchor

    def to_ns(t_perf: float) -> int:
        return anchor_ns + int((t_perf - anchor_perf) * 1e9)

    # each query's interval on the profiler's clock: its annotation, or
    # the host clock mapped through the anchor
    intervals = [queries.get(i, (to_ns(r["t0"]), to_ns(r["t1"])))
                 for i, r in enumerate(records)]
    busy_by_query = [sum(_covered(*u, a, b) for u in unions) / 1e9
                     for a, b in intervals]
    w0 = min((a for a, _ in intervals), default=0)
    w1 = max((b for _, b in intervals), default=0)
    busy_s = sum(_covered(*u, w0, w1) for u in unions) / n / 1e9
    busy_by_card = [_covered(*u, w0, w1) / 1e9 for u in unions]

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
    for union, _, _ in unions:
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
        "device_ops": [[name, t / 1e9] for name, t in sorted(
            by_name.items(), key=lambda x: -x[1])[:TOP]],
        "idle_gaps": [[name, t / n / 1e9] for name, t in sorted(
            idle.items(), key=lambda x: -x[1])[:TOP]]}
    return {"busy_s": busy_s, "busy_by_query": busy_by_query,
            "busy_s_by_card": busy_by_card,
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


def mesh_operator_times(session, sqls: Dict[str, str]):
    """`operator_times` on a mesh, and each exchange's seconds and bytes.
    The query runs once through the program (converged, scans cached),
    then once more with every operator of every shard timed on the host
    clock, the shard's card synchronised around it: an exchange's time
    includes its wait for the slowest shard at the rendezvous. An
    operator type's seconds are the slowest shard's total; an exchange's
    bytes are those its collectives copied between cards
    (`parallel.mesh.COPY_STATS`), and "gather" the result's. Returns
    ({q: {operator: s}}, {q: {exchange tag: {"seconds", "bytes"}}})."""
    import threading
    import torch
    import spark_tpu_torch.execution.executor as E
    from spark_tpu_torch.parallel import mesh as M

    def sync(device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    orig = E.run_plan
    operators: Dict[str, Dict[str, float]] = {}
    exchanges: Dict[str, Dict[str, Dict[str, float]]] = {}
    for q, text in sqls.items():
        session.sql(text).collect()
        per_shard: Dict[Tuple[int, str], float] = \
            collections.defaultdict(float)
        lock = threading.Lock()

        def timed_run_plan(root, ctx, visit=None, loaded=None):
            def timed(node, compute):
                sync(ctx.device)
                t0 = time.perf_counter()
                out = compute()
                sync(ctx.device)
                seconds = time.perf_counter() - t0
                name = type(node).__name__
                with lock:
                    per_shard[(ctx.shard_index, name)] += seconds
                    if name == "ExchangeExec":
                        per_shard[(ctx.shard_index,
                                   f"exchange {node.tag}")] += seconds
                return out
            return orig(root, ctx, timed, loaded)

        M.reset_copy_stats()
        E.run_plan = timed_run_plan
        try:
            session.sql(text).collect()
        finally:
            E.run_plan = orig
        slowest: Dict[str, float] = collections.defaultdict(float)
        for (_, name), seconds in per_shard.items():
            slowest[name] = max(slowest[name], seconds)
        copied = dict(M.COPY_STATS)
        operators[q] = {name: s for name, s in slowest.items()
                        if not name.startswith("exchange ")}
        exchanges[q] = {}
        for name, seconds in slowest.items():
            if name.startswith("exchange "):
                tag = name.split(" ")[1]
                exchanges[q][tag] = {
                    "seconds": seconds,
                    "bytes": sum(v[0] for k, v in copied.items()
                                 if k.split(" ")[-1] == tag)}
        if "gather" in copied:
            exchanges[q]["gather"] = {"seconds": None,
                                      "bytes": copied["gather"][0]}
    return operators, exchanges
