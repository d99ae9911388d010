"""One run of one benchmark cell: set-up, the measured window, the
traced readings and the check against the plain references.

Everything a cell is made of is found by name under this directory:
`cells/<cell>.json` (its configuration, traffic mix and chips),
`configs/<config>.json` (scale factor and the port's settings),
`mixes/<mix>.json` (the queries in order and their parameter ranges),
`queries/<q>.sql` (the query text with `{PARAM}` slots),
`reference/<q>.py` (the plain answer, its float64 control and the
query's byte bound) and `metrics/<metric>.py` (one reader a per-layer
metric). The metric lists come from `BENCHMARK.json` at the checkout
root.

A cell's `chips` is the number of cards it runs on. At 1 the session is
pinned to the device `run` is given (`cuda:0` from `run.py`). At N > 1
the configuration sets `spark_tpu.sql.mesh.size` to N and `run.py`
builds the session without a device, so the port's mesh places its
shards on cuda:0 to cuda:N-1; every card is synchronised and its peak
read, and the traced readings are reduced per card (`tracing.py`). A
device given to `run` (the CPU tests' "cpu") still pins every shard of
such a mesh to it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_tpu")
#: the port's conf key for the number of shards of a query's mesh
MESH_KEY = "spark_tpu.sql.mesh.size"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under this directory, as a module."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Cell:
    """A cell as its files describe it."""

    def __init__(self, name: str):
        self.name = name
        spec = load_json(HERE / "cells" / f"{name}.json")
        self.chips = int(spec["chips"])
        self.config = load_json(HERE / "configs" / f"{spec['config']}.json")
        mesh = int(self.config.get("conf", {}).get(MESH_KEY, 1))
        if mesh != self.chips:
            raise ValueError(
                f"cell {name} asks for {self.chips} chips but its "
                f"configuration {spec['config']} sets {MESH_KEY} to {mesh}: "
                f"a cell runs one shard a card")
        self.mix = load_json(HERE / "mixes" / f"{spec['mix']}.json")
        self.queries: List[str] = list(self.mix["queries"])
        self.texts = {q: (HERE / "queries" / f"{q}.sql").read_text()
                      for q in self.queries}
        self.refs = {q: load_module("reference", q) for q in self.queries}
        bench = load_json(ROOT / "BENCHMARK.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def columns(self) -> Dict[str, List[str]]:
        """Every column, in the schema's order, of each table the
        cell's queries read: the tables as wide as TPC-H defines them."""
        from datagen import SCHEMA
        tables = {t for ref in self.refs.values() for t in ref.TABLES}
        return {t: list(SCHEMA[t]) for t in sorted(tables)}

    def params(self, seed: int) -> Dict[str, Dict[str, str]]:
        """The substitution parameters of each query, drawn once from
        the seed in the mix's order, fixed for the run."""
        rng = random.Random(int(seed))
        out = {}
        for q in self.queries:
            out[q] = {}
            for name, spec in sorted(self.mix["params"].get(q, {}).items()):
                if "int" in spec:
                    lo, hi = spec["int"]
                    out[q][name] = str(rng.randint(lo, hi))
                else:
                    out[q][name] = rng.choice(spec["choice"])
        return out


class Timeline:
    """Each query's phase times and spans, from the program's
    `on_query_end` events (the traced run only)."""

    def __init__(self):
        self.events: List[dict] = []

    def listener(self):
        from spark_tpu_torch.observability.listener import QueryListener
        timeline = self

        class _Listener(QueryListener):
            def on_query_end(self, event) -> None:
                spans = getattr(event.spans, "spans", [])
                timeline.events.append({
                    "query_id": event.query_id, "status": event.status,
                    "phase_times_s": dict(event.event.get("phase_times_s",
                                                          {})),
                    "spans": [(s.name, s.t0, s.t1) for s in spans]})
        return _Listener()


def _sync(cards) -> None:
    """Wait for every card of the run."""
    import torch
    for card in cards:
        if card.type == "cuda":
            torch.cuda.synchronize(card)


def _peak(cards) -> List[int]:
    """Each card's allocator peak since the last call, then reset: the
    peaks of one stage of the run."""
    import torch
    peaks = []
    for card in cards:
        if card.type != "cuda":
            peaks.append(0)
            continue
        peaks.append(torch.cuda.max_memory_allocated(card))
        torch.cuda.reset_peak_memory_stats(card)
    return peaks


def _cards(session, chips: int):
    """The devices the run's shards sit on: the session's own where it
    was built with one (every shard of a pinned mesh on it), else the
    cards cuda:0 to cuda:chips-1 of the port's mesh."""
    import torch
    if session.device_pinned or chips == 1:
        return [session.device]
    return [torch.device("cuda", i) for i in range(chips)]


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: Optional[str] = "cuda", scale: Optional[float] = None,
        workers: Optional[int] = None, t_start: Optional[float] = None
        ) -> dict:
    """One run of a cell; returns the result line as a dict. `device`
    pins the session (and every shard of a mesh) to one device; None
    leaves a mesh cell's shards on cuda:0 to cuda:N-1. `scale` overrides
    the configuration's scale factor (the CPU tests' tiny runs),
    `workers` the generator's threads."""
    t_start = t_start if t_start is not None else time.perf_counter()
    cell = Cell(cell_name)
    sf = float(scale if scale is not None else cell.config["scale_factor"])
    params = cell.params(seed)
    sqls = {q: cell.texts[q].format(**params[q]) for q in cell.queries}

    import datagen
    box: Dict[str, object] = {}

    def generate():
        try:
            box["tables"] = datagen.generate(sf, seed, cell.columns(),
                                             workers)
        except BaseException as e:  # re-raised in the caller below
            box["error"] = e

    gen = threading.Thread(target=generate, name="datagen")
    t_gen = time.perf_counter()
    pre_s = t_gen - t_start
    gen.start()
    # while the threads generate: CUDA start-up and the kernel library
    import torch
    from spark_tpu_torch.io.device_cache import CACHE
    from spark_tpu_torch.session import SparkTpuSession
    builder = SparkTpuSession.builder()
    for key, value in cell.config.get("conf", {}).items():
        builder = builder.config(key, value)
    if device is not None:
        builder = builder.device(device)
    session = builder.get_or_create()
    dev = session.device
    cards = _cards(session, cell.chips)
    for card in cards:
        torch.zeros(1, device=card)
    _sync(cards)
    cuda_s = time.perf_counter() - t_gen
    session.warmup()
    _sync(cards)
    library_s = time.perf_counter() - t_gen - cuda_s
    gen.join()
    if "error" in box:
        raise box["error"]
    tables = box.pop("tables")
    gen_s = time.perf_counter() - t_gen
    t0 = time.perf_counter()
    for name, table in tables.items():
        session.register_table(name, table)
    register_s = time.perf_counter() - t0

    answers: Dict[str, List] = {q: [] for q in cell.queries}

    def keep(q, table) -> None:
        if not any(table.equals(a) for a in answers[q]):
            answers[q].append(table)

    # the cold pass: each query's first run (Arrow to the card, planning
    # from nothing), then one warm pass
    t0 = time.perf_counter()
    for q in cell.queries:
        keep(q, session.sql(sqls[q]).collect())
        _sync(cards)
    cold_pass_s = time.perf_counter() - t0
    peaks = {"cold": _peak(cards)}
    t0 = time.perf_counter()
    for q in cell.queries:
        keep(q, session.sql(sqls[q]).collect())
        _sync(cards)
    warm_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    peaks["warm"] = _peak(cards)

    timeline = Timeline() if trace else None
    if trace:
        session.add_listener(timeline.listener())
    cache0 = CACHE.stats()
    records = []
    attempted = failed = 0
    errors: List[str] = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    anchor = (time.time_ns(), time.perf_counter())
    t_win = time.perf_counter()
    i = 0
    while time.perf_counter() - t_win < seconds:
        q = cell.queries[i % len(cell.queries)]
        attempted += 1
        t_q = time.perf_counter()
        try:
            if trace:
                from torch.profiler import record_function
                with record_function(f"bench:{i}:{q}"):
                    table = session.sql(sqls[q]).collect()
                    _sync(cards)
            else:
                table = session.sql(sqls[q]).collect()
                _sync(cards)
        except Exception as e:  # noqa: BLE001 — a failed query is counted
            failed += 1
            errors.append(f"{q}: {type(e).__name__}: {e}"[:300])
            records.append({"q": q, "t0": t_q, "t1": time.perf_counter(),
                            "ok": False})
        else:
            records.append({"q": q, "t0": t_q, "t1": time.perf_counter(),
                            "ok": True})
            keep(q, table)
        i += 1
    window_s = time.perf_counter() - t_win
    # seconds of each step that reads the trace, after the window
    trace_steps: Dict[str, float] = {}
    if prof is not None:
        prof.__exit__(None, None, None)
        trace_steps["profiler stop"] = time.perf_counter() - t_win - window_s
    cache1 = CACHE.stats()
    peaks["window"] = _peak(cards)
    # each card's peak over the stages; the run's is the fullest card's
    by_card = [max(p) for p in zip(*peaks.values())]
    peak = max(by_card)

    done = [r for r in records if r["ok"]]
    lat_ms = sorted((r["t1"] - r["t0"]) * 1e3 for r in records)
    e2e = {"queries_per_s": (len(done) / window_s, "queries/s"),
           "latency_p95_ms": (statistics.quantiles(lat_ms, n=20)[18]
                              if len(lat_ms) >= 2 else lat_ms[0], "ms"),
           "setup_s": (setup_s, "s")}

    ctx = {"records": records, "cold_pass_s": cold_pass_s,
           "cache": (cache0, cache1), "timeline": timeline}
    if trace:
        import program_ranges
        import tracing
        t0 = time.perf_counter()
        evs = tracing.events(prof)
        del prof
        trace_steps["reading events"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx.update(tracing.reduce_events(
            evs, records, anchor, timeline, [c.index or 0 for c in cards]))
        trace_steps["device reduction"] = time.perf_counter() - t0
        # the program's own ranges, under a key of their own: their
        # window and busy time must not replace the per-card ones above
        t0 = time.perf_counter()
        ctx["ranges"] = program_ranges.reduce_events(
            evs, records,
            program_ranges.dispatch_starts(records, anchor, timeline))
        del evs
        trace_steps["program ranges"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if cell.chips > 1:
            ctx["operators"], ctx["exchanges"] = \
                tracing.mesh_operator_times(session, sqls)
        else:
            ctx["operators"] = tracing.operator_times(session, sqls, dev)
        trace_steps["operator pass"] = time.perf_counter() - t0

    # free the program's state before the reference runs
    CACHE.clear()
    del session
    gc.collect()
    for card in cards:
        if card.type == "cuda":
            with torch.cuda.device(card):
                torch.cuda.empty_cache()

    from yardstick import Tables, Widths, to_rows, wrong_values
    t_ref = time.perf_counter()
    t = Tables(tables)
    checks: Dict[str, dict] = {}
    bytes_by_query: Dict[str, int] = {}
    widths = Widths(t)
    for q in cell.queries:
        want = cell.refs[q].answer(t, params[q])
        wrong = sum(wrong_values(to_rows(a), want) for a in answers[q])
        if not answers[q]:
            wrong += max(1, len(want.rows))
        checks[f"wrong_values.{q}"] = {"value": wrong, "limit": 0}
        if trace:
            bytes_by_query[q] = cell.refs[q].bytes_moved(
                t, params[q], widths, want)
    checks["failed_queries"] = {"value": failed, "limit": 0}
    ref_s = time.perf_counter() - t_ref
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in cell.end_to_end:
        value, unit = e2e[m["name"]]
        metrics[m["name"]] = {"value": value, "unit": unit}
    breakdown = None
    if trace:
        ctx["bytes_by_query"] = bytes_by_query
        metrics = {}
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = ctx.get("breakdown")

    for line in errors[:5]:
        print(f"query failed: {line}", file=sys.stderr)
    print(f"set-up {setup_s:.3f} s (interpreter, imports and card check "
          f"{pre_s:.3f}; device start-up {cuda_s:.3f} and kernel library "
          f"{library_s:.3f} beside generation, both {gen_s:.3f}; "
          f"registering {register_s:.3f}; cold pass {cold_pass_s:.3f}; "
          f"warm pass {warm_s:.3f}); window {window_s:.3f} s, {len(done)} of "
          f"{attempted} queries; reference {ref_s:.3f} s; device peak GiB "
          f"cold pass {max(peaks['cold']) / 2**30:.3f}, warm pass "
          f"{max(peaks['warm']) / 2**30:.3f}, window "
          f"{max(peaks['window']) / 2**30:.3f}; params "
          f"{json.dumps(params, sort_keys=True)}", file=sys.stderr)
    if trace_steps:
        print("trace read after the window, s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in trace_steps.items()), file=sys.stderr)
    if len(cards) > 1:
        print("device peak GiB by card: " + ", ".join(
            f"{c} {p / 2**30:.3f}" for c, p in zip(cards, by_card)),
            file=sys.stderr)
    if trace and cell.chips > 1:
        print("busy s by card: " + ", ".join(
            f"{c} {b:.4f}" for c, b in zip(cards, ctx["busy_s_by_card"]))
            + f" of {ctx['traced_window_s']:.4f}", file=sys.stderr)
        for q in cell.queries:
            ops = ", ".join(f"{n} {s * 1e3:.3f}" for n, s in sorted(
                ctx["operators"][q].items(), key=lambda x: -x[1]))
            moved = ", ".join(
                f"{tag} {x['bytes']} B" + (f" {x['seconds'] * 1e3:.3f} ms"
                                           if x["seconds"] is not None
                                           else "")
                for tag, x in ctx["exchanges"][q].items())
            print(f"{q} operators ms (slowest shard): {ops}; exchanges: "
                  f"{moved or 'none'}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)

    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu",
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if len(cards) > 1:
        out["device"]["memory_peak_bytes_by_card"] = by_card
    if trace:
        out["device"]["busy_s"] = ctx["busy_s"]
        out["device"]["window_s"] = ctx["traced_window_s"]
        if len(cards) > 1:
            out["device"]["busy_s_by_card"] = ctx["busy_s_by_card"]
        if breakdown:
            out["breakdown"] = breakdown
    out["checks"] = checks
    return out
