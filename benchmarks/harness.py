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


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    """The allocator's peak since the last call, then reset: the peak of
    one stage of the run."""
    import torch
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", scale: Optional[float] = None,
        workers: Optional[int] = None, t_start: Optional[float] = None
        ) -> dict:
    """One run of a cell; returns the result line as a dict. `scale`
    overrides the configuration's scale factor (the CPU tests' tiny
    runs), `workers` the generator's threads."""
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
    session = builder.device(device).get_or_create()
    dev = session.device
    torch.zeros(1, device=dev)
    _sync(dev)
    cuda_s = time.perf_counter() - t_gen
    session.warmup()
    _sync(dev)
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
        _sync(dev)
    cold_pass_s = time.perf_counter() - t0
    peaks = {"cold": _peak(dev)}
    t0 = time.perf_counter()
    for q in cell.queries:
        keep(q, session.sql(sqls[q]).collect())
        _sync(dev)
    warm_s = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    peaks["warm"] = _peak(dev)

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
                    _sync(dev)
            else:
                table = session.sql(sqls[q]).collect()
                _sync(dev)
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
    if prof is not None:
        prof.__exit__(None, None, None)
    cache1 = CACHE.stats()
    peaks["window"] = _peak(dev)
    peak = max(peaks.values())

    done = [r for r in records if r["ok"]]
    lat_ms = sorted((r["t1"] - r["t0"]) * 1e3 for r in records)
    e2e = {"queries_per_s": (len(done) / window_s, "queries/s"),
           "latency_p95_ms": (statistics.quantiles(lat_ms, n=20)[18]
                              if len(lat_ms) >= 2 else lat_ms[0], "ms"),
           "setup_s": (setup_s, "s")}

    ctx = {"records": records, "cold_pass_s": cold_pass_s,
           "cache": (cache0, cache1), "timeline": timeline}
    if trace:
        import tracing
        ctx.update(tracing.reduce_profile(prof, records, anchor, timeline))
        del prof
        ctx["operators"] = tracing.operator_times(session, sqls, dev)

    # free the program's state before the reference runs
    CACHE.clear()
    del session
    gc.collect()
    if dev.type == "cuda":
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
          f"cold pass {peaks['cold'] / 2**30:.3f}, warm pass "
          f"{peaks['warm'] / 2**30:.3f}, window "
          f"{peaks['window'] / 2**30:.3f}; params "
          f"{json.dumps(params, sort_keys=True)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)

    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu",
                      "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        out["device"]["busy_s"] = ctx["busy_s"]
        out["device"]["window_s"] = ctx["traced_window_s"]
        if breakdown:
            out["breakdown"] = breakdown
    out["checks"] = checks
    return out
