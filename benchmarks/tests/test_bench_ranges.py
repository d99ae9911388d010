"""The reductions of the program's own profiler ranges
(`program_ranges.py`, `trace_ranges.py`): a kernel goes to the
innermost range around its launch, GPU-side annotations are never busy
time, `tracing.reduce_profile` and the existing readers read a trace the
same with the ranges in it as without, and a traced CPU run reads
`parse_ms` and no device figure."""

import json

import pytest
import torch

import harness
import program_ranges
import tracing
from program_ranges import Ev

SEED = 3_000_000_037
TINY = 0.004


def cpu(name, start, end, tid=1, kind="cpu_op", corr=0, linked=0):
    return Ev(name, False, start, end, tid, kind, corr, linked,
              annotation=kind == "user_annotation")


def gpu(name, start, end, corr=0, linked=0, kind="kernel"):
    return Ev(name, True, start, end, 7, kind, corr, linked,
              annotation=kind == "gpu_user_annotation")


def synthetic():
    """One window query: a dispatch range holding a join and an aggregate
    range. A kernel launched by a torch op inside the join, one launched
    by a bare runtime call (a thread numbered apart) inside the
    aggregate, one launched inside dispatch outside any operator, a
    host sync inside the aggregate, and the GPU-side annotation of the
    join's range across all of it."""
    return [
        cpu("bench:0:q3", 0, 1000, kind="user_annotation"),
        cpu("spark_tpu/dispatch", 100, 900, kind="user_annotation"),
        cpu("spark_tpu/op:JoinExec", 150, 400, kind="user_annotation"),
        cpu("spark_tpu/op:HashAggregateExec", 400, 600,
            kind="user_annotation"),
        cpu("aten::cummax", 200, 250, corr=11),
        cpu("cudaLaunchKernel", 210, 215, tid=999, kind="cuda_runtime",
            corr=501, linked=11),
        gpu("scan_kernel", 300, 500, corr=501, linked=11),
        cpu("cudaStreamSynchronize", 420, 430, tid=999,
            kind="cuda_runtime", corr=503),
        cpu("cudaLaunchKernel", 450, 455, tid=999, kind="cuda_runtime",
            corr=502),
        gpu("dense_sums_private_kernel", 520, 580, corr=502),
        cpu("aten::copy_", 650, 660, corr=12),
        gpu("Memcpy DtoH", 700, 750, corr=504, linked=12,
            kind="gpu_memcpy"),
        gpu("spark_tpu/op:JoinExec", 300, 700, kind="gpu_user_annotation"),
    ]


def test_kernels_go_to_the_innermost_range_around_their_launch():
    evs = synthetic()
    owner = program_ranges.attribute(evs)
    got = {evs[i].name: r.name for i, r in owner.items()}
    assert got == {"scan_kernel": "spark_tpu/op:JoinExec",
                   "dense_sums_private_kernel":
                       "spark_tpu/op:HashAggregateExec",
                   "Memcpy DtoH": "spark_tpu/dispatch"}


def test_reduction_of_a_synthetic_window():
    out = program_ranges.reduce_events(
        synthetic(), [{"q": "q3", "ok": True}], span_starts=[[103]])
    # busy: the three pieces of work, not the annotation over 300-700
    assert out["busy_s"] == pytest.approx((200 + 60 + 50) / 1e9)
    assert out["join_device_ms"] == pytest.approx(200 / 1e6)
    assert out["agg_device_ms"] == pytest.approx(60 / 1e6)
    assert out["op_share_of_dispatch_busy"] == pytest.approx(260 / 310)
    # idle 0-300, 500-520, 580-700, 750-1000: every midpoint in dispatch
    assert out["dispatch_idle_ms"] == pytest.approx(690 / 1e6)
    assert out["idle_by_range_s"] == pytest.approx({
        "dispatch": 370 / 1e9, "op:JoinExec": 300 / 1e9,
        "op:HashAggregateExec": 20 / 1e9})
    assert out["dispatch_in_bench_share"] == 1.0
    assert out["operators"]["op:JoinExec"] == pytest.approx(
        {"device_ms": 200 / 1e6, "launch_ms": 250 / 1e6, "syncs": 0})
    assert out["operators"]["op:HashAggregateExec"]["syncs"] == 1
    assert out["dispatch_offset_us"] == {"median": 0.003, "max": 0.003,
                                         "n": 1}


def test_a_trace_without_program_ranges_gives_no_figure():
    evs = [e for e in synthetic() if not e.name.startswith("spark_tpu/")]
    assert program_ranges.reduce_events(evs, [{"q": "q3", "ok": True}]) \
        == {}


class _Raw:
    """A raw profiler event as `tracing.reduce_profile` reads one."""

    def __init__(self, ev: Ev):
        self.ev = ev

    def name(self):
        return self.ev.name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.ev.device \
            else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self.ev.start

    def duration_ns(self):
        return self.ev.end - self.ev.start

    def is_user_annotation(self):
        return self.ev.annotation

    def correlation_id(self):
        return self.ev.corr

    def start_thread_id(self):
        return self.ev.tid

    def activity_type(self):
        return self.ev.kind

    def linked_correlation_id(self):
        return self.ev.linked

    def device_index(self):
        return 0


class _Prof:
    def __init__(self, evs):
        results = type("R", (), {"events": lambda _self: [
            _Raw(e) for e in evs]})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_events_read_from_the_profile_reduce_as_the_trace_does():
    """`tracing.events` keeps every event a reduction reads: the figures
    from the raw profile equal those from the trace's events as they
    are, with an op that launched nothing and a foreign range dropped."""
    evs = synthetic() + [cpu("aten::empty", 220, 230, corr=13),
                         cpu("other range", 0, 1000,
                             kind="user_annotation")]
    read = tracing.events(_Prof(evs))
    assert {e.name for e in read} == \
        {e.name for e in evs} - {"aten::empty", "other range"}
    records = [{"q": "q3", "t0": 0.0, "t1": 1e-6, "ok": True}]
    assert program_ranges.reduce_events(read, records, [[100]]) == \
        program_ranges.reduce_events(evs, records, [[100]])
    assert tracing.reduce_events(read, records, (0, 0.0), None) == \
        tracing.reduce_events(evs, records, (0, 0.0), None)


@pytest.mark.parametrize("with_ranges", [False, True])
def test_reduce_profile_and_readers_ignore_the_program_ranges(with_ranges):
    """`reduce_profile` and the device readers give the same values
    whether or not the trace holds the program's ranges (their CPU side
    and the GPU-side annotations)."""
    evs = synthetic()
    plain = [e for e in evs if not e.name.startswith("spark_tpu/")]
    records = [{"q": "q3", "t0": 0.0, "t1": 1e-6, "ok": True}]

    def read(events):
        ctx = {"records": records, "bytes_by_query": {"q3": 1000}}
        ctx.update(tracing.reduce_profile(_Prof(events), records, (0, 0.0),
                                          None))
        return ctx, {m: harness.load_module("metrics", m).read(ctx)
                     for m in ("device_idle_share", "device_roofline")}

    base, base_m = read(plain)
    got, got_m = read(evs if with_ranges else plain)
    assert got["busy_s"] == base["busy_s"] == pytest.approx(310 / 1e9)
    assert got["busy_by_query"] == base["busy_by_query"]
    assert got["traced_window_s"] == base["traced_window_s"]
    assert got["breakdown"] == base["breakdown"]
    assert got_m == base_m


def test_traced_cpu_run_reads_parse_ms_and_no_device_figure():
    import trace_ranges
    out, found = trace_ranges.run_traced(
        "tpch-sf1.join", SEED, 0.2, device="cpu", scale=TINY, workers=1)
    assert out["correct"] is True
    assert out["metrics"]["parse_ms"]["value"] > 0
    assert out["metrics"]["plan_ms"]["value"] > 0
    # the CPU profile holds the program's ranges, and no device work
    assert found["dispatch_ranges"] >= out["attempted"]
    assert found["dispatch_in_bench_share"] == 1.0
    for name in ("join_device_ms", "agg_device_ms", "dispatch_idle_ms",
                 "busy_s"):
        assert found.get(name) is None, name
    json.loads(json.dumps(found))
