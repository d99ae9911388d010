"""Cells across cards: a cell's `chips` must match its configuration's
mesh, a four-chip cell runs the port's mesh (here pinned to the CPU at a
tiny scale), and the traced reduction works per card."""

import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import harness
import tracing

device_idle_share = harness.load_module("metrics", "device_idle_share")
device_roofline = harness.load_module("metrics", "device_roofline")

SEED = 3_000_000_019
TINY = 0.004
MESH_CELL = "tpch-sf1.mesh4"


def layout(tmp_path, chips, mesh):
    """A copy of the benchmark's files with one more cell: the `join` mix
    on `tpch-sf1` at `chips` cards, its configuration setting
    `mesh.size` to `mesh` (None: not set), listed wherever the one-card
    join cell is."""
    bench = tmp_path / "benchmarks"
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = harness.load_json(bench / "configs" / "tpch-sf1.json")
    config["conf"] = {} if mesh is None else {harness.MESH_KEY: mesh}
    (bench / "configs" / "tpch-sf1-mesh.json").write_text(json.dumps(config))
    (bench / "cells" / f"{MESH_CELL}.json").write_text(json.dumps(
        {"config": "tpch-sf1-mesh", "mix": "join", "chips": chips,
         "why": "the join mix on a mesh"}))
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tpch-sf1.join" in m.get("workloads", []):
            m["workloads"].append(MESH_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


@pytest.fixture
def mesh_cell(tmp_path, monkeypatch):
    """The four-chip cell in a copy of the layout, and the shard counts
    of every `run_plan` call the port makes."""
    bench = layout(tmp_path, chips=4, mesh=4)
    monkeypatch.setattr(harness, "HERE", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    from spark_tpu_torch.execution import executor
    shards = []
    run_plan = executor.run_plan

    def counted(root, ctx, *args, **kwargs):
        shards.append(ctx.n_shards)
        return run_plan(root, ctx, *args, **kwargs)
    monkeypatch.setattr(executor, "run_plan", counted)
    return shards


@pytest.mark.parametrize("trace", [False, True])
def test_a_four_chip_cell_runs_a_four_shard_mesh(mesh_cell, trace):
    out = harness.run(MESH_CELL, SEED, 0.3, trace, device="cpu",
                      scale=TINY, workers=1)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["count"] == 4
    # pinned: every shard on the one device, so one peak and no list
    assert "memory_peak_bytes_by_card" not in out["device"]
    assert max(mesh_cell) == 4
    cell = harness.Cell(MESH_CELL)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) <= {m["name"] for m in want}
    if trace:
        for name in ("join_ms", "agg_ms", "plan_ms"):
            assert out["metrics"][name]["value"] > 0, name
    else:
        assert set(out["metrics"]) == {m["name"] for m in want}
    json.loads(json.dumps(out))


@pytest.mark.parametrize("chips,mesh", [(4, None), (4, 2), (1, 2)])
def test_a_mesh_that_disagrees_with_the_chips_raises(tmp_path, monkeypatch,
                                                     chips, mesh):
    bench = layout(tmp_path, chips=chips, mesh=mesh)
    monkeypatch.setattr(harness, "HERE", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    with pytest.raises(ValueError) as e:
        harness.Cell(MESH_CELL)
    assert f"{chips} chips" in str(e.value)
    assert f"to {mesh or 1}" in str(e.value)


def test_run_exits_nonzero_without_a_result_on_a_disagreeing_mesh(tmp_path):
    bench = layout(tmp_path, chips=4, mesh=None)
    out = subprocess.run(
        [sys.executable, str(bench / "run.py"), "--workload", MESH_CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "4 chips" in out.stderr and "to 1" in out.stderr


def test_cards_of_a_run():
    pinned = SimpleNamespace(device=torch.device("cpu"), device_pinned=True)
    assert harness._cards(pinned, 4) == [torch.device("cpu")]
    one = SimpleNamespace(device=torch.device("cuda:0"), device_pinned=True)
    assert harness._cards(one, 1) == [torch.device("cuda:0")]
    free = SimpleNamespace(device=torch.device("cuda:0"),
                           device_pinned=False)
    assert harness._cards(free, 4) == [torch.device("cuda", i)
                                       for i in range(4)]
    assert harness._peak([torch.device("cpu")]) == [0]


class Event:
    """A raw profiler event as `tracing.reduce_profile` reads it."""

    def __init__(self, name, start, end, card=None, annotation=False):
        self._name, self._start, self._end = name, start, end
        self._card, self._annotation = card, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        kind = torch.autograd.DeviceType
        return kind.CPU if self._card is None else kind.CUDA

    def device_index(self):
        return -1 if self._card is None else self._card

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return 0

    def linked_correlation_id(self):
        return 0


def profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


US = 1000
#: two queries' ranges on the host, and card 0's kernels: union
#: [10, 50] + [60, 70] in the first query, [130, 190] in the second (us)
QUERIES = [Event("bench:0:q3", 0, 100 * US),
           Event("bench:1:q5", 120 * US, 200 * US)]
KERNELS = [("gather", 10, 30), ("sort", 20, 50), ("gather", 60, 70),
           ("sort", 130, 190)]
RECORDS = [{"q": "q3", "t0": 0.0, "t1": 1e-4, "ok": True},
           {"q": "q5", "t0": 1.2e-4, "t1": 2e-4, "ok": True}]


def kernels(card):
    return [Event(n, s * US, e * US, card) for n, s, e in KERNELS]


def reduce(events, cards):
    return tracing.reduce_profile(profile(events), RECORDS, (0, 0.0), None,
                                  cards)


def test_one_card_reads_as_one_union():
    noise = [Event("annotation", 0, 200 * US, 0, annotation=True),
             Event("empty", 80 * US, 80 * US, 0),
             Event("on another index", 75 * US, 78 * US, 3)]
    out = reduce(QUERIES + kernels(0) + noise, [0])
    assert out["busy_by_query"] == [53 * US / 1e9, 60 * US / 1e9]
    assert out["busy_s"] == 113 * US / 1e9
    assert out["traced_window_s"] == 200 * US / 1e9
    assert out["breakdown"]["device_ops"] == [
        ["sort", 90 * US / 1e9], ["gather", 30 * US / 1e9],
        ["on another index", 3 * US / 1e9]]
    # gaps [0,10] [50,60] [70,75] in q3, [78,130] over the boundary (its
    # midpoint 104 between the queries), [190,200] in q5
    assert out["breakdown"]["idle_gaps"] == [
        ["between queries", 52 * US / 1e9], ["q3.host", 25 * US / 1e9],
        ["q5.host", 10 * US / 1e9]]


def test_two_cards_average_the_idle_and_count_card_seconds():
    one = reduce(QUERIES + kernels(0), [0])
    idle = reduce(QUERIES + kernels(0), [0, 1])
    ctx = {"traced_window_s": idle["traced_window_s"]}
    share_0 = 100 * (1 - 110 / 200)
    share_1 = 100.0
    got = device_idle_share.read({**ctx, "busy_s": idle["busy_s"]})
    assert got == pytest.approx((share_0 + share_1) / 2, rel=1e-12)
    assert idle["busy_by_query"] == one["busy_by_query"]
    assert sum(t for _, t in idle["breakdown"]["idle_gaps"]) == \
        pytest.approx(idle["traced_window_s"] - idle["busy_s"], rel=1e-12)

    # the same kernels on both cards: twice the card-seconds, so the same
    # bytes read half the roofline of one card
    both = reduce(QUERIES + kernels(0) + kernels(1), [0, 1])
    assert both["busy_by_query"] == [2 * b for b in one["busy_by_query"]]
    assert both["busy_s"] == one["busy_s"]
    bytes_by_query = {"q3": 1e6, "q5": 2e6}

    def roofline(reduced):
        return device_roofline.read({"records": RECORDS,
                                     "busy_by_query": reduced["busy_by_query"],
                                     "bytes_by_query": bytes_by_query})
    assert roofline(both) == pytest.approx(roofline(one) / 2, rel=1e-12)
    assert both["breakdown"]["idle_gaps"] == one["breakdown"]["idle_gaps"]
