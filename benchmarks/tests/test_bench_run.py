"""The harness driven end to end on the CPU at a tiny scale: a
well-formed result line, the import guard, the exit without a card, and
`correct` coming out false when the timed path is broken underneath."""

import datetime
import json
import subprocess
import sys
from decimal import Decimal

import pyarrow as pa
import pytest

import harness

SEED = 3_000_000_019
TINY = 0.004


def tiny_run(cell, trace=False, seconds=0.5):
    return harness.run(cell, SEED, seconds, trace, device="cpu", scale=TINY,
                       workers=1)


def check_line(out, cell_name, trace):
    cell = harness.Cell(cell_name)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))


@pytest.mark.parametrize("cell", ["tpch-sf10.q1", "tpch-sf1.join"])
def test_dry_run_is_correct_and_well_formed(cell):
    out = tiny_run(cell)
    check_line(out, cell, trace=False)
    assert out["correct"] is True, out["checks"]


def test_traced_dry_run_reads_host_metrics():
    out = tiny_run("tpch-sf1.join", trace=True, seconds=0.2)
    check_line(out, "tpch-sf1.join", trace=True)
    assert out["correct"] is True
    for name in ("plan_ms", "egress_ms", "scan_cache_hit_share",
                 "cold_pass_s", "join_ms", "agg_ms"):
        assert out["metrics"][name]["value"] > 0, name
    # a CPU run reports no device metric
    assert "device_roofline" not in out["metrics"]
    assert "device_idle_share" not in out["metrics"]
    assert "window_s" in out["device"] and "busy_s" in out["device"]


@pytest.mark.parametrize("cell", ["tpch-sf10.q1", "tpch-sf1.join"])
def test_dry_run_loads_neither_jax_nor_the_jax_package(cell):
    code = (
        "import sys; sys.path[:0] = [{b!r}, {r!r}]\n"
        "import harness\n"
        "harness.run({c!r}, 5, 0.3, False, device='cpu', "
        "scale={s}, workers=1)\n"
        "print(harness.forbidden_modules())\n")
    code = code.format(b=str(harness.HERE), r=str(harness.ROOT), c=cell,
                       s=TINY)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_references_load_nothing_of_the_program():
    """Every reference and the yardstick, loaded in a fresh interpreter
    with nothing else imported, leave no module of the port, of JAX or
    of the JAX package in `sys.modules`."""
    refs = sorted(p.stem for p in (harness.HERE / "reference").glob("*.py"))
    assert refs
    code = (
        "import importlib.util, sys; sys.path.insert(0, {b!r})\n"
        "import yardstick\n"
        "for q in {q!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        'ref_' + q, {b!r} + '/reference/' + q + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
        "{{'spark_tpu_torch', 'spark_tpu', 'jax', 'jaxlib', 'flax'}}))\n")
    code = code.format(b=str(harness.HERE), q=refs)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "spark_tpu_torchlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "spark_tpu.session", sys)
    assert harness.forbidden_modules() == ["spark_tpu"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "tpch-sf10.q1", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=str(harness.ROOT))
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _altered(table: pa.Table) -> pa.Table:
    """The table with its first value changed by one unit."""
    if table.num_rows == 0:
        return table
    col = table.column(0)
    values = col.to_pylist()
    v = values[0]
    if isinstance(v, Decimal):
        v = v + Decimal(1).scaleb(-col.type.scale)
    elif isinstance(v, str):
        v = v + "x"
    elif isinstance(v, datetime.date):
        v = v + datetime.timedelta(days=1)
    else:
        v = v + 1
    values[0] = v
    return table.set_column(0, table.field(0),
                            pa.array(values, col.type))


@pytest.mark.parametrize("cell", ["tpch-sf10.q1", "tpch-sf1.join"])
def test_an_answer_altered_at_egress_is_not_correct(cell, monkeypatch):
    from spark_tpu_torch import columnar
    to_arrow = columnar.Batch.to_arrow
    monkeypatch.setattr(columnar.Batch, "to_arrow",
                        lambda self: _altered(to_arrow(self)))
    out = tiny_run(cell)
    assert out["correct"] is False
    assert sum(c["value"] for c in out["checks"].values()) > 0


@pytest.mark.parametrize("cell", ["tpch-sf10.q1", "tpch-sf1.join"])
def test_half_the_rows_left_out_at_ingest_is_not_correct(cell, monkeypatch):
    from spark_tpu_torch import columnar
    from_arrow = columnar.Batch.from_arrow

    def half(table, *a, **k):
        return from_arrow(table.slice(0, (table.num_rows + 1) // 2), *a, **k)
    monkeypatch.setattr(columnar.Batch, "from_arrow", staticmethod(half))
    out = tiny_run(cell)
    assert out["correct"] is False


def test_a_failing_query_is_not_correct(monkeypatch):
    from spark_tpu_torch import session as S
    sql = S.SparkTpuSession.sql
    calls = {"n": 0}

    def flaky(self, text):
        calls["n"] += 1
        if calls["n"] == 6:
            raise RuntimeError("injected")
        return sql(self, text)
    monkeypatch.setattr(S.SparkTpuSession, "sql", flaky)
    out = tiny_run("tpch-sf10.q1", seconds=1.0)
    assert out["failed"] == 1 and out["correct"] is False


@pytest.mark.cuda
def test_cell_on_the_card_is_correct(card):
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "tpch-sf1.join", "--seed", "77", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["metrics"]["device_roofline"]["value"] <= 100
