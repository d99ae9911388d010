"""The port's source lints (`spark_tpu_torch/analysis/lints/`, run by
`python -m spark_tpu_torch.analysis.lints --all`) against the JAX
package's (`spark_tpu/analysis/lints/`), on the CPU.

Each of the six passes gets a seeded synthetic violation in a temporary
repository. Where the pass is the same in both packages, the same
source goes under each package's tree (`spark_tpu_torch/...` for the
port, `spark_tpu/...` for the JAX package; a port test file is named
`tests/test_torch_*.py`, the only tests the port lints) and both must
report the same lines and messages, package paths put aside. Where the
port's pass differs on purpose the test says how:

- `tracer-leak` knows torch: a `torch.*` call or a tensor reduction
  (`.all()`, `.any()`, `.item()`) under `bool()` is device data, where
  the JAX package knows `jnp`/`lax`; its sites kept on purpose carry a
  reason in `TRACER_LEAK_WAIVERS`;
- `readme-metrics` reads the port's own table in README.md;
- `conf-key` lets the port's tests name the JAX package's keys that the
  port lists as not its own (they set them on JAX sessions), and lets
  the package read such a key only under a reasoned waiver.

Then the CLI's JSON shape and exit status, and the real port tree clean
under every pass.
"""

import json
import os
import subprocess
import sys

import pytest

from spark_tpu.analysis import lints as ref_lints
from spark_tpu_torch.analysis import lints as port_lints
from spark_tpu_torch.analysis.lints import passes as port_passes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = {"port": "spark_tpu_torch/", "jax": "spark_tpu/"}
LINTS = {"port": port_lints, "jax": ref_lints}


def _tmp_repo(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return str(tmp_path)


def _run(pkg, tmp_path, passes, files):
    """`files`: {path with `{pkg}` for the package dir and `{test}` for a
    test-file name: source}."""
    test = "test_torch_x" if pkg == "port" else "test_x"
    repo = _tmp_repo(tmp_path / pkg, {
        rel.format(pkg=PREFIX[pkg].rstrip("/"), test=test): src
        for rel, src in files.items()})
    return LINTS[pkg].run_passes(passes, repo=repo)


def _norm(violations):
    return sorted((v.path.replace("spark_tpu_torch/", "spark_tpu/")
                   .replace("test_torch_x", "test_x"), v.line, v.code,
                   v.message.replace("spark_tpu_torch/", "spark_tpu/"))
                  for v in violations)


def _both(tmp_path, passes, files):
    out = {pkg: _run(pkg, tmp_path, passes, files) for pkg in PREFIX}
    return out["port"], out["jax"]


# -- the six passes on seeded violations -------------------------------------

def test_metric_prefix_pass_synthetic(tmp_path):
    port, ref = _both(tmp_path, ["metric-prefix"], {
        "{pkg}/bad.py": "ctx.add_metric('made_up_name', 1)\n"
                        "ctx.add_metric(f'{x}_dynamic', 1)\n"
                        "ctx.add_metric('rows_fine', 1)\n"})
    assert _norm(port) == _norm(ref)
    msgs = [v.message for v in port]
    assert len(port) == 2
    assert any("made_up_name" in m for m in msgs)
    assert any("not statically attributable" in m for m in msgs)


def test_conf_key_pass_synthetic(tmp_path):
    port, ref = _both(tmp_path, ["conf-key"], {
        "{pkg}/bad.py": "x = conf.get('spark_tpu.sql.not.registered')\n"
                        "BAD_KEY = 'spark_tpu.also.not.registered'\n"
                        "ok = conf.get('spark_tpu.sql.shuffle.partitions')\n"})
    assert [(v.line, v.code) for v in port] == \
        [(v.line, v.code) for v in ref] == [(1, "CK100"), (2, "CK100")]
    assert all("unregistered conf key" in v.message for v in port)


def test_conf_key_port_tests_may_name_jax_only_keys(tmp_path):
    """A port test sets the JAX package's keys on JAX sessions; the
    package itself may not read such a key (the waiver list is empty
    since the SLO key was registered). Since the fleet's keys were
    registered, the compile cache's keys are the JAX-only ones the port
    leaves out."""
    out = _run("port", tmp_path, ["conf-key"], {
        "tests/{test}.py":
            "ref.conf.set('spark_tpu.sql.compileCache.dir', 'd')\n"
            "ref.conf.set('spark_tpu.sql.compileCache.dirr', 'd')\n",
        "{pkg}/bad.py":
            "x = conf.get('spark_tpu.sql.compileCache.dir')\n"
            "y = conf.get('spark_tpu.service.fleet.workers')\n"})
    assert [(v.path, v.line) for v in out] == [
        ("spark_tpu_torch/bad.py", 1), ("tests/test_torch_x.py", 2)]


def test_fault_site_pass_synthetic(tmp_path):
    port, ref = _both(tmp_path, ["fault-site"], {
        "{pkg}/engine.py": "faults.fire('scan_load')\n"
                           "faults.fire('bogus_seam')\n",
        "tests/{test}.py": "spec = 'stage_rnu:fatal:1'\n"})
    for out in (port, ref):
        msgs = [v.render() for v in out]
        assert any("bogus_seam" in m for m in msgs), msgs
        assert any("stage_rnu" in m for m in msgs), msgs
        unwired = [v for v in out if v.path.endswith("testing/faults.py")]
        assert unwired and all("no faults.fire" in v.message
                               for v in unwired)
    # the bogus seam and the typo'd rule, in both, on the same lines
    assert [v.line for v in port if "faults.py" not in v.path] == \
        [v.line for v in ref if "faults.py" not in v.path]


def test_fault_site_pass_register_site_escape(tmp_path):
    port, ref = _both(tmp_path, ["fault-site"], {
        "tests/{test}.py": "faults.register_site('my_seam')\n"
                           "plan.fire('my_seam')\n"
                           "spec = 'my_seam:fatal:1'\n"})
    for out in (port, ref):
        assert [v for v in out if "my_seam" in v.message] == []


def test_tracer_leak_pass_synthetic(tmp_path):
    shared = ("k = hash(col.data)\n"
              "ok = hash('literal')\n"
              "b = bool(x.validity.any())\n"
              "fine = bool(flag_value)\n")
    port, ref = _both(tmp_path, ["tracer-leak"], {
        "{pkg}/execution/bad.py": shared,
        "{pkg}/other.py": "h = hash(x)  # out of scope\n"})
    assert {v.line for v in port} == {v.line for v in ref} == {1, 3}
    # what each package takes for device data besides
    torch_src = ("c = bool(torch.all(m))\n"
                 "d = bool(done.all())\n"
                 "e = bool(jnp.any(x))\n")
    port, ref = _both(tmp_path / "more", ["tracer-leak"], {
        "{pkg}/parallel/bad.py": torch_src})
    # (`jnp.any(...)` is a call of an `.any` too, so the port flags it)
    assert {v.line for v in port} == {1, 2, 3}
    assert {v.line for v in ref} == {3}


def test_tracer_leak_scope(tmp_path):
    """The port's scope: execution/, parallel/, observability/ and
    streaming.py (the service's waits for slice 12c)."""
    out = _run("port", tmp_path, ["tracer-leak"], {
        "{pkg}/observability/bad.py": "b = bool(torch.any(x))\n",
        "{pkg}/streaming.py": "h = hash(batch.validity)\n",
        "{pkg}/parallel/bad.py": "h = hash(x)\n",
        "{pkg}/io/fine.py": "h = hash(x)\n"})
    assert {v.path for v in out} == {
        "spark_tpu_torch/observability/bad.py",
        "spark_tpu_torch/streaming.py", "spark_tpu_torch/parallel/bad.py"}


def test_tracer_leak_waivers(tmp_path, monkeypatch):
    """A waiver covers its function's sites and is listed in the notes;
    one whose function has no site left is stale."""
    monkeypatch.setattr(port_passes, "TRACER_LEAK_WAIVERS", {
        ("spark_tpu_torch/execution/w.py", "Loop.step"): "bounded loop",
        ("spark_tpu_torch/execution/w.py", "gone"): "was here once"})
    repo = _tmp_repo(tmp_path, {
        "spark_tpu_torch/execution/w.py":
            "class Loop:\n"
            "    def step(self):\n"
            "        return bool(self.done.all())\n"
            "def other(m):\n"
            "    return bool(m.all())\n"})
    notes = []
    out = port_lints.run_passes(["tracer-leak"], repo=repo,
                                collect_notes=notes)
    assert sorted((v.line, "stale" in v.message) for v in out) == [
        (1, True), (5, False)]
    assert any("Loop.step -- bounded loop" in n for n in notes)


def test_readme_metrics_pass_synthetic(tmp_path):
    """The port's table: every METRIC_PREFIXES entry must be a row of it
    (a prefix named elsewhere in the README does not count)."""
    from spark_tpu_torch.observability.metrics import METRIC_PREFIXES
    rows = "".join(f"| `{p}` | x |\n" for p in METRIC_PREFIXES[1:])
    text = (f"# r\n\n{port_passes.README_TABLE_HEADING}\n\n| prefix | "
            f"meaning |\n|---|---|\n{rows}\n## next\n`{METRIC_PREFIXES[0]}`"
            f" named outside the table\n")
    out = _run("port", tmp_path, ["readme-metrics"], {"README.md": text})
    assert len(out) == 1 and f"`{METRIC_PREFIXES[0]}`" in out[0].message
    out = _run("port", tmp_path / "none", ["readme-metrics"],
               {"README.md": "# nothing\n"})
    assert len(out) == 1 and "has no" in out[0].message
    # the JAX package's pass over its own table, for the same omission
    ref_rows = "".join(f"| `{p}` | x |\n" for p in METRIC_PREFIXES[1:])
    out = _run("jax", tmp_path, ["readme-metrics"],
               {"README.md": f"| prefix |\n{ref_rows}"})
    assert any(f"`{METRIC_PREFIXES[0]}`" in v.message for v in out)


def test_rule_registry_pass_synthetic():
    from spark_tpu_torch.analysis.lints import LintContext
    from spark_tpu_torch.plan.rules import Rule

    class Dup(Rule):
        name = "CombineFilters"  # collides with the real rule
    Dup.__module__ = "spark_tpu_torch.__mutant__"
    try:
        out = port_passes.RuleRegistryPass().finish(LintContext())
        msgs = [m for _, _, m in out]
        assert any("duplicate rule name 'CombineFilters'" in m for m in msgs)
        assert any("Dup is not reachable" in m for m in msgs)
        assert any("Dup does not declare `schema_preserving`" in m
                   for m in msgs)
    finally:
        # hide the mutant from any later full-tree pass in this process
        Dup.__module__ = "tests.__dead_mutant__"


def test_rule_registry_every_port_rule_declares():
    """The nine rule classes of the port, each reachable and declaring
    `schema_preserving` in its own body, as the JAX package's do."""
    from spark_tpu_torch.plan import join_reorder  # noqa: F401
    from spark_tpu_torch.plan.optimizer import default_optimizer
    rules = [r for b in default_optimizer().batches for r in b.rules]
    assert len(rules) == 9
    for r in rules:
        assert isinstance(type(r).__dict__.get("schema_preserving"), bool)
    notes = []
    assert port_lints.run_passes(["rule-registry"],
                                 collect_notes=notes) == []
    assert "rule-registry: 9 engine rule(s), 9 reachable from " \
           "default_optimizer" in notes


# -- the CLI and the real tree -----------------------------------------------

def test_lint_all_clean_on_real_tree():
    notes = []
    out = port_lints.run_passes(collect_notes=notes)
    assert [v.render() for v in out] == []
    assert sorted(port_lints.LINT_PASSES) == [
        "conf-key", "fault-site", "guarded-by", "lock-order",
        "metric-prefix", "readme-metrics", "rule-registry", "tracer-leak"]
    assert any(n.startswith("tracer-leak waiver:") for n in notes)
    with pytest.raises(ValueError, match="unknown lint pass"):
        port_lints.run_passes(["not-a-pass"])


def test_lints_clean_over_the_service_package(tmp_path):
    """The lints read `spark_tpu_torch/service/` like the rest of the
    package: no finding there on the real tree, the service's waivers
    (each with its reason) in the notes, no conf-key waiver left, and
    an unguarded write seeded into a copy of the service is found."""
    import shutil
    notes = []
    out = port_lints.run_passes(collect_notes=notes)
    assert [v.render() for v in out
            if v.path.startswith("spark_tpu_torch/service/")] == []
    service_notes = [n for n in notes if "spark_tpu_torch/service/" in n]
    assert any("_Entry.current_record" in n for n in service_notes), notes
    assert not any(n.startswith("conf-key waiver:") for n in notes)
    assert port_passes.CONF_KEY_WAIVERS == {}
    repo = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "spark_tpu_torch"),
                    repo / "spark_tpu_torch")
    adm = repo / "spark_tpu_torch" / "service" / "admission.py"
    src = adm.read_text()
    seeded = src.replace(
        "    def release(self, session: str) -> None:\n"
        "        if self.max_per_session <= 0:\n"
        "            return\n",
        "    def release(self, session: str) -> None:\n"
        "        if self.max_per_session <= 0:\n"
        "            return\n"
        "        self._inflight = {}\n", 1)
    assert seeded != src
    adm.write_text(seeded)
    found = port_lints.run_passes(["guarded-by", "lock-order"],
                                  repo=str(repo))
    assert [(v.path, v.pass_name) for v in found] == [
        ("spark_tpu_torch/service/admission.py", "guarded-by")]
    assert "SessionQuota._inflight" in found[0].message


def test_lints_clean_over_the_fleet_and_the_libraries(tmp_path):
    """No lint finds anything in `service/fleet.py`, `ml/` or `graph/`
    on the real tree; the fleet's guarded-by waivers carry the JAX
    package's reasons (`_hbm_share`, the port's own, a reason of its
    own); and an unguarded write seeded into a copy of the fleet is
    found."""
    import shutil
    from spark_tpu.analysis.concurrency import registry as ref_registry
    from spark_tpu_torch.analysis.concurrency import \
        registry as port_registry
    notes = []
    out = port_lints.run_passes(collect_notes=notes)
    scoped = ("spark_tpu_torch/service/fleet.py", "spark_tpu_torch/ml/",
              "spark_tpu_torch/graph/")
    assert [v.render() for v in out if v.path.startswith(scoped)] == []
    for d in ("ml", "graph"):
        assert os.path.isdir(os.path.join(REPO, "spark_tpu_torch", d))
    ref_reasons = {(w.cls, w.attr): w.reason for w in ref_registry.WAIVERS
                   if w.relpath.endswith("service/fleet.py")}
    port_reasons = {(w.cls, w.attr): w.reason
                    for w in port_registry.WAIVERS
                    if w.relpath.endswith("service/fleet.py")}
    assert set(port_reasons) == set(ref_reasons) | {
        ("FleetSupervisor", "_hbm_share")}
    for k, reason in ref_reasons.items():
        assert port_reasons[k] == reason, k
    assert all(any(f"FleetSupervisor.{a}" in n for n in notes)
               for _, a in port_reasons)
    repo = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "spark_tpu_torch"),
                    repo / "spark_tpu_torch")
    fleet = repo / "spark_tpu_torch" / "service" / "fleet.py"
    src = fleet.read_text()
    seeded = src.replace(
        "    def end_request(self) -> None:\n",
        "    def end_request(self) -> None:\n"
        "        self._inflight = 0\n", 1)
    assert seeded != src
    fleet.write_text(seeded)
    found = port_lints.run_passes(["guarded-by", "lock-order"],
                                  repo=str(repo))
    assert [(v.path, v.pass_name) for v in found] == [
        ("spark_tpu_torch/service/fleet.py", "guarded-by")]
    assert "FleetSupervisor._inflight" in found[0].message


def test_lint_json_output_shape(capsys):
    rc = port_lints.main(["--json", "guarded-by", "lock-order"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["ok"] is True
    assert payload["passes"] == ["guarded-by", "lock-order"]
    assert payload["violations"] == []
    assert any(n.startswith("waiver:") for n in payload["notes"])


def test_lint_severity_flows_and_warn_does_not_fail(capsys):
    from spark_tpu_torch.analysis.lints import (LINT_PASSES, LintPass,
                                                register_lint)

    @register_lint
    class _WarnOnly(LintPass):
        name = "test-warn-only"
        code = "TW100"
        doc = "synthetic warn emitter"

        def scope(self, relpath):
            return False

        def check(self, tree, relpath, ctx):
            return []

        def finish(self, ctx):
            return [("somewhere.py", 1, "advisory only", "TW100", "warn")]

    try:
        out = port_lints.run_passes(["test-warn-only"])
        assert [(v.code, v.severity) for v in out] == [("TW100", "warn")]
        assert port_lints.main(["test-warn-only"]) == 0
        assert "ok with 1 warning(s)" in capsys.readouterr().out
        assert port_lints.main(["--json", "test-warn-only"]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["ok"] is True
        assert payload["violations"][0]["severity"] == "warn"
    finally:
        del LINT_PASSES["test-warn-only"]


def test_lint_cli_module_exits_clean_and_fails_on_a_violation(tmp_path):
    """`python -m spark_tpu_torch.analysis.lints --all --json` on the
    real tree exits 0 with the JAX package's --json shape; an error
    violation makes `main` return 1."""
    proc = subprocess.run(
        [sys.executable, "-m", "spark_tpu_torch.analysis.lints", "--all",
         "--json"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert set(payload) == {"ok", "passes", "violations", "notes"}
    assert payload["ok"] is True and len(payload["passes"]) == 8
    repo = _tmp_repo(tmp_path, {
        "spark_tpu_torch/bad.py": "ctx.add_metric('made_up_name', 1)\n"})
    assert port_lints.run_passes(["metric-prefix"], repo=repo)
