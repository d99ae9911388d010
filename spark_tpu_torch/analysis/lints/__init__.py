"""Source-lint framework: a registry of AST passes over the port (the
port of `spark_tpu/analysis/lints/`, with its pass names, codes and
output shape).

Each *pass* is a small class with a name, a file scope, and a
`check(tree, relpath, ctx)` method over a parsed `ast` module;
`run_passes` walks the repository once, parses each file once, and
feeds every in-scope pass. The tree it walks is the port's:
`spark_tpu_torch/`, the port's tests (`tests/test_torch_*.py`,
`tests/torch_*.py`) and `chip_smoke.py`; every registry a pass checks
against is the port's own. `python -m spark_tpu_torch.analysis.lints
--all [--json]` is the CLI (`__main__.py`).

Built-in passes (lints/passes.py):

- ``metric-prefix``: every `ctx.add_metric` name uses a registered
  `observability.metrics.METRIC_PREFIXES` prefix.
- ``conf-key``: every `spark_tpu.*` conf-key string literal read or
  written through a Conf method (or bound to a `*_KEY` constant) is
  `register()`ed in `spark_tpu_torch/config.py` -- a typo'd key
  silently reads `None`.
- ``fault-site``: fault-injection sites are consistent three ways:
  every `faults.fire("<site>")` seam is declared in
  `testing.faults.KNOWN_SITES`, every declared site is wired, and every
  inject-rule string literal (`site:fault:nth`) names a known site.
- ``tracer-leak``: `hash()` of non-constants and truthiness of device
  data in `execution/`, `parallel/`, `observability/` and
  `streaming.py`. In torch both are hidden host syncs (a CUDA tensor's
  `bool()` waits for the card); each site the port keeps on purpose is
  waived by function, with its reason (`passes.TRACER_LEAK_WAIVERS`).
- ``readme-metrics``: every registered METRIC_PREFIXES entry appears in
  the port's metric-name table in README.md.
- ``rule-registry``: every optimizer `Rule` subclass carries a unique
  `name`, is reachable from `default_optimizer()`, and declares
  `schema_preserving` explicitly (RL100).

Concurrency passes (analysis/concurrency/lint_passes.py):
``guarded-by`` and ``lock-order`` over the port's lock registry.

Adding a pass: subclass `LintPass`, decorate with `@register_lint`,
give it `name`, `doc`, optionally override `scope`, implement `check`.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

#: the package the passes lint
PKG = "spark_tpu_torch/"


def is_port_test(relpath: str) -> bool:
    """The port's own test files (they drive both packages)."""
    name = os.path.basename(relpath)
    return relpath.startswith("tests/") and \
        name.startswith(("test_torch_", "torch_"))


@dataclass(frozen=True)
class LintViolation:
    path: str  # repo-relative
    line: int
    pass_name: str
    message: str
    #: stable machine-readable finding code (CI gates key on it); a
    #: pass without per-violation codes inherits its class-level code
    code: str = ""
    #: "error" fails the lint; "warn"/"info" are surfaced only (every
    #: built-in pass emits error -- the tree gates at zero errors)
    severity: str = "error"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}] " \
               f"{self.message}"

    def to_dict(self) -> dict:
        """The --json shape: pass name, file:line, severity, code."""
        return {"pass": self.pass_name, "code": self.code,
                "severity": self.severity, "path": self.path,
                "line": self.line, "message": self.message}


class LintContext:
    """Shared, lazily-built lookup tables the passes consult."""

    def __init__(self, repo: str = REPO):
        self.repo = repo
        #: informational lines passes surface next to violations (the
        #: waiver lists, the lock-order graph size) -- printed by the
        #: CLI and carried in --json, never failing the lint
        self.notes: List[str] = []
        self._conf_keys: Optional[set] = None
        self._unported_keys: Optional[set] = None
        self._metric_prefixes: Optional[tuple] = None
        self._fault_sites: Optional[tuple] = None
        self._fault_classes: Optional[tuple] = None

    @property
    def conf_keys(self) -> set:
        if self._conf_keys is None:
            from ...config import registry
            self._conf_keys = set(registry())
        return self._conf_keys

    @property
    def unported_keys(self) -> set:
        """The JAX package's keys the port lists as not its own
        (`config.UNPORTED_KEYS`): the port's tests set them on JAX
        sessions."""
        if self._unported_keys is None:
            from ...config import UNPORTED_KEYS
            self._unported_keys = set(UNPORTED_KEYS)
        return self._unported_keys

    @property
    def metric_prefixes(self) -> tuple:
        if self._metric_prefixes is None:
            from ...observability.metrics import METRIC_PREFIXES
            self._metric_prefixes = METRIC_PREFIXES
        return self._metric_prefixes

    @property
    def fault_sites(self) -> tuple:
        if self._fault_sites is None:
            from ...testing.faults import KNOWN_SITES
            self._fault_sites = tuple(KNOWN_SITES)
        return self._fault_sites

    @property
    def fault_classes(self) -> tuple:
        if self._fault_classes is None:
            from ...testing.faults import FAULT_CLASSES
            self._fault_classes = tuple(FAULT_CLASSES)
        return self._fault_classes


class LintPass:
    """One static pass. `check` returns (line, message[, code
    [, severity]]) tuples for a single parsed file; `finish`
    (optional) returns whole-tree violations after every file was
    seen -- as (relpath, line, message[, code[, severity]]) tuples.
    Omitted codes default to the pass's class-level `code`; omitted
    severity to "error" (only error-severity violations fail the
    lint)."""

    name: str = "?"
    doc: str = ""
    #: default machine-readable code for this pass's violations
    code: str = ""

    def scope(self, relpath: str) -> bool:
        """Whether the pass wants this repo-relative .py file."""
        return relpath.startswith(PKG)

    def check(self, tree: ast.Module, relpath: str,
              ctx: LintContext) -> List[Tuple[int, str]]:
        raise NotImplementedError

    def finish(self, ctx: LintContext) -> List[Tuple[str, int, str]]:
        return []


LINT_PASSES: Dict[str, type] = {}


def register_lint(cls: type) -> type:
    if cls.name in LINT_PASSES:
        raise ValueError(f"duplicate lint pass: {cls.name}")
    LINT_PASSES[cls.name] = cls
    return cls


def _iter_py_files(repo: str):
    """The port's files: top-level scripts (chip_smoke.py), the package,
    and the port's tests."""
    for fname in sorted(os.listdir(repo)):
        if fname.endswith(".py"):
            yield fname
    for top in ("spark_tpu_torch", "tests"):
        base = os.path.join(repo, top)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames.sort()
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                relpath = os.path.relpath(os.path.join(dirpath, name),
                                          repo)
                if top == "tests" and not is_port_test(relpath):
                    continue
                yield relpath


def run_passes(names: Optional[List[str]] = None,
               repo: str = REPO,
               collect_notes: Optional[List[str]] = None
               ) -> List[LintViolation]:
    """Run the selected passes (default: all) over the repository.
    Parses each file once; a file that fails to parse is itself a
    violation (the tree must stay importable). `collect_notes`
    receives the passes' informational lines (waiver lists etc.)."""
    # import for side effect: the built-in passes register on import
    from . import passes as _passes  # noqa: F401
    from ..concurrency import lint_passes as _cpasses  # noqa: F401
    selected = names or sorted(LINT_PASSES)
    unknown = [n for n in selected if n not in LINT_PASSES]
    if unknown:
        raise ValueError(f"unknown lint pass(es) {unknown}; "
                         f"known: {sorted(LINT_PASSES)}")
    ctx = LintContext(repo)
    instances = [LINT_PASSES[n]() for n in selected]
    out: List[LintViolation] = []

    def emit(p, relpath, item):
        line, msg = item[0], item[1]
        code = item[2] if len(item) > 2 else (p.code or p.name)
        severity = item[3] if len(item) > 3 else "error"
        out.append(LintViolation(relpath, line, p.name, msg,
                                 code=code, severity=severity))

    for relpath in _iter_py_files(repo):
        in_scope = [p for p in instances if p.scope(relpath)]
        if not in_scope:
            continue
        path = os.path.join(repo, relpath)
        try:
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
        except SyntaxError as e:
            out.append(LintViolation(relpath, e.lineno or 1, "parse",
                                     f"syntax error: {e.msg}",
                                     code="PARSE"))
            continue
        for p in in_scope:
            for item in p.check(tree, relpath, ctx):
                emit(p, relpath, item)
    for p in instances:
        for item in p.finish(ctx):
            emit(p, item[0], item[1:])
    if collect_notes is not None:
        collect_notes.extend(ctx.notes)
    return sorted(out, key=lambda v: (v.path, v.line, v.pass_name))


def main(argv) -> int:
    """The CLI: `--all` (every pass, the default), `--list`, `--json`,
    or pass names. Exit status 1 iff any error-severity violation.

    --json prints one object: {"ok", "passes", "violations": [{"pass",
    "code", "severity", "path", "line", "message"}, ...], "notes"}."""
    import json
    from . import passes as _passes  # noqa: F401
    from ..concurrency import lint_passes as _cpasses  # noqa: F401
    as_json = "--json" in argv
    args = [a for a in argv if a not in ("--all", "--json")]
    if "--list" in args:
        for name in sorted(LINT_PASSES):
            print(f"{name:14s} {LINT_PASSES[name].doc}")
        return 0
    names = args or None
    notes: list = []
    violations = run_passes(names, collect_notes=notes)
    errors = [v for v in violations if v.severity == "error"]
    if as_json:
        print(json.dumps({
            "ok": not errors,
            "passes": names or sorted(LINT_PASSES),
            "violations": [v.to_dict() for v in violations],
            "notes": notes,
        }, indent=2))
        return 1 if errors else 0
    label = ",".join(names) if names else "all passes"
    if errors:
        print(f"lint ({label}): FAILED")
        for v in violations:
            print("  " + v.render())
        return 1
    if violations:
        # warn/info only: surfaced, never failing -- the verdict agrees
        # with the exit status (and with --json's `ok` field)
        print(f"lint ({label}): ok with {len(violations)} warning(s)")
        for v in violations:
            print("  " + v.render())
        return 0
    n = len(names) if names else len(LINT_PASSES)
    print(f"lint ({label}): ok ({n} passes, 0 violations)")
    return 0
