"""Built-in lint passes over the port (see the package docstring for the
catalog; the port of `spark_tpu/analysis/lints/passes.py`)."""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from . import PKG, LintContext, LintPass, is_port_test, register_lint


#: the heading of the port's metric-name table in README.md
README_TABLE_HEADING = "### Port metric-name reference"


def _port_scope(relpath: str) -> bool:
    """The package, its chip script and the port's tests."""
    return relpath.startswith(PKG) or relpath == "chip_smoke.py" \
        or is_port_test(relpath)

# ---------------------------------------------------------------------------
# metric-prefix (the original scripts/metrics_lint.py, framework-hosted)
# ---------------------------------------------------------------------------


def _metric_prefix_of(node: ast.expr):
    """(kind, literal-or-None) for an add_metric name argument."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return "literal", node.value
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant) \
                and isinstance(node.values[0].value, str) \
                and node.values[0].value:
            return "fstring", node.values[0].value
        return "fstring", None
    return "dynamic", None


@register_lint
class MetricPrefixPass(LintPass):
    """Every `ctx.add_metric(...)` name must use a registered prefix
    (observability.metrics.METRIC_PREFIXES): an unregistered traced
    metric would flow into the event log but silently miss every
    history summary column."""

    name = "metric-prefix"
    code = "MP100"
    doc = "add_metric names use registered METRIC_PREFIXES prefixes"

    def check(self, tree, relpath, ctx: LintContext
              ) -> List[Tuple[int, str]]:
        problems = []
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_metric"
                    and node.args):
                continue
            kind, text = _metric_prefix_of(node.args[0])
            if text is None:
                problems.append(
                    (node.lineno,
                     f"metric name not statically attributable "
                     f"({kind} argument)"))
            elif not text.startswith(ctx.metric_prefixes):
                problems.append(
                    (node.lineno,
                     f"unregistered metric prefix: {text!r}"))
        return problems


# ---------------------------------------------------------------------------
# conf-key
# ---------------------------------------------------------------------------

#: what a conf key looks like (dots, camelCase segments)
_KEY_RX = re.compile(r"^spark_tpu(\.[A-Za-z][A-Za-z0-9]*)+$")

#: Conf methods whose first argument is a key
_CONF_METHODS = ("get", "set", "contains", "unset", "is_explicitly_set")

#: keys of a later slice (`config.UNPORTED_KEYS`) the package reads on
#: purpose, key -> the reason. Such a key can only hold its default in
#: the port (setting anything else raises `UnportedConfError`), so the
#: read gives the default; the lint lists these in its notes.
CONF_KEY_WAIVERS: Dict[str, str] = {}


@register_lint
class ConfKeyPass(LintPass):
    """Every `spark_tpu.*` key string read/written through a Conf
    method -- or bound to a `*_KEY` module constant -- must be
    `register()`ed in the port's config.py. A typo'd key never errors:
    `get` silently returns the fallback and the feature quietly
    disables. The port's tests drive JAX sessions too, so there a key
    the port lists as the JAX package's (`config.UNPORTED_KEYS`) is
    known as well; in the package and its chip script it is not (the
    port would read None)."""

    name = "conf-key"
    code = "CK100"
    doc = "conf-key string literals are registered in config.py"

    def scope(self, relpath: str) -> bool:
        if relpath == PKG + "config.py":
            return False  # register() calls DEFINE the keys
        return _port_scope(relpath)

    def check(self, tree, relpath, ctx: LintContext
              ) -> List[Tuple[int, str]]:
        problems = []
        known = ctx.conf_keys | ctx.unported_keys \
            if is_port_test(relpath) else \
            ctx.conf_keys | (set(CONF_KEY_WAIVERS) & ctx.unported_keys)

        def check_key(lineno: int, key: str, via: str) -> None:
            if key not in known:
                problems.append(
                    (lineno,
                     f"unregistered conf key {key!r} ({via}); add a "
                     f"register(...) entry in {PKG}config.py"))

        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _CONF_METHODS and node.args:
                a = node.args[0]
                if isinstance(a, ast.Constant) \
                        and isinstance(a.value, str) \
                        and a.value.startswith("spark_tpu."):
                    check_key(a.lineno, a.value,
                              f"conf.{node.func.attr}")
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str) \
                    and _KEY_RX.match(node.value.value):
                names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
                if any(n.endswith("_KEY") for n in names):
                    check_key(node.lineno, node.value.value,
                              f"{names[0]} constant")
        return problems

    def finish(self, ctx: LintContext):
        out = []
        for key, reason in sorted(CONF_KEY_WAIVERS.items()):
            ctx.notes.append(f"conf-key waiver: {key} -- {reason}")
            if key not in ctx.unported_keys:
                out.append((PKG + "config.py", 1,
                            f"stale conf-key waiver: {key} is not in "
                            f"UNPORTED_KEYS (register it, or drop the "
                            f"waiver)"))
        return out


# ---------------------------------------------------------------------------
# fault-site
# ---------------------------------------------------------------------------

FAULTS_MODULE = PKG + "testing/faults.py"


@register_lint
class FaultSitePass(LintPass):
    """Three-way consistency for fault-injection sites: `faults.fire`
    seams <-> `testing.faults.KNOWN_SITES` <-> inject-rule string
    literals in tests/scripts. A rule naming an unwired site would arm
    and then never fire — the chaos test silently tests nothing."""

    name = "fault-site"
    code = "FS100"
    doc = "fault sites are declared, wired, and spelled consistently"

    def __init__(self):
        self._engine_wired: dict = {}  # site -> first (relpath, line)
        self._registered: set = set()  # register_site("...") literals
        self._uses: list = []  # (relpath, line, site, via)

    def scope(self, relpath: str) -> bool:
        return _port_scope(relpath)

    def _spec_rules(self, text: str, ctx: LintContext):
        """Parse `text` as an inject spec; None unless EVERY comma part
        matches `site:fault:nth[:arg]` with a known fault class (the
        disambiguator against arbitrary colon-bearing strings)."""
        rules = []
        parts = [p for p in text.split(",") if p.strip()]
        if not parts:
            return None
        for part in parts:
            bits = part.strip().split(":")
            if len(bits) not in (3, 4) or any(" " in b for b in bits):
                return None
            if not re.match(r"^[a-z_][a-z0-9_]*$", bits[0]):
                return None  # f-string fragments etc. — not a spec
            if bits[1] not in ctx.fault_classes:
                return None
            if not bits[2].isdigit():
                return None
            rules.append(bits[0])
        return rules

    def check(self, tree, relpath, ctx: LintContext
              ) -> List[Tuple[int, str]]:
        # collect only; every verdict lands in finish(), so the pass is
        # independent of file-walk order (a test may register_site a
        # seam the same file then uses)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args \
                    and relpath != FAULTS_MODULE:
                fn = node.func
                callee = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None)
                a = node.args[0]
                lit = a.value if (isinstance(a, ast.Constant)
                                  and isinstance(a.value, str)) else None
                if callee == "fire" and lit is not None:
                    if relpath.startswith(PKG):
                        self._engine_wired.setdefault(
                            lit, (relpath, a.lineno))
                    self._uses.append((relpath, a.lineno, lit, "fire"))
                elif callee in ("register_site", "scoped_site") \
                        and lit is not None:
                    self._registered.add(lit)
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                for site in self._spec_rules(node.value, ctx) or ():
                    self._uses.append((relpath, node.lineno, site,
                                       "inject rule"))
        return []

    def finish(self, ctx: LintContext):
        known = set(ctx.fault_sites) | self._registered
        out = []
        seen = set()
        for relpath, line, site, via in self._uses:
            if site in known or (relpath, line, site) in seen:
                continue
            seen.add((relpath, line, site))
            out.append((relpath, line,
                        f"{via} names unknown fault site {site!r} "
                        f"(not in KNOWN_SITES, never register_site'd); "
                        f"known: {ctx.fault_sites}"))
        for site in ctx.fault_sites:
            if site not in self._engine_wired:
                out.append((FAULTS_MODULE, 1,
                            f"KNOWN_SITES declares {site!r} but no "
                            f"faults.fire({site!r}) seam wires it"))
        return out


# ---------------------------------------------------------------------------
# readme-metrics
# ---------------------------------------------------------------------------


@register_lint
class ReadmeMetricsPass(LintPass):
    """Every registered METRIC_PREFIXES entry of the port must appear in
    the port's metric-name table in README.md (the table under
    `README_TABLE_HEADING`, up to the next heading): a prefix the docs
    don't list is a metric family operators can't discover."""

    name = "readme-metrics"
    code = "RM100"
    doc = "every METRIC_PREFIXES entry appears in the port's README table"

    def scope(self, relpath: str) -> bool:
        return False  # whole-tree pass: finish() reads README.md

    def check(self, tree, relpath, ctx: LintContext):
        return []

    def finish(self, ctx: LintContext):
        import os
        path = os.path.join(ctx.repo, "README.md")
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            return [("README.md", 1, "README.md unreadable")]
        start = text.find(README_TABLE_HEADING)
        if start < 0:
            return [("README.md", 1,
                     f"README.md has no {README_TABLE_HEADING!r} "
                     f"section")]
        end = text.find("\n#", start + len(README_TABLE_HEADING))
        table = text[start:end if end >= 0 else len(text)]
        line = text.count("\n", 0, start) + 1
        out = []
        for prefix in ctx.metric_prefixes:
            if f"| `{prefix}" not in table:
                out.append(
                    ("README.md", line,
                     f"metric prefix `{prefix}` (METRIC_PREFIXES) is "
                     f"missing from the README metric-name reference "
                     f"table"))
        return out


# ---------------------------------------------------------------------------
# rule-registry
# ---------------------------------------------------------------------------


@register_lint
class RuleRegistryPass(LintPass):
    """Optimizer-rule registration discipline, enforced at the class
    level: every `Rule` subclass in the engine (1) carries a unique
    `name` (rule traces, `excludedRules` ablation and
    `PlanIntegrityError` attribution all key on it), (2) is reachable
    from `default_optimizer()` (an orphaned rule is dead code the
    fuzzer can never ablate), and (3) declares `schema_preserving`
    explicitly in its own body — the plan-integrity verifier holds
    undeclared rules to the preservation contract, so an implicit
    inheritance is a latent false positive/negative."""

    name = "rule-registry"
    code = "RL100"
    doc = "Rule subclasses: unique name, reachable, explicit " \
          "schema_preserving"

    def scope(self, relpath: str) -> bool:
        return False  # whole-tree pass: finish() imports the registry

    def check(self, tree, relpath, ctx: LintContext):
        return []

    def _subclasses(self, base) -> list:
        out = []
        for cls in base.__subclasses__():
            out.append(cls)
            out.extend(self._subclasses(cls))
        return out

    def finish(self, ctx: LintContext):
        import inspect
        import os
        from ...plan import join_reorder  # noqa: F401 -- registers rules
        from ...plan import optimizer
        from ...plan.rules import Rule

        def site(cls) -> Tuple[str, int]:
            try:
                relpath = os.path.relpath(inspect.getsourcefile(cls),
                                          ctx.repo)
                line = inspect.getsourcelines(cls)[1]
            except (OSError, TypeError):
                relpath, line = PKG + "plan/rules.py", 1
            return relpath, line

        engine_rules = [cls for cls in self._subclasses(Rule)
                        if cls.__module__.startswith("spark_tpu_torch.")]
        reachable = {type(r)
                     for b in optimizer.default_optimizer().batches
                     for r in b.rules}
        out = []
        by_name: dict = {}
        for cls in engine_rules:
            relpath, line = site(cls)
            rname = cls.__dict__.get("name")
            if not rname:
                out.append((relpath, line,
                            f"Rule subclass {cls.__name__} has no "
                            f"`name` of its own (traces/ablation/"
                            f"integrity errors key on it)"))
            elif rname in by_name:
                out.append((relpath, line,
                            f"duplicate rule name {rname!r} (also "
                            f"{by_name[rname].__name__}): excludedRules "
                            f"and rule traces cannot distinguish them"))
            else:
                by_name[rname] = cls
            if cls not in reachable:
                out.append((relpath, line,
                            f"rule {cls.__name__} is not reachable "
                            f"from default_optimizer(): dead rule the "
                            f"fuzzer can never ablate"))
            if not isinstance(cls.__dict__.get("schema_preserving"),
                              bool):
                out.append((relpath, line,
                            f"rule {cls.__name__} does not declare "
                            f"`schema_preserving` in its own body; the "
                            f"plan-integrity verifier needs the "
                            f"explicit contract (True = must preserve "
                            f"the root schema, False = legitimately "
                            f"reshapes)"))
        ctx.notes.append(
            f"rule-registry: {len(engine_rules)} engine rule(s), "
            f"{len(reachable)} reachable from default_optimizer")
        return out


# ---------------------------------------------------------------------------
# tracer-leak
# ---------------------------------------------------------------------------

#: names/attributes whose presence marks an expression as (potentially)
#: device data: torch calls, a Column's/Vec's tensors, and the tensor
#: reductions whose 0-d result `bool()` would read back (Python's own
#: containers have no `.all()`/`.any()`/`.item()` methods)
_TRACED_NAMES = ("torch",)
_TRACED_ATTRS = ("data", "validity", "elem_validity", "selection")
_TRACED_METHODS = ("all", "any", "item")

#: sites the port keeps on purpose, by (repo path, enclosing function's
#: qualified name) -> the reason. Each is a deliberate host sync: the
#: loop or branch needs the value on the host, once per step or once
#: per call, and no cheaper form gives it. The lint lists them in its
#: notes; a site outside this table is a finding.
TRACER_LEAK_WAIVERS: Dict[Tuple[str, str], str] = {
    (PKG + "execution/hash_join.py", "build_table"):
        "the open-addressing insert loop ends once every distinct build "
        "key holds a slot: its exit test reads one bool per insert step, "
        "at most hashMaxProbe steps and usually a few; running all "
        "hashMaxProbe steps blind would cost more device time than the "
        "syncs, and the step count is the join_build_steps_ metric",
    (PKG + "execution/hash_join.py", "probe_table"):
        "the probe loop ends once every probe row has hit its key or a "
        "vacant slot: one bool per probe step, at most hashMaxProbe "
        "steps; the step count is the join_probe_steps_ metric",
}


def _mentions_traced(node: ast.expr) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _TRACED_NAMES:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _TRACED_ATTRS:
            return True
        if isinstance(sub, ast.Call) \
                and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _TRACED_METHODS:
            return True
    return False


def _calls_by_function(tree: ast.Module):
    """(qualified name of the innermost enclosing def, Call) for every
    call in the module ("<module>" at top level)."""
    out = []

    def visit(node, qual):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                visit(child, child.name if qual == "<module>"
                      else f"{qual}.{child.name}")
                continue
            if isinstance(child, ast.Call):
                out.append((qual, child))
            visit(child, qual)

    visit(tree, "<module>")
    return out


@register_lint
class TracerLeakPass(LintPass):
    """`hash()` of a non-constant, or truthiness coercion of device
    data, in the modules that hold tensors: in torch both hide a host
    sync (`bool()` of a CUDA tensor waits for the card to finish
    everything queued before it; `hash()` of a tensor hashes its
    identity, so dict/set keying on it misbehaves across equal values).
    Scope: `execution/`, `parallel/`, `observability/` and
    `streaming.py`. Sites kept on purpose carry a waiver with its
    reason (`TRACER_LEAK_WAIVERS`), listed in the lint's notes."""

    name = "tracer-leak"
    code = "TL100"
    doc = "no hash()/bool() of device values in tensor-holding modules"

    def __init__(self):
        self._used = set()
        self._seen = set()

    def scope(self, relpath: str) -> bool:
        return relpath.startswith((PKG + "execution/", PKG + "parallel/",
                                   PKG + "observability/")) \
            or relpath == PKG + "streaming.py"

    def check(self, tree, relpath, ctx: LintContext
              ) -> List[Tuple[int, str]]:
        problems = []
        self._seen.add(relpath)
        for qual, node in _calls_by_function(tree):
            if not isinstance(node.func, ast.Name):
                continue
            if node.func.id == "hash" and node.args:
                if all(isinstance(a, ast.Constant) for a in node.args):
                    continue
                msg = ("hash() of a non-constant in a tensor-holding "
                       "module: a tensor here hashes its identity, not "
                       "its value (use a structural key instead)")
            elif node.func.id == "bool" and node.args \
                    and _mentions_traced(node.args[0]):
                msg = ("bool() over device data in a tensor-holding "
                       "module: a hidden device->host sync (waits for "
                       "everything queued on the card)")
            else:
                continue
            if (relpath, qual) in TRACER_LEAK_WAIVERS:
                self._used.add((relpath, qual))
                continue
            problems.append((node.lineno, f"{msg} [in {qual}]"))
        return problems

    def finish(self, ctx: LintContext):
        out = []
        for (relpath, qual), reason in sorted(TRACER_LEAK_WAIVERS.items()):
            ctx.notes.append(f"tracer-leak waiver: {relpath}: {qual} "
                             f"-- {reason}")
            if not reason.strip():
                out.append((relpath, 1, f"tracer-leak waiver for {qual} "
                            f"has no reason"))
            elif relpath in self._seen \
                    and (relpath, qual) not in self._used:
                out.append((relpath, 1, f"stale tracer-leak waiver: "
                            f"{qual} has no hash()/bool() site left"))
        return out
