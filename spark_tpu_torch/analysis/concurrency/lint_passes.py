"""LintPass adapters for the concurrency analyses (the port of
`spark_tpu/analysis/concurrency/lint_passes.py`).

Registered into the lint framework (`python -m
spark_tpu_torch.analysis.lints --all`) alongside the metric-prefix /
conf-key / fault-site / tracer-leak passes. The real logic lives in
guarded.py / lockorder.py as injectable-registry libraries so tests can
run them against synthetic trees and synthetic declarations.
"""

from __future__ import annotations

import ast
from typing import List, Tuple

from ..lints import PKG, LintContext, LintPass, register_lint
from .guarded import GuardedAnalysis
from .lockorder import LockOrderAnalysis


@register_lint
class GuardedByPass(LintPass):
    """Shared mutable state is inventoried and written under its
    declared lock (analysis/concurrency/registry.py): declaration <->
    lock object <-> write sites, three ways. ContextVar-backed state
    is thread-confined; intentional benign races carry waivers whose
    reasons are surfaced in the lint output."""

    name = "guarded-by"
    doc = "shared-state writes hold their GUARDED_BY-declared lock"
    code = "GB100"

    def __init__(self):
        self._analysis = GuardedAnalysis()

    def scope(self, relpath: str) -> bool:
        # every spark_tpu_torch file: lock creations must be registered
        # anywhere; write checks apply inside the registry's modules
        return relpath.startswith(PKG)

    def check(self, tree: ast.Module, relpath: str,
              ctx: LintContext) -> List[Tuple[int, str]]:
        self._analysis.add_file(relpath, tree)
        return []

    def finish(self, ctx: LintContext):
        out = [(relpath, line, msg, code)
               for relpath, line, code, msg in self._analysis.finish()]
        ctx.notes.extend(self._analysis.notes())
        return out


@register_lint
class LockOrderPass(LintPass):
    """The static lock-acquisition graph (nested `with` + resolvable
    call-graph edges + declared EXTRA_EDGES) is acyclic and every edge
    ascends in registry rank — the canonical order lockwatch asserts
    at runtime."""

    name = "lock-order"
    doc = "static lock-acquisition graph is acyclic and rank-ascending"
    code = "LO200"

    def __init__(self):
        self._analysis = LockOrderAnalysis()

    def scope(self, relpath: str) -> bool:
        return relpath in self._analysis.view.scanned_relpaths()

    def check(self, tree: ast.Module, relpath: str,
              ctx: LintContext) -> List[Tuple[int, str]]:
        self._analysis.add_file(relpath, tree)
        return []

    def finish(self, ctx: LintContext):
        edges, violations = self._analysis.finish()
        verdict = "acyclic, rank-ascending" if not violations else \
            f"{len(violations)} ORDER VIOLATION(S)"
        ctx.notes.append(
            f"lock-order: {len(edges)} static acquisition edges over "
            f"{len(self._analysis.view.locks)} registered locks "
            f"({verdict})")
        return [(relpath, line, msg, code)
                for relpath, line, code, msg in violations]
