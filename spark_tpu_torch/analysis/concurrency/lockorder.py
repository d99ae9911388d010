"""Static lock-acquisition graph: extract, then prove it deadlock-free
(the port of `spark_tpu/analysis/concurrency/lockorder.py`, over the
port's registry).

Edges come from three sources:

1. lexically nested ``with`` blocks on registered locks (``with
   self._cv: ... CACHE.evict_bytes(...)``);
2. the call graph, where a call made while holding a lock resolves —
   through the registry's receiver tables — to methods whose own
   (transitive) acquisitions are known. Resolution is deliberately
   conservative: only ``self``, the named receivers/attrs in the
   registry, factory-return chains (``self.metrics.counter(x).inc()``)
   and unique module-level functions resolve; anything else
   contributes no edge (lockwatch observes the real runtime edges);
3. ``EXTRA_EDGES``: declared, commented edges for holds the lexical
   extractor cannot see (locks held across function boundaries, opaque
   callbacks).

Verdicts: an edge ``a -> b`` must STRICTLY ASCEND in registry rank
(LO202) — with every edge ascending the graph is acyclic, the ranking
is the canonical acquisition order, and lockwatch asserts runtime
edges against the same ranks. Cycle detection (LO201) still runs
independently, so a registry with duplicated ranks cannot hide a
cycle, and acquiring a non-reentrant lock while already holding it is
a self-deadlock (LO201).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .guarded import RegistryView, _dotted

CODE_CYCLE = "LO201"
CODE_RANK = "LO202"

#: a resolved callable: (class name, method) — class "" = module fn
_Fn = Tuple[str, str]


class LockOrderAnalysis:
    """Feed files with `add_file`, then `finish()` -> (edges,
    violations). Edges map (lock_a, lock_b) -> human 'where' string."""

    def __init__(self, view: Optional[RegistryView] = None):
        self.view = view or RegistryView()
        #: fn -> list of (held lock ids, ("acquire", lock) | ("call", fn))
        self._events: Dict[_Fn, List[Tuple[Tuple[str, ...], str,
                                           object]]] = {}
        #: fn -> source location of its def
        self._where: Dict[_Fn, str] = {}
        #: module-level function name -> fn key (None = ambiguous)
        self._module_fns: Dict[str, Optional[_Fn]] = {}
        self._lock_attr_ids: Dict[Tuple[str, str], str] = {}

    # -- extraction ---------------------------------------------------------

    def add_file(self, relpath: str, tree: ast.Module) -> None:
        if relpath not in self.view.scanned_relpaths():
            return
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                for meth in node.body:
                    if isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._scan_fn(relpath, node.name, meth)
                    elif isinstance(meth, ast.ClassDef):
                        # one level of class nesting
                        for sub in meth.body:
                            if isinstance(sub, (ast.FunctionDef,
                                                ast.AsyncFunctionDef)):
                                self._scan_fn(relpath, meth.name, sub)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self._scan_fn(relpath, "", node)
                key = (f"mod:{relpath}", node.name)
                if node.name in self._module_fns \
                        and self._module_fns[node.name] != key:
                    # same function name in two scanned files: refuse
                    # to link it (a wrong charge would fabricate or
                    # mask edges with the wrong 'where')
                    self._module_fns[node.name] = None
                else:
                    self._module_fns[node.name] = key

    def _scan_fn(self, relpath: str, cls: str, fn) -> None:
        # module functions are keyed per-FILE (a "mod:<relpath>"
        # pseudo-class): two scanned files defining the same function
        # name must not merge their event lists — name-based linking
        # happens in _link, which refuses ambiguous names. Class
        # methods stay name-keyed: the receiver tables resolve by
        # class NAME by contract, and scanned class names are unique.
        key = (cls, fn.name) if cls else (f"mod:{relpath}", fn.name)
        self._where.setdefault(key, f"{relpath}:{fn.lineno}")
        events = self._events.setdefault(key, [])
        held0: Tuple[str, ...] = ()
        held_attr = self.view.held_callees.get((relpath, cls, fn.name))
        if held_attr is not None:
            lid = self.view.class_locks(relpath, cls).get(held_attr)
            if lid is not None:
                held0 = (lid,)
        self._walk(fn.body, relpath, cls, held0, events)

    def _resolve_lock(self, expr, relpath: str, cls: str
                      ) -> Optional[str]:
        """A with-item / acquire target -> lock id, when resolvable."""
        d = _dotted(expr)
        if d is not None:
            parts = d.split(".")
            if parts[0] == "self" and len(parts) == 2:
                return self.view.class_locks(relpath, cls).get(parts[1])
            if len(parts) == 1:
                return self.view.class_locks(relpath, "").get(parts[0])
            if len(parts) == 2 \
                    and parts[0] in self.view.receiver_names:
                rcls = self.view.receiver_names[parts[0]]
                for decl in self.view.locks:
                    if decl.cls == rcls and decl.attr == parts[1]:
                        return decl.lock_id
            return None
        if isinstance(expr, ast.Call):
            target = self._resolve_call(expr.func, cls)
            if target is not None:
                return self.view.context_managers.get(target)
        return None

    def _resolve_call(self, func, cls: str) -> Optional[_Fn]:
        if isinstance(func, ast.Name):
            return ("", func.id)  # module fn; validated at link time
        if not isinstance(func, ast.Attribute):
            return None
        recv = func.value
        if isinstance(recv, ast.Name):
            if recv.id == "self" and cls:
                return (cls, func.attr)
            rcls = self.view.receiver_names.get(recv.id)
            return None if rcls is None else (rcls, func.attr)
        if isinstance(recv, ast.Attribute):
            rcls = self.view.receiver_attrs.get(recv.attr)
            return None if rcls is None else (rcls, func.attr)
        if isinstance(recv, ast.Call):
            inner = self._resolve_call(recv.func, cls)
            if inner is not None:
                ret = self.view.factory_returns.get(inner)
                if ret is not None:
                    return (ret, func.attr)
        return None

    def _walk(self, stmts, relpath, cls, held, events) -> None:
        for st in stmts:
            if isinstance(st, (ast.With, ast.AsyncWith)):
                added = []
                for item in st.items:
                    # earlier items of a multi-item `with a, b:` are
                    # already held when later items acquire
                    held_now = held + tuple(added)
                    lid = self._resolve_lock(item.context_expr,
                                             relpath, cls)
                    if lid is not None:
                        events.append((held_now, "acquire", lid))
                        added.append(lid)
                    else:
                        self._calls_in(item.context_expr, cls,
                                       held_now, events)
                self._walk(st.body, relpath, cls,
                           held + tuple(added), events)
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # nested defs run with no inherited hold
            self._calls_in(st, cls, held, events,
                           skip_bodies=True)
            for name in ("body", "orelse", "finalbody"):
                body = getattr(st, name, None)
                if body:
                    self._walk(body, relpath, cls, held, events)
            for h in getattr(st, "handlers", []) or []:
                self._walk(h.body, relpath, cls, held, events)

    def _calls_in(self, node, cls, held, events,
                  skip_bodies: bool = False) -> None:
        """Record resolvable calls in this statement's expressions
        (not its nested statement bodies — the walker recurses those
        with the right held set)."""
        skip = set()
        if skip_bodies:
            for name in ("body", "orelse", "finalbody"):
                for sub in getattr(node, name, None) or []:
                    skip.update(id(x) for x in ast.walk(sub))
            for h in getattr(node, "handlers", []) or []:
                for sub in h.body:
                    skip.update(id(x) for x in ast.walk(sub))
        for sub in ast.walk(node):
            if id(sub) in skip or not isinstance(sub, ast.Call):
                continue
            target = self._resolve_call(sub.func, cls)
            if target is not None:
                events.append((held, "call", target))

    # -- linking + verdicts -------------------------------------------------

    def _link(self, fn: _Fn) -> Optional[_Fn]:
        """Resolve a call target to a summarized function (module-fn
        names link only when unique)."""
        cls, name = fn
        if cls == "":
            return self._module_fns.get(name)
        return fn if fn in self._events else None

    def _acq_closure(self) -> Dict[_Fn, Set[str]]:
        acq: Dict[_Fn, Set[str]] = {
            fn: {payload for _, kind, payload in events
                 if kind == "acquire"}
            for fn, events in self._events.items()}
        changed = True
        while changed:
            changed = False
            for fn, events in self._events.items():
                for _, kind, payload in events:
                    if kind != "call":
                        continue
                    callee = self._link(payload)
                    if callee is None or callee not in acq:
                        continue
                    before = len(acq[fn])
                    acq[fn] |= acq[callee]
                    changed = changed or len(acq[fn]) != before
        return acq

    def edges(self) -> Dict[Tuple[str, str], str]:
        """(held, acquired) -> first 'where' seen (extracted +
        declared EXTRA_EDGES)."""
        acq = self._acq_closure()
        out: Dict[Tuple[str, str], str] = {}
        for fn, events in self._events.items():
            where = self._where[fn]
            for held, kind, payload in events:
                if not held:
                    continue
                if kind == "acquire":
                    inner = {payload}
                else:
                    callee = self._link(payload)
                    inner = acq.get(callee, set()) if callee else set()
                for h in held:
                    for m in inner:
                        out.setdefault((h, m), where)
        for a, b, why in self.view.extra_edges:
            out.setdefault((a, b), f"EXTRA_EDGES: {why}")
        return out

    def finish(self) -> Tuple[Dict[Tuple[str, str], str],
                              List[Tuple[str, int, str, str]]]:
        edges = self.edges()
        violations: List[Tuple[str, int, str, str]] = []
        reg_path = "spark_tpu_torch/analysis/concurrency/registry.py"
        for (a, b), where in sorted(edges.items()):
            if a == b:
                if self.view.kind_of(a) != "rlock":
                    violations.append((
                        reg_path, 1, CODE_CYCLE,
                        f"self-deadlock: non-reentrant lock {a!r} "
                        f"acquired while already held ({where})"))
                continue
            ra, rb = self.view.rank_of(a), self.view.rank_of(b)
            if ra is None or rb is None:
                continue  # unregistered ends are GB104's finding
            if ra >= rb:
                violations.append((
                    reg_path, 1, CODE_RANK,
                    f"lock-order inversion: {a!r} (rank {ra}) held "
                    f"while acquiring {b!r} (rank {rb}) at {where} — "
                    f"edges must ascend in rank or the ranking must "
                    f"change (with every OTHER nesting re-checked)"))
        for cycle in self._cycles({e for e in edges if e[0] != e[1]}):
            violations.append((
                reg_path, 1, CODE_CYCLE,
                f"lock-order cycle (potential deadlock): "
                f"{' -> '.join(cycle + (cycle[0],))}"))
        return edges, violations

    @staticmethod
    def _cycles(edge_set: Set[Tuple[str, str]]) -> List[Tuple[str, ...]]:
        graph: Dict[str, List[str]] = {}
        for a, b in sorted(edge_set):
            graph.setdefault(a, []).append(b)
        seen: Set[str] = set()
        cycles: List[Tuple[str, ...]] = []

        def dfs(node, stack, on_stack):
            seen.add(node)
            on_stack[node] = len(stack)
            stack.append(node)
            for nxt in graph.get(node, ()):
                if nxt in on_stack:
                    cycles.append(tuple(stack[on_stack[nxt]:]))
                elif nxt not in seen:
                    dfs(nxt, stack, on_stack)
            stack.pop()
            del on_stack[node]

        for start in sorted(graph):
            if start not in seen:
                dfs(start, [], {})
        return cycles


def build_graph(repo: str, view: Optional[RegistryView] = None
                ) -> Tuple[Dict[Tuple[str, str], str],
                           List[Tuple[str, int, str, str]]]:
    """Convenience: parse the repository's scanned modules and return
    (edges, violations) — tests and lockwatch consumers use this."""
    import os
    analysis = LockOrderAnalysis(view)
    for relpath in sorted(analysis.view.scanned_relpaths()):
        path = os.path.join(repo, relpath)
        try:
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        analysis.add_file(relpath, tree)
    return analysis.finish()
