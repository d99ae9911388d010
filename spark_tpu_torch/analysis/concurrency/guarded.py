"""Guarded-by analysis: declared shared state is written under its lock
(the port of `spark_tpu/analysis/concurrency/guarded.py`, over the
port's registry).

Three-way check, mirroring the fault-site lint:

1. declaration -> lock object: every `LockDecl` matches a real
   `threading.Lock()/RLock()/Condition()` creation site, and every
   creation site in `spark_tpu_torch/` is declared (GB104/GB105) — a new
   lock cannot ship unranked;
2. declaration -> state: every `GuardDecl`/`Waiver` names a class and
   attribute that actually exist (GB103) — the registry cannot go
   stale;
3. state -> use sites: every write to a declared attribute outside
   `__init__` sits inside `with <declared lock>` (GB101), and every
   OTHER instance-attribute write in a shared class is either
   declared, waived, or a finding (GB102) — shared mutable state must
   be inventoried, not discovered in an incident.

Thread-confined state is exempt two ways: classes declared
`ConfinedDecl` (ContextVar-installed / single-consumer instances),
and module globals initialized from `ContextVar(...)`, which the
scanner recognizes automatically.

Write detection covers `self.<attr> = / += / del`, subscript stores
`self.<attr>[k] = v`, mutating method calls (`.append`, `.pop`,
`.setdefault`, ...), the same shapes through the registry's named
receivers (`entry.current_record = ...`), and module globals (both
`global X` rebinds and mutator calls on module-level collection
literals). Mutations through local aliases are out of scope — see the
package docstring.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import registry as _reg

#: method names that mutate their receiver in place
MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "remove", "discard", "clear", "setdefault", "move_to_end",
    "appendleft", "popleft", "sort", "reverse",
})

#: methods exempt from write checks (construction happens-before)
INIT_METHODS = ("__init__", "__new__", "__post_init__")

CODE_UNGUARDED = "GB101"
CODE_UNDECLARED = "GB102"
CODE_STALE_DECL = "GB103"
CODE_UNREG_LOCK = "GB104"
CODE_STALE_LOCK = "GB105"
CODE_EMPTY_WAIVER = "GB107"


@dataclass
class RegistryView:
    """The subset of the registry the analyses consult — injectable so
    tests can run the passes against synthetic declarations."""

    locks: tuple = _reg.LOCKS
    guards: tuple = _reg.GUARDED_BY
    waivers: tuple = _reg.WAIVERS
    confined: tuple = _reg.CONFINED
    receiver_names: dict = field(
        default_factory=lambda: dict(_reg.RECEIVER_NAMES))
    receiver_attrs: dict = field(
        default_factory=lambda: dict(_reg.RECEIVER_ATTRS))
    factory_returns: dict = field(
        default_factory=lambda: dict(_reg.FACTORY_RETURNS))
    context_managers: dict = field(
        default_factory=lambda: dict(_reg.CONTEXT_MANAGERS))
    extra_edges: tuple = _reg.EXTRA_EDGES
    held_callees: dict = field(
        default_factory=lambda: dict(_reg.CALLED_WITH_LOCK_HELD))

    # -- derived lookups ----------------------------------------------------

    def class_locks(self, relpath: str, cls: str) -> Dict[str, str]:
        return {d.attr: d.lock_id for d in self.locks
                if d.relpath == relpath and d.cls == cls}

    def guard_map(self, relpath: str, cls: str) -> Dict[str, str]:
        return {g.attr: g.lock for g in self.guards
                if g.relpath == relpath and g.cls == cls}

    def waived(self, relpath: str, cls: str) -> Set[str]:
        return {w.attr for w in self.waivers
                if w.relpath == relpath and w.cls == cls}

    def confined_classes(self, relpath: str) -> Set[str]:
        return {c.cls for c in self.confined if c.relpath == relpath}

    def shared_classes(self, relpath: str) -> Set[str]:
        """Classes the inventory applies to in this file: lock owners
        plus anything with guard or waiver declarations."""
        out = {d.cls for d in self.locks
               if d.relpath == relpath and d.cls}
        out |= {g.cls for g in self.guards
                if g.relpath == relpath and g.cls}
        out |= {w.cls for w in self.waivers
                if w.relpath == relpath and w.cls}
        return out

    def scanned_relpaths(self) -> Set[str]:
        return ({d.relpath for d in self.locks}
                | {g.relpath for g in self.guards}
                | {w.relpath for w in self.waivers}
                | {c.relpath for c in self.confined})

    def rank_of(self, lock_id: str) -> Optional[int]:
        for d in self.locks:
            if d.lock_id == lock_id:
                return d.rank
        return None

    def kind_of(self, lock_id: str) -> Optional[str]:
        for d in self.locks:
            if d.lock_id == lock_id:
                return d.kind
        return None


def _dotted(node: ast.expr) -> Optional[str]:
    """'self._lock' / 'entry.lock' / '_REGISTRY_LOCK' for simple
    name/attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _is_lock_ctor(call: ast.expr) -> Optional[str]:
    """'lock'/'rlock'/'condition' when `call` constructs one."""
    if not isinstance(call, ast.Call):
        return None
    fn = call.func
    name = None
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "threading":
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    return {"Lock": "lock", "RLock": "rlock",
            "Condition": "condition"}.get(name)


def _is_contextvar_ctor(call: ast.expr) -> bool:
    if not isinstance(call, ast.Call):
        return False
    fn = call.func
    return (isinstance(fn, ast.Name) and fn.id == "ContextVar") or \
        (isinstance(fn, ast.Attribute) and fn.attr == "ContextVar")


@dataclass
class _Write:
    """One detected mutation site."""

    relpath: str
    line: int
    cls: str            # owning class ("" = module global)
    attr: str
    held: Tuple[str, ...]  # dotted lock exprs held at the site
    via: str            # "assign" | "augassign" | "del" | mutator name
    receiver: str       # "self" | receiver name | "" (global)


class GuardedAnalysis:
    """Feed files with `add_file`, then `finish()` -> (violations,
    notes). Violations are (relpath, line, code, message)."""

    def __init__(self, view: Optional[RegistryView] = None):
        self.view = view or RegistryView()
        #: (relpath, cls, attr) -> (line, kind) for lock creations
        self.lock_creations: Dict[Tuple[str, str, str],
                                  Tuple[int, str]] = {}
        #: (relpath, cls) -> attrs assigned anywhere (incl __init__)
        self.assigned: Dict[Tuple[str, str], Set[str]] = {}
        self.writes: List[_Write] = []
        self.violations: List[Tuple[str, int, str, str]] = []
        self._seen_files: Set[str] = set()

    # -- per-file -----------------------------------------------------------

    def add_file(self, relpath: str, tree: ast.Module) -> None:
        self._seen_files.add(relpath)
        in_scope = relpath in self.view.scanned_relpaths()
        module_globals = self._module_globals(tree)
        # module-level lock creations + global write checks
        self._scan_module_level(relpath, tree, module_globals, in_scope)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._scan_class(relpath, node, in_scope,
                                 module_globals)
        # lock creations can hide inside nested defs/classes too
        self._scan_all_lock_creations(relpath, tree)

    def _module_globals(self, tree: ast.Module) -> Dict[str, str]:
        """Module-level names -> 'contextvar' | 'collection' | 'other'
        (what the global-write checks key on)."""
        out: Dict[str, str] = {}
        for node in tree.body:
            targets = []
            value = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if _is_contextvar_ctor(value):
                    out[t.id] = "contextvar"
                elif isinstance(value, (ast.Dict, ast.List, ast.Set)) \
                        or (isinstance(value, ast.Call)
                            and isinstance(value.func, ast.Name)
                            and value.func.id in ("dict", "list", "set",
                                                  "OrderedDict")):
                    out[t.id] = "collection"
                else:
                    out[t.id] = "other"
        return out

    def _scan_all_lock_creations(self, relpath: str,
                                 tree: ast.Module) -> None:
        """Find every lock construction, attributed to (class, attr)
        for `self.X = threading.Lock()` inside a class, or ("", name)
        for module-level `X = threading.Lock()`."""
        def scan(node, cls: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    # only attribute top-level classes; nested classes
                    # keep the outer attribution off (rare, and their
                    # locks still get flagged under the outer class)
                    scan(child, child.name if cls == "" else cls)
                    continue
                if isinstance(child, ast.Assign):
                    kind = _is_lock_ctor(child.value)
                    if kind is not None:
                        for t in child.targets:
                            d = _dotted(t)
                            if d is None:
                                continue
                            if d.startswith("self."):
                                key = (relpath, cls, d[5:])
                            elif "." not in d:
                                key = (relpath, "" if cls == "" else cls,
                                       d)
                            else:
                                continue
                            self.lock_creations.setdefault(
                                key, (child.lineno, kind))
                scan(child, cls)

        scan(tree, "")

    def _scan_module_level(self, relpath: str, tree: ast.Module,
                           module_globals: Dict[str, str],
                           in_scope: bool) -> None:
        if not in_scope:
            return
        guard = self.view.guard_map(relpath, "")
        waived = self.view.waived(relpath, "")
        # top-level functions + class methods ONLY: _walk already
        # recurses nested defs, so walking every FunctionDef ast.walk
        # yields would double-report violations inside nested functions
        funcs = [n for n in tree.body
                 if isinstance(n, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))]
        for cls_node in tree.body:
            if isinstance(cls_node, ast.ClassDef):
                funcs += [n for n in cls_node.body
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
        for node in funcs:
            gnames = {n for st in ast.walk(node)
                      if isinstance(st, ast.Global) for n in st.names}
            self._walk(node.body, relpath, "", frozenset(),
                       watch_globals=gnames | {
                           n for n, k in module_globals.items()
                           if k == "collection" or n in guard
                           or n in waived},
                       module_globals=module_globals,
                       guard=guard, waived=waived,
                       confined_globals={
                           n for n, k in module_globals.items()
                           if k == "contextvar"},
                       exempt=False, shared=True)

    def _scan_class(self, relpath: str, node: ast.ClassDef,
                    in_scope: bool,
                    module_globals: Dict[str, str]) -> None:
        cls = node.name
        assigned = self.assigned.setdefault((relpath, cls), set())
        for sub in ast.walk(node):
            targets = []
            if isinstance(sub, ast.Assign):
                targets = sub.targets
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                targets = [sub.target]
            for t in targets:
                d = _dotted(t)
                if d is not None and d.startswith("self.") \
                        and d.count(".") == 1:
                    assigned.add(d[5:])
            # dataclass-style class-body annotations count as existing
            if isinstance(sub, ast.AnnAssign) \
                    and isinstance(sub.target, ast.Name):
                assigned.add(sub.target.id)
        if not in_scope:
            return
        shared = cls in self.view.shared_classes(relpath)
        confined = cls in self.view.confined_classes(relpath)
        if confined or not shared:
            # confined classes skip write checks; non-inventoried
            # classes are out of scope (receiver-writes into them are
            # handled from the writing file)
            return
        guard = self.view.guard_map(relpath, cls)
        waived = self.view.waived(relpath, cls)
        lock_attrs = set(self.view.class_locks(relpath, cls))
        for meth in node.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            exempt = meth.name in INIT_METHODS
            held0 = frozenset()
            held_lock = self.view.held_callees.get(
                (relpath, cls, meth.name))
            if held_lock is not None:
                held0 = frozenset({f"self.{held_lock}"})
            self._walk(meth.body, relpath, cls, held0,
                       watch_globals=set(), module_globals={},
                       guard=guard, waived=waived | lock_attrs,
                       confined_globals=set(), exempt=exempt,
                       shared=True)

    # -- statement walker with a held-locks stack ---------------------------

    def _walk(self, stmts, relpath, cls, held, *, watch_globals,
              module_globals, guard, waived, confined_globals, exempt,
              shared) -> None:
        kw = dict(watch_globals=watch_globals,
                  module_globals=module_globals, guard=guard,
                  waived=waived, confined_globals=confined_globals,
                  exempt=exempt, shared=shared)
        for st in stmts:
            if isinstance(st, (ast.With, ast.AsyncWith)):
                added = set()
                for item in st.items:
                    # earlier items of a multi-item `with a, b:` are
                    # already held while later items evaluate
                    self._exprs(item.context_expr, relpath, cls,
                                held | added, **kw)
                    d = _dotted(item.context_expr)
                    if d is not None:
                        added.add(d)
                self._walk(st.body, relpath, cls, held | added, **kw)
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def runs later, on an unknown thread with
                # no inherited lock: conservative empty held set
                self._walk(st.body, relpath, cls, frozenset(), **kw)
                continue
            if isinstance(st, ast.ClassDef):
                continue
            # this statement's own effects
            self._stmt(st, relpath, cls, held, **kw)
            # recurse into nested statement bodies
            for name in ("body", "orelse", "finalbody"):
                body = getattr(st, name, None)
                if body:
                    self._walk(body, relpath, cls, held, **kw)
            for h in getattr(st, "handlers", []) or []:
                self._walk(h.body, relpath, cls, held, **kw)

    def _stmt(self, st, relpath, cls, held, **kw) -> None:
        targets = []
        via = "assign"
        if isinstance(st, ast.Assign):
            targets = st.targets
        elif isinstance(st, ast.AugAssign):
            targets, via = [st.target], "augassign"
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            targets = [st.target]
        elif isinstance(st, ast.Delete):
            targets, via = st.targets, "del"
        for t in targets:
            self._target(t, relpath, cls, held, via, **kw)
        # mutator calls in this statement's OWN expressions — nested
        # statement bodies are excluded: the walker revisits them with
        # the correct held set (a `with self._lock:` inside a try arm
        # must not be scanned lock-less from the Try node)
        skip = set()
        for name in ("body", "orelse", "finalbody"):
            for sub in getattr(st, name, None) or []:
                skip.update(id(x) for x in ast.walk(sub))
        for h in getattr(st, "handlers", []) or []:
            for sub in h.body:
                skip.update(id(x) for x in ast.walk(sub))
        for sub in ast.walk(st):
            if id(sub) in skip:
                continue
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in MUTATORS:
                d = _dotted(sub.func.value)
                if d is not None:
                    self._write(relpath, sub.lineno, cls, d, held,
                                sub.func.attr, **kw)

    def _exprs(self, expr, relpath, cls, held, **kw) -> None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in MUTATORS:
                d = _dotted(sub.func.value)
                if d is not None:
                    self._write(relpath, sub.lineno, cls, d, held,
                                sub.func.attr, **kw)

    def _target(self, t, relpath, cls, held, via, **kw) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._target(el, relpath, cls, held, via, **kw)
            return
        if isinstance(t, ast.Subscript):
            d = _dotted(t.value)
        else:
            d = _dotted(t)
        if d is not None:
            self._write(relpath, t.lineno, cls, d, held, via, **kw)

    # -- write classification ----------------------------------------------

    def _write(self, relpath, line, cls, dotted, held, via, *,
               watch_globals, module_globals, guard, waived,
               confined_globals, exempt, shared) -> None:
        if exempt or not shared:
            return
        parts = dotted.split(".")
        if parts[0] == "self" and len(parts) == 2 and cls:
            self._check_attr(relpath, line, cls, parts[1], held, via,
                             receiver="self")
        elif cls == "" and len(parts) == 1:
            name = parts[0]
            if name in confined_globals:
                return  # ContextVar-backed: thread-confined by design
            if name not in watch_globals:
                return
            self._check_attr(relpath, line, "", name, held, via,
                             receiver="")
        elif len(parts) == 2 and parts[0] in self.view.receiver_names:
            # `entry.current_record = ...` — resolve the receiver to
            # its declaring class and apply that class's rules
            rcls = self.view.receiver_names[parts[0]]
            for g in self.view.guards:
                if g.cls == rcls and g.attr == parts[1]:
                    self._check_attr(g.relpath, line, rcls, parts[1],
                                     held, via, receiver=parts[0],
                                     at_relpath=relpath)
                    return
            for w in self.view.waivers:
                if w.cls == rcls and w.attr == parts[1]:
                    self.writes.append(_Write(relpath, line, rcls,
                                              parts[1], tuple(held),
                                              via, parts[0]))
                    return
            for d in self.view.locks:
                if d.cls == rcls:
                    self.violations.append((
                        relpath, line, CODE_UNDECLARED,
                        f"write to {rcls}.{parts[1]} (via receiver "
                        f"{parts[0]!r}) is not declared in GUARDED_BY "
                        f"or waived — shared state must be "
                        f"inventoried"))
                    return

    def _check_attr(self, relpath, line, cls, attr, held, via, *,
                    receiver, at_relpath=None) -> None:
        at = at_relpath or relpath
        guard = self.view.guard_map(relpath, cls)
        waived = self.view.waived(relpath, cls)
        lock_attrs = set(self.view.class_locks(relpath, cls))
        self.writes.append(_Write(at, line, cls, attr, tuple(held),
                                  via, receiver))
        if attr in waived:
            return
        if attr in guard:
            lock = guard[attr]
            want = f"{receiver}.{lock}" if receiver else lock
            if want not in held:
                label = f"{cls}.{attr}" if cls else attr
                self.violations.append((
                    at, line, CODE_UNGUARDED,
                    f"unguarded write to {label} (via {via}): "
                    f"GUARDED_BY declares lock {lock!r} but it is not "
                    f"held here (held: {sorted(held) or 'none'})"))
            return
        if receiver == "self" and attr in lock_attrs:
            return  # handled by the creation-site checks
        label = f"{cls}.{attr}" if cls else f"module global {attr}"
        self.violations.append((
            at, line, CODE_UNDECLARED,
            f"write to {label} (via {via}) is not declared in "
            f"GUARDED_BY, waived, or thread-confined — add a "
            f"GuardDecl, a Waiver with a reason, or a ConfinedDecl "
            f"(registry.py)"))

    # -- whole-tree verdicts ------------------------------------------------

    def finish(self) -> List[Tuple[str, int, str, str]]:
        v = self.view
        out = list(self.violations)
        # lock object <-> declaration, both directions
        declared = {(d.relpath, d.cls, d.attr): d for d in v.locks}
        for key, (line, kind) in self.lock_creations.items():
            if key not in declared:
                relpath, cls, attr = key
                label = f"{cls}.{attr}" if cls else attr
                out.append((relpath, line, CODE_UNREG_LOCK,
                            f"unregistered {kind}: {label} has no "
                            f"LockDecl (analysis/concurrency/"
                            f"registry.py) — every lock needs an "
                            f"acquisition-order rank"))
        for key, d in declared.items():
            if key not in self.lock_creations:
                out.append((d.relpath, 1, CODE_STALE_LOCK,
                            f"stale LockDecl {d.lock_id!r}: no "
                            f"threading.{d.kind} creation for "
                            f"{d.cls or '<module>'}.{d.attr} found"))
        # guard/waiver declarations name real state + a real lock
        for g in v.guards:
            locks = v.class_locks(g.relpath, g.cls)
            if g.lock not in locks:
                out.append((g.relpath, 1, CODE_STALE_DECL,
                            f"GuardDecl for {g.cls or '<module>'}."
                            f"{g.attr} names lock {g.lock!r} which has "
                            f"no LockDecl on that class"))
            if g.cls and g.attr not in self.assigned.get(
                    (g.relpath, g.cls), set()):
                out.append((g.relpath, 1, CODE_STALE_DECL,
                            f"stale GuardDecl: {g.cls}.{g.attr} is "
                            f"never assigned in the class"))
        for w in v.waivers:
            if not w.reason.strip():
                out.append((w.relpath, 1, CODE_EMPTY_WAIVER,
                            f"waiver for {w.cls or '<module>'}."
                            f"{w.attr} has no justification reason"))
            if w.cls and (w.relpath, w.cls) in self.assigned \
                    and w.attr not in self.assigned[(w.relpath, w.cls)]:
                out.append((w.relpath, 1, CODE_STALE_DECL,
                            f"stale Waiver: {w.cls}.{w.attr} is never "
                            f"assigned in the class"))
        return out

    def notes(self) -> List[str]:
        """The waiver list the lint prints (and --json carries)."""
        out = []
        for w in self.view.waivers:
            label = f"{w.cls}.{w.attr}" if w.cls else w.attr
            out.append(f"waiver: {w.relpath}: {label} — {w.reason}")
        for c in self.view.confined:
            out.append(f"confined: {c.relpath}: {c.cls} — {c.reason}")
        return out
