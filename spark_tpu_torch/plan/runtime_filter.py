"""Runtime join-filter injection (the port of
`spark_tpu/plan/runtime_filter.py`; reference: InjectRuntimeFilter.scala:1).

The planner-side rule of the runtime-filter subsystem: walk the physical
plan and, for each join whose build side is selective and small, wrap
the probe-side subtree in a `RuntimeFilterExec` that prunes probe rows
against a device Bloom filter + min/max key bounds built from the
build-side keys (execution/join.py kernels over sketch.py).

Creation-side extraction follows the reference's
`extractSelectiveFilterOverScan`: descend from the join's build child
through exchanges, joins (into the child the key column originates
from), aggregates (through group keys), sorts and limits, until a cheap
Project/Filter-over-leaf chain evaluates the key. Every descent step
only ever WIDENS the key set (join outputs, aggregate group keys and
limits are subsets of their origin columns), so the filter built from
the chain is a superset of the true build keys — pruning stays sound,
it just prunes less than a perfect filter would.

Injection preconditions:
- join type is probe-prunable (inner / left_semi: dropping a probe row
  with no build match cannot change the result);
- the creation chain is selective (a FilterExec or pushed scan filters
  — an unfiltered table filters nothing worth the build);
- estimated creation bytes <= runtimeFilter.creationSideThreshold
  (the chain is recomputed for the filter, reference-style).

The planner skips the rule when spark_tpu.sql.runtimeFilter.enabled is
false. A filter goes below the probe side's exchange when it has one,
as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

from ..expr import Alias, ColumnRef, Expression, plain_column_name
from . import physical as P

ENABLED_KEY = "spark_tpu.sql.runtimeFilter.enabled"
THRESHOLD_KEY = "spark_tpu.sql.runtimeFilter.creationSideThreshold"
FPP_KEY = "spark_tpu.sql.runtimeFilter.expectedFpp"
SEMI_KEY = "spark_tpu.sql.runtimeFilter.semiAwareCreation"

#: join types where dropping a non-matching probe row preserves results
_PRUNABLE_JOINS = ("inner", "left_semi")


def estimate_rows_physical(node: P.PhysicalPlan) -> Optional[int]:
    """Upper-bound-ish row estimate over the PHYSICAL tree (the
    planner.estimate_rows analog after conversion; exchanges and
    filters pass through, inner joins take the FK max heuristic)."""
    if isinstance(node, P.ScanExec):
        return node.source.estimated_rows()
    if isinstance(node, P.RangeExec):
        return node.num_rows()
    if isinstance(node, (P.ProjectExec, P.FilterExec, P.SortExec,
                         P.ExchangeExec, P.WindowExec,
                         P.HashAggregateExec, P.RuntimeFilterExec)):
        return estimate_rows_physical(node.children[0])
    if isinstance(node, P.LimitExec):
        child = estimate_rows_physical(node.children[0])
        return node.n if child is None else min(node.n, child)
    if isinstance(node, P.JoinExec):
        if node.how in ("left_semi", "left_anti"):
            return estimate_rows_physical(node.children[0])
        l = estimate_rows_physical(node.children[0])
        r = estimate_rows_physical(node.children[1])
        if node.how == "inner" and l is not None and r is not None:
            return max(l, r)
        return None
    if isinstance(node, P.UnionExec):
        l = estimate_rows_physical(node.children[0])
        r = estimate_rows_physical(node.children[1])
        if l is not None and r is not None:
            return l + r
    return None


def _resolves(e: Expression, schema) -> bool:
    try:
        e.dtype(schema)
        return True
    except Exception:
        return False


def _cheap_chain(node: P.PhysicalPlan) -> bool:
    """True when the subtree is only Project/Filter over one leaf —
    cheap enough to recompute for the filter build (the reference
    bounds its creation side the same way)."""
    while isinstance(node, (P.ProjectExec, P.FilterExec)):
        node = node.children[0]
    return isinstance(node, P.LeafExec)


def _chain_selective(node: P.PhysicalPlan) -> bool:
    """A creation chain is worth a filter only if something narrows it:
    a residual FilterExec, filters pushed into the scan, or (for a
    synthesized semi-narrowed creation) a selective side of the semi."""
    while isinstance(node, (P.ProjectExec, P.FilterExec)):
        if isinstance(node, P.FilterExec):
            return True
        node = node.children[0]
    if isinstance(node, P.JoinExec) and node.creation_side:
        return (_chain_selective(node.children[0])
                or _chain_selective(node.children[1]))
    return isinstance(node, P.ScanExec) and bool(node.pushed_filters)


def _substitute(expr: Expression, mapping: dict) -> Expression:
    def f(node):
        if isinstance(node, ColumnRef) and node._name in mapping:
            return mapping[node._name]
        return node
    return expr.transform_up(f)


def _semi_other(node: P.PhysicalPlan) -> Optional[P.PhysicalPlan]:
    """The build side of a SYNTHESIZED creation semi: a cheap,
    recomputable copy of `node` with pass-throughs stripped. Cheap
    Project/Filter-over-leaf chains are shared verbatim (the documented
    creation DAG); equi-joins of cheap sides are shallow-copied with
    `creation_side` set so the planner tags them in the cj namespace.
    Dropping a Sort/Limit/RuntimeFilter hop only WIDENS the semi's keep
    set — still a superset of the true build keys, so still sound."""
    while isinstance(node, (P.ExchangeExec, P.SortExec, P.LimitExec,
                            P.RuntimeFilterExec)):
        node = node.children[0]
    if _cheap_chain(node):
        return node
    if isinstance(node, P.JoinExec) and node.how in ("inner",
                                                     "left_semi"):
        l = _semi_other(node.left)
        r = _semi_other(node.right)
        if l is None or r is None:
            return None
        new = copy.copy(node)
        new.creation_side = True
        new.children = (l, r)
        return new
    return None


def _creation_anchor(node: P.PhysicalPlan) -> P.PhysicalPlan:
    """The original-tree node a (possibly nested-synthesized) creation
    chain bottoms out at: synthesized left-semis preserve their left
    child's schema, so the anchor's schema IS the creation's schema."""
    while isinstance(node, P.JoinExec) and node.creation_side:
        node = node.children[0]
    return node


def _tree_contains(node: P.PhysicalPlan, target: P.PhysicalPlan) -> bool:
    if node is target:
        return True
    return any(_tree_contains(c, target) for c in node.children)


def _keys_transparent(node: P.PhysicalPlan, target: P.PhysicalPlan,
                      names) -> bool:
    """True when every descent hop from `node` down to `target` passes
    the columns in `names` through UNCHANGED (same name, same value),
    so an ancestor join's key exprs resolve against target's schema to
    the values they had at `node`. Name-resolution alone is NOT enough:
    a Project that aliases a different expr onto a key's name while the
    underlying relation keeps a same-named physical column would bind
    the wrong column and build the filter from a non-superset — so a
    shadowing Project, a join whose children both carry a key name
    (ambiguous binding), or an aggregate that computes one fails the
    check and the synthesis is skipped."""
    if node is target:
        return True
    if isinstance(node, P.JoinExec) and node.creation_side:
        return _keys_transparent(node.children[0], target, names)
    if isinstance(node, (P.ExchangeExec, P.SortExec, P.LimitExec,
                         P.RuntimeFilterExec, P.FilterExec)):
        return _keys_transparent(node.children[0], target, names)
    if isinstance(node, P.ProjectExec):
        for e in node.exprs:
            if isinstance(e, Alias) and e.name() in names:
                base = e.child
                if not (isinstance(base, ColumnRef)
                        and base.name() == e.name()):
                    return False
        return _keys_transparent(node.children[0], target, names)
    if isinstance(node, P.JoinExec):
        l_names = set(node.left.schema().names)
        r_names = set(node.right.schema().names)
        if any(n in l_names and n in r_names for n in names):
            return False
        for child in node.children:
            if _tree_contains(child, target):
                side = l_names if child is node.children[0] else r_names
                if not all(n in side for n in names):
                    return False
                return _keys_transparent(child, target, names)
        return False
    if isinstance(node, P.HashAggregateExec):
        for n in names:
            ok = False
            for g in node.group_exprs:
                if g.name() != n:
                    continue
                base = g
                while isinstance(base, Alias):
                    base = base.child
                ok = isinstance(base, ColumnRef) and base.name() == n
            if not ok:
                return False
        return _keys_transparent(node.children[0], target, names)
    return False


def _synthesize_semi(join: P.JoinExec, side: str,
                     sub: Tuple[P.PhysicalPlan, Expression]
                     ) -> Optional[Tuple[P.PhysicalPlan, Expression]]:
    """Wrap a creation chain extracted from `join`'s `side` child in a
    left-semi against the OTHER child, so the creation keys inherit the
    other side's narrowing (Q5: customer inherits the nation<-region
    semi-effect) instead of widening past it. Ignoring the join's
    residual condition (and any Sort/Limit dropped by `_semi_other`)
    only widens the keep set, so the synthesized chain still yields a
    superset of the true build keys."""
    creation, ckey = sub
    if side == "left":
        other_child, keys_self, keys_other = \
            join.right, join.left_keys, join.right_keys
    else:
        other_child, keys_self, keys_other = \
            join.left, join.right_keys, join.left_keys
    if not keys_self:
        return None
    other = _semi_other(other_child)
    if other is None or not _chain_selective(other):
        return None  # nothing to inherit: plain descent is equivalent
    # the join keys must survive the descent: a Project hop may have
    # renamed them away from creation's output
    if not all(_resolves(k, creation.schema()) for k in keys_self):
        return None
    if not all(_resolves(k, other.schema()) for k in keys_other):
        return None
    # ... and resolve to the SAME VALUES they had at the join's child:
    # name resolution alone would let a shadowing Project (a different
    # expr aliased onto a key name over a relation that keeps a
    # same-named physical column) bind the wrong column and build the
    # filter from a non-superset — silently wrong results
    names = [plain_column_name(k) for k in keys_self]
    if any(n is None for n in names):
        return None
    self_child = join.left if side == "left" else join.right
    if not _keys_transparent(self_child, _creation_anchor(creation),
                             names):
        return None
    semi = P.JoinExec(creation, other, keys_self, keys_other,
                      how="left_semi", condition=None,
                      out_schema=creation.schema())
    semi.creation_side = True
    return semi, ckey


def extract_creation_side(node: P.PhysicalPlan, key: Expression,
                          semi_aware: bool = False
                          ) -> Optional[Tuple[P.PhysicalPlan, Expression]]:
    """Descend from a join's build child to the cheap chain the key
    column originates from. Returns (creation_plan, key_expr) with the
    key rewritten to evaluate against creation_plan's output, or None.
    Every hop preserves the superset property (see module docstring).
    With `semi_aware`, a descent through an equi-join whose other side
    is selective keeps that side's effect as a synthesized left-semi
    (`runtimeFilter.semiAwareCreation`)."""
    if _cheap_chain(node) and _resolves(key, node.schema()):
        return node, key
    if isinstance(node, (P.ExchangeExec, P.SortExec, P.LimitExec,
                         P.RuntimeFilterExec)):
        return extract_creation_side(node.children[0], key, semi_aware)
    if isinstance(node, P.FilterExec):
        # descending past the filter widens the key set: still sound
        return extract_creation_side(node.children[0], key, semi_aware)
    if isinstance(node, P.ProjectExec):
        mapping = {}
        for e in node.exprs:
            if isinstance(e, Alias):
                mapping[e.name()] = e.child
            elif isinstance(e, ColumnRef):
                mapping[e.name()] = e
        new = _substitute(key, mapping)
        if _resolves(new, node.children[0].schema()):
            return extract_creation_side(node.children[0], new,
                                         semi_aware)
        return None
    if isinstance(node, P.JoinExec):
        name = plain_column_name(key)
        if name is None:
            return None
        left_names = list(node.left.schema().names)
        if node.how in ("left_semi", "left_anti"):
            if name not in left_names:
                return None
            sub = extract_creation_side(node.left, ColumnRef(name),
                                        semi_aware)
            if semi_aware and sub is not None \
                    and node.how == "left_semi":
                semi = _synthesize_semi(node, "left", sub)
                if semi is not None:
                    return semi
            return sub
        out_names = list(node.schema().names)
        if name not in out_names:
            return None
        idx = out_names.index(name)
        n_left = len(left_names)
        if idx < n_left:
            sub = extract_creation_side(node.left,
                                        ColumnRef(left_names[idx]),
                                        semi_aware)
            side = "left"
        else:
            right_names = list(node.right.schema().names)
            if idx - n_left >= len(right_names):
                return None
            sub = extract_creation_side(
                node.right, ColumnRef(right_names[idx - n_left]),
                semi_aware)
            side = "right"
        if semi_aware and sub is not None and node.how == "inner":
            semi = _synthesize_semi(node, side, sub)
            if semi is not None:
                return semi
        return sub
    if isinstance(node, P.HashAggregateExec):
        name = plain_column_name(key)
        for g in node.group_exprs:
            if g.name() != name:
                continue
            base = g
            while isinstance(base, Alias):
                base = base.child
            if isinstance(base, ColumnRef):
                return extract_creation_side(node.children[0],
                                             ColumnRef(base.name()),
                                             semi_aware)
        return None
    return None


def inject_runtime_filters(plan: P.PhysicalPlan, conf
                           ) -> P.PhysicalPlan:
    """Bottom-up walk wrapping eligible joins' probe subtrees (below
    their exchange) in RuntimeFilterExec nodes. Tags are assigned by
    the planner's _assign_join_tags pass afterwards."""
    threshold = int(conf.get(THRESHOLD_KEY))
    fpp = float(conf.get(FPP_KEY))
    # synthesized creation semis are sound only when every shard sees
    # the full other side — always, on the port's one device
    semi_aware = bool(conf.get(SEMI_KEY))

    def walk(node):
        new_children = tuple(walk(c) for c in node.children)
        if new_children != node.children:
            node = copy.copy(node)
            node.children = new_children
        if isinstance(node, P.JoinExec) and node.how in _PRUNABLE_JOINS:
            injected = _try_inject(node, threshold, fpp, semi_aware)
            if injected is not None:
                node = injected
        return node

    return walk(plan)


def _try_inject(join: P.JoinExec, threshold: int, fpp: float,
                semi_aware: bool = False) -> Optional[P.JoinExec]:
    probe, build = join.children
    target = probe.children[0] if isinstance(probe, P.ExchangeExec) \
        else probe
    if isinstance(target, P.RuntimeFilterExec):
        return None  # one filter per probe side
    for pk, bk in zip(join.left_keys, join.right_keys):
        found = extract_creation_side(build, bk, semi_aware)
        if found is None:
            continue
        creation, build_key = found
        if creation is target:
            continue  # self-filter: the probe IS the creation chain
        if not _chain_selective(creation):
            continue
        rows = estimate_rows_physical(creation)
        if rows is None:
            continue
        width = 8 * max(1, len(creation.schema().fields))
        if rows * width > threshold:
            continue
        if not _resolves(pk, target.schema()):
            continue
        # bucketed, as the JAX package prints it (there it keeps the
        # stage-cache key stable). Bloom sizing only rounds UP — the
        # false-positive rate can only improve.
        from ..columnar import bucket_capacity
        rf = P.RuntimeFilterExec(target, creation, pk, build_key,
                                 est_items=bucket_capacity(max(int(rows), 8)),
                                 fpp=fpp)
        new_join = copy.copy(join)
        if isinstance(probe, P.ExchangeExec):
            new_ex = copy.copy(probe)
            new_ex.children = (rf,)
            new_join.children = (new_ex, build)
        else:
            new_join.children = (rf, build)
        return new_join
    return None
