"""Cost-based join reorder (the port of `spark_tpu/plan/join_reorder.py`;
reference: CostBasedJoinReorder.scala:1).

A logical optimizer rule that re-sequences maximal regions of inner
equi-joins (chains and bushes of `Join(how='inner', condition=None)`)
by estimated cost. TPC-DS's deep snowflakes are where join ORDER, not
kernel choice, dominates: joining the most selective dimensions first
shrinks every intermediate the later joins (and the runtime filters
built on them) ever see.

Cost model — the planner-statistics sliver, star-schema shaped:

- each base relation contributes `base` rows (source statistics via
  `planner.estimate_rows`, ignoring filters) and a filter selectivity
  `frac` estimated from its Filter chain (equality ~0.1 per conjunct,
  ranges interpolated against Parquet-footer column min/max when
  `spark_tpu.sql.stats.parquetFooter` provides them, OR/NOT combined
  probabilistically);
- an inner FK join of an accumulated side A with relation R produces
  `max(rows) x frac(smaller side)` rows — joining a filtered dimension
  scales the fact side by the dimension's selectivity;
- the chosen order minimizes the SUM of intermediate result sizes
  (left-deep dynamic programming over connected subsets, Selinger
  -style, bounded by `spark_tpu.sql.cbo.maxReorderRelations`).

The rebuilt tree keeps the engine's orientation convention (larger
side on the probe/left, dimensions on the build/right — the same
convention the SQL frontend's size flip establishes) and is wrapped in
a Project restoring the original output schema, so everything above is
oblivious. The rule runs BEFORE physical planning, hence before
runtime-filter injection: creation sides are chosen on the REORDERED
tree, composing with (not bypassing) the PR-1/7 filter machinery.

Soundness gates — a region is only reordered when:
- every join key is a plain column reference and resolves to exactly
  one region relation (no `_r` rename collisions anywhere in the
  region);
- every relation has a row estimate (no estimate -> no cost -> keep
  the frontend order);
- the region joins are all plain inner equi-joins (a residual
  condition or null-aware join is a region BOUNDARY, reordering may
  still happen below it).

The rule makes the same decisions as the JAX package's, so the reordered
plans print alike. The JAX package's decision log and per-join
estimate annotation (its event log and prediction grading) are not
ported."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..expr import (And, BinaryComparison, ColumnRef, EQ, Expression,
                    GE, GT, In, IsNull, LE, LT, NE, Not, Or,
                    plain_column_name)
from . import logical as L
from .rules import Rule

ENABLED_KEY = "spark_tpu.sql.cbo.joinReorder"
MAX_RELATIONS_KEY = "spark_tpu.sql.cbo.maxReorderRelations"
STATS_FOOTER_KEY = "spark_tpu.sql.stats.parquetFooter"

#: fallback selectivities when no tighter bound is derivable (the
#: FilterEstimation.scala defaults, same spirit)
SEL_EQ = 0.1
SEL_RANGE = 0.33
SEL_ISNULL = 0.05
SEL_DEFAULT = 0.5


# ---------------------------------------------------------------------------
# Selectivity estimation
# ---------------------------------------------------------------------------


def _numeric(value) -> Optional[float]:
    """Best-effort numeric view of a stats/literal value (dates ->
    epoch days, Decimal -> float)."""
    import datetime
    import decimal
    if value is None or isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, decimal.Decimal):
        return float(value)
    if isinstance(value, datetime.date):
        return float((value - datetime.date(1970, 1, 1)).days)
    return None


def _scan_stats(leaf: L.LogicalPlan, conf) -> Dict[str, dict]:
    """Column stats of the scan at the bottom of a Filter/Scan chain
    (empty when disabled, unavailable, or the chain projects/aliases —
    a renamed column must not bind another column's bounds)."""
    if conf is None or not bool(conf.get(STATS_FOOTER_KEY)):
        return {}
    node = leaf
    while isinstance(node, L.Filter):
        node = node.child
    if not isinstance(node, L.Scan):
        return {}
    try:
        stats = node.source.column_stats()
    except Exception:  # noqa: BLE001 — stats are advisory
        return {}
    return stats or {}


def _range_fraction(stats: Optional[dict], op, lit_value) -> float:
    """Fraction of [min, max] selected by `col <op> literal`, linearly
    interpolated from footer stats; SEL_RANGE when unavailable."""
    if not stats:
        return SEL_RANGE
    lo = _numeric(stats.get("min"))
    hi = _numeric(stats.get("max"))
    v = _numeric(lit_value)
    if lo is None or hi is None or v is None or hi <= lo:
        return SEL_RANGE
    frac = (v - lo) / (hi - lo)
    frac = min(1.0, max(0.0, frac))
    if op in (LT, LE):
        out = frac
    else:  # GT, GE
        out = 1.0 - frac
    # clamp away from 0: footer min/max are bounds, not histograms
    return min(1.0, max(0.01, out))


def estimate_selectivity(cond: Expression, stats: Dict[str, dict]) -> float:
    """Heuristic selectivity of one predicate over its relation."""
    if isinstance(cond, And):
        a, b = cond.children
        return estimate_selectivity(a, stats) * \
            estimate_selectivity(b, stats)
    if isinstance(cond, Or):
        a = estimate_selectivity(cond.children[0], stats)
        b = estimate_selectivity(cond.children[1], stats)
        return min(1.0, a + b - a * b)
    if isinstance(cond, Not):
        return max(0.0, 1.0 - estimate_selectivity(cond.children[0],
                                                   stats))
    if isinstance(cond, EQ):
        return SEL_EQ
    if isinstance(cond, NE):
        return 1.0 - SEL_EQ
    if isinstance(cond, In):
        return min(1.0, SEL_EQ * max(1, len(cond.values)))
    if isinstance(cond, IsNull):
        return SEL_ISNULL
    if isinstance(cond, BinaryComparison) and \
            type(cond) in (LT, LE, GT, GE):
        from ..expr import Literal
        le, re = cond.children
        if isinstance(le, ColumnRef) and isinstance(re, Literal):
            return _range_fraction(stats.get(le.name()), type(cond),
                                   re.value)
        if isinstance(re, ColumnRef) and isinstance(le, Literal):
            flipped = {LT: GT, LE: GE, GT: LT, GE: LE}[type(cond)]
            return _range_fraction(stats.get(re.name()), flipped,
                                   le.value)
        return SEL_RANGE
    return SEL_DEFAULT


def _leaf_estimate(leaf: L.LogicalPlan, conf) -> Optional[Tuple[int, float]]:
    """(base_rows, selectivity_fraction) for one region relation: base
    from source statistics ignoring filters, fraction from the Filter
    chain's predicates. None when the source has no estimate."""
    from .planner import estimate_rows
    base = estimate_rows(leaf)
    if base is None or base <= 0:
        return None
    stats = _scan_stats(leaf, conf)
    frac = 1.0
    node = leaf
    while isinstance(node, (L.Filter, L.Project)):
        if isinstance(node, L.Filter):
            frac *= estimate_selectivity(node.condition, stats)
        node = node.children[0]
    return base, max(frac, 1.0 / max(base, 1))


# ---------------------------------------------------------------------------
# Region flattening
# ---------------------------------------------------------------------------


def _is_region_join(node: L.LogicalPlan) -> bool:
    return (isinstance(node, L.Join) and node.how == "inner"
            and node.condition is None and not node.null_aware
            and all(plain_column_name(k) is not None
                    for k in node.left_keys + node.right_keys))


class _Region:
    """A maximal flattened inner-equi-join region: `rels` in frontend
    (in-order) sequence, `edges` as (rel_a, name_a, rel_b, name_b)."""

    def __init__(self):
        self.rels: List[L.LogicalPlan] = []
        self.edges: List[Tuple[int, str, int, str]] = []
        self.ok = True

    def owner_of(self, name: str) -> Optional[int]:
        hits = [i for i, r in enumerate(self.rels)
                if name in r.schema().names]
        return hits[0] if len(hits) == 1 else None


def _flatten(node: L.LogicalPlan, region: _Region) -> None:
    if not region.ok:
        return
    if _is_region_join(node):
        # a rename inside the region means two relations collide on a
        # column name — key origins would be ambiguous; keep the tree
        nm = node.right_name_map()
        if any(k != v for k, v in nm.items()):
            region.ok = False
            return
        _flatten(node.left, region)
        _flatten(node.right, region)
        if not region.ok:
            return
        for lk, rk in zip(node.left_keys, node.right_keys):
            ln, rn = plain_column_name(lk), plain_column_name(rk)
            lo, ro = region.owner_of(ln), region.owner_of(rn)
            if lo is None or ro is None or lo == ro:
                region.ok = False
                return
            region.edges.append((lo, ln, ro, rn))
    else:
        region.rels.append(node)


# ---------------------------------------------------------------------------
# Order search (left-deep DP over connected subsets)
# ---------------------------------------------------------------------------


def _join_estimate(rows_a: float, frac_a: float, rows_b: float,
                   frac_b: float) -> float:
    """FK-heuristic output estimate: the larger side scaled by the
    smaller (dimension) side's accumulated filter selectivity."""
    if rows_a >= rows_b:
        return max(1.0, rows_a * min(1.0, frac_b))
    return max(1.0, rows_b * min(1.0, frac_a))


def _best_order(est: List[Tuple[int, float]],
                adj: List[int]) -> Optional[Tuple[Tuple[int, ...],
                                                  List[int]]]:
    """Minimal-cost left-deep order over connected subsets.
    `est[i] = (rows_i, frac_i)`, `adj[i]` = bitmask of neighbors.
    Returns (order, per-join estimated output rows) or None when the
    region graph is disconnected."""
    n = len(est)
    full = (1 << n) - 1
    # state per subset: (cost, order, rows, frac, per_join_rows)
    best: Dict[int, Tuple[float, Tuple[int, ...], float, float,
                          List[int]]] = {}
    for i in range(n):
        rows = max(1.0, est[i][0] * est[i][1])
        best[1 << i] = (0.0, (i,), rows, est[i][1], [])
    for mask in range(1, full + 1):
        state = best.get(mask)
        if state is None:
            continue
        cost, order, rows, frac, per = state
        for i in range(n):
            bit = 1 << i
            if mask & bit or not (adj[i] & mask):
                continue
            ri = max(1.0, est[i][0] * est[i][1])
            out = _join_estimate(rows, frac, ri, est[i][1])
            nxt = (cost + out, order + (i,), out,
                   min(1.0, frac * est[i][1]), per + [int(out)])
            cur = best.get(mask | bit)
            # deterministic: strictly-better cost wins; ties keep the
            # lexicographically-earlier order (frontend bias)
            if cur is None or (nxt[0], nxt[1]) < (cur[0], cur[1]):
                best[mask | bit] = nxt
    final = best.get(full)
    if final is None:
        return None
    return final[1], final[4]


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------


class CostBasedJoinReorder(Rule):
    name = "CostBasedJoinReorder"
    # the restoring Project keeps names/dtypes but re-derives
    # nullability from the reordered join tree
    schema_preserving = False

    def __init__(self, conf=None):
        self.conf = conf

    def apply(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        if self.conf is None or not bool(self.conf.get(ENABLED_KEY)):
            return plan
        return self._rewrite(plan)

    def _rewrite(self, node: L.LogicalPlan) -> L.LogicalPlan:
        if _is_region_join(node):
            out = self._try_region(node)
            if out is not None:
                return out
        return node.map_children(self._rewrite)

    @staticmethod
    def _signature(node: L.LogicalPlan, leaf_index: Dict[int, int]):
        """Shape signature of a region tree: leaves by region index,
        joins by (children signatures, key-name pairs) — the change
        test (attribute-based same_result would see the advisory
        `_cbo_est_rows` annotation as a difference)."""
        if _is_region_join(node):
            pairs = tuple(sorted(
                (plain_column_name(lk), plain_column_name(rk))
                for lk, rk in zip(node.left_keys, node.right_keys)))
            return ("J",
                    CostBasedJoinReorder._signature(node.left, leaf_index),
                    CostBasedJoinReorder._signature(node.right, leaf_index),
                    pairs)
        return ("R", leaf_index[id(node)])

    def _try_region(self, node: L.LogicalPlan) -> Optional[L.LogicalPlan]:
        """Reorder one maximal region; None = not eligible (caller
        recurses into children instead)."""
        max_rels = int(self.conf.get(MAX_RELATIONS_KEY))
        region = _Region()
        _flatten(node, region)
        if not region.ok or not (3 <= len(region.rels) <= max_rels):
            return None
        # estimates; any missing -> keep the frontend order
        est: List[Tuple[int, float]] = []
        for rel in region.rels:
            e = _leaf_estimate(rel, self.conf)
            if e is None:
                return None
            est.append(e)
        n = len(region.rels)
        adj = [0] * n
        for a, _na, b, _nb in region.edges:
            adj[a] |= 1 << b
            adj[b] |= 1 << a
        found = _best_order(est, adj)
        if found is None:
            return None  # disconnected region (cross joins): keep
        order, _per_join = found
        # rewrite the region relations themselves first (nested regions
        # under aggregates/subqueries)
        rels = [self._rewrite(r) for r in region.rels]
        rebuilt, new_leaf_index = self._build(rels, est, region.edges,
                                              order)
        if rebuilt is None:
            return None
        orig_leaf_index = {id(r): i for i, r in enumerate(region.rels)}
        changed = (self._signature(node, orig_leaf_index)
                   != self._signature(rebuilt, new_leaf_index))
        if not changed:
            # keep the frontend tree (modulo rewritten leaves below it)
            return self._rebuild_shape(node, {
                id(r): new for r, new in zip(region.rels, rels)})
        # restore the original output schema (names AND order) so
        # everything above the region is oblivious to the reorder
        from ..expr import ColumnRef as Ref
        orig_names = node.schema().names
        return L.Project(rebuilt, [Ref(nm) for nm in orig_names])

    def _rebuild_shape(self, node: L.LogicalPlan,
                       leaf_map: Dict[int, L.LogicalPlan]
                       ) -> L.LogicalPlan:
        """The original region tree with its leaves swapped for their
        rewritten versions (identity-preserving when nothing below
        changed)."""
        if _is_region_join(node):
            left = self._rebuild_shape(node.left, leaf_map)
            right = self._rebuild_shape(node.right, leaf_map)
            if left is node.left and right is node.right:
                return node
            return L.Join(left, right, node.left_keys, node.right_keys,
                          "inner")
        return leaf_map[id(node)]

    def _build(self, rels: List[L.LogicalPlan],
               est: List[Tuple[int, float]],
               edges: List[Tuple[int, str, int, str]],
               order: Tuple[int, ...]
               ) -> Tuple[Optional[L.LogicalPlan], Dict[int, int]]:
        """Left-deep tree over `order`, orientation following the
        engine convention: bigger estimated side on the probe (left).
        Also returns the id(new leaf) -> region index map for the
        shape-signature change test.

        Orientation follows BASE capacities, not post-filter estimates:
        the engine masks filtered rows rather than compacting them, so
        the side with more physical rows (the fact) must stay on the
        probe/left regardless of how selective its filters are — a
        build side is sorted at its full static capacity."""
        leaf_index = {id(rels[i]): i for i in range(len(rels))}
        bound = {order[0]}
        acc = rels[order[0]]
        acc_rows = max(1.0, est[order[0]][0] * est[order[0]][1])
        acc_frac = est[order[0]][1]
        acc_cap = float(est[order[0]][0])
        for i in order[1:]:
            acc_keys: List[Expression] = []
            rel_keys: List[Expression] = []
            for a, na, b, nb in edges:
                if a in bound and b == i:
                    acc_keys.append(ColumnRef(na))
                    rel_keys.append(ColumnRef(nb))
                elif b in bound and a == i:
                    acc_keys.append(ColumnRef(nb))
                    rel_keys.append(ColumnRef(na))
            if not acc_keys:
                return None, leaf_index  # disconnected step
            ri = max(1.0, est[i][0] * est[i][1])
            if float(est[i][0]) > acc_cap:
                join = L.Join(rels[i], acc, rel_keys, acc_keys, "inner")
            else:
                join = L.Join(acc, rels[i], acc_keys, rel_keys, "inner")
            out = _join_estimate(acc_rows, acc_frac, ri, est[i][1])
            acc = join
            acc_rows = out
            acc_frac = min(1.0, acc_frac * est[i][1])
            acc_cap = max(acc_cap, float(est[i][0]))
            bound.add(i)
        return acc, leaf_index
