"""Aggregate functions as declarative accumulator specs.

The port of the `spark_tpu/expr_agg.py` subset the slices need: COUNT,
SUM, AVG, MIN and MAX (reference: DeclarativeAggregate in
`expressions/aggregate/interfaces.scala`). Each function declares flat
*accumulator* columns with an associative/commutative reduce kind, an
``update`` producing per-row contributions (already neutralized for
NULL/unselected rows), and a ``device_finalize``.

Decimal/integer SUM accumulates in int64 mod 2^64 (integer adds wrap):
intermediate wraparound is harmless because modular arithmetic recovers
the true sum whenever the final value fits int64 — the bound of the
scaled-decimal representation itself. The CUDA group-by kernel adds
with 64-bit atomics, which wrap the same way, so the sums are exact in
any order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import types as T
from .columnar import Batch
from .expr import Expression, Vec


@dataclass(frozen=True)
class AccSpec:
    """One accumulator column: reduce kind + device dtype + neutral value.

    `width` bounds the per-row contribution: width=8 promises values in
    [0, 256). The JAX package's MXU kernel uses it to carry fewer limbs;
    the CUDA kernel adds whole int64 values and ignores it."""

    suffix: str
    np_dtype: np.dtype
    reduce: str  # 'sum' | 'min' | 'max'
    width: int = 64

    @property
    def neutral(self):
        if self.reduce == "sum":
            return np.zeros((), self.np_dtype)
        if self.reduce == "min":
            return _max_of(self.np_dtype)
        return _min_of(self.np_dtype)


def _max_of(dt):
    if np.dtype(dt) == np.dtype(np.bool_):
        return np.array(True)
    return np.array(np.finfo(dt).max if np.issubdtype(dt, np.floating)
                    else np.iinfo(dt).max, dt)


def _min_of(dt):
    if np.dtype(dt) == np.dtype(np.bool_):
        return np.array(False)
    return np.array(np.finfo(dt).min if np.issubdtype(dt, np.floating)
                    else np.iinfo(dt).min, dt)


class AggregateFunction:
    """Base class. `child` may be None (COUNT(*))."""

    def __init__(self, child: Optional[Expression] = None):
        self.child = child
        self.children = (child,) if child is not None else ()

    def result_type(self, schema: T.Schema) -> T.DataType:
        raise NotImplementedError

    def result_nullable(self, schema: T.Schema) -> bool:
        return True

    def accumulators(self, schema: T.Schema) -> List[AccSpec]:
        raise NotImplementedError

    def update(self, batch: Batch, sel) -> List:
        """Per-row contribution tensors, one per accumulator, with the
        accumulator's neutral element wherever the row is unselected or
        the input is NULL."""
        raise NotImplementedError

    def device_finalize(self, accs: List, schema: T.Schema):
        """Accumulator tensors -> (data, validity|None)."""
        raise NotImplementedError

    def references(self) -> set:
        out = set()
        for c in self.children:
            out |= c.references()
        return out

    def with_args(self, args) -> "AggregateFunction":
        """Copy with argument expressions replaced (the one seam plan
        rewriters use)."""
        import copy
        nf = copy.copy(self)
        nf.children = tuple(args)
        if len(args) == 1:
            nf.child = args[0]
        return nf

    def alias(self, name: str) -> "AggExpr":
        return AggExpr(self, name)

    def over(self, spec) -> "Expression":
        """sum(x).over(Window.partitionBy(...)) — turn this aggregate into
        a window expression (pyspark's Column.over)."""
        from .window import AGG_WINDOW_KINDS, WindowExpr
        kind = AGG_WINDOW_KINDS.get(type(self).__name__)
        if kind is None:
            raise NotImplementedError(
                f"{type(self).__name__} is not supported over a window")
        return WindowExpr(kind, self.child, spec)

    def _eval_child(self, batch: Batch, sel) -> Tuple[Vec, object]:
        v = self.child.eval(batch)
        m = sel
        if v.validity is not None:
            m = v.validity if m is None else (m & v.validity)
        return v, m

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.child!r})"


class Count(AggregateFunction):
    def result_type(self, schema):
        return T.LONG

    def result_nullable(self, schema):
        return False

    def accumulators(self, schema):
        return [AccSpec("count", np.dtype(np.int64), "sum", width=8)]

    def update(self, batch, sel):
        if self.child is None:
            m = batch.selection_mask() if sel is None else sel
            return [m.to(torch.int64)]
        _, m = self._eval_child(batch, sel)
        if m is None:
            m = torch.ones((batch.capacity,), dtype=torch.bool,
                           device=batch.device)
        return [m.to(torch.int64)]

    def device_finalize(self, accs, schema):
        return accs[0], None

    def __repr__(self):
        return f"count({'*' if self.child is None else repr(self.child)})"


class Sum(AggregateFunction):
    def result_type(self, schema):
        dt = self.child.dtype(schema)
        if isinstance(dt, T.DecimalType):
            return T.DecimalType(min(38, dt.precision + 10), dt.scale)
        if isinstance(dt, T.IntegralType):
            return T.LONG
        return T.DOUBLE

    def accumulators(self, schema):
        dt = self.child.dtype(schema)
        if isinstance(dt, (T.DecimalType, T.IntegralType)):
            from .expr import static_unsigned_bits
            w = static_unsigned_bits(self.child) if \
                isinstance(dt, T.IntegralType) else None
            return [AccSpec("sum", np.dtype(np.int64), "sum",
                            width=min(w, 64) if w else 64),
                    AccSpec("cnt", np.dtype(np.int64), "sum", width=8)]
        return [AccSpec("sum", np.dtype(np.float64), "sum"),
                AccSpec("cnt", np.dtype(np.int64), "sum", width=8)]

    def update(self, batch, sel):
        v, m = self._eval_child(batch, sel)
        spec = self.accumulators(batch.schema())[0]
        x = v.data.to(T.torch_dtype(spec.np_dtype))
        cnt = torch.ones((batch.capacity,), dtype=torch.int64,
                         device=batch.device)
        if m is None:
            return [x, cnt]
        return [torch.where(m, x, torch.zeros_like(x)),
                torch.where(m, cnt, torch.zeros_like(cnt))]

    def device_finalize(self, accs, schema):
        total, cnt = accs
        return total, cnt > 0


def decimal_avg_halfup(total, safe_cnt, extra: int):
    """Exact integer HALF_UP of (total * extra) / cnt, split as
    q*extra + round(r*extra/cnt) so intermediates stay in int64."""
    safe = safe_cnt.to(torch.int64)
    absn = total.abs()
    q0 = torch.div(absn, safe, rounding_mode="floor")
    r0 = absn - q0 * safe
    frac = torch.div(r0 * extra + torch.div(safe, 2, rounding_mode="floor"),
                     safe, rounding_mode="floor")  # HALF_UP
    mag = q0 * extra + frac
    return torch.where(total < 0, -mag, mag)


class Avg(AggregateFunction):
    def result_type(self, schema):
        dt = self.child.dtype(schema)
        if isinstance(dt, T.DecimalType):
            # reference: avg(decimal(p,s)) -> decimal(p+4, s+4)
            return T.DecimalType(min(38, dt.precision + 4), min(38, dt.scale + 4))
        return T.DOUBLE

    def accumulators(self, schema):
        return Sum(self.child).accumulators(schema)

    def update(self, batch, sel):
        return Sum(self.child).update(batch, sel)

    def device_finalize(self, accs, schema):
        dt = self.child.dtype(schema)
        total, cnt = accs
        safe = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
        if isinstance(dt, T.DecimalType):
            # exact integer HALF_UP, matching the reference digit for digit
            out_dt = self.result_type(schema)
            return decimal_avg_halfup(
                total, safe, 10 ** (out_dt.scale - dt.scale)), cnt > 0
        return total.to(torch.float64) / safe.to(torch.float64), cnt > 0


class _MinMax(AggregateFunction):
    _reduce = "min"

    def result_type(self, schema):
        return self.child.dtype(schema)

    def accumulators(self, schema):
        dt = self.child.dtype(schema)
        return [AccSpec(self._reduce, dt.np_dtype, self._reduce),
                AccSpec("cnt", np.dtype(np.int64), "sum", width=8)]

    def update(self, batch, sel):
        v, m = self._eval_child(batch, sel)
        spec = self.accumulators(batch.schema())[0]
        x = v.data.to(T.torch_dtype(spec.np_dtype))
        cnt = torch.ones((batch.capacity,), dtype=torch.int64,
                         device=batch.device)
        if m is None:
            return [x, cnt]
        return [torch.where(m, x, torch.full_like(x, spec.neutral.item())),
                torch.where(m, cnt, torch.zeros_like(cnt))]

    def device_finalize(self, accs, schema):
        return accs[0], accs[1] > 0


class Min(_MinMax):
    _reduce = "min"


class Max(_MinMax):
    _reduce = "max"


class _DistinctMarker(AggregateFunction):
    """agg(DISTINCT x): a planning marker — the optimizer's
    RewriteDistinctAggregates expands it into the plain aggregate over a
    (groups, x) dedupe aggregate, the single-distinct case of the
    reference's `AggUtils.planAggregateWithOneDistinct`. It never reaches
    physical execution itself."""

    _plain = None  # the aggregate the rewrite applies over the dedupe
    _label = "?"

    def result_type(self, schema):
        return self._plain(self.child).result_type(schema)

    def accumulators(self, schema):
        raise NotImplementedError(
            f"{self._label}(DISTINCT) must be rewritten before execution")

    def __repr__(self):
        return f"{self._label}(DISTINCT {self.child!r})"


class CountDistinct(_DistinctMarker):
    _plain = Count
    _label = "count"

    def result_nullable(self, schema):
        return False


class SumDistinct(_DistinctMarker):
    _plain = Sum
    _label = "sum"


class AvgDistinct(_DistinctMarker):
    _plain = Avg
    _label = "avg"


class NotPortedAggregate(AggregateFunction):
    """An aggregate the SQL parser knows (stddev, variance, corr, first,
    percentile, collect_list, ...) whose accumulators are not ported
    yet: analysis raises AnalysisError naming it."""

    def __init__(self, sql_name: str, *args: Expression):
        self.sql_name = sql_name
        self.child = args[0] if args else None
        self.children = tuple(args)

    def result_type(self, schema):
        from .expr import AnalysisError
        raise AnalysisError(
            f"aggregate {self.sql_name.lower()}() is not yet ported to "
            f"spark_tpu_torch")

    def accumulators(self, schema):
        return self.result_type(schema)

    def __repr__(self):
        args = ", ".join(repr(c) for c in self.children)
        return f"{self.sql_name.lower()}({args})"


@dataclass
class AggExpr:
    """A named aggregate output column (reference: AggregateExpression)."""

    func: AggregateFunction
    out_name: str

    def __repr__(self):
        return f"{self.func!r} AS {self.out_name}"
