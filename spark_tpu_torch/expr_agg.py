"""Aggregate functions as declarative accumulator specs.

The port of `spark_tpu/expr_agg.py` (reference: DeclarativeAggregate in
`expressions/aggregate/interfaces.scala`). Each function
declares flat *accumulator* columns with an associative/commutative
reduce kind, an ``update`` producing per-row contributions (already
neutralized for NULL/unselected rows), and a ``device_finalize``.
Percentile, median, collect_list and collect_set have no such
decomposition: they are *positional* and run in one complete pass over a
sort by (group keys, value) (`execution/aggregate.py`,
`positional_sort`); the collect aggregates give array columns.

The statistical aggregates (variance, stddev, corr, covar, skewness,
kurtosis) carry raw power sums in float64, so they are plain sums too
and take the dense group-by kernel with float rows.

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
from .expr import AnalysisError, Expression, Vec, cast_vec


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

    #: True for position-packed aggregates (first/last/any_value) whose
    #: update() takes a row base that makes positions unique across the
    #: chunks of a stream: a tie on in-chunk position would let the two
    #: word accumulators of a 64-bit value pick different rows
    uses_row_base = False

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

    def finalize(self, accs: List[np.ndarray], schema: T.Schema):
        """Host finalize: accumulator arrays (one value per group) ->
        (np data, validity|None), the values `device_finalize` gives on
        CPU tensors (the event-time streaming path merges partials on
        the host)."""
        data, validity = self.device_finalize(
            [torch.from_numpy(np.array(a)) for a in accs],
            schema)
        return (data.numpy(),
                None if validity is None else validity.numpy())

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


def _masked_double(v: Vec, m, capacity: int, device):
    """The child cast to DOUBLE with 0.0 under unselected or NULL rows,
    and the matching count row (one per contributing row)."""
    x = cast_vec(v, T.DOUBLE).data
    cnt = torch.ones((capacity,), dtype=torch.int64, device=device)
    if m is not None:
        x = torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))
        cnt = torch.where(m, cnt, torch.zeros_like(cnt))
    return x, cnt


class _CentralMoment(AggregateFunction):
    """Variance/stddev via raw power sums (cnt, sum x, sum x^2): all
    three are plain associative SUM accumulators (the reference's
    `CentralMomentAgg.scala` carries (n, avg, m2) with a merge formula
    instead; power sums fit the declarative reduce model)."""

    _sample = True   # ddof=1
    _sqrt = False

    def result_type(self, schema):
        return T.DOUBLE

    def accumulators(self, schema):
        return [AccSpec("cnt", np.dtype(np.int64), "sum", width=8),
                AccSpec("sx", np.dtype(np.float64), "sum"),
                AccSpec("sxx", np.dtype(np.float64), "sum")]

    def update(self, batch, sel):
        v, m = self._eval_child(batch, sel)
        x, cnt = _masked_double(v, m, batch.capacity, batch.device)
        return [cnt, x, x * x]

    def device_finalize(self, accs, schema):
        cnt, sx, sxx = accs
        n = cnt.to(torch.float64)
        ddof = 1 if self._sample else 0
        denom = torch.clamp_min(n - ddof, 1)
        mean = sx / torch.clamp_min(n, 1)
        m2 = torch.clamp_min(sxx - sx * mean, 0.0)  # clamp the cancellation
        var = m2 / denom
        out = torch.sqrt(var) if self._sqrt else var
        return out, cnt > ddof


class VarianceSamp(_CentralMoment):
    _sample, _sqrt = True, False


class VariancePop(_CentralMoment):
    _sample, _sqrt = False, False


class StddevSamp(_CentralMoment):
    _sample, _sqrt = True, True


class StddevPop(_CentralMoment):
    _sample, _sqrt = False, True


_WORD = 0xFFFFFFFF


def _low32(word):
    """int64 holding an unsigned 32-bit word -> its int32 bit pattern."""
    return torch.where(word >= (1 << 31), word - (1 << 32), word) \
        .to(torch.int32)


class First(AggregateFunction):
    """first(x[, ignorenulls]): value at the smallest row position
    (non-deterministic across shuffles, like the reference's First —
    interfaces.scala). Each 32-bit word of the value is packed as
    (pos << 33 | isnull << 32 | word) under a MIN reduce; positions are
    unique, so every word accumulator independently picks the SAME
    winning row. 64-bit types carry two word accumulators; a double
    rides as a (hi, lo) float32 pair, as in the JAX package, whose
    hi + lo is exact to about 2^-48 relative."""

    _reduce = "min"
    _name = "first"
    uses_row_base = True

    def __init__(self, child, ignorenulls: bool = False):
        super().__init__(child)
        self.ignorenulls = ignorenulls
        self.output_dictionary = None

    def result_type(self, schema):
        return self.child.dtype(schema)

    def _wide(self, schema) -> bool:
        dt = self.child.dtype(schema)
        if isinstance(dt, T.StringType):
            return False  # dictionary codes are int32
        return np.dtype(dt.np_dtype).itemsize > 4

    def accumulators(self, schema):
        specs = [AccSpec(f"{self._name}_w0", np.dtype(np.int64),
                         self._reduce)]
        if self._wide(schema):
            specs.append(AccSpec(f"{self._name}_w1", np.dtype(np.int64),
                                 self._reduce))
        specs.append(AccSpec("cnt", np.dtype(np.int64), "sum", width=8))
        return specs

    def update(self, batch, sel, row_base=None):
        v = self.child.eval(batch)
        self.output_dictionary = v.dictionary
        cap = batch.capacity
        dev = batch.device
        # min picks the smallest position (first), max the largest
        # (last): the position rides the high packed bits, 30 of them.
        # `row_base` offsets the positions of a streamed chunk, so they
        # stay unique across chunks; the streaming loop bounds
        # row_base + cap below 2^30.
        if cap >= (1 << 30):
            raise AnalysisError(
                f"{self._name}() input exceeds the 2^30 packed-position "
                f"bound ({cap} rows)")
        pos = torch.arange(cap, dtype=torch.int64, device=dev)
        if row_base is not None:
            pos = pos + int(row_base)
        isnull = torch.zeros((cap,), dtype=torch.int64, device=dev) \
            if v.validity is None else (~v.validity).to(torch.int64)
        data = v.data
        if data.dtype == torch.bool:
            data = data.to(torch.int32)
        if data.dtype == torch.float64:
            hi = data.to(torch.float32)
            lo = (data - hi.to(torch.float64)).to(torch.float32)
            words = [hi.view(torch.int32).to(torch.int64) & _WORD,
                     lo.view(torch.int32).to(torch.int64) & _WORD]
        elif data.element_size() > 4:
            wide = data.to(torch.int64)
            words = [wide & _WORD, (wide >> 32) & _WORD]
        else:
            if data.dtype == torch.float32:
                bits = data.view(torch.int32)  # bit pattern, same width
            else:
                bits = data.to(torch.int32)  # widen narrow ints
            words = [bits.to(torch.int64) & _WORD]
        m = batch.selection_mask() if sel is None else sel
        contributing = m
        if self.ignorenulls and v.validity is not None:
            contributing = contributing & v.validity
        neutral = torch.tensor(
            (_max_of if self._reduce == "min" else _min_of)(
                np.dtype(np.int64)).item(), dtype=torch.int64, device=dev)
        out = []
        for w in words:
            packed = (pos << 33) | (isnull << 32) | w
            out.append(torch.where(contributing, packed, neutral))
        out.append(contributing.to(torch.int64))
        return out

    def device_finalize(self, accs, schema):
        word_accs = accs[:-1]
        isnull = ((word_accs[0] >> 32) & 1).to(torch.bool)
        words = [a & _WORD for a in word_accs]
        out_np = np.dtype(self.result_type(schema).np_dtype)
        if len(words) == 2:
            if out_np == np.dtype(np.float64):
                hi = _low32(words[0]).view(torch.float32)
                lo = _low32(words[1]).view(torch.float32)
                val = hi.to(torch.float64) + lo.to(torch.float64)
            else:
                val = (words[1] << 32) | words[0]
        else:
            low32 = _low32(words[0])
            if self.output_dictionary is not None or \
                    out_np == np.dtype(np.int32):
                val = low32
            elif np.issubdtype(out_np, np.floating):
                val = low32.view(torch.float32)
            else:
                val = low32.to(T.torch_dtype(out_np))
        return val, (accs[-1] > 0) & ~isnull

    def __repr__(self):
        return f"{self._name}({self.child!r})"


class Last(First):
    _reduce = "max"
    _name = "last"


class AnyValue(First):
    _name = "any_value"


class _TwoChildAgg(AggregateFunction):
    """Base for two-input declarative aggregates (corr/covar)."""

    def __init__(self, x: Expression, y: Expression):
        self.child = None
        self.x = x
        self.y = y
        self.children = (x, y)

    def with_args(self, args):
        import copy
        nf = copy.copy(self)
        nf.x, nf.y = args
        nf.children = tuple(args)
        return nf

    def result_type(self, schema):
        return T.DOUBLE

    def _xy(self, batch, sel):
        vx = self.x.eval(batch)
        vy = self.y.eval(batch)
        m = sel
        for v in (vx, vy):
            if v.validity is not None:
                m = v.validity if m is None else (m & v.validity)
        x, cnt = _masked_double(vx, m, batch.capacity, batch.device)
        y, _ = _masked_double(vy, m, batch.capacity, batch.device)
        return x, y, cnt

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.x!r}, {self.y!r})"


class Corr(_TwoChildAgg):
    """Pearson correlation via power sums (reference: Corr in
    CentralMomentAgg.scala, merge-formula form)."""

    def accumulators(self, schema):
        return [AccSpec("cnt", np.dtype(np.int64), "sum", width=8)] + \
            [AccSpec(s, np.dtype(np.float64), "sum")
             for s in ("sx", "sy", "sxx", "syy", "sxy")]

    def update(self, batch, sel):
        x, y, cnt = self._xy(batch, sel)
        return [cnt, x, y, x * x, y * y, x * y]

    def device_finalize(self, accs, schema):
        cnt, sx, sy, sxx, syy, sxy = accs
        n = torch.clamp_min(cnt, 1).to(torch.float64)
        cov = sxy - sx * sy / n
        vx = sxx - sx * sx / n
        vy = syy - sy * sy / n
        denom = torch.sqrt(torch.clamp_min(vx, 0.0) * torch.clamp_min(vy, 0.0))
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        return cov / safe, (cnt > 1) & (denom > 0)


class _Covar(_TwoChildAgg):
    _ddof = 1

    def accumulators(self, schema):
        return [AccSpec("cnt", np.dtype(np.int64), "sum", width=8),
                AccSpec("sx", np.dtype(np.float64), "sum"),
                AccSpec("sy", np.dtype(np.float64), "sum"),
                AccSpec("sxy", np.dtype(np.float64), "sum")]

    def update(self, batch, sel):
        x, y, cnt = self._xy(batch, sel)
        return [cnt, x, y, x * y]

    def device_finalize(self, accs, schema):
        cnt, sx, sy, sxy = accs
        n = torch.clamp_min(cnt, 1).to(torch.float64)
        denom = torch.clamp_min(cnt - self._ddof, 1).to(torch.float64)
        return (sxy - sx * sy / n) / denom, cnt > self._ddof


class CovarSamp(_Covar):
    _ddof = 1


class CovarPop(_Covar):
    _ddof = 0


class _HigherMoment(AggregateFunction):
    """skewness/kurtosis via raw power sums (reference:
    CentralMomentAgg.scala Skewness/Kurtosis, population form)."""

    _order = 3

    def result_type(self, schema):
        return T.DOUBLE

    def accumulators(self, schema):
        return [AccSpec("cnt", np.dtype(np.int64), "sum", width=8)] + \
            [AccSpec(f"s{k}", np.dtype(np.float64), "sum")
             for k in range(1, self._order + 1)]

    def update(self, batch, sel):
        v, m = self._eval_child(batch, sel)
        x, cnt = _masked_double(v, m, batch.capacity, batch.device)
        out = [cnt]
        p = x
        for _ in range(self._order):
            out.append(p)
            p = p * x
        return out

    @staticmethod
    def _moments(accs):
        cnt = accs[0]
        n = torch.clamp_min(cnt, 1).to(torch.float64)
        mean = accs[1] / n
        m2 = accs[2] / n - mean * mean
        return cnt, n, mean, torch.clamp_min(m2, 0.0)


class Skewness(_HigherMoment):
    _order = 3

    def device_finalize(self, accs, schema):
        cnt, n, mean, m2 = self._moments(accs)
        m3 = accs[3] / n - 3 * mean * (accs[2] / n) + 2 * mean ** 3
        sd = torch.sqrt(m2)
        safe = torch.where(sd > 0, sd, torch.ones_like(sd))
        return m3 / (safe ** 3), (cnt > 0) & (m2 > 0)


class Kurtosis(_HigherMoment):
    """Excess kurtosis m4/m2^2 - 3 (the reference's Kurtosis)."""
    _order = 4

    def device_finalize(self, accs, schema):
        cnt, n, mean, m2 = self._moments(accs)
        m4 = (accs[4] / n - 4 * mean * (accs[3] / n)
              + 6 * mean ** 2 * (accs[2] / n) - 3 * mean ** 4)
        safe = torch.where(m2 > 0, m2, torch.ones_like(m2))
        return m4 / (safe * safe) - 3.0, (cnt > 0) & (m2 > 0)


class _BoolAggBase(AggregateFunction):
    _reduce = "min"  # bool_and: min over {0,1}

    def result_type(self, schema):
        return T.BOOLEAN

    def accumulators(self, schema):
        return [AccSpec(self._reduce, np.dtype(np.bool_), self._reduce),
                AccSpec("cnt", np.dtype(np.int64), "sum", width=8)]

    def update(self, batch, sel):
        v, m = self._eval_child(batch, sel)
        x = v.data.to(torch.bool)
        cnt = torch.ones((batch.capacity,), dtype=torch.int64,
                         device=batch.device)
        if m is not None:
            neutral = self._reduce == "min"  # True for and, False for or
            x = torch.where(m, x, torch.tensor(neutral, device=x.device))
            cnt = torch.where(m, cnt, torch.zeros_like(cnt))
        return [x, cnt]

    def device_finalize(self, accs, schema):
        return accs[0], accs[1] > 0


class BoolAnd(_BoolAggBase):
    _reduce = "min"


class BoolOr(_BoolAggBase):
    _reduce = "max"


class CountIf(AggregateFunction):
    """count_if(pred): rows where the predicate is true."""

    def result_type(self, schema):
        return T.LONG

    def result_nullable(self, schema):
        return False

    def accumulators(self, schema):
        return [AccSpec("count", np.dtype(np.int64), "sum", width=8)]

    def update(self, batch, sel):
        v, m = self._eval_child(batch, sel)
        x = v.data.to(torch.bool)
        if m is not None:
            x = x & m
        return [x.to(torch.int64)]

    def device_finalize(self, accs, schema):
        return accs[0], None


class _PositionalAgg(AggregateFunction):
    """An aggregate without a flat accumulator decomposition (reference:
    Percentile.scala, ApproximatePercentile.scala:1): HashAggregateExec
    computes it in ONE complete-mode pass over a (group keys, value)
    sort (the ObjectHashAggregate seat)."""

    positional = True

    def accumulators(self, schema):
        raise AnalysisError(
            f"{type(self).__name__} has no accumulator decomposition "
            "(positional aggregates run in one complete pass)")

    def update(self, batch, sel):
        raise AnalysisError(f"{type(self).__name__}.update unreachable")


class Percentile(_PositionalAgg):
    """Exact percentile with linear interpolation; nulls ignored."""

    def __init__(self, child, q: float):
        super().__init__(child)
        if not (0.0 <= float(q) <= 1.0):
            raise AnalysisError(
                f"percentile fraction must be in [0, 1], got {q}")
        self.q = float(q)

    def result_type(self, schema):
        return T.DOUBLE

    def __repr__(self):
        return f"percentile({self.child!r}, {self.q})"


class Median(Percentile):
    def __init__(self, child):
        super().__init__(child, 0.5)

    def __repr__(self):
        return f"median({self.child!r})"


class CollectList(_PositionalAgg):
    """collect_list: the group's non-null values as an array (order is
    value-sorted — a valid instance of the reference's unspecified
    order)."""

    distinct = False
    _name = "collect_list"

    def result_type(self, schema):
        return T.ArrayType(self.child.dtype(schema))

    def __repr__(self):
        return f"{self._name}({self.child!r})"


class CollectSet(CollectList):
    """collect_set: the group's distinct non-null values, value-sorted."""

    distinct = True
    _name = "collect_set"


@dataclass
class AggExpr:
    """A named aggregate output column (reference: AggregateExpression)."""

    func: AggregateFunction
    out_name: str

    def __repr__(self):
        return f"{self.func!r} AS {self.out_name}"
