"""User-facing expression constructors (the reference's `functions.scala`;
the port of `spark_tpu/functions.py`). The window functions
return `WindowExpr`s to finish with `.over(spec)` (`window.Window`
builds specs)."""

from __future__ import annotations

from typing import Optional, Union

from . import types as T
from .expr import (CaseWhen, ColumnRef, ConcatLit, DateAdd, EqNullSafe,
                   Expression, ExtractDay, ExtractMonth, ExtractYear,
                   Literal, Lower, StringLength, Trim, Upper, date_literal)
from .expr_agg import (Avg, Count, CountDistinct, Max, Min, StddevPop,
                       StddevSamp, Sum, VariancePop, VarianceSamp)


def col(name: str) -> ColumnRef:
    return ColumnRef(name)


def lit(value, dtype: Optional[T.DataType] = None) -> Literal:
    return Literal(value, dtype)


def to_date(s: str) -> Literal:
    """A DATE literal from 'YYYY-MM-DD'."""
    return date_literal(s)


def decimal_lit(value: Union[int, float, str], scale: int = 2) -> Literal:
    return Literal(float(value), T.DecimalType(38, scale))


def _expr(e) -> Expression:
    return e if isinstance(e, Expression) else col(e) if isinstance(e, str) \
        else Literal(e)


def sum(e) -> Sum:  # noqa: A001 - mirrors pyspark.sql.functions naming
    return Sum(_expr(e))


def avg(e) -> Avg:
    return Avg(_expr(e))


def count(e="*") -> Count:
    if e is None or (isinstance(e, str) and e == "*"):
        return Count(None)
    return Count(_expr(e))


def min(e) -> Min:  # noqa: A001
    return Min(_expr(e))


def max(e) -> Max:  # noqa: A001
    return Max(_expr(e))


def year(e) -> ExtractYear:
    return ExtractYear(_expr(e))


def month(e) -> ExtractMonth:
    return ExtractMonth(_expr(e))


def day(e) -> ExtractDay:
    return ExtractDay(_expr(e))


dayofmonth = day


def date_add(e, days) -> DateAdd:
    return DateAdd(_expr(e), _expr(days))


def date_sub(e, days) -> DateAdd:
    from .expr import Neg
    d = _expr(days)
    if isinstance(d, Literal) and isinstance(d.value, int):
        return DateAdd(_expr(e), Literal(-d.value))
    return DateAdd(_expr(e), Neg(d))


def stddev(e) -> StddevSamp:
    return StddevSamp(_expr(e))


stddev_samp = stddev


def stddev_pop(e) -> StddevPop:
    return StddevPop(_expr(e))


def variance(e) -> VarianceSamp:
    return VarianceSamp(_expr(e))


var_samp = variance


def var_pop(e) -> VariancePop:
    return VariancePop(_expr(e))


def count_distinct(e) -> CountDistinct:
    return CountDistinct(_expr(e))


countDistinct = count_distinct


def upper(e) -> Upper:
    return Upper(_expr(e))


def lower(e) -> Lower:
    return Lower(_expr(e))


def trim(e) -> Trim:
    return Trim(_expr(e))


def length(e) -> StringLength:
    return StringLength(_expr(e))


def concat(*parts) -> Expression:
    """concat of string literals around ONE string column (general
    column-column concat needs a product dictionary — unsupported)."""
    exprs = [_expr(p) for p in parts]
    if any(isinstance(p, Literal) and p.value is None for p in exprs):
        return Literal(None, T.STRING)  # NULL in -> NULL out
    col_idx = [i for i, p in enumerate(exprs)
               if not isinstance(p, Literal)]
    if len(col_idx) != 1:
        from .expr import AnalysisError
        raise AnalysisError("concat supports exactly one non-literal "
                            "string argument")
    i = col_idx[0]
    prefix = "".join(str(p.value) for p in exprs[:i])
    suffix = "".join(str(p.value) for p in exprs[i + 1:])
    return ConcatLit(exprs[i], prefix, suffix)


def eq_null_safe(a, b) -> EqNullSafe:
    """a <=> b (reference: EqualNullSafe)."""
    return EqNullSafe(_expr(a), _expr(b))


# window functions (spark_tpu_torch.window has the Window/WindowSpec builders)
def row_number():
    from .window import row_number as f
    return f()


def rank():
    from .window import rank as f
    return f()


def dense_rank():
    from .window import dense_rank as f
    return f()


def lag(e, offset: int = 1, default=None):
    from .window import lag as f
    return f(e, offset, default)


def lead(e, offset: int = 1, default=None):
    from .window import lead as f
    return f(e, offset, default)


def pmod(dividend, divisor) -> Expression:
    """Positive modulo: result in [0, |divisor|) (reference: pmod())."""
    from .expr import Pmod
    return Pmod(_expr(dividend), _expr(divisor))


class _WhenBuilder(Expression):
    """when(cond, val).when(...).otherwise(...) chain (functions.scala when)."""

    def __init__(self, branches):
        self._branches = branches
        self.children = ()

    def when(self, cond: Expression, value) -> "_WhenBuilder":
        return _WhenBuilder(self._branches + [(cond, _expr(value))])

    def otherwise(self, value) -> CaseWhen:
        return CaseWhen(self._branches, _expr(value))

    def _case(self) -> CaseWhen:
        return CaseWhen(self._branches, None)

    def dtype(self, schema):
        return self._case().dtype(schema)

    def nullable(self, schema):
        return True

    def eval(self, batch):
        return self._case().eval(batch)

    def references(self):
        return self._case().references()


def when(cond: Expression, value) -> _WhenBuilder:
    return _WhenBuilder([(cond, _expr(value))])


# ---------------------------------------------------------------------------
# math / datetime / string / null / extended aggregates (registry-driven
# SQL names live in sql/registry.py; these are the pyspark-shaped DSL
# constructors)
# ---------------------------------------------------------------------------

from . import expr_fns as _X  # noqa: E402
from .expr_agg import (AnyValue as _AnyValue, AvgDistinct as _AvgDistinct,  # noqa: E402
                       BoolAnd as _BoolAnd, BoolOr as _BoolOr,
                       Corr as _Corr, CountIf as _CountIf,
                       CovarPop as _CovarPop, CovarSamp as _CovarSamp,
                       First as _First, Kurtosis as _Kurtosis,
                       Last as _Last, Median as _Median,
                       Percentile as _Percentile, Skewness as _Skewness,
                       SumDistinct as _SumDistinct)


def _u1(cls):
    def f(e):
        return cls(_expr(e))
    return f


abs = _u1(_X.Abs)  # noqa: A001
sqrt = _u1(_X.Sqrt)
cbrt = _u1(_X.Cbrt)
exp = _u1(_X.Exp)
expm1 = _u1(_X.Expm1)
log = _u1(_X.Ln)
log10 = _u1(_X.Log10)
log2 = _u1(_X.Log2)
log1p = _u1(_X.Log1p)
sin = _u1(_X.Sin)
cos = _u1(_X.Cos)
tan = _u1(_X.Tan)
asin = _u1(_X.Asin)
acos = _u1(_X.Acos)
atan = _u1(_X.Atan)
sinh = _u1(_X.Sinh)
cosh = _u1(_X.Cosh)
tanh = _u1(_X.Tanh)
degrees = _u1(_X.Degrees)
radians = _u1(_X.Radians)
rint = _u1(_X.Rint)
signum = _u1(_X.Signum)
ceil = _u1(_X.Ceil)
floor = _u1(_X.Floor)
factorial = _u1(_X.Factorial)
bit_count = _u1(_X.BitCount)
bitwise_not = _u1(_X.BitwiseNot)
isnan = _u1(_X.IsNan)
quarter = _u1(_X.Quarter)
dayofweek = _u1(_X.DayOfWeek)
weekday = _u1(_X.WeekDay)
dayofyear = _u1(_X.DayOfYear)
weekofyear = _u1(_X.WeekOfYear)
last_day = _u1(_X.LastDay)
ltrim = _u1(_X.Ltrim)
rtrim = _u1(_X.Rtrim)
reverse = _u1(_X.Reverse)
initcap = _u1(_X.InitCap)
ascii = _u1(_X.Ascii)  # noqa: A001


def round(e, scale: int = 0):  # noqa: A001
    return _X.Round(_expr(e), scale)


def pow(a, b):  # noqa: A001
    return _X.Pow(_expr(a), _expr(b))


power = pow


def atan2(a, b):
    return _X.Atan2(_expr(a), _expr(b))


def hypot(a, b):
    return _X.Hypot(_expr(a), _expr(b))


def shiftleft(e, n):
    return _X.ShiftLeft(_expr(e), _expr(n))


def shiftright(e, n):
    return _X.ShiftRight(_expr(e), _expr(n))


def greatest(*args):
    return _X.Greatest(*[_expr(a) for a in args])


def least(*args):
    return _X.Least(*[_expr(a) for a in args])


def coalesce(*args):
    from .expr import Coalesce
    return Coalesce(*[_expr(a) for a in args])


def nvl(a, b):
    return _X.Nvl(_expr(a), _expr(b))


ifnull = nvl


def nvl2(a, b, c):
    return _X.Nvl2(_expr(a), _expr(b), _expr(c))


def nullif(a, b):
    return _X.NullIf(_expr(a), _expr(b))


def nanvl(a, b):
    return _X.Nanvl(_expr(a), _expr(b))


def expr_if(cond, a, b):
    return _X.If(cond, _expr(a), _expr(b))


def next_day(e, day_name: str):
    return _X.NextDay(_expr(e), day_name)


def add_months(e, n):
    return _X.AddMonths(_expr(e), _expr(n))


def months_between(end, start):
    return _X.MonthsBetween(_expr(end), _expr(start))


def datediff(end, start):
    return _X.DateDiff(_expr(end), _expr(start))


def trunc(e, fmt: str):
    return _X.TruncDate(_expr(e), fmt)


def make_date(y, m, d):
    return _X.MakeDate(_expr(y), _expr(m), _expr(d))


def lpad(e, length: int, pad: str = " "):
    return _X.Lpad(_expr(e), length, pad)


def rpad(e, length: int, pad: str = " "):
    return _X.Rpad(_expr(e), length, pad)


def translate(e, matching: str, replace: str):
    return _X.Translate(_expr(e), matching, replace)


def repeat(e, n: int):
    return _X.Repeat(_expr(e), n)


def regexp_replace(e, pattern: str, replacement: str):
    return _X.RegexpReplace(_expr(e), pattern, replacement)


def regexp_extract(e, pattern: str, idx: int = 1):
    return _X.RegexpExtract(_expr(e), pattern, idx)


def rlike(e, pattern: str):
    return _X.RLike(_expr(e), pattern)


def instr(e, sub: str):
    return _X.Instr(_expr(e), sub)


def contains(e, sub: str):
    return _X.Contains(_expr(e), sub)


def startswith(e, prefix: str):
    return _X.StartsWith(_expr(e), prefix)


def endswith(e, suffix: str):
    return _X.EndsWith(_expr(e), suffix)


def replace(e, search: str, replacement: str = ""):
    return _X.StringReplace(_expr(e), search, replacement)


# extended aggregates
def first(e, ignorenulls: bool = False):
    return _First(_expr(e), ignorenulls)


def last(e, ignorenulls: bool = False):
    return _Last(_expr(e), ignorenulls)


def any_value(e):
    return _AnyValue(_expr(e))


def corr(x, y):
    return _Corr(_expr(x), _expr(y))


def covar_samp(x, y):
    return _CovarSamp(_expr(x), _expr(y))


def covar_pop(x, y):
    return _CovarPop(_expr(x), _expr(y))


def skewness(e):
    return _Skewness(_expr(e))


def kurtosis(e):
    return _Kurtosis(_expr(e))


def bool_and(e):
    return _BoolAnd(_expr(e))


def bool_or(e):
    return _BoolOr(_expr(e))


def count_if(e):
    return _CountIf(_expr(e))


def sum_distinct(e):
    return _SumDistinct(_expr(e))


def avg_distinct(e):
    return _AvgDistinct(_expr(e))


# positional aggregates (Percentile.scala)
def percentile(e, q):
    return _Percentile(_expr(e), q)


def percentile_approx(e, q, accuracy=None):
    """Exact percentile (better than the required accuracy bound of the
    reference's ApproximatePercentile.scala:1 — the device sort makes
    exact as cheap as approximate)."""
    return _Percentile(_expr(e), q)


approx_percentile = percentile_approx


def median(e):
    return _Median(_expr(e))


# -- Python UDFs (ArrowEvalPythonExec.scala:1 / worker.py:504 analog) -------

from .udf import pandas_udf, udf  # noqa: E402,F401


# -- arrays (collectionOperations.scala / complexTypeCreator.scala) ---------

from . import expr_array as _A  # noqa: E402


def array(*cols):
    return _A.MakeArray(*[_expr(c) for c in cols])


def size(c):
    return _A.Size(_expr(c))


def array_contains(c, value):
    return _A.ArrayContains(_expr(c), value)


def element_at(c, index):
    return _A.ElementAt(_expr(c), _expr(index))


def explode(c):
    return _A.Explode(_expr(c))


def explode_outer(c):
    return _A.Explode(_expr(c), outer=True)


# -- collect aggregates (collect.scala) -------------------------------------

from .expr_agg import (CollectList as _CollectList,  # noqa: E402
                       CollectSet as _CollectSet)


def collect_list(e):
    return _CollectList(_expr(e))


def collect_set(e):
    return _CollectSet(_expr(e))


def window(ts, duration):
    """Tumbling event-time window start (reference: TimeWindow); used as
    a streaming group key with with_watermark for event-time
    aggregation."""
    return _X.TumbleWindow(_expr(ts), duration)
