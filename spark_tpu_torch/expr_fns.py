"""Expression-library breadth: math, datetime, string, bitwise and
conditional functions and the event-time window (the port of
`spark_tpu/expr_fns.py`; reference:
`expressions/mathExpressions.scala`, `datetimeExpressions.scala`,
`stringExpressions.scala`, `regexpExpressions.scala`,
`bitwiseExpressions.scala`, `nullExpressions.scala`).

- numeric and date functions are whole-column torch ops;
- string functions run on the HOST DICTIONARY, not per row: a
  dictionary-encoded column makes upper/regexp/replace a rewrite of the
  (small) dictionary plus an O(1) per-row code remap or table gather,
  with Python `re` for the regexps, as the JAX package does.

Null semantics follow the reference: NULL in -> NULL out unless
documented otherwise (coalesce/greatest/least skip NULLs; ln/log of
non-positive values is NULL, matching Spark's `Logarithm`).
"""

from __future__ import annotations

import math
import re
from typing import Callable, List, Optional

import numpy as np
import pyarrow as pa
import torch

from . import types as T
from .expr import (AnalysisError, CaseWhen, Coalesce, EQ, Expression,
                   IsNull, Not, Vec, _and_valid, _civil_from_days, _wrap,
                   cast_vec)


def _to_f64(v: Vec) -> Vec:
    return cast_vec(v, T.DOUBLE)


_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def _f64_to_int64(x):
    """double -> int64 as XLA converts (and Java's (long) cast): NaN to
    0, out-of-range values saturated."""
    safe = torch.where(torch.isnan(x) | (x.abs() >= 2.0 ** 63),
                       torch.zeros_like(x), x)
    out = safe.to(torch.int64)
    out = torch.where(x >= 2.0 ** 63, torch.full_like(out, _INT64_MAX), out)
    return torch.where(x <= -2.0 ** 63, torch.full_like(out, _INT64_MIN),
                       out)


# ---------------------------------------------------------------------------
# Math
# ---------------------------------------------------------------------------

class _MathUnary(Expression):
    """f(x) -> DOUBLE elementwise; rows outside `_domain` become NULL
    (Spark's Logarithm & friends return NULL, not NaN, off-domain)."""

    _fn: Callable = None
    _domain: Optional[Callable] = None  # data -> bool mask of valid inputs

    def __init__(self, child: Expression):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return T.DOUBLE

    def eval(self, batch):
        v = _to_f64(self.children[0].eval(batch))
        data = type(self)._fn(v.data)
        validity = v.validity
        if type(self)._domain is not None:
            ok = type(self)._domain(v.data)
            data = torch.where(ok, data, torch.zeros_like(data))
            validity = ok if validity is None else (validity & ok)
        return Vec(data, T.DOUBLE, validity)

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


def _make_unary(name: str, fn, domain=None):
    cls = type(name, (_MathUnary,), {"_fn": staticmethod(fn)})
    if domain is not None:
        cls._domain = staticmethod(domain)
    return cls


def _cbrt(x):
    """Real cube root (torch has none): pow of |x| with the sign copied,
    then one Newton step, which takes exact cubes to their exact root."""
    y = torch.copysign(x.abs().pow(1.0 / 3.0), x)
    step = torch.isfinite(y) & (y != 0)
    safe = torch.where(step, y, torch.ones_like(y))
    return torch.where(step, safe - (safe * safe * safe - x)
                       / (3.0 * safe * safe), y)


def _signum(x):
    """jnp.sign: NaN stays NaN and a signed zero keeps its sign."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


Sqrt = _make_unary("Sqrt", torch.sqrt)        # sqrt(-x) = NaN like Spark
Exp = _make_unary("Exp", torch.exp)
Expm1 = _make_unary("Expm1", torch.expm1)
Ln = _make_unary("Ln", torch.log, domain=lambda x: x > 0)
Log10 = _make_unary("Log10", torch.log10, domain=lambda x: x > 0)
Log2 = _make_unary("Log2", torch.log2, domain=lambda x: x > 0)
Log1p = _make_unary("Log1p", torch.log1p, domain=lambda x: x > -1)
Sin = _make_unary("Sin", torch.sin)
Cos = _make_unary("Cos", torch.cos)
Tan = _make_unary("Tan", torch.tan)
Cot = _make_unary("Cot", lambda x: 1.0 / torch.tan(x))
Asin = _make_unary("Asin", torch.asin)
Acos = _make_unary("Acos", torch.acos)
Atan = _make_unary("Atan", torch.atan)
Sinh = _make_unary("Sinh", torch.sinh)
Cosh = _make_unary("Cosh", torch.cosh)
Tanh = _make_unary("Tanh", torch.tanh)
Cbrt = _make_unary("Cbrt", _cbrt)
Degrees = _make_unary("Degrees", torch.rad2deg)
Radians = _make_unary("Radians", torch.deg2rad)
Rint = _make_unary("Rint", torch.round)       # half to even, as rint
Signum = _make_unary("Signum", _signum)


class _MathBinary(Expression):
    _fn: Callable = None

    def __init__(self, left, right):
        self.children = (_wrap(left), _wrap(right))

    def dtype(self, schema):
        return T.DOUBLE

    def eval(self, batch):
        l = _to_f64(self.children[0].eval(batch))
        r = _to_f64(self.children[1].eval(batch))
        return Vec(type(self)._fn(l.data, r.data), T.DOUBLE,
                   _and_valid(l.validity, r.validity))

    def __repr__(self):
        return (f"{type(self).__name__.lower()}"
                f"({self.children[0]!r}, {self.children[1]!r})")


class Pow(_MathBinary):
    _fn = staticmethod(torch.pow)


class Atan2(_MathBinary):
    _fn = staticmethod(torch.atan2)


class Hypot(_MathBinary):
    _fn = staticmethod(torch.hypot)


class Logarithm(_MathBinary):
    """log(base, x): NULL when x <= 0 or base <= 0 (reference:
    mathExpressions.scala Logarithm)."""

    def eval(self, batch):
        b = _to_f64(self.children[0].eval(batch))
        x = _to_f64(self.children[1].eval(batch))
        ok = (x.data > 0) & (b.data > 0)
        one = torch.ones((), dtype=torch.float64, device=x.data.device)
        quotient = torch.log(torch.where(x.data > 0, x.data, one)) \
            / torch.log(torch.where(b.data > 0, b.data, 2.0 * one))
        data = torch.where(ok, quotient, torch.zeros_like(quotient))
        validity = _and_valid(_and_valid(b.validity, x.validity), ok)
        return Vec(data, T.DOUBLE, validity)


class Abs(Expression):
    """Type-preserving |x| (decimal scale preserved: scaled-int abs)."""

    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return self.children[0].dtype(schema)

    def eval(self, batch):
        v = self.children[0].eval(batch)
        return Vec(v.data.abs(), v.dtype, v.validity)

    def __repr__(self):
        return f"abs({self.children[0]!r})"


def _half_up(data, scale_pow: float):
    """HALF_UP rounding of float data to `scale_pow` = 10^d (Spark's
    `round`, away from zero on ties)."""
    scaled = data * scale_pow
    return torch.sign(scaled) * torch.floor(scaled.abs() + 0.5) / scale_pow


class Round(Expression):
    """round(x, d) HALF_UP (reference: mathExpressions.scala Round).
    Integers pass through for d >= 0; decimals round exactly on the
    scaled-int representation; floats via f64."""

    def __init__(self, child, d: int = 0):
        self.children = (_wrap(child),)
        self.d = int(d)

    def dtype(self, schema):
        dt = self.children[0].dtype(schema)
        if isinstance(dt, T.DecimalType):
            return T.DecimalType(dt.precision, max(0, min(dt.scale, self.d)))
        if isinstance(dt, T.IntegralType):
            return dt
        return T.DOUBLE

    def eval(self, batch):
        v = self.children[0].eval(batch)
        dt = v.dtype
        if isinstance(dt, T.DecimalType):
            out_scale = max(0, min(dt.scale, self.d))
            drop = dt.scale - out_scale
            if drop <= 0:
                return Vec(v.data, T.DecimalType(dt.precision, out_scale),
                           v.validity)
            p = 10 ** drop
            q = (v.data.abs() + p // 2) // p  # HALF_UP on the scaled int
            return Vec(torch.sign(v.data) * q,
                       T.DecimalType(dt.precision, out_scale), v.validity)
        if isinstance(dt, T.IntegralType):
            if self.d >= 0:
                return v
            p = 10 ** (-self.d)
            q = ((v.data.to(torch.int64).abs() + p // 2) // p) * p
            return Vec((torch.sign(v.data) * q).to(v.data.dtype), dt,
                       v.validity)
        f = _to_f64(v)
        return Vec(_half_up(f.data, float(10.0 ** self.d)), T.DOUBLE,
                   f.validity)

    def __repr__(self):
        return f"round({self.children[0]!r}, {self.d})"


class _CeilFloor(Expression):
    _ceil = True
    _name = "ceil"

    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        dt = self.children[0].dtype(schema)
        if isinstance(dt, T.DecimalType):
            return T.DecimalType(dt.precision, 0)
        if isinstance(dt, T.IntegralType):
            return dt
        return T.LONG  # reference: ceil/floor of double -> LONG

    def eval(self, batch):
        v = self.children[0].eval(batch)
        dt = v.dtype
        if isinstance(dt, T.IntegralType):
            return v
        if isinstance(dt, T.DecimalType):
            p = 10 ** dt.scale
            q = -((-v.data) // p) if self._ceil else v.data // p
            return Vec(q, T.DecimalType(dt.precision, 0), v.validity)
        f = _to_f64(v)
        rounded = torch.ceil(f.data) if self._ceil else torch.floor(f.data)
        return Vec(_f64_to_int64(rounded), T.LONG, f.validity)

    def __repr__(self):
        return f"{self._name}({self.children[0]!r})"


class Ceil(_CeilFloor):
    _ceil = True
    _name = "ceil"


class Floor(_CeilFloor):
    _ceil = False
    _name = "floor"


class Factorial(Expression):
    """factorial(n) for n in [0, 20], NULL outside (reference:
    mathExpressions.scala Factorial) — a 21-entry table gather."""

    _TABLE = np.array([math.factorial(i) for i in range(21)], np.int64)

    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return T.LONG

    def eval(self, batch):
        v = self.children[0].eval(batch)
        idx = v.data.to(torch.int32)
        ok = (idx >= 0) & (idx <= 20)
        table = torch.from_numpy(self._TABLE).to(idx.device)
        data = table[idx.clamp(0, 20).long()]
        return Vec(data, T.LONG, _and_valid(v.validity, ok))

    def __repr__(self):
        return f"factorial({self.children[0]!r})"


class _BitwiseBinary(Expression):
    """Bitwise ops on two's complement ints. Shift counts outside
    [0, width) give 0 for << and the sign fill for >>, as XLA's shifts
    do (and torch's)."""

    _op = None
    _sym = "&"

    def __init__(self, left, right):
        self.children = (_wrap(left), _wrap(right))

    def dtype(self, schema):
        return self.children[0].dtype(schema)

    def eval(self, batch):
        l = self.children[0].eval(batch)
        r = self.children[1].eval(batch)
        rd = r.data.to(l.data.dtype)
        return Vec(type(self)._op(l.data, rd), l.dtype,
                   _and_valid(l.validity, r.validity))

    def __repr__(self):
        return f"({self.children[0]!r} {self._sym} {self.children[1]!r})"


class BitwiseAnd(_BitwiseBinary):
    _op = staticmethod(lambda a, b: a & b)
    _sym = "&"


class BitwiseOr(_BitwiseBinary):
    _op = staticmethod(lambda a, b: a | b)
    _sym = "|"


class BitwiseXor(_BitwiseBinary):
    _op = staticmethod(lambda a, b: a ^ b)
    _sym = "^"


class ShiftLeft(_BitwiseBinary):
    _op = staticmethod(lambda a, b: a << b)
    _sym = "<<"


class ShiftRight(_BitwiseBinary):
    _op = staticmethod(lambda a, b: a >> b)
    _sym = ">>"


class BitwiseNot(Expression):
    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return self.children[0].dtype(schema)

    def eval(self, batch):
        v = self.children[0].eval(batch)
        return Vec(~v.data, v.dtype, v.validity)

    def __repr__(self):
        return f"~{self.children[0]!r}"


def _popcount64(x):
    """Set bits of each int64's two's complement pattern (torch has no
    population count): the SWAR sum, every step masked so that the
    arithmetic shift's sign fill never reaches a counted bit."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


class BitCount(Expression):
    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return T.INT

    def eval(self, batch):
        v = self.children[0].eval(batch)
        # the reference widens to long and counts 64 bits
        # (Long.bitCount), so negative narrow ints sign-extend:
        # bit_count(-1) = 64 for every integral width
        cnt = _popcount64(v.data.to(torch.int64)).to(torch.int32)
        return Vec(cnt, T.INT, v.validity)

    def __repr__(self):
        return f"bit_count({self.children[0]!r})"


# ---------------------------------------------------------------------------
# Null / conditional
# ---------------------------------------------------------------------------

class NullIf(Expression):
    """nullif(a, b): NULL when a == b else a."""

    def __init__(self, a, b):
        self.children = (_wrap(a), _wrap(b))

    def dtype(self, schema):
        return self.children[0].dtype(schema)

    def nullable(self, schema):
        return True

    def eval(self, batch):
        a = self.children[0].eval(batch)
        # the engine's comparison semantics (dictionary strings,
        # decimals, NULLs) instead of raw-data equality
        eqv = EQ(self.children[0], self.children[1]).eval(batch)
        equal = eqv.data
        if eqv.validity is not None:  # NULL comparison never equals
            equal = equal & eqv.validity
        validity = (~equal) if a.validity is None else (a.validity & ~equal)
        return Vec(a.data, a.dtype, validity, a.dictionary)

    def __repr__(self):
        return f"nullif({self.children[0]!r}, {self.children[1]!r})"


def Nvl(a, b) -> Expression:
    return Coalesce(_wrap(a), _wrap(b))


def Nvl2(a, b, c) -> Expression:
    return CaseWhen([(Not(IsNull(_wrap(a))), _wrap(b))], _wrap(c))


def If(cond, a, b) -> Expression:
    return CaseWhen([(_wrap(cond), _wrap(a))], _wrap(b))


class _GreatestLeast(Expression):
    _name = "greatest"

    def __init__(self, *args):
        if len(args) < 2:
            raise AnalysisError(f"{self._name} requires >= 2 arguments")
        self.children = tuple(_wrap(a) for a in args)

    def dtype(self, schema):
        dts = [c.dtype(schema) for c in self.children]
        for dt in dts:
            if isinstance(dt, T.StringType):
                raise AnalysisError(
                    f"{self._name} over strings is not supported "
                    f"(dictionary codes have no value order)")
        out = dts[0]
        for dt in dts[1:]:
            out = T.common_type(out, dt)
        return out

    def nullable(self, schema):
        return all(c.nullable(schema) for c in self.children)

    @staticmethod
    def _pick(a, b):
        raise NotImplementedError

    @staticmethod
    def _pick_float(a, b):
        raise NotImplementedError

    def eval(self, batch):
        out_dt = self.dtype(batch.schema())
        vs = [cast_vec(c.eval(batch), out_dt) for c in self.children]
        data, validity = vs[0].data, vs[0].validity
        pick = self._pick_float if data.is_floating_point() else self._pick
        if validity is None:
            validity = torch.ones(data.shape, dtype=torch.bool,
                                  device=data.device)
        for v in vs[1:]:
            vvalid = v.validity if v.validity is not None else \
                torch.ones(v.data.shape, dtype=torch.bool,
                           device=v.data.device)
            # NULLs are skipped (reference: greatest/least ignore nulls)
            better = vvalid & (~validity | pick(v.data, data))
            data = torch.where(better, v.data, data)
            validity = validity | vvalid
        return Vec(data, out_dt, validity)

    def __repr__(self):
        return f"{self._name}({', '.join(map(repr, self.children))})"


class Greatest(_GreatestLeast):
    _name = "greatest"

    @staticmethod
    def _pick(a, b):
        return a > b

    @staticmethod
    def _pick_float(a, b):
        # the reference orders NaN as the LARGEST double: greatest
        # prefers NaN over any number (including +inf)
        return (torch.isnan(a) & ~torch.isnan(b)) | (a > b)


class Least(_GreatestLeast):
    _name = "least"

    @staticmethod
    def _pick(a, b):
        return a < b

    @staticmethod
    def _pick_float(a, b):
        # NaN is the largest double, so least only keeps NaN when every
        # input is NaN — a number always replaces an accumulated NaN
        return ~torch.isnan(a) & (torch.isnan(b) | (a < b))


class IsNan(Expression):
    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return T.BOOLEAN

    def nullable(self, schema):
        return False

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if not v.data.is_floating_point():
            return Vec(torch.zeros(v.data.shape, dtype=torch.bool,
                                   device=v.data.device), T.BOOLEAN, None)
        isnan = torch.isnan(v.data)
        if v.validity is not None:
            isnan = isnan & v.validity  # NULL is not NaN
        return Vec(isnan, T.BOOLEAN, None)

    def __repr__(self):
        return f"isnan({self.children[0]!r})"


class NanToNull(Expression):
    """Internal: NaN -> NULL (used by nanvl lowering)."""

    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return self.children[0].dtype(schema)

    def eval(self, batch):
        v = self.children[0].eval(batch)
        notnan = ~torch.isnan(v.data)
        return Vec(v.data, v.dtype, _and_valid(v.validity, notnan))

    def __repr__(self):
        return f"nan_to_null({self.children[0]!r})"


def Nanvl(a, b) -> Expression:
    return Coalesce(NanToNull(_wrap(a)), _wrap(b))


# ---------------------------------------------------------------------------
# Datetime (int32 days since epoch; _civil_from_days does the calendar).
# torch's `//` and `%` on integer tensors floor, as jnp's do, so
# negative days take the same arithmetic.
# ---------------------------------------------------------------------------

class _DatePart(Expression):
    _name = "quarter"

    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return T.INT

    def _compute(self, days):
        raise NotImplementedError

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if not isinstance(v.dtype, T.DateType):
            raise AnalysisError(f"{self._name} expects a DATE input")
        return Vec(self._compute(v.data.to(torch.int64)).to(torch.int32),
                   T.INT, v.validity)

    def __repr__(self):
        return f"{self._name}({self.children[0]!r})"


class Quarter(_DatePart):
    _name = "quarter"

    def _compute(self, days):
        _y, m, _d = _civil_from_days(days)
        return (m - 1) // 3 + 1


class DayOfWeek(_DatePart):
    """1 = Sunday ... 7 = Saturday (reference: DayOfWeek)."""
    _name = "dayofweek"

    def _compute(self, days):
        return (days + 4) % 7 + 1  # 1970-01-01 was a Thursday


class WeekDay(_DatePart):
    """0 = Monday ... 6 = Sunday (reference: WeekDay)."""
    _name = "weekday"

    def _compute(self, days):
        return (days + 3) % 7


class DayOfYear(_DatePart):
    _name = "dayofyear"

    def _compute(self, days):
        y, _m, _d = _civil_from_days(days)
        jan1 = _days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
        return days - jan1 + 1


class WeekOfYear(_DatePart):
    """ISO-8601 week number (reference: WeekOfYear)."""
    _name = "weekofyear"

    def _compute(self, days):
        # ISO week = week of the year containing this date's Thursday
        thursday = days - ((days + 3) % 7) + 3  # Monday-start week
        y, _m, _d = _civil_from_days(thursday)
        jan1 = _days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
        return (thursday - jan1) // 7 + 1


def _days_from_civil(y, m, d):
    """Inverse of _civil_from_days (Howard Hinnant's algorithm)."""
    y = y - (m <= 2).to(y.dtype)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _next_month(y, m):
    """(year, month) of the month after (y, m)."""
    return (torch.where(m == 12, y + 1, y),
            torch.where(m == 12, torch.ones_like(m), m + 1))


class LastDay(_DatePart):
    _name = "last_day"

    def dtype(self, schema):
        return T.DATE

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if not isinstance(v.dtype, T.DateType):
            raise AnalysisError("last_day expects a DATE input")
        days = v.data.to(torch.int64)
        y, m, _d = _civil_from_days(days)
        ny, nm = _next_month(y, m)
        out = _days_from_civil(ny, nm, torch.ones_like(nm)) - 1
        return Vec(out.to(torch.int32), T.DATE, v.validity)


class NextDay(Expression):
    """next_day(date, 'MON'): first date later than `date` falling on
    the given weekday."""

    _DOW = {"SUN": 0, "MON": 1, "TUE": 2, "WED": 3, "THU": 4, "FRI": 5,
            "SAT": 6, "SUNDAY": 0, "MONDAY": 1, "TUESDAY": 2,
            "WEDNESDAY": 3, "THURSDAY": 4, "FRIDAY": 5, "SATURDAY": 6}

    def __init__(self, child, day_name: str):
        self.children = (_wrap(child),)
        key = day_name.strip().upper()
        if key not in self._DOW:
            raise AnalysisError(f"unknown day-of-week {day_name!r}")
        self.target = self._DOW[key]
        self.day_name = day_name

    def dtype(self, schema):
        return T.DATE

    def eval(self, batch):
        v = self.children[0].eval(batch)
        days = v.data.to(torch.int64)
        dow = (days + 4) % 7  # 0 = Sunday
        delta = (self.target - dow + 6) % 7 + 1
        return Vec((days + delta).to(torch.int32), T.DATE, v.validity)

    def __repr__(self):
        return f"next_day({self.children[0]!r}, {self.day_name!r})"


class AddMonths(Expression):
    """add_months(date, n): calendar month arithmetic with day clamping
    (reference: AddMonths; Jan 31 + 1 month = Feb 28/29)."""

    def __init__(self, child, n):
        self.children = (_wrap(child), _wrap(n))

    def dtype(self, schema):
        return T.DATE

    def eval(self, batch):
        v = self.children[0].eval(batch)
        n = self.children[1].eval(batch)
        days = v.data.to(torch.int64)
        y, m, d = _civil_from_days(days)
        total = y * 12 + (m - 1) + n.data.to(torch.int64)
        ny = total // 12
        nm = total % 12 + 1
        # clamp the day to the target month's length
        nym, nmm = _next_month(ny, nm)
        month_len = (_days_from_civil(nym, nmm, torch.ones_like(nmm))
                     - _days_from_civil(ny, nm, torch.ones_like(nm)))
        out = _days_from_civil(ny, nm, torch.minimum(d, month_len))
        return Vec(out.to(torch.int32), T.DATE,
                   _and_valid(v.validity, n.validity))

    def __repr__(self):
        return f"add_months({self.children[0]!r}, {self.children[1]!r})"


class MonthsBetween(Expression):
    """months_between(end, start) -> double (reference: MonthsBetween,
    31-day month convention, rounded to 8 digits)."""

    def __init__(self, end, start):
        self.children = (_wrap(end), _wrap(start))

    def dtype(self, schema):
        return T.DOUBLE

    def eval(self, batch):
        e = self.children[0].eval(batch)
        s = self.children[1].eval(batch)
        ed, sd = e.data.to(torch.int64), s.data.to(torch.int64)
        ey, em, edd = _civil_from_days(ed)
        sy, sm, sdd = _civil_from_days(sd)
        # last-day-of-month pairs count as whole months
        e_last = LastDay(self.children[0]).eval(batch).data.to(torch.int64)
        s_last = LastDay(self.children[1]).eval(batch).data.to(torch.int64)
        both_last = (ed == e_last) & (sd == s_last)
        whole = ((ey - sy) * 12 + (em - sm)).to(torch.float64)
        frac = (edd - sdd).to(torch.float64) / 31.0
        out = torch.where(both_last | (edd == sdd), whole, whole + frac)
        out = torch.round(out * 1e8) / 1e8
        return Vec(out, T.DOUBLE, _and_valid(e.validity, s.validity))

    def __repr__(self):
        return (f"months_between({self.children[0]!r}, "
                f"{self.children[1]!r})")


class DateDiff(Expression):
    def __init__(self, end, start):
        self.children = (_wrap(end), _wrap(start))

    def dtype(self, schema):
        return T.INT

    def eval(self, batch):
        e = self.children[0].eval(batch)
        s = self.children[1].eval(batch)
        return Vec(e.data.to(torch.int32) - s.data.to(torch.int32),
                   T.INT, _and_valid(e.validity, s.validity))

    def __repr__(self):
        return f"datediff({self.children[0]!r}, {self.children[1]!r})"


class TruncDate(Expression):
    """trunc(date, 'year'|'quarter'|'month'|'week') (reference:
    TruncDate)."""

    _FMTS = ("year", "yyyy", "yy", "quarter", "month", "mon", "mm", "week")

    def __init__(self, child, fmt: str):
        self.children = (_wrap(child),)
        self.fmt = fmt.strip().lower()
        if self.fmt not in self._FMTS:
            raise AnalysisError(f"unsupported trunc format {fmt!r}")

    def dtype(self, schema):
        return T.DATE

    def eval(self, batch):
        v = self.children[0].eval(batch)
        days = v.data.to(torch.int64)
        y, m, _d = _civil_from_days(days)
        one = torch.ones_like(m)
        if self.fmt in ("year", "yyyy", "yy"):
            out = _days_from_civil(y, one, one)
        elif self.fmt == "quarter":
            out = _days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
        elif self.fmt in ("month", "mon", "mm"):
            out = _days_from_civil(y, m, one)
        else:  # week: Monday start
            out = days - ((days + 3) % 7)
        return Vec(out.to(torch.int32), T.DATE, v.validity)

    def __repr__(self):
        return f"trunc({self.children[0]!r}, {self.fmt!r})"


class MakeDate(Expression):
    def __init__(self, y, m, d):
        self.children = (_wrap(y), _wrap(m), _wrap(d))

    def dtype(self, schema):
        return T.DATE

    def eval(self, batch):
        y = self.children[0].eval(batch)
        m = self.children[1].eval(batch)
        d = self.children[2].eval(batch)
        y64 = y.data.to(torch.int64)
        m64 = m.data.to(torch.int64)
        d64 = d.data.to(torch.int64)
        out = _days_from_civil(y64, m64, d64)
        # round-trip through the calendar: invalid dates (make_date(
        # 2023, 2, 30)) would silently roll into the next month; the
        # reference returns NULL (non-ANSI) instead
        ry, rm, rd = _civil_from_days(out)
        ok = (ry == y64) & (rm == m64) & (rd == d64)
        validity = _and_valid(
            _and_valid(y.validity, m.validity),
            _and_valid(d.validity, ok))
        return Vec(out.to(torch.int32), T.DATE, validity)

    def __repr__(self):
        return (f"make_date({self.children[0]!r}, {self.children[1]!r}, "
                f"{self.children[2]!r})")


# ---------------------------------------------------------------------------
# Strings: dictionary-table functions
# ---------------------------------------------------------------------------

def _dictionary_values(v: Vec, fn_name: str) -> List[Optional[str]]:
    if v.dictionary is None:
        raise AnalysisError(f"{fn_name} requires dictionary-encoded strings")
    d = v.dictionary
    if isinstance(d, pa.ChunkedArray):
        d = d.combine_chunks()
    return d.to_pylist()


class _DictPyTransform(Expression):
    """string -> string via a Python function mapped over the (small)
    host dictionary: O(|dict|) host work, then the codes are remapped
    onto the deduplicated result, in `pc.unique` order as the JAX
    package orders it."""

    def __init__(self, child, *params):
        self.children = (_wrap(child),)
        self.params = params

    def dtype(self, schema):
        return T.STRING

    def _py(self, s: str) -> str:
        raise NotImplementedError

    def eval(self, batch):
        from .columnar import apply_code_remap, dedupe_dictionary
        v = self.children[0].eval(batch)
        vals = [None if s is None else self._py(s)
                for s in _dictionary_values(v, type(self).__name__)]
        remap, uniq = dedupe_dictionary(pa.array(vals, type=pa.string()))
        return Vec(apply_code_remap(v.data, remap), T.STRING, v.validity,
                   uniq)

    def __repr__(self):
        ps = ", ".join(repr(p) for p in self.params)
        return (f"{type(self).__name__.lower()}({self.children[0]!r}"
                + (f", {ps}" if ps else "") + ")")


class Ltrim(_DictPyTransform):
    def _py(self, s):
        return s.lstrip()


class Rtrim(_DictPyTransform):
    def _py(self, s):
        return s.rstrip()


class Reverse(_DictPyTransform):
    def _py(self, s):
        return s[::-1]


class InitCap(_DictPyTransform):
    def _py(self, s):
        return " ".join(w[:1].upper() + w[1:].lower() if w else w
                        for w in s.split(" "))


class Lpad(_DictPyTransform):
    def __init__(self, child, length: int, pad: str = " "):
        super().__init__(child, length, pad)
        self.length = int(length)
        self.pad = pad

    def _fill(self, s):
        need = self.length - len(s)
        return (self.pad * need)[:need] if self.pad else ""

    def _py(self, s):
        if len(s) >= self.length:
            return s[:self.length]
        return self._fill(s) + s


class Rpad(Lpad):
    def _py(self, s):
        if len(s) >= self.length:
            return s[:self.length]
        return s + self._fill(s)


class StringReplace(_DictPyTransform):
    def __init__(self, child, search: str, replace: str = ""):
        super().__init__(child, search, replace)
        self.search = search
        self.replace = replace

    def _py(self, s):
        return s.replace(self.search, self.replace)


class Translate(_DictPyTransform):
    def __init__(self, child, matching: str, replace: str):
        super().__init__(child, matching, replace)
        self.table = str.maketrans(
            {m: (replace[i] if i < len(replace) else None)
             for i, m in enumerate(matching)})

    def _py(self, s):
        return s.translate(self.table)


class Repeat(_DictPyTransform):
    def __init__(self, child, n: int):
        super().__init__(child, n)
        self.n = int(n)

    def _py(self, s):
        return s * max(0, self.n)


class RegexpReplace(_DictPyTransform):
    def __init__(self, child, pattern: str, replacement: str):
        super().__init__(child, pattern, replacement)
        self.pattern = re.compile(pattern)
        # Java-style $1 group refs -> Python \1
        self.replacement = re.sub(r"\$(\d+)", r"\\\1", replacement)

    def _py(self, s):
        return self.pattern.sub(self.replacement, s)


class RegexpExtract(_DictPyTransform):
    def __init__(self, child, pattern: str, idx: int = 1):
        super().__init__(child, pattern, idx)
        self.pattern = re.compile(pattern)
        self.idx = int(idx)

    def _py(self, s):
        m = self.pattern.search(s)
        if m is None:
            return ""
        try:
            g = m.group(self.idx)
        except (IndexError, re.error):
            raise AnalysisError(
                f"regexp group {self.idx} out of range for "
                f"{self.pattern.pattern!r}")
        return g if g is not None else ""


class _DictLookup(Expression):
    """string -> scalar via a per-dictionary-entry lookup table gathered
    by code (the StringLength pattern generalized)."""

    _out: T.DataType = T.INT

    def __init__(self, child, *params):
        self.children = (_wrap(child),)
        self.params = params

    def dtype(self, schema):
        return self._out

    def nullable(self, schema):
        return self.children[0].nullable(schema)

    def _table(self, values: List[Optional[str]]) -> np.ndarray:
        raise NotImplementedError

    def eval(self, batch):
        v = self.children[0].eval(batch)
        table = torch.from_numpy(self._table(
            _dictionary_values(v, type(self).__name__))).to(v.data.device)
        if table.shape[0] == 0:
            table = torch.zeros((1,), dtype=table.dtype,
                                device=table.device)
        data = table[v.data.clamp(0, table.shape[0] - 1).long()]
        return Vec(data, self._out, v.validity)

    def __repr__(self):
        ps = ", ".join(repr(p) for p in self.params)
        return (f"{type(self).__name__.lower()}({self.children[0]!r}"
                + (f", {ps}" if ps else "") + ")")


class Instr(_DictLookup):
    """instr(str, substr): 1-based position, 0 = not found."""
    _out = T.INT

    def __init__(self, child, sub: str):
        super().__init__(child, sub)
        self.sub = sub

    def _table(self, values):
        return np.array([0 if s is None else s.find(self.sub) + 1
                         for s in values], np.int32)


class Ascii(_DictLookup):
    _out = T.INT

    def _table(self, values):
        return np.array([0 if not s else ord(s[0]) for s in values],
                        np.int32)


class RLike(_DictLookup):
    """rlike/regexp_like: full Python regex search over the dictionary."""
    _out = T.BOOLEAN

    def __init__(self, child, pattern: str):
        super().__init__(child, pattern)
        self.pattern = re.compile(pattern)

    def _table(self, values):
        return np.array([False if s is None
                         else self.pattern.search(s) is not None
                         for s in values], np.bool_)


class Contains(_DictLookup):
    _out = T.BOOLEAN

    def __init__(self, child, sub: str):
        super().__init__(child, sub)
        self.sub = sub

    def _table(self, values):
        return np.array([False if s is None else self.sub in s
                         for s in values], np.bool_)


class StartsWith(_DictLookup):
    _out = T.BOOLEAN

    def __init__(self, child, prefix: str):
        super().__init__(child, prefix)
        self.prefix = prefix

    def _table(self, values):
        return np.array([False if s is None else s.startswith(self.prefix)
                         for s in values], np.bool_)


class EndsWith(_DictLookup):
    _out = T.BOOLEAN

    def __init__(self, child, suffix: str):
        super().__init__(child, suffix)
        self.suffix = suffix

    def _table(self, values):
        return np.array([False if s is None else s.endswith(self.suffix)
                         for s in values], np.bool_)


# ---------------------------------------------------------------------------
# Event-time window bucketing (reference: TimeWindow in
# datetimeExpressions.scala / the window() function): the group key is
# the tumbling-window START; streaming reads `duration_us` off the
# expression for watermark eviction (window end = start + duration).
# ---------------------------------------------------------------------------

_DUR_UNITS_US = {
    "microsecond": 1, "microseconds": 1,
    "millisecond": 1000, "milliseconds": 1000,
    "second": 1_000_000, "seconds": 1_000_000,
    "minute": 60_000_000, "minutes": 60_000_000,
    "hour": 3_600_000_000, "hours": 3_600_000_000,
    "day": 86_400_000_000, "days": 86_400_000_000,
}


def parse_duration_us(s) -> int:
    if isinstance(s, (int, float)):
        return int(s)
    parts = str(s).strip().split()
    if len(parts) != 2 or parts[1].lower() not in _DUR_UNITS_US:
        raise AnalysisError(
            f"cannot parse duration {s!r} (want e.g. '10 seconds')")
    return int(float(parts[0]) * _DUR_UNITS_US[parts[1].lower()])


class TumbleWindow(Expression):
    """window(ts, duration): the tumbling-window START timestamp."""

    def __init__(self, child, duration):
        self.children = (_wrap(child),)
        self.duration_us = parse_duration_us(duration)
        if self.duration_us <= 0:
            raise AnalysisError("window duration must be positive")

    def dtype(self, schema):
        dt = self.children[0].dtype(schema)
        if not isinstance(dt, (T.TimestampType, T.LongType,
                               T.IntegerType)):
            raise AnalysisError(
                f"window() needs a timestamp event-time column, "
                f"got {dt!r}")
        return dt

    def name(self):
        return "window"

    def eval(self, batch):
        v = self.children[0].eval(batch)
        d = self.duration_us
        start = torch.div(v.data, d, rounding_mode="floor") * d
        return Vec(start.to(v.data.dtype), v.dtype, v.validity)

    def __repr__(self):
        return f"window({self.children[0]!r}, {self.duration_us}us)"
