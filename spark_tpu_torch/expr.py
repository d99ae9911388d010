"""Expression IR: typed tree evaluating to whole-column torch programs.

The port of the `spark_tpu/expr.py` subset that TPC-H Q1 and Q6 use
(reference: `Expression.scala:86`). ``eval`` runs eagerly over whole
columns of a :class:`Batch`; there is no jit counterpart.

Null semantics follow the reference: NULL-propagating arithmetic,
Kleene three-valued AND/OR, null-safe IsNull. NULLs ride a boolean
validity tensor (None == all valid).

String expressions are dictionary-aware: comparisons against literals
are evaluated once on the host-side dictionary and become O(1) code
lookups on the device.

torch differs from `jax.numpy` in two places this module has to mind:
an integer tensor combined with a Python float gives float32 (so every
float computation converts to float64 first), and a 0-d tensor does not
widen a dimensioned tensor's dtype (so operands are cast to the result
type before they meet).
"""

from __future__ import annotations

from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from . import types as T
from .columnar import Batch, Column


@dataclass
class Vec:
    """An evaluated column-expression: data + validity + type + dictionary.

    `bits`: optional static bound — values are known to lie in
    [0, 2^bits) (Range ids set it)."""

    data: Any
    dtype: T.DataType
    validity: Any = None  # None = all valid
    dictionary: Optional[pa.Array] = None
    bits: Optional[int] = None


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


class AnalysisError(Exception):
    pass


class Expression:
    """Base expression node."""

    children: Tuple["Expression", ...] = ()

    def dtype(self, schema: T.Schema) -> T.DataType:
        raise NotImplementedError

    def nullable(self, schema: T.Schema) -> bool:
        return any(c.nullable(schema) for c in self.children) if self.children else True

    def eval(self, batch: Batch) -> Vec:
        raise NotImplementedError

    def name(self) -> str:
        return repr(self)

    # -- tree utilities (reference: TreeNode.scala transform combinators) ---

    def map_children(self, f: Callable[["Expression"], "Expression"]) -> "Expression":
        if not self.children:
            return self
        import copy
        new = copy.copy(self)
        new.children = tuple(f(c) for c in self.children)
        return new

    def transform_up(self, f) -> "Expression":
        node = self.map_children(lambda c: c.transform_up(f))
        return f(node)

    def references(self) -> set:
        out = set()
        for c in self.children:
            out |= c.references()
        return out

    def foldable(self) -> bool:
        return bool(self.children) and all(c.foldable() for c in self.children)

    # sugar so users can compose: (col("a") + 1 > col("b")) & ...
    def __add__(self, o): return Add(self, _wrap(o))
    def __radd__(self, o): return Add(_wrap(o), self)
    def __sub__(self, o): return Sub(self, _wrap(o))
    def __rsub__(self, o): return Sub(_wrap(o), self)
    def __mul__(self, o): return Mul(self, _wrap(o))
    def __rmul__(self, o): return Mul(_wrap(o), self)
    def __truediv__(self, o): return Div(self, _wrap(o))
    def __rtruediv__(self, o): return Div(_wrap(o), self)
    def __mod__(self, o): return Mod(self, _wrap(o))
    def __neg__(self): return Neg(self)
    def __eq__(self, o): return EQ(self, _wrap(o))  # type: ignore[override]
    def __ne__(self, o): return NE(self, _wrap(o))  # type: ignore[override]
    def __lt__(self, o): return LT(self, _wrap(o))
    def __le__(self, o): return LE(self, _wrap(o))
    def __gt__(self, o): return GT(self, _wrap(o))
    def __ge__(self, o): return GE(self, _wrap(o))
    def __and__(self, o): return And(self, _wrap(o))
    def __rand__(self, o): return And(_wrap(o), self)
    def __or__(self, o): return Or(self, _wrap(o))
    def __ror__(self, o): return Or(_wrap(o), self)
    def __invert__(self): return Not(self)
    def __hash__(self):
        return hash((type(self).__name__, self.children))

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def cast(self, dt: T.DataType) -> "Cast":
        return Cast(self, dt)

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "Not":
        return Not(IsNull(self))

    def isin(self, *values) -> "In":
        return In(self, tuple(values))

    def between(self, lo, hi) -> "Expression":
        return And(GE(self, _wrap(lo)), LE(self, _wrap(hi)))

    def asc(self) -> "SortOrder":
        return SortOrder(self, ascending=True)

    def desc(self) -> "SortOrder":
        return SortOrder(self, ascending=False)


def _wrap(v) -> Expression:
    if isinstance(v, Expression):
        return v
    return Literal(v)


def structurally_equal(a: Expression, b: Expression) -> bool:
    """Semantic (structural) equality — `__eq__` is overloaded for DSL use."""
    if type(a) is not type(b):
        return False
    sa = {k: v for k, v in a.__dict__.items() if k != "children"}
    sb = {k: v for k, v in b.__dict__.items() if k != "children"}
    if sa.keys() != sb.keys():
        return False
    for k in sa:
        va, vb = sa[k], sb[k]
        if isinstance(va, Expression) or isinstance(vb, Expression):
            if not (isinstance(va, Expression) and isinstance(vb, Expression)
                    and structurally_equal(va, vb)):
                return False
        elif va is not vb and va != vb:
            return False
    if len(a.children) != len(b.children):
        return False
    return all(structurally_equal(x, y) for x, y in zip(a.children, b.children))


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

class ColumnRef(Expression):
    """Unresolved-by-name column reference (reference: UnresolvedAttribute)."""

    def __init__(self, name: str):
        self._name = name
        self.children = ()

    def dtype(self, schema: T.Schema) -> T.DataType:
        return _resolve_field(schema, self._name).dtype

    def nullable(self, schema: T.Schema) -> bool:
        return _resolve_field(schema, self._name).nullable

    def eval(self, batch: Batch) -> Vec:
        col = _resolve_column(batch, self._name)
        return Vec(col.data, col.dtype, col.validity, col.dictionary,
                   bits=col.bits)

    def references(self) -> set:
        return {self._name}

    def foldable(self) -> bool:
        return False

    def name(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return self._name


# session-level resolution mode, set from spark_tpu.sql.caseSensitive by
# the executor before analysis (a ContextVar, so concurrent queries on
# other threads keep their own value)
_CASE_SENSITIVE: ContextVar[bool] = ContextVar(
    "spark_tpu_torch_case_sensitive", default=False)


def case_sensitive() -> bool:
    return _CASE_SENSITIVE.get()


def set_case_sensitive(value: bool) -> None:
    _CASE_SENSITIVE.set(bool(value))


def _resolve_field(schema: T.Schema, name: str) -> T.Field:
    matches = [f for f in schema.fields if f.name == name]
    if not matches and not case_sensitive():
        matches = [f for f in schema.fields if f.name.lower() == name.lower()]
    if not matches:
        raise AnalysisError(
            f"column {name!r} not found among {schema.names}")
    if len(matches) > 1:
        raise AnalysisError(f"ambiguous column {name!r}")
    return matches[0]


def _resolve_column(batch: Batch, name: str) -> Column:
    if name in batch.columns:
        return batch.columns[name]
    if not case_sensitive():
        for n, c in batch.columns.items():
            if n.lower() == name.lower():
                return c
    raise AnalysisError(f"column {name!r} not found among {batch.names}")


class Literal(Expression):
    def __init__(self, value, dtype: Optional[T.DataType] = None):
        self.value = value
        self._dtype = dtype or _infer_literal_type(value)
        self.children = ()

    def dtype(self, schema=None) -> T.DataType:
        return self._dtype

    def nullable(self, schema=None) -> bool:
        return self.value is None

    def foldable(self) -> bool:
        return True

    def eval(self, batch: Batch) -> Vec:
        return self.eval_scalar(batch.device)

    def eval_scalar(self, device=None) -> Vec:
        """0-d tensors on `device` (the CPU when None)."""
        tdt = T.torch_dtype(self._dtype.np_dtype)
        if self.value is None:
            # NULL strings carry a placeholder dictionary so operators see
            # a well-formed dictionary column
            dic = pa.array([""]) \
                if isinstance(self._dtype, T.StringType) else None
            return Vec(torch.zeros((), dtype=tdt, device=device), self._dtype,
                       validity=torch.zeros((), dtype=torch.bool,
                                            device=device),
                       dictionary=dic)
        v = self.value
        if isinstance(self._dtype, T.DecimalType):
            import decimal
            if not isinstance(v, decimal.Decimal):
                # via str() so 0.05 means 5e-2, rounded HALF_UP
                v = decimal.Decimal(str(v))
            v = int((v * (10 ** self._dtype.scale)).to_integral_value(
                rounding=decimal.ROUND_HALF_UP))
        if isinstance(self._dtype, T.DateType):
            import datetime
            if isinstance(v, datetime.date):
                v = (v - datetime.date(1970, 1, 1)).days
        if isinstance(self._dtype, T.StringType):
            # scalar strings stay host-side; comparisons special-case them
            return Vec(None, self._dtype, None, None)
        return Vec(torch.tensor(v, dtype=tdt, device=device), self._dtype)

    def __repr__(self) -> str:
        return repr(self.value)


def _infer_literal_type(v) -> T.DataType:
    import datetime
    import decimal
    if v is None:
        return T.NULL
    if isinstance(v, bool):
        return T.BOOLEAN
    if isinstance(v, int):
        return T.LONG if not (-2**31 <= v < 2**31) else T.INT
    if isinstance(v, float):
        return T.DOUBLE
    if isinstance(v, str):
        return T.STRING
    if isinstance(v, decimal.Decimal):
        sign, digits, exp = v.as_tuple()
        scale = max(0, -exp)
        return T.DecimalType(max(len(digits), scale + 1), scale)
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return T.DATE
    if isinstance(v, datetime.datetime):
        return T.TIMESTAMP
    raise TypeError(f"cannot infer literal type for {v!r}")


def date_literal(s: str) -> Literal:
    """'1998-09-02' -> days-since-epoch DATE literal."""
    days = (np.datetime64(s, "D") - np.datetime64("1970-01-01", "D")).astype(int)
    return Literal(int(days), T.DATE)


class Alias(Expression):
    def __init__(self, child: Expression, alias_name: str):
        self.children = (child,)
        self._alias = alias_name

    @property
    def child(self):
        return self.children[0]

    def dtype(self, schema):
        return self.child.dtype(schema)

    def nullable(self, schema):
        return self.child.nullable(schema)

    def eval(self, batch):
        return self.child.eval(batch)

    def name(self) -> str:
        return self._alias

    def __repr__(self) -> str:
        return f"{self.children[0]!r} AS {self._alias}"


def plain_column_name(e: Expression) -> Optional[str]:
    """The column a (possibly aliased) plain reference names, or None for
    a computed expression."""
    while isinstance(e, Alias):
        e = e.child
    return e.name() if isinstance(e, ColumnRef) else None


class SortOrder(Expression):
    """Sort key + direction + null ordering (reference: SortOrder.scala)."""

    def __init__(self, child: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.children = (child,)
        self.ascending = ascending
        # Spark default: NULLS FIRST for ASC, NULLS LAST for DESC
        self.nulls_first = ascending if nulls_first is None else nulls_first

    @property
    def child(self):
        return self.children[0]

    def dtype(self, schema):
        return self.child.dtype(schema)

    def eval(self, batch):
        return self.child.eval(batch)

    def __repr__(self):
        return f"{self.children[0]!r} {'ASC' if self.ascending else 'DESC'}"


# ---------------------------------------------------------------------------
# Casts and numeric helpers
# ---------------------------------------------------------------------------

class Cast(Expression):
    def __init__(self, child: Expression, to: T.DataType):
        self.children = (child,)
        self.to = to

    def dtype(self, schema):
        return self.to

    def eval(self, batch: Batch) -> Vec:
        return cast_vec(self.children[0].eval(batch), self.to)

    def __repr__(self):
        return f"cast({self.children[0]!r} as {self.to!r})"


def cast_vec(v: Vec, to: T.DataType) -> Vec:
    if v.dtype == to:
        return v
    src = v.dtype
    data = v.data
    if isinstance(src, T.DecimalType) and isinstance(to, T.DecimalType):
        ds = to.scale - src.scale
        if ds >= 0:
            data = data * (10 ** ds)
        else:
            data = _div_round_half_up(data, 10 ** (-ds))
        return Vec(data, to, v.validity)
    if isinstance(src, T.DecimalType):
        if isinstance(to, (T.DoubleType, T.FloatType)):
            out = data.to(torch.float64) / (10.0 ** src.scale)
            return Vec(out.to(T.torch_dtype(to.np_dtype)), to, v.validity)
        if isinstance(to, T.IntegralType):
            return Vec(_div_round_half_up(data, 10 ** src.scale)
                       .to(T.torch_dtype(to.np_dtype)), to, v.validity)
    if isinstance(to, T.DecimalType):
        if isinstance(src, T.IntegralType) or isinstance(src, T.BooleanType):
            return Vec(data.to(torch.int64) * (10 ** to.scale), to,
                       v.validity)
        if isinstance(src, (T.DoubleType, T.FloatType)):
            scaled = torch.round(data.to(torch.float64) * (10.0 ** to.scale))
            return Vec(scaled.to(torch.int64), to, v.validity)
    if isinstance(src, T.StringType) or isinstance(to, T.StringType):
        raise AnalysisError(f"cast {src!r} -> {to!r} not supported on device")
    return Vec(data.to(T.torch_dtype(to.np_dtype)), to, v.validity)


def _div_round_half_up(data, divisor: int):
    # HALF_UP rounding on integers, matching the reference Decimal.scala
    half = divisor // 2
    adj = torch.where(data >= 0, data + half, data - half)
    return torch.div(adj, divisor, rounding_mode="floor")


_INT64_MAX = (1 << 63) - 1


def _div_exact_int64(l, r, shift: int):
    """l * 10^shift / r rounded HALF_UP in int64 arithmetic, for r != 0.
    Returns (quotient, fits): `fits` marks the rows whose scaled operand
    stays inside int64, where the quotient is exact; None when 10^|shift|
    itself exceeds int64."""
    scale = 10 ** abs(shift)
    if scale > _INT64_MAX:
        return None
    lim = _INT64_MAX // scale
    if shift >= 0:
        num, den = l * scale, r
        fits = (l >= -lim) & (l <= lim) & (r > -_INT64_MAX)
    else:
        num, den = l, r * scale
        fits = (r >= -lim) & (r <= lim) & (l > -_INT64_MAX)
    q = torch.div(num, den, rounding_mode="trunc")
    rem = (num - q * den).abs()
    # |rem| >= |den| / 2, without doubling rem past int64
    up = rem >= den.abs() - rem
    sign = torch.where((num < 0) != (den < 0), -1, 1)
    return q + torch.where(up, sign, 0), fits


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

class BinaryArithmetic(Expression):
    op: str = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    def dtype(self, schema):
        lt = self.children[0].dtype(schema)
        rt = self.children[1].dtype(schema)
        return self._result_type(lt, rt)

    def _result_type(self, lt, rt):
        return T.common_type(lt, rt)

    def eval(self, batch: Batch) -> Vec:
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        validity = _and_valid(lv.validity, rv.validity)
        out_dtype = self._result_type(lv.dtype, rv.dtype)
        data = self._compute(lv, rv, out_dtype)
        return Vec(data, out_dtype, validity)

    def _compute(self, lv: Vec, rv: Vec, out: T.DataType):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.children[0]!r} {self.op} {self.children[1]!r})"


def _align(v: Vec, out: T.DataType):
    return cast_vec(v, out).data


class Add(BinaryArithmetic):
    op = "+"

    def _compute(self, lv, rv, out):
        return _align(lv, out) + _align(rv, out)


class Sub(BinaryArithmetic):
    op = "-"

    def _compute(self, lv, rv, out):
        return _align(lv, out) - _align(rv, out)


class Mul(BinaryArithmetic):
    op = "*"

    def _result_type(self, lt, rt):
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            ls = lt.scale if isinstance(lt, T.DecimalType) else 0
            rs = rt.scale if isinstance(rt, T.DecimalType) else 0
            lp = lt.precision if isinstance(lt, T.DecimalType) else 20
            rp = rt.precision if isinstance(rt, T.DecimalType) else 20
            if isinstance(lt, T.NumericType) and isinstance(rt, T.NumericType) \
                    and not isinstance(lt, (T.FloatType, T.DoubleType)) \
                    and not isinstance(rt, (T.FloatType, T.DoubleType)):
                return T.DecimalType(min(38, lp + rp), ls + rs)
            return T.DOUBLE
        return T.common_type(lt, rt)

    def _compute(self, lv, rv, out):
        if isinstance(out, T.DecimalType):
            l = lv.data if isinstance(lv.dtype, T.DecimalType) else \
                cast_vec(lv, T.DecimalType(20, 0)).data
            r = rv.data if isinstance(rv.dtype, T.DecimalType) else \
                cast_vec(rv, T.DecimalType(20, 0)).data
            return l * r
        return _align(lv, out) * _align(rv, out)


class Div(BinaryArithmetic):
    """`/`: true division. Integer/integer -> double (Spark SQL); decimal
    division returns a DECIMAL quotient with scale max(6, s1+p2+1)
    capped at 8 (scaled int64 device representation), HALF_UP-rounded.
    Division by zero yields NULL (non-ANSI reference behavior). The JAX
    package also yields NULL where the scaled dividend or the divisor
    passes 2^53; the port computes those rows exactly in int64 and
    yields NULL only past int64."""

    op = "/"

    def nullable(self, schema):
        return True

    def _result_type(self, lt, rt):
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            if isinstance(lt, (T.FloatType, T.DoubleType)) or \
                    isinstance(rt, (T.FloatType, T.DoubleType)):
                return T.DOUBLE
            s1 = lt.scale if isinstance(lt, T.DecimalType) else 0
            p1 = lt.precision if isinstance(lt, T.DecimalType) else 20
            s2 = rt.scale if isinstance(rt, T.DecimalType) else 0
            p2 = rt.precision if isinstance(rt, T.DecimalType) else 20
            scale = min(max(6, s1 + p2 + 1), 8)
            prec = min(38, p1 - s1 + s2 + scale)
            return T.DecimalType(prec, scale)
        return T.DOUBLE

    def eval(self, batch: Batch) -> Vec:
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        out = self._result_type(lv.dtype, rv.dtype)
        validity = _and_valid(lv.validity, rv.validity)
        if isinstance(out, T.DecimalType):
            s1 = lv.dtype.scale if isinstance(lv.dtype, T.DecimalType) else 0
            s2 = rv.dtype.scale if isinstance(rv.dtype, T.DecimalType) else 0
            l = lv.data if isinstance(lv.dtype, T.DecimalType) else \
                cast_vec(lv, T.DecimalType(20, 0)).data
            r = rv.data if isinstance(rv.dtype, T.DecimalType) else \
                cast_vec(rv, T.DecimalType(20, 0)).data
            zero = r == 0
            safe_r = torch.where(zero, torch.ones_like(r), r)
            # unscaled_out = l / r * 10^(out.scale + s2 - s1), HALF_UP,
            # via f64 inside the 2^53 exactness bound, as the JAX package
            # computes it
            shift = out.scale + s2 - s1
            if shift >= 0:
                l_bound = (1 << 53) // (10 ** shift)
            else:
                l_bound = (1 << 53) * (10 ** (-shift))
            exact = (l.abs() <= min(l_bound, (1 << 62))) \
                & (r.abs() <= (1 << 53))
            q = (l.to(torch.float64) * (10.0 ** shift)
                 / safe_r.to(torch.float64))
            data = (torch.sign(q) * torch.floor(q.abs() + 0.5)).to(torch.int64)
            int64_path = _div_exact_int64(l, safe_r, shift)
            if int64_path is not None:
                # past the bound, where the JAX package gives NULL (at
                # TPC-H SF 0.3 and above, Q8's mkt_share): the exact
                # int64 quotient, NULL only where it cannot be formed
                quotient, fits = int64_path
                data = torch.where(exact, data, quotient)
                exact = exact | fits
            extra = ~zero & exact
        else:
            l = cast_vec(lv, T.DOUBLE).data
            r = cast_vec(rv, T.DOUBLE).data
            zero = r == 0.0
            data = l / torch.where(zero, torch.ones_like(r), r)
            extra = ~zero
        validity = _and_valid(validity, extra)
        if validity is not None and validity.dim() == 0:
            validity = validity.expand(data.shape)
        return Vec(data, out, validity)

    def _compute(self, lv, rv, out):
        raise AssertionError("Div.eval is overridden")


class Mod(BinaryArithmetic):
    """`%` with the reference's truncated-division semantics
    (`arithmetic.scala` Remainder): the result carries the sign of the
    DIVIDEND (-7 % 3 == -1). `Pmod` is the positive variant (result in
    [0, |m|)). Division by zero yields NULL (non-ANSI reference behavior)."""

    op = "%"
    _positive = False  # Pmod overrides

    def nullable(self, schema):
        return True  # divisor may be zero

    def _compute_valid(self, lv, rv, out):
        div_expr = self.children[1]
        while isinstance(div_expr, (Alias, Cast)):
            div_expr = div_expr.children[0]
        if (isinstance(div_expr, Literal)
                and isinstance(div_expr.value, int)
                and 0 < div_expr.value < (1 << 26)
                and isinstance(lv.dtype, T.IntegralType)
                and isinstance(out, T.IntegralType)):
            # constant positive divisor: never zero, so no validity of
            # its own (the JAX package's f64 strength reduction is a TPU
            # workaround; the card has an exact integer remainder)
            m = int(div_expr.value)
            x = lv.data.to(torch.int64)
            r = torch.remainder(x, m)  # floored: in [0, m)
            if not self._positive:
                r = torch.where((x < 0) & (r != 0), r - m, r)
            return r.to(T.torch_dtype(out.np_dtype)), None
        l = _align(lv, out)
        r = _align(rv, out)
        zero = r == 0
        safe_r = torch.where(zero, torch.ones_like(r), r)
        fr = torch.remainder(l, safe_r)  # floored: sign of divisor
        if self._positive:
            res = torch.where(fr < 0, fr + safe_r.abs(), fr)
        else:
            # truncated: sign of dividend
            sign_mismatch = (l < 0) != (safe_r < 0)
            res = torch.where((fr != 0) & sign_mismatch, fr - safe_r, fr)
        return res, ~zero

    def _compute(self, lv, rv, out):
        data, _ = self._compute_valid(lv, rv, out)
        return data

    def eval(self, batch: Batch) -> Vec:
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        out_dtype = self._result_type(lv.dtype, rv.dtype)
        data, extra_valid = self._compute_valid(lv, rv, out_dtype)
        validity = _and_valid(_and_valid(lv.validity, rv.validity), extra_valid)
        if validity is not None and validity.dim() == 0:
            validity = validity.expand(data.shape)
        return Vec(data, out_dtype, validity)


class Pmod(Mod):
    """pmod(a, m): positive modulo, result in [0, |m|) (the reference's
    `Pmod`, arithmetic.scala). The dense-domain group-by path keys on this."""

    op = "pmod"
    _positive = True

    def __repr__(self):
        return f"pmod({self.children[0]!r}, {self.children[1]!r})"


def static_unsigned_bits(e: "Expression") -> Optional[int]:
    """Static bound w with values of e in [0, 2^w), or None (AccSpec.width;
    the CUDA group-by kernel needs no such bound, it is kept for parity
    of the accumulator specs with the JAX package)."""
    while isinstance(e, Alias):
        e = e.children[0]
    if isinstance(e, Pmod):
        d = e.children[1]
        while isinstance(d, (Alias, Cast)):
            d = d.children[0]
        if isinstance(d, Literal) and isinstance(d.value, int) \
                and d.value > 0:
            return max(1, (d.value - 1).bit_length())
    if isinstance(e, Literal) and isinstance(e.value, int) \
            and not isinstance(e.value, bool) and e.value >= 0:
        return max(1, int(e.value).bit_length())
    return None


class Neg(Expression):
    def __init__(self, child):
        self.children = (child,)

    def dtype(self, schema):
        return self.children[0].dtype(schema)

    def eval(self, batch):
        v = self.children[0].eval(batch)
        return Vec(-v.data, v.dtype, v.validity)

    def __repr__(self):
        return f"(-{self.children[0]!r})"


# ---------------------------------------------------------------------------
# Dates (reference: datetimeExpressions.scala)
# ---------------------------------------------------------------------------

def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(days):
    """days-since-epoch -> (year, month, day), branch-free (Howard
    Hinnant's civil-from-days algorithm, vectorized). Every division
    floors, as `//` does in the JAX package: `era` is negative before
    0000-03-01 and torch's default integer division would truncate."""
    z = days + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    year = torch.where(m <= 2, y + 1, y)
    return year, m, d


_US_PER_DAY = 86_400_000_000


class _ExtractDatePart(Expression):
    """year/month/day(date) (reference: datetimeExpressions.scala)."""

    _part = "year"

    def __init__(self, child):
        self.children = (child,)

    def dtype(self, schema):
        return T.INT

    def eval(self, batch):
        v = self.children[0].eval(batch)
        x = v.data.to(torch.int64)
        if isinstance(v.dtype, T.TimestampType):
            # microseconds -> days, floored so pre-epoch times are right
            x = _floordiv(x, _US_PER_DAY)
        y, m, d = _civil_from_days(x)
        part = {"year": y, "month": m, "day": d}[self._part]
        return Vec(part.to(torch.int32), T.INT, v.validity)

    def __repr__(self):
        return f"{self._part}({self.children[0]!r})"


class ExtractYear(_ExtractDatePart):
    _part = "year"


class ExtractMonth(_ExtractDatePart):
    _part = "month"


class ExtractDay(_ExtractDatePart):
    _part = "day"


class DateAdd(Expression):
    """date_add(date, n): shift by days (reference: DateAdd)."""

    def __init__(self, child, days: Expression):
        self.children = (child, days)

    def dtype(self, schema):
        return T.DATE

    def eval(self, batch):
        v = self.children[0].eval(batch)
        n = self.children[1].eval(batch)
        x = v.data
        if isinstance(v.dtype, T.TimestampType):
            # like the reference, the timestamp is cast to DATE first
            x = _floordiv(x.to(torch.int64), _US_PER_DAY)
        data = x.to(torch.int32) + n.data.to(torch.int32)
        return Vec(data, T.DATE, _and_valid(v.validity, n.validity))

    def __repr__(self):
        return f"date_add({self.children[0]!r}, {self.children[1]!r})"


# ---------------------------------------------------------------------------
# Predicates (three-valued logic; reference: predicates.scala)
# ---------------------------------------------------------------------------

class BinaryComparison(Expression):
    op = "?"

    def __init__(self, left, right):
        self.children = (left, right)

    def dtype(self, schema):
        return T.BOOLEAN

    def eval(self, batch: Batch) -> Vec:
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        # dictionary-encoded string vs host string literal
        if isinstance(lv.dtype, T.StringType) or isinstance(rv.dtype, T.StringType):
            return self._eval_string(lv, rv, batch)
        # decimal column vs float scalar: an integer compare on the
        # unscaled decimal against host-computed thresholds that
        # replicate host-f64 semantics bit for bit (README: Q6's
        # `l_discount >= 0.05`)
        for a, b, b_expr, flip in ((lv, rv, self.children[1], False),
                                   (rv, lv, self.children[0], True)):
            lit = _host_float_value(b_expr, b.dtype)
            if isinstance(a.dtype, T.DecimalType) \
                    and isinstance(b.dtype, (T.DoubleType, T.FloatType)) \
                    and lit is not None:
                op = _flip_op(self.op) if flip else self.op
                data = _decimal_vs_float_scalar(a.data, a.dtype.scale,
                                                lit, op)
                if data is not None:
                    return Vec(data, T.BOOLEAN,
                               _and_valid(lv.validity, rv.validity))
        out = T.common_type(lv.dtype, rv.dtype)
        l = _align(lv, out)
        r = _align(rv, out)
        return Vec(self._cmp(l, r), T.BOOLEAN, _and_valid(lv.validity, rv.validity))

    def _eval_string(self, lv: Vec, rv: Vec, batch: Batch) -> Vec:
        lit = None
        colv = None
        for a, b in ((lv, rv), (rv, lv)):
            if a.data is None and a.dictionary is None:
                lit, colv = a, b
        if lit is None:
            # column-vs-column string compare: only EQ/NE via shared dictionary
            if lv.dictionary is not None and rv.dictionary is not None \
                    and lv.dictionary.equals(rv.dictionary) \
                    and type(self) in (EQ, NE):
                return Vec(self._cmp(lv.data, rv.data), T.BOOLEAN,
                           _and_valid(lv.validity, rv.validity))
            raise AnalysisError(
                f"string comparison {self.op} requires a literal or shared "
                f"dictionary")
        # evaluate the comparison on the host dictionary once, then gather
        lit_expr = self.children[0] if lv is lit else self.children[1]
        value = lit_expr.value  # type: ignore[attr-defined]
        table = _dict_compare_table(colv.dictionary, value,
                                    self.op if colv is lv or type(self) in (EQ, NE)
                                    else _flip_op(self.op))
        if len(table) == 0:
            # all-null column: the dictionary is empty, so no code is
            # valid and the payload is masked everywhere
            data = torch.zeros(colv.data.shape, dtype=torch.bool,
                               device=colv.data.device)
        else:
            table = table.to(colv.data.device)
            data = table[colv.data.clamp(0, len(table) - 1).long()]
        return Vec(data, T.BOOLEAN, colv.validity)

    def _cmp(self, l, r):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.children[0]!r} {self.op} {self.children[1]!r})"


def _flip_op(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}[op]


def _host_float_value(e: "Expression", dtype: T.DataType) -> Optional[float]:
    """Host-side float value of a literal expression. FLOAT literals
    round through f32 first, matching `_align`'s cast chain."""
    while isinstance(e, (Alias, Cast)):
        e = e.children[0]
    if not (isinstance(e, Literal)
            and isinstance(e.value, (int, float))
            and not isinstance(e.value, bool)):
        return None
    if isinstance(dtype, T.FloatType):
        return float(np.float64(np.float32(e.value)))
    return float(e.value)


def _decimal_vs_float_scalar(data, scale: int, lit: float, op: str):
    """Integer-domain rewrite of ``f64(n / 10^scale) OP lit``.

    ``f64(n / 10^s)`` is monotone non-decreasing in the unscaled int n, so
    each comparison against a float scalar reduces to integer thresholds
    found by host binary search over exact host f64. Returns None when
    the rewrite doesn't apply (a NaN literal keeps the float path)."""
    if np.isnan(lit):
        return None
    div = np.float64(10.0 ** scale)
    lo_b, hi_b = -(1 << 63), (1 << 63) - 1

    def first_n(pred) -> int:
        """Smallest n in [lo_b, hi_b] with pred(f64(n/10^s)) true; hi_b+1
        when none (pred is monotone in n)."""
        lo, hi = lo_b, hi_b + 1
        while lo < hi:
            mid = (lo + hi) // 2
            if pred(np.float64(mid) / div):
                hi = mid
            else:
                lo = mid + 1
        return lo

    n_ge = first_n(lambda v: v >= lit)   # first n with value >= lit
    n_gt = first_n(lambda v: v > lit)    # first n with value >  lit

    def at_least(n: int):
        """data >= n, handling the no-n-satisfies sentinel (n > hi_b)."""
        if n > hi_b:
            return torch.zeros(data.shape, dtype=torch.bool,
                               device=data.device)
        return data >= n

    if op == ">=":
        return at_least(n_ge)
    if op == ">":
        return at_least(n_gt)
    if op == "<":
        return ~at_least(n_ge)
    if op == "<=":
        return ~at_least(n_gt)
    if op == "=":
        return at_least(n_ge) & ~at_least(n_gt)
    if op == "!=":
        return ~at_least(n_ge) | at_least(n_gt)
    return None


def _dict_compare_table(dictionary: Optional[pa.Array], value: str, op: str):
    if dictionary is None:
        raise AnalysisError("string column without dictionary")
    ops = {"=": pc.equal, "!=": pc.not_equal, "<": pc.less,
           "<=": pc.less_equal, ">": pc.greater, ">=": pc.greater_equal}
    mask = ops[op](dictionary, pa.scalar(value)).to_numpy(zero_copy_only=False)
    return torch.from_numpy(np.asarray(mask, dtype=np.bool_))


class EQ(BinaryComparison):
    op = "="

    def _cmp(self, l, r):
        return l == r


class NE(BinaryComparison):
    op = "!="

    def _cmp(self, l, r):
        return l != r


class LT(BinaryComparison):
    op = "<"

    def _cmp(self, l, r):
        return l < r


class LE(BinaryComparison):
    op = "<="

    def _cmp(self, l, r):
        return l <= r


class GT(BinaryComparison):
    op = ">"

    def _cmp(self, l, r):
        return l > r


class GE(BinaryComparison):
    op = ">="

    def _cmp(self, l, r):
        return l >= r


class EqNullSafe(BinaryComparison):
    """`<=>`: NULL <=> NULL is true, NULL <=> x is false — never returns
    NULL (reference: EqualNullSafe in predicates.scala)."""

    op = "<=>"

    def nullable(self, schema):
        return False

    def eval(self, batch: Batch) -> Vec:
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        if isinstance(lv.dtype, T.StringType) or \
                isinstance(rv.dtype, T.StringType):
            base = EQ(self.children[0], self.children[1]).eval(batch)
            both_null = self._both_null(lv, rv, base.data)
            ok = base.data
            if base.validity is not None:
                ok = ok & base.validity
            return Vec(ok | both_null, T.BOOLEAN)
        out = T.common_type(lv.dtype, rv.dtype)
        eq = _align(lv, out) == _align(rv, out)
        both_valid = _and_valid(lv.validity, rv.validity)
        if both_valid is not None:
            eq = eq & both_valid
        return Vec(eq | self._both_null(lv, rv, eq), T.BOOLEAN)

    @staticmethod
    def _both_null(lv: Vec, rv: Vec, like):
        if lv.validity is None or rv.validity is None:
            return torch.zeros_like(like, dtype=torch.bool)
        return torch.broadcast_to(~lv.validity & ~rv.validity, like.shape)

    def _cmp(self, l, r):
        raise AssertionError("EqNullSafe.eval is overridden")


def _dictionary_table(dictionary: pa.Array, fn, np_dtype, device):
    """Host lookup table of `fn(dictionary)`, on the codes' device."""
    values = fn(dictionary).to_numpy(zero_copy_only=False)
    return torch.from_numpy(np.asarray(values, dtype=np_dtype)).to(device)


def _gather_by_code(table, codes):
    """table[code] per row. Codes are clamped into the table, as the JAX
    package clamps them, so padded rows stay in range; an empty table
    (an all-NULL column) gives zeros, which its validity masks."""
    if table.shape[0] == 0:
        return torch.zeros(codes.shape, dtype=table.dtype,
                           device=codes.device)
    return table[codes.clamp(0, table.shape[0] - 1).long()]


class _DictStringTransform(Expression):
    """String function as a host-side dictionary rewrite: device codes
    are remapped once, per-row work is O(1)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def dtype(self, schema):
        return T.STRING

    def _transform(self, dictionary: pa.Array) -> pa.Array:
        raise NotImplementedError

    def eval(self, batch):
        from .columnar import apply_code_remap, dedupe_dictionary
        v = self.children[0].eval(batch)
        if v.dictionary is None:
            raise AnalysisError(
                f"{type(self).__name__} requires dictionary-encoded strings")
        remap, uniq = dedupe_dictionary(self._transform(v.dictionary))
        return Vec(apply_code_remap(v.data, remap), T.STRING, v.validity,
                   uniq)

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.children[0]!r})"


class Upper(_DictStringTransform):
    def _transform(self, d):
        return pc.utf8_upper(d)


class Lower(_DictStringTransform):
    def _transform(self, d):
        return pc.utf8_lower(d)


class Trim(_DictStringTransform):
    def _transform(self, d):
        return pc.utf8_trim_whitespace(d)


class ConcatLit(_DictStringTransform):
    """concat with string literals around one string column (general
    column-column concat would need a product dictionary)."""

    def __init__(self, child: Expression, prefix: str = "", suffix: str = ""):
        super().__init__(child)
        self.prefix = prefix
        self.suffix = suffix

    def _transform(self, d):
        if d.type != pa.string():
            d = d.cast(pa.string())
        return pc.binary_join_element_wise(
            pa.array([self.prefix] * len(d)), d,
            pa.array([self.suffix] * len(d)), pa.scalar(""))

    def __repr__(self):
        return (f"concat({self.prefix!r}, {self.children[0]!r}, "
                f"{self.suffix!r})")


class StringLength(Expression):
    """length(str): a host dictionary lookup table, gathered by code."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def dtype(self, schema):
        return T.INT

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if v.dictionary is None:
            raise AnalysisError("length requires dictionary-encoded strings")
        table = _dictionary_table(v.dictionary, pc.utf8_length, np.int32,
                                  v.data.device)
        return Vec(_gather_by_code(table, v.data), T.INT, v.validity)

    def __repr__(self):
        return f"length({self.children[0]!r})"


class And(Expression):
    def __init__(self, left, right):
        self.children = (left, right)

    def dtype(self, schema):
        return T.BOOLEAN

    def eval(self, batch):
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        data = lv.data & rv.data
        if lv.validity is None and rv.validity is None:
            return Vec(data, T.BOOLEAN)
        # Kleene: false AND null = false
        lval = lv.validity if lv.validity is not None else \
            torch.ones_like(lv.data)
        rval = rv.validity if rv.validity is not None else \
            torch.ones_like(rv.data)
        false_l = ~lv.data & lval
        false_r = ~rv.data & rval
        validity = (lval & rval) | false_l | false_r
        return Vec(data & validity, T.BOOLEAN, validity)

    def __repr__(self):
        return f"({self.children[0]!r} AND {self.children[1]!r})"


class Or(Expression):
    def __init__(self, left, right):
        self.children = (left, right)

    def dtype(self, schema):
        return T.BOOLEAN

    def eval(self, batch):
        lv = self.children[0].eval(batch)
        rv = self.children[1].eval(batch)
        data = lv.data | rv.data
        if lv.validity is None and rv.validity is None:
            return Vec(data, T.BOOLEAN)
        lval = lv.validity if lv.validity is not None else \
            torch.ones_like(lv.data)
        rval = rv.validity if rv.validity is not None else \
            torch.ones_like(rv.data)
        true_l = lv.data & lval
        true_r = rv.data & rval
        validity = (lval & rval) | true_l | true_r
        return Vec(data, T.BOOLEAN, validity)

    def __repr__(self):
        return f"({self.children[0]!r} OR {self.children[1]!r})"


class Not(Expression):
    def __init__(self, child):
        self.children = (child,)

    def dtype(self, schema):
        return T.BOOLEAN

    def eval(self, batch):
        v = self.children[0].eval(batch)
        return Vec(~v.data, T.BOOLEAN, v.validity)

    def __repr__(self):
        return f"(NOT {self.children[0]!r})"


class IsNull(Expression):
    def __init__(self, child):
        self.children = (child,)

    def dtype(self, schema):
        return T.BOOLEAN

    def nullable(self, schema):
        return False

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if v.validity is None:
            if v.data is None:
                return Vec(torch.zeros((), dtype=torch.bool,
                                       device=batch.device), T.BOOLEAN)
            return Vec(torch.zeros(tuple(v.data.shape) or (1,),
                                   dtype=torch.bool, device=v.data.device),
                       T.BOOLEAN)
        return Vec(~v.validity, T.BOOLEAN)

    def __repr__(self):
        return f"({self.children[0]!r} IS NULL)"


class In(Expression):
    def __init__(self, child: Expression, values: Tuple):
        self.children = (child,)
        self.values = tuple(values)

    def dtype(self, schema):
        return T.BOOLEAN

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if isinstance(v.dtype, T.StringType):
            if v.dictionary is None:
                raise AnalysisError("IN on string requires dictionary")
            mask = pc.is_in(v.dictionary,
                            value_set=pa.array(list(self.values))) \
                .to_numpy(zero_copy_only=False)
            table = torch.from_numpy(np.asarray(mask, dtype=np.bool_)) \
                .to(v.data.device)
            data = table[v.data.clamp(0, len(table) - 1).long()]
            return Vec(data, T.BOOLEAN, v.validity)
        acc = None
        for val in self.values:
            lit = cast_vec(Literal(val).eval_scalar(v.data.device), v.dtype)
            hit = v.data == lit.data
            acc = hit if acc is None else (acc | hit)
        return Vec(acc, T.BOOLEAN, v.validity)

    def __repr__(self):
        return f"({self.children[0]!r} IN {self.values!r})"


class Like(Expression):
    """LIKE with SQL wildcards, evaluated on the host dictionary then
    gathered by code — O(|dict|) host work regardless of row count."""

    def __init__(self, child: Expression, pattern: str):
        self.children = (child,)
        self.pattern = pattern

    def dtype(self, schema):
        return T.BOOLEAN

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if v.dictionary is None:
            raise AnalysisError(
                "LIKE requires a dictionary-encoded string column")
        table = _dictionary_table(
            v.dictionary, lambda d: pc.match_like(d, self.pattern), np.bool_,
            v.data.device)
        return Vec(_gather_by_code(table, v.data), T.BOOLEAN, v.validity)

    def __repr__(self):
        return f"({self.children[0]!r} LIKE {self.pattern!r})"


class Substring(Expression):
    """substring(col, start, len) on dictionary strings: rewrites the
    host dictionary, then dedupes it and remaps the device codes, since
    distinct old values can slice to one new value and group-by and join
    compare codes directly."""

    def __init__(self, child: Expression, start: int, length: int):
        self.children = (child,)
        self.start = start
        self.length = length

    def dtype(self, schema):
        return T.STRING

    def eval(self, batch):
        from .columnar import apply_code_remap, dedupe_dictionary
        v = self.children[0].eval(batch)
        if v.dictionary is None:
            raise AnalysisError(
                "substring requires dictionary-encoded strings")
        new_dict = pc.utf8_slice_codeunits(
            v.dictionary, start=self.start - 1,
            stop=self.start - 1 + self.length)
        remap, uniq = dedupe_dictionary(new_dict)
        return Vec(apply_code_remap(v.data, remap), T.STRING, v.validity,
                   uniq)

    def __repr__(self):
        return f"substring({self.children[0]!r},{self.start},{self.length})"


def _ones_like_valid(validity):
    return torch.ones((), dtype=torch.bool, device=validity.device)


class Coalesce(Expression):
    """First non-NULL argument (reference: nullExpressions.scala Coalesce)."""

    def __init__(self, *children: Expression):
        if not children:
            raise AnalysisError("coalesce requires at least one argument")
        self.children = tuple(children)

    def dtype(self, schema):
        out = self.children[0].dtype(schema)
        for c in self.children[1:]:
            out = T.common_type(out, c.dtype(schema))
        return out

    def nullable(self, schema):
        return all(c.nullable(schema) for c in self.children)

    def eval(self, batch):
        out_dtype = self.dtype(batch.schema())
        if isinstance(out_dtype, T.StringType):
            return self._eval_string(batch)
        acc = cast_vec(self.children[0].eval(batch), out_dtype)
        data, validity = acc.data, acc.validity
        for c in self.children[1:]:
            if validity is None:
                break
            v = cast_vec(c.eval(batch), out_dtype)
            vval = v.validity if v.validity is not None else \
                _ones_like_valid(validity)
            data = torch.where(validity, data, v.data)
            validity = validity | torch.broadcast_to(vval, validity.shape)
        return Vec(data, out_dtype, validity)

    def _eval_string(self, batch):
        from .columnar import unify_string_columns
        acc = self.children[0].eval(batch)
        data, validity, dictionary = acc.data, acc.validity, acc.dictionary
        for c in self.children[1:]:
            if validity is None:
                break
            v = c.eval(batch)
            if v.data is None and isinstance(c, Literal) \
                    and isinstance(c.value, str):
                # host-scalar string literal -> singleton dictionary
                v = Vec(torch.zeros(data.shape, dtype=torch.int32,
                                    device=data.device), T.STRING,
                        None, pa.array([c.value]))
            if dictionary is None or v.dictionary is None:
                raise AnalysisError(
                    "coalesce on strings requires dictionaries")
            data, v_data, dictionary = unify_string_columns(
                data, dictionary, v.data, v.dictionary)
            vval = v.validity if v.validity is not None else \
                _ones_like_valid(validity)
            data = torch.where(validity, data, v_data)
            validity = validity | torch.broadcast_to(vval, validity.shape)
        return Vec(data, T.STRING, validity, dictionary)

    def __repr__(self):
        return f"coalesce({', '.join(repr(c) for c in self.children)})"


class CaseWhen(Expression):
    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 otherwise: Optional[Expression] = None):
        self.branches = [(c, v) for c, v in branches]
        self.otherwise = otherwise
        flat: List[Expression] = []
        for c, v in self.branches:
            flat += [c, v]
        if otherwise is not None:
            flat.append(otherwise)
        self.children = tuple(flat)

    def map_children(self, f):
        # branches/otherwise are views over `children`; the base
        # copy-and-replace would leave them pointing at stale nodes
        # (eval reads self.branches, not self.children)
        new_kids = [f(c) for c in self.children]
        n = len(self.branches)
        branches = [(new_kids[2 * i], new_kids[2 * i + 1]) for i in range(n)]
        otherwise = new_kids[2 * n] if self.otherwise is not None else None
        return CaseWhen(branches, otherwise)

    def dtype(self, schema):
        dts = [v.dtype(schema) for _, v in self.branches]
        if self.otherwise is not None:
            dts.append(self.otherwise.dtype(schema))
        out = dts[0]
        for d in dts[1:]:
            out = T.common_type(out, d)
        return out

    @staticmethod
    def _true(cond: Expression, batch) -> Any:
        cv = cond.eval(batch)
        return cv.data if cv.validity is None else (cv.data & cv.validity)

    def _eval_string(self, batch):
        """CASE producing strings from LITERAL branches: the branch
        values become the dictionary and codes select by condition
        (string columns in branches would need dictionary unification —
        unsupported)."""
        def literal_value(v, what):
            if not (isinstance(v, Literal)
                    and (v.value is None or isinstance(v.value, str))):
                raise AnalysisError(
                    f"CASE with string results supports {what} only")
            return v.value

        vals = [literal_value(v, "literal branch values")
                for _c, v in self.branches]
        vals.append(None if self.otherwise is None else
                    literal_value(self.otherwise, "a literal ELSE"))
        dev = batch.device
        codes = torch.full((batch.capacity,), len(vals) - 1,
                           dtype=torch.int32, device=dev)
        for i, (cond, _v) in reversed(list(enumerate(self.branches))):
            codes = torch.where(self._true(cond, batch),
                                torch.tensor(i, dtype=torch.int32,
                                             device=dev), codes)
        dictionary = pa.array([v if v is not None else "" for v in vals],
                              type=pa.string())
        validity = None
        for nc in (i for i, v in enumerate(vals) if v is None):
            keep = codes != nc
            validity = keep if validity is None else (validity & keep)
        return Vec(codes, T.STRING, validity, dictionary)

    def eval(self, batch):
        out_dtype = self.dtype(batch.schema())
        if isinstance(out_dtype, T.StringType):
            return self._eval_string(batch)
        dev = batch.device
        if self.otherwise is not None:
            acc = cast_vec(self.otherwise.eval(batch), out_dtype)
            acc_data, acc_val = acc.data, acc.validity
        else:
            acc_data = torch.zeros((), dtype=T.torch_dtype(out_dtype.np_dtype),
                                   device=dev)
            acc_val = torch.zeros((), dtype=torch.bool, device=dev)
        for cond, val in reversed(self.branches):
            cond_true = self._true(cond, batch)
            vv = cast_vec(val.eval(batch), out_dtype)
            acc_data = torch.where(cond_true, vv.data, acc_data)
            if vv.validity is not None or acc_val is not None:
                one = torch.ones((), dtype=torch.bool, device=dev)
                vval = vv.validity if vv.validity is not None else one
                aval = acc_val if acc_val is not None else one
                acc_val = torch.where(cond_true, vval, aval)
        if acc_val is not None:
            acc_val = torch.broadcast_to(acc_val, acc_data.shape)
        return Vec(acc_data, out_dtype, acc_val)

    def __repr__(self):
        return f"CASE {self.branches!r} ELSE {self.otherwise!r}"
