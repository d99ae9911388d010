"""Function registry: one declarative table driving SQL function
resolution (the port of `spark_tpu/sql/registry.py`; reference:
`analysis/FunctionRegistry.scala` — expression builders keyed by name
with arity checking).

Each entry: NAME -> (builder, min_args, max_args). Builders receive
already-parsed Expression args; entries whose parameters must be
literals (regexp patterns, pad strings, trunc formats) unwrap them and
raise AnalysisError otherwise. Every name of the JAX package's
registry is here, the array functions (`expr_array.py`) included.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .. import expr_fns as X
from .. import types as T
from ..expr import (AnalysisError, Coalesce, ConcatLit, DateAdd, Expression,
                    ExtractDay, ExtractMonth, ExtractYear, IsNull,
                    Literal, Lower, Neg, Not, Pmod, StringLength, Trim, Upper)

#: NAME -> (builder(args) -> Expression, min_args, max_args)
REGISTRY: Dict[str, Tuple[Callable, int, int]] = {}


def register(name: str, builder: Callable, lo: int, hi: int) -> None:
    REGISTRY[name.upper()] = (builder, lo, hi)


def lookup(name: str, args: List[Expression]) -> Optional[Expression]:
    """Build the expression for `name(args)`, or None when unknown.
    Raises AnalysisError on arity mismatch for a known function."""
    entry = REGISTRY.get(name.upper())
    if entry is None:
        return None
    builder, lo, hi = entry
    if not (lo <= len(args) <= hi):
        want = str(lo) if lo == hi else f"{lo}..{hi}"
        raise AnalysisError(
            f"{name} expects {want} arguments, got {len(args)}")
    return builder(args)


def _lit_str(e: Expression, fn: str) -> str:
    if isinstance(e, Literal) and isinstance(e.value, str):
        return e.value
    raise AnalysisError(f"{fn} requires a string literal argument")


def _lit_int(e: Expression, fn: str) -> int:
    if isinstance(e, Literal) and isinstance(e.value, int):
        return int(e.value)
    raise AnalysisError(f"{fn} requires an integer literal argument")


def _u(cls):
    return lambda a: cls(a[0])


def _b(cls):
    return lambda a: cls(a[0], a[1])


# -- math -------------------------------------------------------------------
register("ABS", _u(X.Abs), 1, 1)
register("SQRT", _u(X.Sqrt), 1, 1)
register("CBRT", _u(X.Cbrt), 1, 1)
register("EXP", _u(X.Exp), 1, 1)
register("EXPM1", _u(X.Expm1), 1, 1)
register("LN", _u(X.Ln), 1, 1)
register("LOG10", _u(X.Log10), 1, 1)
register("LOG2", _u(X.Log2), 1, 1)
register("LOG1P", _u(X.Log1p), 1, 1)
register("LOG", lambda a: X.Ln(a[0]) if len(a) == 1
         else X.Logarithm(a[0], a[1]), 1, 2)
register("POW", _b(X.Pow), 2, 2)
register("POWER", _b(X.Pow), 2, 2)
register("SIN", _u(X.Sin), 1, 1)
register("COS", _u(X.Cos), 1, 1)
register("TAN", _u(X.Tan), 1, 1)
register("COT", _u(X.Cot), 1, 1)
register("ASIN", _u(X.Asin), 1, 1)
register("ACOS", _u(X.Acos), 1, 1)
register("ATAN", _u(X.Atan), 1, 1)
register("ATAN2", _b(X.Atan2), 2, 2)
register("SINH", _u(X.Sinh), 1, 1)
register("COSH", _u(X.Cosh), 1, 1)
register("TANH", _u(X.Tanh), 1, 1)
register("HYPOT", _b(X.Hypot), 2, 2)
register("DEGREES", _u(X.Degrees), 1, 1)
register("RADIANS", _u(X.Radians), 1, 1)
register("RINT", _u(X.Rint), 1, 1)
register("SIGN", _u(X.Signum), 1, 1)
register("SIGNUM", _u(X.Signum), 1, 1)
register("CEIL", _u(X.Ceil), 1, 1)
register("CEILING", _u(X.Ceil), 1, 1)
register("FLOOR", _u(X.Floor), 1, 1)
register("ROUND", lambda a: X.Round(
    a[0], _lit_int(a[1], "ROUND") if len(a) == 2 else 0), 1, 2)
register("FACTORIAL", _u(X.Factorial), 1, 1)
register("PMOD", _b(Pmod), 2, 2)
register("MOD", lambda a: a[0] % a[1], 2, 2)
register("SHIFTLEFT", _b(X.ShiftLeft), 2, 2)
register("SHIFTRIGHT", _b(X.ShiftRight), 2, 2)
register("BIT_COUNT", _u(X.BitCount), 1, 1)
register("GREATEST", lambda a: X.Greatest(*a), 2, 64)
register("LEAST", lambda a: X.Least(*a), 2, 64)

# -- null / conditional -----------------------------------------------------
register("COALESCE", lambda a: Coalesce(*a), 1, 64)
register("NVL", lambda a: X.Nvl(a[0], a[1]), 2, 2)
register("IFNULL", lambda a: X.Nvl(a[0], a[1]), 2, 2)
register("NVL2", lambda a: X.Nvl2(a[0], a[1], a[2]), 3, 3)
register("NULLIF", _b(X.NullIf), 2, 2)
register("IF", lambda a: X.If(a[0], a[1], a[2]), 3, 3)
register("ISNULL", lambda a: IsNull(a[0]), 1, 1)
register("ISNOTNULL", lambda a: Not(IsNull(a[0])), 1, 1)
register("ISNAN", _u(X.IsNan), 1, 1)
register("NANVL", lambda a: X.Nanvl(a[0], a[1]), 2, 2)

# -- datetime ---------------------------------------------------------------
register("YEAR", _u(ExtractYear), 1, 1)
register("MONTH", _u(ExtractMonth), 1, 1)
register("DAY", _u(ExtractDay), 1, 1)
register("DAYOFMONTH", _u(ExtractDay), 1, 1)
register("QUARTER", _u(X.Quarter), 1, 1)
register("DAYOFWEEK", _u(X.DayOfWeek), 1, 1)
register("WEEKDAY", _u(X.WeekDay), 1, 1)
register("DAYOFYEAR", _u(X.DayOfYear), 1, 1)
register("WEEKOFYEAR", _u(X.WeekOfYear), 1, 1)
register("LAST_DAY", _u(X.LastDay), 1, 1)
register("NEXT_DAY", lambda a: X.NextDay(
    a[0], _lit_str(a[1], "NEXT_DAY")), 2, 2)
register("ADD_MONTHS", _b(X.AddMonths), 2, 2)
register("MONTHS_BETWEEN", _b(X.MonthsBetween), 2, 2)
register("DATEDIFF", _b(X.DateDiff), 2, 2)
register("DATE_ADD", _b(DateAdd), 2, 2)
register("DATE_SUB", lambda a: DateAdd(a[0], Neg(a[1])), 2, 2)
register("TRUNC", lambda a: X.TruncDate(
    a[0], _lit_str(a[1], "TRUNC")), 2, 2)
register("MAKE_DATE", lambda a: X.MakeDate(a[0], a[1], a[2]), 3, 3)

# -- strings ----------------------------------------------------------------
register("UPPER", _u(Upper), 1, 1)
register("UCASE", _u(Upper), 1, 1)
register("LOWER", _u(Lower), 1, 1)
register("LCASE", _u(Lower), 1, 1)
register("TRIM", _u(Trim), 1, 1)
register("LTRIM", _u(X.Ltrim), 1, 1)
register("RTRIM", _u(X.Rtrim), 1, 1)
register("LENGTH", _u(StringLength), 1, 1)
register("CHAR_LENGTH", _u(StringLength), 1, 1)
register("REVERSE", _u(X.Reverse), 1, 1)
register("INITCAP", _u(X.InitCap), 1, 1)
register("LPAD", lambda a: X.Lpad(
    a[0], _lit_int(a[1], "LPAD"),
    _lit_str(a[2], "LPAD") if len(a) == 3 else " "), 2, 3)
register("RPAD", lambda a: X.Rpad(
    a[0], _lit_int(a[1], "RPAD"),
    _lit_str(a[2], "RPAD") if len(a) == 3 else " "), 2, 3)
register("REPLACE", lambda a: X.StringReplace(
    a[0], _lit_str(a[1], "REPLACE"),
    _lit_str(a[2], "REPLACE") if len(a) == 3 else ""), 2, 3)
register("TRANSLATE", lambda a: X.Translate(
    a[0], _lit_str(a[1], "TRANSLATE"), _lit_str(a[2], "TRANSLATE")), 3, 3)
register("REPEAT", lambda a: X.Repeat(
    a[0], _lit_int(a[1], "REPEAT")), 2, 2)
register("INSTR", lambda a: X.Instr(
    a[0], _lit_str(a[1], "INSTR")), 2, 2)
register("LOCATE", lambda a: X.Instr(
    a[1], _lit_str(a[0], "LOCATE")), 2, 2)
register("ASCII", _u(X.Ascii), 1, 1)
register("RLIKE", lambda a: X.RLike(
    a[0], _lit_str(a[1], "RLIKE")), 2, 2)
register("REGEXP_LIKE", lambda a: X.RLike(
    a[0], _lit_str(a[1], "REGEXP_LIKE")), 2, 2)
register("REGEXP_REPLACE", lambda a: X.RegexpReplace(
    a[0], _lit_str(a[1], "REGEXP_REPLACE"),
    _lit_str(a[2], "REGEXP_REPLACE")), 3, 3)
register("REGEXP_EXTRACT", lambda a: X.RegexpExtract(
    a[0], _lit_str(a[1], "REGEXP_EXTRACT"),
    _lit_int(a[2], "REGEXP_EXTRACT") if len(a) == 3 else 1), 2, 3)
register("CONTAINS", lambda a: X.Contains(
    a[0], _lit_str(a[1], "CONTAINS")), 2, 2)
register("STARTSWITH", lambda a: X.StartsWith(
    a[0], _lit_str(a[1], "STARTSWITH")), 2, 2)
register("ENDSWITH", lambda a: X.EndsWith(
    a[0], _lit_str(a[1], "ENDSWITH")), 2, 2)


def _concat(args: List[Expression]) -> Expression:
    if any(isinstance(p, Literal) and p.value is None for p in args):
        # reference semantics: concat is NULL if ANY argument is NULL
        return Literal(None, T.STRING)
    non_lit = [i for i, p in enumerate(args) if not isinstance(p, Literal)]
    if len(non_lit) != 1:
        raise AnalysisError(
            "CONCAT supports exactly one non-literal string argument "
            "(general column-column concat needs a product dictionary)")
    i = non_lit[0]
    prefix = "".join(str(p.value) for p in args[:i])
    suffix = "".join(str(p.value) for p in args[i + 1:])
    return ConcatLit(args[i], prefix, suffix)


register("CONCAT", _concat, 1, 64)


# -- arrays (collectionOperations.scala) ------------------------------------

from .. import expr_array as _arr  # noqa: E402

register("ARRAY", lambda a: _arr.MakeArray(*a), 1, 64)
register("SIZE", lambda a: _arr.Size(a[0]), 1, 1)
register("CARDINALITY", lambda a: _arr.Size(a[0]), 1, 1)
register("ARRAY_CONTAINS", lambda a: _arr.ArrayContains(a[0], a[1]), 2, 2)
register("ELEMENT_AT", lambda a: _arr.ElementAt(a[0], a[1]), 2, 2)
register("EXPLODE", lambda a: _arr.Explode(a[0]), 1, 1)
register("EXPLODE_OUTER", lambda a: _arr.Explode(a[0], outer=True), 1, 1)
