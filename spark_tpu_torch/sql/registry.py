"""Function registry: one declarative table driving SQL function
resolution (the port of `spark_tpu/sql/registry.py`; reference:
`analysis/FunctionRegistry.scala` — expression builders keyed by name
with arity checking).

Each entry: NAME -> (builder, min_args, max_args). Builders receive
already-parsed Expression args. Only the entries whose expressions
exist in the port are registered; the JAX package's other scalar
functions (`expr_fns.py`, `expr_array.py`) are listed in
`NOT_YET_PORTED` and raise AnalysisError naming them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .. import types as T
from ..expr import (AnalysisError, Coalesce, ConcatLit, DateAdd, Expression,
                    ExtractDay, ExtractMonth, ExtractYear, IsNull,
                    Literal, Lower, Neg, Not, Pmod, StringLength, Trim, Upper)
from ..expr_fns import Abs

#: NAME -> (builder(args) -> Expression, min_args, max_args)
REGISTRY: Dict[str, Tuple[Callable, int, int]] = {}

#: functions the JAX package's registry resolves that the port has no
#: expression for yet (its `expr_fns.py` and `expr_array.py`)
NOT_YET_PORTED = frozenset("""
    SQRT CBRT EXP EXPM1 LN LOG10 LOG2 LOG1P LOG POW POWER SIN COS TAN
    COT ASIN ACOS ATAN ATAN2 SINH COSH TANH HYPOT DEGREES RADIANS RINT SIGN
    SIGNUM CEIL CEILING FLOOR ROUND FACTORIAL SHIFTLEFT SHIFTRIGHT BIT_COUNT
    GREATEST LEAST NVL IFNULL NVL2 NULLIF IF ISNAN NANVL QUARTER DAYOFWEEK
    WEEKDAY DAYOFYEAR WEEKOFYEAR LAST_DAY NEXT_DAY ADD_MONTHS MONTHS_BETWEEN
    DATEDIFF TRUNC MAKE_DATE LTRIM RTRIM REVERSE INITCAP LPAD RPAD REPLACE
    TRANSLATE REPEAT INSTR LOCATE ASCII RLIKE REGEXP_LIKE REGEXP_REPLACE
    REGEXP_EXTRACT CONTAINS STARTSWITH ENDSWITH ARRAY SIZE CARDINALITY
    ARRAY_CONTAINS ELEMENT_AT EXPLODE EXPLODE_OUTER
""".split())


def register(name: str, builder: Callable, lo: int, hi: int) -> None:
    REGISTRY[name.upper()] = (builder, lo, hi)


def lookup(name: str, args: List[Expression]) -> Optional[Expression]:
    """Build the expression for `name(args)`, or None when unknown.
    Raises AnalysisError on arity mismatch for a known function, and for
    a function the JAX package has but the port does not yet."""
    entry = REGISTRY.get(name.upper())
    if entry is None:
        if name.upper() in NOT_YET_PORTED:
            raise AnalysisError(
                f"function {name.lower()}() is not yet ported to "
                f"spark_tpu_torch")
        return None
    builder, lo, hi = entry
    if not (lo <= len(args) <= hi):
        want = str(lo) if lo == hi else f"{lo}..{hi}"
        raise AnalysisError(
            f"{name} expects {want} arguments, got {len(args)}")
    return builder(args)


def _u(cls):
    return lambda a: cls(a[0])


def _b(cls):
    return lambda a: cls(a[0], a[1])


# -- math -------------------------------------------------------------------
register("ABS", _u(Abs), 1, 1)
register("PMOD", _b(Pmod), 2, 2)
register("MOD", lambda a: a[0] % a[1], 2, 2)

# -- null / conditional -----------------------------------------------------
register("COALESCE", lambda a: Coalesce(*a), 1, 64)
register("ISNULL", lambda a: IsNull(a[0]), 1, 1)
register("ISNOTNULL", lambda a: Not(IsNull(a[0])), 1, 1)

# -- datetime ---------------------------------------------------------------
register("YEAR", _u(ExtractYear), 1, 1)
register("MONTH", _u(ExtractMonth), 1, 1)
register("DAY", _u(ExtractDay), 1, 1)
register("DAYOFMONTH", _u(ExtractDay), 1, 1)
register("DATE_ADD", _b(DateAdd), 2, 2)
register("DATE_SUB", lambda a: DateAdd(a[0], Neg(a[1])), 2, 2)

# -- strings ----------------------------------------------------------------
register("UPPER", _u(Upper), 1, 1)
register("UCASE", _u(Upper), 1, 1)
register("LOWER", _u(Lower), 1, 1)
register("LCASE", _u(Lower), 1, 1)
register("TRIM", _u(Trim), 1, 1)
register("LENGTH", _u(StringLength), 1, 1)
register("CHAR_LENGTH", _u(StringLength), 1, 1)


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
