"""User-facing expression constructors (the reference's `functions.scala`;
the subset of `spark_tpu/functions.py` the port supports so far). The
window functions return `WindowExpr`s to finish with `.over(spec)`
(`window.Window` builds specs)."""

from __future__ import annotations

from typing import Optional

from . import types as T
from .expr import ColumnRef, Expression, Literal, date_literal
from .expr_agg import Avg, Count, Max, Min, Sum


def col(name: str) -> ColumnRef:
    return ColumnRef(name)


def lit(value, dtype: Optional[T.DataType] = None) -> Literal:
    return Literal(value, dtype)


def to_date(s: str) -> Literal:
    """A DATE literal from 'YYYY-MM-DD'."""
    return date_literal(s)


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


def abs(e) -> Expression:  # noqa: A001
    from .expr_fns import Abs
    return Abs(_expr(e))


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
