"""Expression-library breadth (the port of `spark_tpu/expr_fns.py`;
reference: `expressions/mathExpressions.scala` and its siblings).

Only `abs` is ported so far; the JAX package's other math, datetime,
string and conditional functions are listed in `sql/registry.py`'s
`NOT_YET_PORTED` and raise AnalysisError naming them.
"""

from __future__ import annotations

from .expr import Expression, Vec, _wrap


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
