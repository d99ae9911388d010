"""Array (complex-type) expressions: array(), size, array_contains,
element_at, explode (the port of `spark_tpu/expr_array.py`).

Reference: `sql/catalyst/.../expressions/collectionOperations.scala` +
`complexTypeCreator.scala`, over the offsets-encoded device layout
(`columnar.Column`: flattened elements + int32 offsets — the Arrow List
layout instead of `UnsafeArrayData.java:1`). Every operation is a
whole-column pass; per-row element slices resolve through offsets
arithmetic and segment gathers, never per-row loops.
"""

from __future__ import annotations

import torch

from . import types as T
from .expr import (AnalysisError, Expression, Literal, Vec, _and_valid,
                   _wrap, cast_vec)


def _value_segments(offsets, n_values: int):
    """For each flattened value slot, the row owning it (the row count
    for the dead tail past the last offset)."""
    iota = torch.arange(n_values, dtype=torch.int32, device=offsets.device)
    return torch.searchsorted(offsets, iota, right=True) - 1


def _segment_any(flags, seg, rows: int):
    """Per row: whether any of its value slots' `flags` is set (`seg`
    from `_value_segments`; the dead tail lands in a dropped slot)."""
    hits = torch.zeros((rows + 1,), dtype=torch.int32, device=flags.device)
    hits.index_add_(0, seg.clamp(0, rows), flags.to(torch.int32))
    return hits[:rows] > 0


def _full(t, cap: int):
    return t.expand((cap,)) if t.dim() == 0 else t


class MakeArray(Expression):
    """array(e1, e2, ...): each row's array is the N evaluated scalars
    (complexTypeCreator.scala CreateArray)."""

    def __init__(self, *children):
        if not children:
            raise AnalysisError("array() needs at least one element")
        self.children = tuple(_wrap(c) for c in children)

    def dtype(self, schema):
        dts = [c.dtype(schema) for c in self.children]
        out = dts[0]
        for dt in dts[1:]:
            out = T.common_type(out, dt)
        return T.ArrayType(out)

    def nullable(self, schema):
        return False

    def eval(self, batch):
        out_t = self.dtype(batch.schema())
        elem_t = out_t.element
        vs = [cast_vec(c.eval(batch), elem_t) for c in self.children]
        if any(v.dictionary is not None for v in vs):
            raise AnalysisError(
                "array() over string columns is not supported (per-"
                "column dictionaries have no shared encoding)")
        cap = batch.capacity
        device = batch.device
        n = len(vs)
        data = torch.stack([_full(v.data, cap) for v in vs], 1).reshape(-1)
        if all(v.validity is None for v in vs):
            ev = None
        else:
            ones = torch.ones((cap,), dtype=torch.bool, device=device)
            ev = torch.stack([ones if v.validity is None
                              else _full(v.validity, cap) for v in vs],
                             1).reshape(-1)
        offsets = torch.arange(cap + 1, dtype=torch.int32,
                               device=device) * n
        return Vec(data, out_t, None, None, offsets=offsets,
                   elem_validity=ev)

    def name(self):
        return f"array({', '.join(c.name() for c in self.children)})"

    def __repr__(self):
        return f"array({', '.join(map(repr, self.children))})"


class Size(Expression):
    """size(arr): element count per row; NULL input -> -1 (the
    reference's legacy sizeOfNull=true default)."""

    def __init__(self, child):
        self.children = (_wrap(child),)

    def dtype(self, schema):
        return T.INT

    def nullable(self, schema):
        return False

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if v.offsets is None:
            raise AnalysisError(f"size() needs an array, got {v.dtype!r}")
        sizes = (v.offsets[1:] - v.offsets[:-1]).to(torch.int32)
        if v.validity is not None:
            sizes = torch.where(v.validity, sizes,
                                torch.full_like(sizes, -1))
        return Vec(sizes, T.INT, None)

    def __repr__(self):
        return f"size({self.children[0]!r})"


class ArrayContains(Expression):
    """array_contains(arr, value): NULL row -> NULL; a missing match with
    NULL elements present gives NULL (the reference's three-valued
    ArrayContains)."""

    def __init__(self, child, value):
        self.children = (_wrap(child), _wrap(value))

    def dtype(self, schema):
        return T.BOOLEAN

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if v.offsets is None:
            raise AnalysisError("array_contains() needs an array")
        lit = self.children[1]
        if not isinstance(lit, Literal):
            raise AnalysisError(
                "array_contains() requires a literal search value")
        elem_t = v.dtype.element
        if isinstance(elem_t, T.StringType):
            if v.dictionary is None:
                raise AnalysisError("string array without dictionary")
            import pyarrow.compute as pc
            idx = pc.index_in(lit.value, value_set=v.dictionary).as_py()
            needle = -1 if idx is None else idx
        else:
            needle = lit.value
        cap = batch.capacity
        seg = _value_segments(v.offsets, v.data.shape[0])
        hit = v.data == torch.tensor(needle, dtype=v.data.dtype,
                                     device=v.data.device)
        has_null_elem = torch.zeros((cap,), dtype=torch.bool,
                                    device=v.data.device)
        if v.elem_validity is not None:
            hit = hit & v.elem_validity
            has_null_elem = _segment_any(~v.elem_validity, seg, cap)
        found = _segment_any(hit, seg, cap)
        validity = ~(~found & has_null_elem)
        return Vec(found, T.BOOLEAN, _and_valid(v.validity, validity))

    def __repr__(self):
        return (f"array_contains({self.children[0]!r}, "
                f"{self.children[1]!r})")


class ElementAt(Expression):
    """element_at(arr, i): 1-based; negative indexes count from the end;
    out of bounds -> NULL (the reference's non-ANSI behaviour)."""

    def __init__(self, child, index):
        self.children = (_wrap(child), _wrap(index))

    def dtype(self, schema):
        dt = self.children[0].dtype(schema)
        if not isinstance(dt, T.ArrayType):
            raise AnalysisError("element_at() needs an array")
        return dt.element

    def eval(self, batch):
        v = self.children[0].eval(batch)
        if v.offsets is None:
            raise AnalysisError("element_at() needs an array")
        iv = cast_vec(self.children[1].eval(batch), T.INT)
        idx = _full(iv.data, batch.capacity).to(torch.int64)
        offsets = v.offsets.to(torch.int64)
        starts = offsets[:-1]
        lens = offsets[1:] - starts
        pos = torch.where(idx > 0, idx - 1, lens + idx)  # 1-based / from end
        ok = (pos >= 0) & (pos < lens) & (idx != 0)
        slot = (starts + pos).clamp(0, max(v.data.shape[0] - 1, 0))
        data = v.data[slot]
        validity = ok
        if v.elem_validity is not None:
            validity = validity & v.elem_validity[slot]
        validity = _and_valid(v.validity, validity)
        if iv.validity is not None:
            validity = validity & _full(iv.validity, batch.capacity)
        return Vec(data, self.dtype(batch.schema()), validity,
                   v.dictionary)

    def __repr__(self):
        return f"element_at({self.children[0]!r}, {self.children[1]!r})"


class Explode(Expression):
    """Marker: one output row per array element. Never evaluates as a
    column expression — the select paths extract it into a Generate
    plan node (reference: GenerateExec.scala:1 / ExtractGenerator)."""

    def __init__(self, child, outer: bool = False):
        self.children = (_wrap(child),)
        self.outer = outer

    def dtype(self, schema):
        dt = self.children[0].dtype(schema)
        if not isinstance(dt, T.ArrayType):
            raise AnalysisError(f"explode() needs an array, got {dt!r}")
        return dt.element

    def eval(self, batch):
        raise AnalysisError(
            "explode() must be planned through a Generate node (use it "
            "at the top level of a select list)")

    def name(self):
        return "col"  # the reference's default generator output name

    def __repr__(self):
        return f"explode({self.children[0]!r})"


def contains_explode(e: Expression) -> bool:
    if isinstance(e, Explode):
        return True
    return any(contains_explode(c) for c in e.children)


def extract_generators(plan, exprs):
    """Pull explode() out of a projection into a Generate plan node
    (the reference's ExtractGenerator analyzer rule): at most one
    generator per select list, only at top level / under an alias."""
    from .expr import Alias, ColumnRef
    from .plan import logical as L
    if not any(contains_explode(e) for e in exprs):
        return plan, list(exprs)
    gens = []
    out = []
    taken = set(plan.schema().names)
    for e in exprs:
        base, want = (e.child, e.name()) if isinstance(e, Alias) else \
            (e, None)
        if isinstance(base, Explode):
            name = want or "col"
            if name in taken:
                raise AnalysisError(
                    f"generator output name {name!r} collides")
            gens.append((base, name))
            out.append(ColumnRef(name))
            continue
        if contains_explode(e):
            raise AnalysisError(
                "explode() is only supported at the top level of a "
                "select list (optionally aliased)")
        out.append(e)
    if len(gens) != 1:
        raise AnalysisError(
            "only one explode() per select list is supported")
    gen, name = gens[0]
    plan = L.Generate(plan, gen.children[0], name, outer=gen.outer)
    return plan, out
