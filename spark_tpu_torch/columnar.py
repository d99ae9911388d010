"""Columnar batch substrate: the device-side data representation.

The port of `spark_tpu/columnar.py` to torch tensors (reference:
UnsafeRow `UnsafeRow.java:62`, `ColumnarBatch.java:30`):

- a :class:`Column` is one flat ``torch.Tensor`` of a fixed device dtype
  plus an optional boolean validity tensor (NULL mask) and, for strings,
  a host-side pyarrow dictionary (values live on host; codes on device);
- a :class:`Batch` is an ordered dict of Columns sharing a *capacity*
  (padded row count) and a *selection* mask marking live rows. Filters
  update the selection instead of compacting;
- capacities are rounded up to buckets (`bucket_capacity`), the same
  contract as the JAX package, so operator outputs compare one to one
  before compaction.

Every tensor of a batch lives on one device. Entry points pick it with
`resolve_device`: CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import torch

from . import types as T


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA card. Raises when no device is given and CUDA is absent
    — the engine never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the engine on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def bucket_capacity(n: int, growth: float = 2.0, floor: int = 8) -> int:
    """Round n up to the padding bucket (power-of-growth)."""
    if n <= floor:
        return floor
    k = math.ceil(math.log(n / floor, growth))
    return int(floor * growth ** k)


class Column:
    """One device column: data + optional validity + optional host dictionary.

    `bits` is an optional static value bound: values in [0, 2^bits).

    `prov` is the provenance of a column a join gathered:
    ``(base_data, base_validity, idx, present)``, the column being
    ``base_data[idx]`` with validity ``base_validity[idx] & present``. Such
    a column is lazy: its data and validity are gathered on first use, and
    a later join composes its indices through `prov` instead
    (`execution/join.py gather_columns`). So a chain of joins gathers each
    payload column once from its base, and a column no operator reads is
    never gathered."""

    __slots__ = ("_data", "_validity", "dtype", "dictionary", "bits", "prov")

    def __init__(self, data, dtype: T.DataType, validity=None,
                 dictionary: Optional[pa.Array] = None,
                 bits: Optional[int] = None, prov=None):
        self._data = data
        self.dtype = dtype
        self._validity = validity  # None means all-valid
        self.dictionary = dictionary  # host pyarrow array for StringType
        self.bits = bits
        self.prov = prov

    @classmethod
    def gathered(cls, base_data, base_validity, idx, present,
                 dtype: T.DataType, dictionary=None) -> "Column":
        """The lazy column ``base[idx]``, NULL where `present` is False."""
        return cls(None, dtype, _LAZY, dictionary,
                   prov=(base_data, base_validity, idx, present))

    @property
    def data(self):
        if self._data is None and self.prov is not None:
            self._data = self.prov[0][self.prov[2]]
        return self._data

    @property
    def validity(self):
        if self._validity is _LAZY:
            base_valid, idx, present = self.prov[1:]
            self._validity = present if base_valid is None else \
                (base_valid[idx] & present)
        return self._validity

    @property
    def capacity(self) -> int:
        if self._data is None and self.prov is not None:
            return self.prov[2].shape[0]
        return self._data.shape[0]

    def __repr__(self) -> str:
        return (f"Column({self.dtype!r}, cap={self.capacity}, "
                f"nullable={self.validity is not None}, "
                f"dict={len(self.dictionary) if self.dictionary is not None else None})")


#: marks a gathered column's validity as not computed yet
_LAZY = object()


class Batch:
    """An ordered set of equal-capacity Columns plus a row-selection mask.

    ``selection`` is a bool[capacity] tensor; None means all `capacity`
    rows are live. ``device`` is where the batch's tensors live; a batch
    without columns (constant folding) states it or defaults to the CPU.
    """

    __slots__ = ("columns", "selection", "_device")

    def __init__(self, columns: Dict[str, Column], selection=None,
                 device=None):
        self.columns = dict(columns)
        self.selection = selection
        self._device = None if device is None else torch.device(device)

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_arrow(table: pa.Table, device, growth: float = 2.0,
                   capacity: Optional[int] = None) -> "Batch":
        """Ingest a pyarrow table: dictionary-encode strings, pad to bucket,
        copy to `device`."""
        device = torch.device(device)
        n = table.num_rows
        cap = capacity if capacity is not None else bucket_capacity(n, growth)
        if cap < n:
            raise ValueError(f"capacity {cap} < rows {n}")
        cols: Dict[str, Column] = {}
        for name, col in zip(table.column_names, table.columns):
            cols[name] = _arrow_to_column(name, col, n, cap, device)
        sel = torch.arange(cap, device=device) < n
        return Batch(cols, sel, device)

    # -- shape/meta ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        for c in self.columns.values():
            return c.capacity
        return 0

    @property
    def device(self) -> torch.device:
        if self._device is not None:
            return self._device
        for c in self.columns.values():
            return c.data.device
        if self.selection is not None:
            return self.selection.device
        return torch.device("cpu")

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def column(self, name: str) -> Column:
        return self.columns[name]

    def num_rows(self):
        """Count of live rows (a 0-d device tensor)."""
        if self.selection is None:
            return torch.tensor(self.capacity, dtype=torch.int32,
                                device=self.device)
        return self.selection.sum().to(torch.int32)

    def schema(self) -> T.Schema:
        return T.Schema([T.Field(n, c.dtype, c.validity is not None)
                         for n, c in self.columns.items()])

    def selection_mask(self):
        if self.selection is None:
            return torch.ones((self.capacity,), dtype=torch.bool,
                              device=self.device)
        return self.selection

    # -- transforms ---------------------------------------------------------

    def with_selection(self, sel) -> "Batch":
        return Batch(self.columns, sel, self._device)

    def select(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.selection,
                     self._device)

    # -- egress -------------------------------------------------------------

    def to_arrow(self) -> pa.Table:
        """Compact (drop unselected rows), decode dictionaries, return
        host table."""
        sel = None if self.selection is None else \
            self.selection.cpu().numpy()
        arrays = []
        names = []
        for name, col in self.columns.items():
            data = col.data.cpu().numpy()
            valid = None if col.validity is None else \
                col.validity.cpu().numpy()
            if sel is not None:
                data = data[sel]
                if valid is not None:
                    valid = valid[sel]
            arrays.append(_column_to_arrow(col, data, valid))
            names.append(name)
        return pa.table(arrays, names=names)

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def __repr__(self) -> str:
        return f"Batch(cap={self.capacity}, cols={self.columns!r})"


# ---------------------------------------------------------------------------
# Dictionary algebra (host-side)
#
# String columns carry host pyarrow dictionaries; device data is int32
# codes. Any transform that slices or combines dictionaries must keep the
# invariant "equal strings <=> equal codes *within one dictionary*", and
# any operator combining two columns must first remap both onto one shared
# dictionary. These helpers do that once on host; the remap tables are
# returned as CPU int32 tensors (`apply_code_remap` moves them next to
# the codes).
# ---------------------------------------------------------------------------


def dedupe_dictionary(dictionary: pa.Array):
    """Collapse duplicate values in a dictionary.

    Returns (remap, deduped) where `remap` is an int32 tensor mapping old
    code -> new code, or None when the dictionary was already unique."""
    import pyarrow.compute as pc
    arr = dictionary.combine_chunks() if isinstance(
        dictionary, pa.ChunkedArray) else dictionary
    uniq = pc.unique(arr)
    if len(uniq) == len(arr):
        return None, arr
    remap = pc.index_in(arr, value_set=uniq).cast(pa.int32())
    # a writable copy: Arrow's buffer is read-only
    return torch.from_numpy(remap.to_numpy(zero_copy_only=False).copy()), \
        uniq


def unify_dictionaries(da: pa.Array, db: pa.Array):
    """Merge two (internally unique) dictionaries into one shared one.

    Returns (remap_b, merged): `merged` extends `da` with values of `db`
    not already present (so codes into `da` stay valid), and `remap_b`
    maps b-codes -> merged codes (None when the dictionaries are
    identical)."""
    import pyarrow.compute as pc
    da = da.combine_chunks() if isinstance(da, pa.ChunkedArray) else da
    db = db.combine_chunks() if isinstance(db, pa.ChunkedArray) else db
    if da.equals(db):
        return None, da
    present = pc.index_in(db, value_set=da)
    new_mask = pc.is_null(present)
    if pc.any(new_mask).as_py():
        new_vals = pc.filter(db, new_mask)
        merged = pa.concat_arrays([da.cast(pa.string()),
                                   new_vals.cast(pa.string())])
    else:
        merged = da
    remap = pc.index_in(db, value_set=merged).cast(pa.int32())
    # a writable copy: Arrow's buffer is read-only
    return torch.from_numpy(remap.to_numpy(zero_copy_only=False).copy()), \
        merged


def apply_code_remap(codes, remap):
    """Gather new codes through a remap table (identity when remap is None)."""
    if remap is None:
        return codes
    if remap.shape[0] == 0:
        # all-null column: the dictionary (and thus the remap) is empty,
        # no code is valid and validity masks every row
        return torch.zeros_like(codes)
    remap = remap.to(codes.device)
    return remap[codes.clamp(0, remap.shape[0] - 1).long()]


def unify_string_columns(l_data, l_dict: pa.Array, r_data, r_dict: pa.Array):
    """Re-encode two string code columns onto one shared dictionary.
    Returns (l_data, r_data, merged)."""
    lmap, ld = dedupe_dictionary(l_dict)
    rmap, rd = dedupe_dictionary(r_dict)
    l_data = apply_code_remap(l_data, lmap)
    r_data = apply_code_remap(r_data, rmap)
    bmap, merged = unify_dictionaries(ld, rd)
    r_data = apply_code_remap(r_data, bmap)
    return l_data, r_data, merged


# ---------------------------------------------------------------------------
# Arrow conversion helpers
# ---------------------------------------------------------------------------

_ARROW_TO_DTYPE = {
    pa.bool_(): T.BOOLEAN,
    pa.int8(): T.BYTE,
    pa.int16(): T.SHORT,
    pa.int32(): T.INT,
    pa.int64(): T.LONG,
    pa.float32(): T.FLOAT,
    pa.float64(): T.DOUBLE,
    pa.date32(): T.DATE,
    pa.timestamp("us"): T.TIMESTAMP,
}


def _to_device(np_arr: np.ndarray, device: torch.device):
    t = torch.from_numpy(np.ascontiguousarray(np_arr))
    return t if device.type == "cpu" else t.to(device, non_blocking=False)


def _arrow_to_column(name: str, col, n: int, cap: int,
                     device: torch.device) -> Column:
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    at = arr.type
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        raise TypeError(f"array column {name} is not supported by this "
                        f"engine yet")
    dictionary = None
    if pa.types.is_null(at):
        # an empty/all-None object column infers arrow `null`: treat it
        # as an all-NULL string column
        arr = arr.cast(pa.string())
        at = arr.type
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        arr = arr.dictionary_encode()
        at = arr.type
    if pa.types.is_dictionary(at):
        dictionary = arr.dictionary
        codes = arr.indices.cast(pa.int32())
        np_data = codes.to_numpy(zero_copy_only=False)
        dt: T.DataType = T.STRING
    elif pa.types.is_decimal(at):
        dt = T.DecimalType(at.precision, at.scale)
        # exact unscaled int64: the low 64-bit limb of the 128-bit
        # little-endian decimal buffer (two's complement reinterpret is
        # exact for values in int64 range, which the representation
        # requires)
        if arr.type.bit_width != 128:
            arr = arr.cast(pa.decimal128(38, at.scale))
        buf = arr.buffers()[1]
        raw = np.frombuffer(buf, dtype=np.int64,
                            count=2 * (arr.offset + len(arr)))
        lo = raw[2 * arr.offset::2]
        if at.precision > 18:
            hi = raw[2 * arr.offset + 1::2]
            mism = hi != (lo >> 63)
            if arr.null_count:
                mism = mism & ~np.asarray(arr.is_null()).astype(bool)
            if mism.any():
                raise OverflowError(
                    f"decimal column {name} exceeds int64 unscaled range")
        np_data = lo
    elif at == pa.date32():
        dt = T.DATE
        np_data = arr.cast(pa.int32()).to_numpy(zero_copy_only=False)
    elif pa.types.is_timestamp(at):
        dt = T.TIMESTAMP
        np_data = arr.cast(pa.timestamp("us")).cast(pa.int64()).to_numpy(
            zero_copy_only=False)
    else:
        dt = _ARROW_TO_DTYPE.get(at)
        if dt is None:
            raise TypeError(f"unsupported arrow type {at} for column {name}")
        np_data = arr.cast(pa.from_numpy_dtype(dt.np_dtype)).to_numpy(
            zero_copy_only=False)

    validity = None
    if arr.null_count > 0:
        valid_np = np.zeros(cap, dtype=np.bool_)
        valid_np[:n] = ~np.asarray(arr.is_null())
        np_data = np.where(valid_np[:n], np_data,
                           np.zeros((), dtype=dt.np_dtype))
        validity = _to_device(valid_np, device)

    padded = np.zeros(cap, dtype=dt.np_dtype)
    padded[:n] = np_data
    return Column(_to_device(padded, device), dt, validity, dictionary)


def _column_to_arrow(col: Column, data: np.ndarray,
                     valid: Optional[np.ndarray]) -> pa.Array:
    dt = col.dtype
    mask = None if valid is None else ~valid
    if isinstance(dt, T.StringType):
        if col.dictionary is None:
            return pa.array(data.astype("U"), mask=mask)
        codes = np.clip(data, 0, len(col.dictionary) - 1)
        out = pa.DictionaryArray.from_arrays(
            pa.array(codes.astype(np.int32), mask=mask), col.dictionary)
        return out.cast(pa.string())
    if isinstance(dt, T.DecimalType):
        # inverse of ingest: unscaled int64 in the low limb of a
        # little-endian 128-bit buffer, sign extension in the high limb
        lo = data.astype(np.int64)
        raw = np.empty((len(lo), 2), dtype=np.int64)
        raw[:, 0] = lo
        raw[:, 1] = lo >> 63
        validity_buf = None
        if valid is not None:
            validity_buf = pa.array(valid.astype(np.bool_)).buffers()[1]
        return pa.Array.from_buffers(
            pa.decimal128(max(dt.precision, 19), dt.scale), len(lo),
            [validity_buf, pa.py_buffer(raw.tobytes())],
            null_count=int((~valid).sum()) if valid is not None else 0)
    if isinstance(dt, T.DateType):
        return pa.array(data.astype(np.int32), mask=mask).cast(pa.date32())
    if isinstance(dt, T.TimestampType):
        return pa.array(data.astype(np.int64), mask=mask).cast(pa.timestamp("us"))
    return pa.array(data, mask=mask)
