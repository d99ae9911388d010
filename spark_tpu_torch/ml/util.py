"""Shared ML data plumbing (the port of `spark_tpu/ml/util.py`):
DataFrame <-> dense matrices. The host side stays numpy and pyarrow;
`to_device` puts a matrix on the DataFrame's session's device as
float64."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import torch


def features_to_matrix(table: pa.Table, features_col: str) -> np.ndarray:
    """Fixed-width array column -> dense [rows, d] float64 matrix."""
    col = table.column(features_col)
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if not (pa.types.is_list(arr.type) or pa.types.is_large_list(arr.type)):
        raise TypeError(
            f"{features_col!r} must be an array column (use "
            f"VectorAssembler); got {arr.type}")
    offs = arr.offsets.to_numpy(zero_copy_only=False)
    widths = np.diff(offs)
    if len(widths) == 0:
        return np.zeros((0, 0))
    d = int(widths[0])
    if not (widths == d).all():
        raise ValueError(
            f"{features_col!r} is ragged; ML needs fixed-width vectors")
    vals = arr.values.to_numpy(zero_copy_only=False).astype(np.float64)
    return vals.reshape(len(widths), d)


def collect_xy(df, features_col: str, label_col: Optional[str]
               ) -> Tuple[pa.Table, np.ndarray, Optional[np.ndarray]]:
    table = df.collect() if hasattr(df, "collect") else df
    X = features_to_matrix(table, features_col)
    y = None
    if label_col is not None:
        y = np.asarray(table.column(label_col).to_numpy(
            zero_copy_only=False), dtype=np.float64)
    return table, X, y


def to_device(df, a: np.ndarray) -> torch.Tensor:
    """A host array as a float64 tensor on `df`'s session's device."""
    return torch.from_numpy(np.require(a, np.float64, ["C", "W"])) \
        .to(df.session.device)


def attach_column(df, table: pa.Table, name: str,
                  values: np.ndarray):
    """Materialized table + new column -> DataFrame (the transform
    output seat; array columns in `table` round-trip untouched)."""
    out = table.append_column(name, pa.array(np.asarray(values)))
    return df.session.create_dataframe(out, name="__ml__")
