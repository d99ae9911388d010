"""Feature transformers (the port of `spark_tpu/ml/feature.py`;
reference: ml/feature -- VectorAssembler.scala, StandardScaler.scala)."""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from .base import Estimator, Model, Transformer
from .util import collect_xy, features_to_matrix


class VectorAssembler(Transformer):
    """Combine numeric columns into one fixed-width array column -- a
    pure engine expression (F.array), lazy until the frame runs."""

    def __init__(self, inputCols=None, outputCol="features"):
        self.inputCols = list(inputCols or [])
        self.outputCol = outputCol

    def transform(self, df):
        from .. import functions as F
        from ..functions import col
        keep = [col(n) for n in df.plan.schema().names]
        arr = F.array(*[_dbl(c) for c in self.inputCols])
        return df.select(*keep, arr.alias(self.outputCol))


def _dbl(name):
    from ..expr import Cast, ColumnRef
    from .. import types as T
    return Cast(ColumnRef(name), T.DOUBLE)


class StandardScaler(Estimator):
    """fit: per-feature mean/std over the collected matrix (host numpy,
    as in the JAX package); transform rebuilds the vector column with
    standardized values."""

    def __init__(self, inputCol="features", outputCol="scaled",
                 withMean=True, withStd=True):
        self.inputCol = inputCol
        self.outputCol = outputCol
        self.withMean = withMean
        self.withStd = withStd

    def fit(self, df) -> "StandardScalerModel":
        _, X, _ = collect_xy(df, self.inputCol, None)
        mean = X.mean(axis=0) if len(X) else np.zeros(X.shape[1])
        std = X.std(axis=0) if len(X) else np.ones(X.shape[1])
        std = np.where(std == 0, 1.0, std)
        return StandardScalerModel(self.inputCol, self.outputCol,
                                   mean if self.withMean else
                                   np.zeros_like(mean),
                                   std if self.withStd else
                                   np.ones_like(std))


class StandardScalerModel(Model):
    def __init__(self, inputCol, outputCol, mean, std):
        self.inputCol = inputCol
        self.outputCol = outputCol
        self.mean = np.asarray(mean)
        self.std = np.asarray(std)

    def transform(self, df):
        table = df.collect()
        X = features_to_matrix(table, self.inputCol)
        Z = (X - self.mean) / self.std
        n, d = Z.shape if Z.size else (0, len(self.mean))
        arr = pa.ListArray.from_arrays(
            pa.array(np.arange(n + 1, dtype=np.int32) * d),
            pa.array(Z.reshape(-1)))
        out = table.append_column(self.outputCol, arr)
        return df.session.create_dataframe(out, "__scaled__")
