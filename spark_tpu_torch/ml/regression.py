"""Linear regression (the port of `spark_tpu/ml/regression.py`;
reference: ml/regression/LinearRegression.scala).

The training pass: the Gram matrix X^T X and the moment vector X^T y
are two matmuls on the session's device, the solve a tiny [d+1, d+1]
linear system on the host -- instead of the reference's treeAggregate
of per-partition gradient summaries (WeightedLeastSquares.scala). A
model saves to the JAX package's `np.savez` format, so either package
loads the other's."""

from __future__ import annotations

import numpy as np
import torch

from .base import Estimator, Model
from .util import attach_column, collect_xy, to_device


def _gram_moments(X: torch.Tensor, y: torch.Tensor, reg: float):
    """Device side: the O(n d^2) matmuls. The tiny solve happens on the
    host (`np.linalg.solve`), as in the JAX package: the Gram matrix is
    a few KB."""
    n = X.shape[0]
    Xb = torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=X.device)],
                   dim=1)
    gram = torch.matmul(Xb.T, Xb)
    ridge = torch.eye(Xb.shape[1], dtype=X.dtype, device=X.device)
    ridge[-1, -1] = 0.0  # no intercept regularization
    return gram + reg * ridge, torch.matmul(Xb.T, y)


def _normal_solve(X: torch.Tensor, y: torch.Tensor, reg: float):
    gram, xty = _gram_moments(X, y, reg)
    return np.linalg.solve(gram.cpu().numpy(), xty.cpu().numpy())


class LinearRegression(Estimator):
    def __init__(self, featuresCol="features", labelCol="label",
                 predictionCol="prediction", regParam=0.0):
        self.featuresCol = featuresCol
        self.labelCol = labelCol
        self.predictionCol = predictionCol
        self.regParam = float(regParam)

    def fit(self, df) -> "LinearRegressionModel":
        _, X, y = collect_xy(df, self.featuresCol, self.labelCol)
        theta = _normal_solve(to_device(df, X), to_device(df, y),
                              self.regParam)
        return LinearRegressionModel(self.featuresCol,
                                     self.predictionCol,
                                     theta[:-1], float(theta[-1]))


class LinearRegressionModel(Model):
    def __init__(self, featuresCol, predictionCol, coefficients,
                 intercept):
        self.featuresCol = featuresCol
        self.predictionCol = predictionCol
        self.coefficients = np.asarray(coefficients)
        self.intercept = float(intercept)

    def transform(self, df):
        table, X, _ = collect_xy(df, self.featuresCol, None)
        pred = torch.matmul(to_device(df, X),
                            to_device(df, self.coefficients)) \
            + self.intercept
        return attach_column(df, table, self.predictionCol,
                             pred.cpu().numpy())

    def save(self, path: str) -> None:
        np.savez(path, coefficients=self.coefficients,
                 intercept=self.intercept,
                 featuresCol=self.featuresCol,
                 predictionCol=self.predictionCol)

    @staticmethod
    def load(path: str) -> "LinearRegressionModel":
        z = np.load(path, allow_pickle=True)
        return LinearRegressionModel(str(z["featuresCol"]),
                                     str(z["predictionCol"]),
                                     z["coefficients"],
                                     float(z["intercept"]))
