"""Logistic regression (the port of `spark_tpu/ml/classification.py`;
reference: ml/classification/LogisticRegression.scala): full-batch
gradient descent on the session's device, in float64 -- every
iteration is two matmuls (X @ w, X^T residual) instead of the
reference's per-partition LogisticAggregator treeAggregate round
trips. The JAX package runs the `maxIter` steps as one compiled scan;
here they are a plain loop of torch ops, with no host read inside."""

from __future__ import annotations

import numpy as np
import torch

from .base import Estimator, Model
from .util import attach_column, collect_xy, to_device


def _logreg_fit(X: torch.Tensor, y: torch.Tensor, max_iter: int,
                step: float, reg: float) -> torch.Tensor:
    n, d = X.shape
    Xb = torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=X.device)],
                   dim=1)
    # regularize every weight but the intercept
    keep = torch.ones(d + 1, dtype=X.dtype, device=X.device)
    keep[-1] = 0.0
    w = torch.zeros(d + 1, dtype=X.dtype, device=X.device)
    for _ in range(max_iter):
        p = torch.sigmoid(torch.matmul(Xb, w))
        grad = torch.matmul(Xb.T, p - y) / n
        grad = grad + reg * (w * keep)
        w = w - step * grad
    return w


class LogisticRegression(Estimator):
    def __init__(self, featuresCol="features", labelCol="label",
                 predictionCol="prediction",
                 probabilityCol="probability",
                 maxIter=200, stepSize=1.0, regParam=0.0):
        self.featuresCol = featuresCol
        self.labelCol = labelCol
        self.predictionCol = predictionCol
        self.probabilityCol = probabilityCol
        self.maxIter = int(maxIter)
        self.stepSize = float(stepSize)
        self.regParam = float(regParam)

    def fit(self, df) -> "LogisticRegressionModel":
        _, X, y = collect_xy(df, self.featuresCol, self.labelCol)
        w = _logreg_fit(to_device(df, X), to_device(df, y), self.maxIter,
                        self.stepSize, self.regParam).cpu().numpy()
        return LogisticRegressionModel(
            self.featuresCol, self.predictionCol, self.probabilityCol,
            w[:-1], float(w[-1]))


class LogisticRegressionModel(Model):
    def __init__(self, featuresCol, predictionCol, probabilityCol,
                 coefficients, intercept):
        self.featuresCol = featuresCol
        self.predictionCol = predictionCol
        self.probabilityCol = probabilityCol
        self.coefficients = np.asarray(coefficients)
        self.intercept = float(intercept)

    def transform(self, df):
        table, X, _ = collect_xy(df, self.featuresCol, None)
        p = torch.sigmoid(torch.matmul(to_device(df, X),
                                       to_device(df, self.coefficients))
                          + self.intercept).cpu().numpy()
        out = attach_column(df, table, self.probabilityCol, p)
        table2 = out.collect()
        return attach_column(out, table2, self.predictionCol,
                             (p >= 0.5).astype(np.float64))
