"""Evaluators (the port of `spark_tpu/ml/evaluation.py`; reference:
ml/evaluation/RegressionEvaluator.scala,
BinaryClassificationEvaluator.scala). Host numpy over the collected
Arrow result, as in the JAX package."""

from __future__ import annotations

import numpy as np

from .base import Params


class RegressionEvaluator(Params):
    def __init__(self, labelCol="label", predictionCol="prediction",
                 metricName="rmse"):
        self.labelCol = labelCol
        self.predictionCol = predictionCol
        self.metricName = metricName

    def evaluate(self, df) -> float:
        t = df.collect()
        y = np.asarray(t.column(self.labelCol).to_numpy(
            zero_copy_only=False), dtype=np.float64)
        p = np.asarray(t.column(self.predictionCol).to_numpy(
            zero_copy_only=False), dtype=np.float64)
        err = y - p
        if self.metricName == "rmse":
            return float(np.sqrt(np.mean(err ** 2)))
        if self.metricName == "mse":
            return float(np.mean(err ** 2))
        if self.metricName == "mae":
            return float(np.mean(np.abs(err)))
        if self.metricName == "r2":
            ss_res = float(np.sum(err ** 2))
            ss_tot = float(np.sum((y - y.mean()) ** 2))
            return 1.0 - ss_res / ss_tot if ss_tot else 0.0
        raise ValueError(f"unknown metric {self.metricName!r}")


class BinaryClassificationEvaluator(Params):
    """areaUnderROC via the rank statistic (exact, ties averaged)."""

    def __init__(self, labelCol="label", rawPredictionCol="probability",
                 metricName="areaUnderROC"):
        self.labelCol = labelCol
        self.rawPredictionCol = rawPredictionCol
        self.metricName = metricName

    def evaluate(self, df) -> float:
        if self.metricName != "areaUnderROC":
            raise ValueError(f"unknown metric {self.metricName!r}")
        t = df.collect()
        y = np.asarray(t.column(self.labelCol).to_numpy(
            zero_copy_only=False), dtype=np.float64)
        s = np.asarray(t.column(self.rawPredictionCol).to_numpy(
            zero_copy_only=False), dtype=np.float64)
        import pandas as pd
        ranks = pd.Series(s).rank(method="average").to_numpy()
        n_pos = int((y == 1).sum())
        n_neg = len(y) - n_pos
        if n_pos == 0 or n_neg == 0:
            return 0.0
        return float((ranks[y == 1].sum()
                      - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
