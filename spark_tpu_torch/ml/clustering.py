"""KMeans (the port of `spark_tpu/ml/clustering.py`; reference:
ml/clustering/KMeans.scala): Lloyd's iterations on the session's
device -- the [n, k] distance matrix is a matmul (|x|^2 - 2 x.c +
|c|^2), the assignment an argmin, and the centroid updates segment sums
(`index_add_`), versus the reference's per-partition runs +
collectAsMap per iteration. The farthest-point initialisation stays
host numpy with the JAX package's RandomState(seed)."""

from __future__ import annotations

import numpy as np
import torch

from .base import Estimator, Model
from .util import attach_column, collect_xy, to_device


def _assign(X: torch.Tensor, x2: torch.Tensor, C: torch.Tensor):
    c2 = torch.sum(C * C, dim=1)[None, :]                   # [1, k]
    d = x2 - 2.0 * torch.matmul(X, C.T) + c2                # [n, k]
    return torch.argmin(d, dim=1)


def _lloyd(X: torch.Tensor, init_centers: torch.Tensor, k: int,
           max_iter: int):
    n = X.shape[0]
    x2 = torch.sum(X * X, dim=1, keepdim=True)              # [n, 1]
    one = torch.ones(n, dtype=X.dtype, device=X.device)
    C = init_centers
    for _ in range(max_iter):
        a = _assign(X, x2, C)
        cnt = torch.zeros(k, dtype=X.dtype, device=X.device) \
            .index_add_(0, a, one)
        tot = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device) \
            .index_add_(0, a, X)
        new = tot / torch.clamp(cnt, min=1.0)[:, None]
        # empty clusters keep their previous center
        C = torch.where((cnt > 0)[:, None], new, C)
    return C, _assign(X, x2, C)


class KMeans(Estimator):
    def __init__(self, k=2, featuresCol="features",
                 predictionCol="prediction", maxIter=20, seed=42):
        self.k = int(k)
        self.featuresCol = featuresCol
        self.predictionCol = predictionCol
        self.maxIter = int(maxIter)
        self.seed = int(seed)

    def fit(self, df) -> "KMeansModel":
        _, X, _ = collect_xy(df, self.featuresCol, None)
        rs = np.random.RandomState(self.seed)
        # farthest-point init (the k-means|| seat): robust to seeds
        # landing inside one cluster, deterministic per seed
        centers = [X[rs.randint(len(X))]]
        for _ in range(1, self.k):
            d = np.min(np.stack([
                np.sum((X - c) ** 2, axis=1) for c in centers]), axis=0)
            centers.append(X[int(np.argmax(d))])
        init = np.stack(centers)
        C, _ = _lloyd(to_device(df, X), to_device(df, init), self.k,
                      self.maxIter)
        return KMeansModel(self.featuresCol, self.predictionCol,
                           C.cpu().numpy())


class KMeansModel(Model):
    def __init__(self, featuresCol, predictionCol, centers):
        self.featuresCol = featuresCol
        self.predictionCol = predictionCol
        self.cluster_centers = np.asarray(centers)

    clusterCenters = property(lambda self: self.cluster_centers)

    def transform(self, df):
        table, X, _ = collect_xy(df, self.featuresCol, None)
        Xt = to_device(df, X)
        a = _assign(Xt, torch.sum(Xt * Xt, dim=1, keepdim=True),
                    to_device(df, self.cluster_centers))
        return attach_column(df, table, self.predictionCol,
                             a.cpu().numpy().astype(np.int64))
