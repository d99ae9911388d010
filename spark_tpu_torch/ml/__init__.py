"""spark_tpu_torch.ml: the MLlib analog (the port of `spark_tpu/ml/`;
reference: `mllib/src/main/scala/org/apache/spark/ml/Pipeline.scala:1`
+ feature/regression/classification/clustering packages):

- feature vectors are fixed-width array columns (the engine's offsets
  layout) that reshape on the host to a dense [rows, n_features]
  float64 matrix, which goes to the session's device once; every
  algorithm below is then torch matmuls and segment sums there, not
  per-row iterators;
- estimators `fit` on a DataFrame and return Models (Transformers);
  `Pipeline` chains them exactly like the reference's Estimator/
  Transformer/Params contract;
- training runs eagerly on the device: the normal equations' Gram
  moments, a loop of full-batch gradient steps, Lloyd iterations. The
  JAX package compiles each into one program; no Pallas kernel is
  reached, so no hand kernel is needed here.
"""

from .base import Estimator, Model, Pipeline, PipelineModel, Transformer
from .feature import StandardScaler, StandardScalerModel, VectorAssembler
from .regression import LinearRegression, LinearRegressionModel
from .classification import LogisticRegression, LogisticRegressionModel
from .clustering import KMeans, KMeansModel
from .evaluation import (BinaryClassificationEvaluator,
                         RegressionEvaluator)

__all__ = [
    "Estimator", "Model", "Pipeline", "PipelineModel", "Transformer",
    "VectorAssembler", "StandardScaler", "StandardScalerModel",
    "LinearRegression", "LinearRegressionModel",
    "LogisticRegression", "LogisticRegressionModel",
    "KMeans", "KMeansModel",
    "RegressionEvaluator", "BinaryClassificationEvaluator",
]
