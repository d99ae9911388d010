"""spark_tpu_torch: the PyTorch/CUDA port of spark_tpu.

A second package beside the JAX one, written in PyTorch for an NVIDIA
H100. It keeps the JAX package's module names, class names and plan
strings, so each module has a counterpart there and plan-level parity is
a string compare. It imports nothing from `spark_tpu` (that package's
`__init__` imports JAX) and keeps its own copies of the pure-Python
pieces it needs.

The main path so far: SQL text (`session.sql`, the 22 TPC-H and 21
TPC-DS queries) or DataFrame programs -> logical plan -> optimizer ->
physical plan -> Parquet scan with pushdown -> Filter/Project, joins,
windows, unions -> HashAggregate, whose dense-domain sums run in the
hand-written CUDA kernels of `execution/dense_groupby.py` -> Sort ->
Arrow.
"""

from . import functions
from . import types
from .columnar import Batch, Column
from .config import Conf
from .dataframe import DataFrame
from .session import SparkTpuSession

__version__ = "0.1.0"

__all__ = ["SparkTpuSession", "DataFrame", "Batch", "Column", "Conf",
           "functions", "types", "__version__"]
