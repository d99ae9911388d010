"""spark_tpu_torch.graph: the GraphX analog (the port of
`spark_tpu/graph/`; reference: `graphx/src/main/scala/org/apache/spark/
graphx/Graph.scala`, `Pregel.scala:59`): vertices and edges are device
tensors; one Pregel superstep = gather (edge-indexed takes) -> message
combine (segment reduce) -> vertex program (elementwise), replacing the
reference's per-iteration RDD joins + shuffles. The JAX package runs
the supersteps in one compiled while-loop; the port runs them eagerly,
reading one flag from the device per superstep for the stop test.
"""

from .graph import Graph, pregel
from .lib import connected_components, page_rank

__all__ = ["Graph", "pregel", "page_rank", "connected_components"]
