"""Multi-device execution over a mesh of torch devices (the port of
`spark_tpu/parallel/`).

The JAX package replaces Spark's scheduler, shuffle files and block
transfer with one gang-scheduled program over a 1-D "data" axis: leaves
shard rows over the axis, `ExchangeExec(HashPartitioning)` lowers to an
on-device partition plus `lax.all_to_all`, `ExchangeExec(SinglePartition
| Replicated)` to `lax.all_gather`, aggregates plan partial -> exchange
-> final, and flags and metrics reduce back to the host.

The port keeps that program and runs it eagerly: one Python thread per
shard, each running the executor's `run_plan` over its own stripe on
its own device (`mesh.run_on_shards`), meeting the other shards at a
rendezvous for every collective (`mesh.ShardGroup`); rows move between
cards by peer copies (`shuffle.py`). See `mesh.py` for where shards
live, what a position's device id is and how a peer copy is ordered;
`elastic.py` for the gang restart, graceful decommission and straggler
rebalancing; `cluster.py` for a mesh that spans engine processes (the
`spark_tpu.sql.cluster.*` keys) and `launch.py` for starting such
processes on one host.
"""

from .mesh import AXIS, Mesh, get_mesh, mesh_size, run_on_shards
from .shuffle import (all_gather_batch, concat_batches, exchange_hash,
                      exchange_range, pad_batch_to_multiple, shard_stripes,
                      stripe_batch)

__all__ = ["AXIS", "Mesh", "get_mesh", "mesh_size", "run_on_shards",
           "exchange_hash", "exchange_range", "all_gather_batch",
           "stripe_batch", "pad_batch_to_multiple", "shard_stripes",
           "concat_batches"]
