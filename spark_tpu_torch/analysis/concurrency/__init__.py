"""Concurrency analyzer of the port: guarded-by lint, lock-order graph,
lockwatch (the port of `spark_tpu/analysis/concurrency/`).

The port is multithreaded: a mesh runs one thread per shard, the
ingest-prefetch daemon decodes chunks beside the query, a supervised
streaming query triggers on its own thread, the status store samples on
a heartbeat thread, and the listener bus delivers on whichever thread
posts. This package turns the lock discipline that keeps them correct
into STATIC CHECKS over one declarative registry (registry.py):

- ``guarded-by`` (guarded.py): every declared shared mutable attribute
  is written only inside a ``with <declared lock>`` block; every
  ``threading.Lock/RLock/Condition`` in `spark_tpu_torch/` is
  registered (with a deadlock-avoidance rank); every lock-owning class
  fully declares its shared state; ContextVar-backed state is
  recognized as thread-confined; intentional benign races carry an
  explicit waiver whose reason the lint prints.
- ``lock-order`` (lockorder.py): the static lock-acquisition graph --
  lexically nested ``with`` blocks plus resolvable call-graph edges --
  must be acyclic AND consistent with the ranks declared in the
  registry (every edge ascends; the ranks ARE the canonical order).

The runtime half lives in ``spark_tpu_torch.testing.lockwatch``:
wrapped locks record the ACTUAL acquisition order, hold times and
contention under a concurrent stress run, and assert the observed order
is consistent with the same registry the static passes prove acyclic.

Known limitation (by design, as in the JAX package): the write-site
check tracks ``self.<attr>`` targets plus the named receivers in
``registry.RECEIVER_NAMES``; a mutation through a local alias
(``stat = COPY_STATS.setdefault(...); stat[0] += n``) is invisible to
it. Every such alias site in the tree sits inside the owning lock's
``with`` block; lockwatch is the dynamic backstop.
"""

from .registry import (CONFINED, EXTRA_EDGES, GUARDED_BY, LOCKS,
                       MODULE_WAIVERS, WAIVERS, kind_of, lock_ids,
                       rank_of)

__all__ = ["LOCKS", "GUARDED_BY", "WAIVERS", "CONFINED",
           "MODULE_WAIVERS", "EXTRA_EDGES", "rank_of", "kind_of",
           "lock_ids"]
