"""Named process counters of a session (the counter part of the JAX
package's `observability/metrics.py` MetricsRegistry): the recovery
layer counts replayed chunks and reused stages, the lifecycle layer
cancelled and deadlined queries, the prefetcher its stall and overlap
milliseconds, the UDF lanes (`execution/python_eval.py`,
`udf_worker/pool.py`) their batches, rows, evaluation and worker spawn
milliseconds and worker restarts (`UDF_COUNTERS`)."""

from __future__ import annotations

import threading
from typing import Dict

#: the UDF lanes' counters; the session creates them at start
UDF_COUNTERS = ("udf_batches", "udf_rows", "udf_exec_ms",
                "udf_worker_spawn_ms", "udf_worker_restarts")


class Counter:
    """Monotonic counter; `inc` is lock-guarded (the prefetch worker and
    query threads share one registry)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class MetricsRegistry:
    """Counters by name, created on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c
