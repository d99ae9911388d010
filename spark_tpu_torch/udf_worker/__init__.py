"""Out-of-process Python UDF worker pool (the `ArrowEvalPythonExec` /
`PythonRunner.scala:84` seat; the port of `spark_tpu/udf_worker/`):
Arrow-batched evaluation of user Python in reusable CPython
subprocesses, with batch-granular retry, cancel and counters. See
pool.py (parent side), worker.py (child loop), protocol.py (framing).
Selected by `spark_tpu.sql.udf.mode = worker`; the default `inprocess`
keeps the single-process lane.

This package __init__ stays import-light: it must not drag the pool
machinery (or pyarrow) in before the worker lane needs it.
"""

from __future__ import annotations


class UdfError(RuntimeError):
    """User code raised inside a UDF worker. Carries the USER traceback
    captured in the child (not the pool's framing stack) and classifies
    FATAL (`execution/failures.py`) — a user bug never burns retry
    budget. `code` is the structured error code the JAX package's SQL
    service maps it to."""

    code = "UDF_ERROR"

    def __init__(self, udf_name: str, etype: str, message: str,
                 worker_traceback: str):
        super().__init__(
            f"python UDF {udf_name!r} raised {etype}: {message}")
        self.udf_name = udf_name
        self.etype = etype
        self.worker_traceback = worker_traceback


class UdfNotShippable(RuntimeError):
    """The worker lane cannot carry this function to a worker: without
    `cloudpickle` it ships functions with `pickle`, which carries only
    functions importable by module and name (not lambdas, nested or
    `__main__` functions). Raised instead of falling back to the
    in-process lane."""

    def __init__(self, udf_name: str, detail: str):
        super().__init__(
            f"python UDF {udf_name!r} cannot be shipped to a UDF worker: "
            f"cloudpickle is not installed and pickle cannot carry it "
            f"({detail}); define it at module level in an importable "
            f"module, or use spark_tpu.sql.udf.mode=inprocess")
        self.udf_name = udf_name
