"""Partial-progress recovery: chunk-granular retry, stage-output reuse and
mesh checkpoints (the port of `spark_tpu/execution/recovery.py`;
reference: lineage plus task-level retry re-runs one partition, and
completed shuffle files survive a downstream failure — Zaharia et al.,
NSDI'12).

- **ChunkRetrier** — per-chunk retry inside the streaming loops
  (`streaming_agg.py` and `external.py`). The carried state (the
  accumulator tables, the spill list, the chunk cursor) advances only
  after a chunk succeeds, so a TRANSIENT/TIMEOUT fault replays exactly
  the failed chunk — `spark_tpu.execution.chunkRetry.{enabled,
  maxRetries}`. The `stream_chunk` fault seam fires once per chunk
  attempt here. The UDF worker lane (`python_eval.py`) runs each Arrow
  batch as one chunk at the `udf_batch` site, which its step fires.
  Ingest (`next(chunks)`) is not retried: a reader failure poisons the
  ChunkIterator (io/sources.py) and surfaces to the whole-query ladder,
  which restarts the stream on a fresh iterator.
- **RecoveryContext** — per-execution recovery state: the fault
  recorder and a memo of completed stage outputs (streamed-aggregate
  splices, join build sides). When the executor re-executes the query
  after a failure, completed upstream stages replay from the memo
  instead of running again. A re-plan that changes shapes invalidates
  it (epoch bump).
- **MeshCheckpoint** — every `checkpoint.everyChunks` chunks the mesh
  stream (`streaming_agg.stream_scan_aggregate_mesh`) snapshots its
  per-shard accumulator state to the host, as the partial-aggregate
  Arrow table a final aggregate consumes. A gang restart resumes the
  mesh stream at the checkpointed chunk cursor, and so does the
  single-device fallback (`resume_from_mesh_checkpoint`), instead of
  chunk 0. The `mesh_checkpoint` fault seam fires at each snapshot
  point. Checkpoints survive re-plans (they are host data under a
  plan-independent key) and end with the execution. On a mesh that
  spans engine processes the snapshot gathers every process's partial
  rows, so every process saves the same table at the same cursor under
  the same key; a resume agrees the cursor and the consumed-chunk
  watermark (`agree_progress`), so `rec_chunks_replayed` is equal in
  every process.

Recovery actions flow through the executor's `_record_fault`
(`chunk_retry`, `stage_reuse`, `checkpoint_restore`) into
`fault_summary`; the session's metrics count `rec_chunks_replayed`,
`rec_stages_reused` and `rec_ckpt_bytes`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from .failures import FailureClass, RetryPolicy, classify

CHUNK_RETRY_ENABLED_KEY = "spark_tpu.execution.chunkRetry.enabled"
CHUNK_RETRY_MAX_KEY = "spark_tpu.execution.chunkRetry.maxRetries"
CHECKPOINT_EVERY_KEY = "spark_tpu.execution.checkpoint.everyChunks"
BACKOFF_KEY = "spark_tpu.execution.backoffMs"

#: failure classes a chunk replay can recover (OOM descends the
#: executor's ladder instead)
_RETRYABLE = (FailureClass.TRANSIENT, FailureClass.TIMEOUT)


@dataclass
class MeshCheckpoint:
    """Device-to-host snapshot of a mesh stream's accumulator state: the
    partial-aggregate rows covering the first `cursor` chunks."""

    key: str
    cursor: int  # chunks folded into `table` (a resume skips these)
    table: Any  # pyarrow.Table of partial-aggregate rows


class ChunkRetrier:
    """Per-chunk retry policy for the streaming loops' compute steps.

    `run(step)` passes the cancellation boundary, fires the chunk's fault
    seam, runs the step and — when chunk retry is on — replays it on
    TRANSIENT/TIMEOUT failures under a fresh per-chunk RetryPolicy (the
    budget is per task attempt, not per stream). The caller's carried
    state advances only on success, so the pre-chunk state is the
    snapshot the replay runs against. A replay that meets a second,
    non-retryable error re-raises the original transient one, so the
    whole-query ladder still classifies the failure as retryable."""

    def __init__(self, conf, recovery: Optional["RecoveryContext"] = None,
                 site: str = "stream_chunk"):
        self.enabled = bool(conf.get(CHUNK_RETRY_ENABLED_KEY))
        self.max_retries = int(conf.get(CHUNK_RETRY_MAX_KEY))
        self.backoff_ms = float(conf.get(BACKOFF_KEY))
        self.recovery = recovery
        # "stream_chunk" for the compute steps, "ingest_prefetch" for the
        # prefetcher's host decode (io/sources.py), "udf_batch" for the
        # worker lane's batches (python_eval.py)
        self.site = site

    def run(self, step, chunk: int = 0):
        from ..testing import faults
        from .lifecycle import checkpoint
        # every chunk of every stream passes here: a cancel or deadline
        # lands within one chunk of delivery
        checkpoint("chunk")
        policy: Optional[RetryPolicy] = None
        orig: Optional[Exception] = None
        while True:
            try:
                if self.site == "ingest_prefetch":
                    faults.fire("ingest_prefetch")
                elif self.site == "udf_batch":
                    # the seam fires INSIDE the step (python_eval's worker
                    # lane): the step kills the in-flight worker before
                    # the injected error surfaces, so a fatal rule models
                    # a real SIGKILL mid-batch
                    pass
                else:
                    faults.fire("stream_chunk")
                return step()
            except Exception as e:  # noqa: BLE001 — classified below
                if not self.enabled or self.max_retries <= 0:
                    raise
                cls = classify(e)
                if cls is FailureClass.CANCELLED:
                    raise
                if cls not in _RETRYABLE:
                    if orig is not None:
                        raise orig from e
                    raise
                if policy is None:
                    policy = RetryPolicy(self.max_retries, self.backoff_ms)
                slept = policy.attempt_retry()
                if slept is None:
                    raise  # per-chunk budget spent: the outer ladder
                orig = e
                if self.recovery is not None:
                    self.recovery.chunk_replayed(e, chunk=chunk,
                                                 backoff_ms=slept)


class RecoveryContext:
    """Per-execution recovery state, made by the executor at every
    execute_batch / external-collect entry and threaded through the
    streaming loops: the fault recorder, the stage-output memo and the
    mesh checkpoint store."""

    def __init__(self, metrics=None, record=None):
        self.metrics = metrics  # the session's MetricsRegistry (or None)
        self._record = record   # QueryExecution._record_fault (or None)
        # key -> (epoch, attempt, value); keys are (kind, id(node)): node
        # identities are stable across recovery re-executions (a re-plan
        # rebuilds the plan and bumps the epoch)
        self._memo: Dict[Tuple, Tuple[int, int, Any]] = {}
        self.epoch = 0
        # set once a recovery action was applied: memo hits before the
        # first failure are dedup within an attempt, not recovery
        self.in_recovery = False
        self.attempt = 0
        self._reuse_logged: set = set()
        self.checkpoints: Dict[str, MeshCheckpoint] = {}
        # checkpoint key -> chunks consumed: a restore reports how many
        # chunks its resume covers again (progress - cursor). Survives
        # invalidate(), like the checkpoints it is measured against.
        self._progress: Dict[str, int] = {}
        #: per-stream chunk timings the chunk loops record
        #: (`streaming_agg._ChunkClock`), kept by the executor as
        #: `stream_stats`
        self.chunk_stats: list = []

    def record(self, action: str, exc=None, **extra) -> None:
        if self._record is not None:
            self._record(action, exc, **extra)

    def chunk_replayed(self, exc, chunk: int, backoff_ms: float) -> None:
        self.record("chunk_retry", exc, chunk=int(chunk),
                    backoff_ms=round(float(backoff_ms), 1))
        if self.metrics is not None:
            self.metrics.counter("rec_chunks_replayed").inc()

    def begin_recovery_attempt(self) -> None:
        """A recovery action was applied and the query will run again:
        memo hits from here on are stage reuse, counted once per attempt
        per key."""
        self.in_recovery = True
        self.attempt += 1

    def memo_get(self, key: Tuple, label: str = ""):
        hit = self._memo.get(key)
        if hit is None or hit[0] != self.epoch:
            return None
        _epoch, put_attempt, value = hit
        if self.in_recovery and put_attempt < self.attempt \
                and (self.attempt, key) not in self._reuse_logged:
            self._reuse_logged.add((self.attempt, key))
            self.record("stage_reuse", None, stage=str(label)[:120])
            if self.metrics is not None:
                self.metrics.counter("rec_stages_reused").inc()
        return value

    def memo_put(self, key: Tuple, value) -> None:
        self._memo[key] = (self.epoch, self.attempt, value)

    def invalidate(self) -> None:
        """A re-plan changed shapes (a join strategy, the mesh's size, the
        OOM ladder's deviceBudget re-route): memoized outputs no longer
        splice into the new plan. Checkpoints survive: they are host
        Arrow data under a plan-independent key."""
        self.epoch += 1
        self._memo.clear()

    # -- mesh checkpoints ---------------------------------------------------

    def save_checkpoint(self, key: str, cursor: int, snapshot) -> None:
        """Snapshot a mesh stream's accumulator state at `cursor` consumed
        chunks. `snapshot` is a thunk giving the host Arrow partial
        table; it runs after the `mesh_checkpoint` seam, so a fault
        injected there leaves the previous checkpoint in place."""
        from ..testing import faults
        faults.fire("mesh_checkpoint")
        table = snapshot()
        self.checkpoints[key] = MeshCheckpoint(key=key, cursor=int(cursor),
                                               table=table)
        if self.metrics is not None:
            self.metrics.counter("rec_ckpt_bytes").inc(int(table.nbytes))

    def get_checkpoint(self, key: str) -> Optional[MeshCheckpoint]:
        return self.checkpoints.get(key)

    def note_progress(self, key: str, chunks: int) -> None:
        """Advance a stream's consumed-chunk watermark (monotone)."""
        if int(chunks) > self._progress.get(key, 0):
            self._progress[key] = int(chunks)

    def progress(self, key: str) -> int:
        return self._progress.get(key, 0)

    def agree_progress(self, key: str, chunks: int) -> None:
        """Set a stream's watermark to the one the processes of a cluster
        agreed (the least they reached), so every process's restore
        reports the same replay."""
        self._progress[key] = int(chunks)

    def restore_replayed(self, key: str, cursor: int) -> int:
        """Chunks a resume at `cursor` covers again (the failed attempt
        had consumed up to the watermark), counted into
        rec_chunks_replayed: the bound of at most checkpoint.everyChunks
        chunks per mesh recovery is a metric."""
        replayed = max(0, self.progress(key) - int(cursor))
        if replayed and self.metrics is not None:
            self.metrics.counter("rec_chunks_replayed").inc(replayed)
        return replayed

    def release(self) -> None:
        """Drop retained stage outputs (device batches), checkpoint
        tables and progress when the execution ends: they span recovery
        loops, not executions."""
        self._memo.clear()
        self.checkpoints.clear()
        self._progress.clear()
