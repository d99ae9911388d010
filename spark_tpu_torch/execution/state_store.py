"""Incremental streaming state store: versioned deltas + snapshots (the
port of `spark_tpu/execution/state_store.py`: numpy and pandas over the
host copies of the state, so the same code).

The `RocksDBStateStoreProvider` analog scaled to this engine
(reference: `HDFSBackedStateStoreProvider.scala:73` keeps one full
state file per version; RocksDB keeps **changelog deltas** between
periodic snapshot uploads). Rewriting the ENTIRE aggregate state to
disk every trigger would cost O(state) I/O per trigger no matter how few
groups a micro-batch touched. This store makes
per-trigger persistence incremental:

- **delta** (the common case): only the groups whose accumulators
  changed this batch, diffed on HOST from the pre/post tables — for
  the dense-domain device path an ``__idx__`` vector of changed group
  slots plus each table's values at those slots; for the event-time
  host-table path the upserted rows plus tombstoned (evicted) keys.
- **snapshot**: the full state, written for version 0 and then every
  ``spark_tpu.streaming.stateStore.snapshotEveryDeltas`` versions
  (default 10), bounding restore replay.
- **restore**: newest snapshot <= the committed version + replay of
  the following deltas (at most snapshotEveryDeltas of them).
- **compaction**: `prune` retires snapshots and deltas older than the
  newest snapshot at-or-below the retained-version floor — never a
  file the last committed version's restore chain needs.

Durability: every file is written to a tmp name, flushed + fsync'd,
then `os.replace`d — a torn write can never shadow a committed
version. A replayed batch (crash between the offset and commit logs)
re-commits its version by atomic overwrite, so replays are idempotent.

The ``stream_state_commit`` chaos seam fires at every commit entry
(before any byte is written): an injected fault models a hard crash at
the state-persistence boundary with the previous version intact.

Layout (under the query's ``<checkpoint>/state/``)::

    deltas/delta-<version>.npz            dense-table delta
    deltas/delta-<version>.parquet        event-time upsert rows
    deltas/delta-<version>.tombstones.parquet   evicted keys (if any)
    snapshots/snapshot-<version>.{npz,parquet}  full state
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

SNAPSHOT_EVERY_KEY = "spark_tpu.streaming.stateStore.snapshotEveryDeltas"
RETAIN_KEY = "spark_tpu.streaming.retainBatches"

_FILE_RX = re.compile(
    r"^(?P<kind>delta|snapshot)-(?P<ver>\d+)"
    r"(?P<tomb>\.tombstones)?\.(?P<ext>npz|parquet)$")


def fsync_replace(tmp: str, final: str) -> None:
    """THE torn-write guard for every checkpoint surface (state files,
    metadata logs, sink parts + manifests — one definition, so crash
    behavior can't diverge between them): fsync the tmp file, then
    atomically swap it in. A lost rename is never load-bearing — the
    batch re-runs; a torn rename cannot happen (os.replace is atomic);
    a reordered flush leaves a corrupt file that the readers
    (_MetadataLog.latest / FileStreamSource.slice healing) fall back
    across."""
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, final)




class StateStore:
    """One streaming query's versioned state files. Versions are batch
    ids; exactly one delta OR snapshot file exists per committed
    version, so the restore chain `newest snapshot <= v` + deltas
    `(s, v]` is always dense."""

    def __init__(self, state_dir: str, conf, metrics=None):
        self.dir = state_dir
        self.delta_dir = os.path.join(state_dir, "deltas")
        self.snap_dir = os.path.join(state_dir, "snapshots")
        os.makedirs(self.delta_dir, exist_ok=True)
        os.makedirs(self.snap_dir, exist_ok=True)
        self.snapshot_every = max(1, int(conf.get(SNAPSHOT_EVERY_KEY)))
        self.metrics = metrics
        #: deltas replayed by the most recent load_* call (the
        #: bounded-restore proof is a readable number, not an inference)
        self.last_restore_replayed = 0

    # -- file inventory -----------------------------------------------------

    def _versions(self, d: str, kind: str) -> List[int]:
        out = []
        try:
            names = os.listdir(d)
        except OSError:
            return out
        for name in names:
            m = _FILE_RX.match(name)
            if m and m.group("kind") == kind and not m.group("tomb"):
                out.append(int(m.group("ver")))
        return sorted(set(out))

    def snapshot_versions(self) -> List[int]:
        return self._versions(self.snap_dir, "snapshot")

    def delta_versions(self) -> List[int]:
        return self._versions(self.delta_dir, "delta")

    def kind_for(self, version: int) -> str:
        """delta or snapshot for this version — derived from the files
        on disk, so a REPLAYED version deterministically rewrites the
        same kind it originally had."""
        snaps = [v for v in self.snapshot_versions() if v < version]
        if not snaps:
            return "snapshot"
        return ("snapshot"
                if version - max(snaps) >= self.snapshot_every
                else "delta")

    def _path(self, kind: str, version: int, ext: str,
              tomb: bool = False) -> str:
        d = self.snap_dir if kind == "snapshot" else self.delta_dir
        suffix = ".tombstones" if tomb else ""
        return os.path.join(d, f"{kind}-{version}{suffix}.{ext}")

    def _fire_seam(self) -> None:
        from ..testing import faults
        faults.fire("stream_state_commit")

    def _count_bytes(self, kind: str, nbytes: int) -> None:
        if self.metrics is not None:
            name = ("streaming_state_snapshot_bytes"
                    if kind == "snapshot"
                    else "streaming_state_delta_bytes")
            self.metrics.counter(name).inc(int(nbytes))

    # -- dense-table codec (the device direct-aggregate path) ---------------

    def commit_tables(self, version: int, flat: Dict[str, np.ndarray],
                      prev: Optional[Dict[str, np.ndarray]]) -> dict:
        """Persist the host copies of the accumulator tables for
        `version`. `prev` is the committed state at `version - 1` (None
        for the first version); a delta stores only the group slots
        where any table changed. Returns {"kind", "bytes", "changed",
        "diff_ms", "write_ms"}, the last two the host milliseconds of
        the diff and of the file write."""
        self._fire_seam()
        kind = self.kind_for(version)
        changed = None
        t0 = time.perf_counter()
        if kind == "delta":
            if prev is None:
                prev = self.load_tables(version - 1)
            payload = _diff_tables(prev, flat)
            if payload is None:  # shape drift: snapshot is the fallback
                kind = "snapshot"
            else:
                changed = int(payload["__idx__"].shape[0])
                # full-churn guard: a delta of (nearly) every group is
                # LARGER than the snapshot it avoids (values + the
                # __idx__ vector) — write the snapshot instead. The
                # decision is a pure function of (prev, post), so a
                # replayed batch deterministically re-picks it.
                delta_nbytes = sum(np.asarray(a).nbytes
                                   for a in payload.values())
                snap_nbytes = sum(np.asarray(a).nbytes
                                  for a in flat.values())
                if delta_nbytes >= snap_nbytes:
                    kind = "snapshot"
                    changed = None
        if kind == "snapshot":
            payload = dict(flat)
        t1 = time.perf_counter()
        path = self._path(kind, version, "npz")
        tmp = path + ".tmp.npz"
        np.savez(tmp, **payload)
        fsync_replace(tmp, path)
        nbytes = os.path.getsize(path)
        self._count_bytes(kind, nbytes)
        return {"kind": kind, "bytes": int(nbytes), "changed": changed,
                "diff_ms": (t1 - t0) * 1e3,
                "write_ms": (time.perf_counter() - t1) * 1e3}

    def load_tables(self, version: int
                    ) -> Optional[Dict[str, np.ndarray]]:
        """Restore the flat table dict at `version`: newest snapshot
        <= version, then replay the following deltas in order."""
        if version < 0:
            return None
        snaps = [v for v in self.snapshot_versions() if v <= version]
        if not snaps:
            raise FileNotFoundError(
                f"no state snapshot at or below version {version} "
                f"under {self.snap_dir}")
        base = max(snaps)
        with np.load(self._path("snapshot", base, "npz")) as z:
            flat = {k: np.array(z[k]) for k in z.files}
        replayed = 0
        for v in range(base + 1, version + 1):
            with np.load(self._path("delta", v, "npz")) as z:
                idx = z["__idx__"]
                for k in z.files:
                    if k == "__idx__":
                        continue
                    flat[k][idx] = z[k]
            replayed += 1
        self.last_restore_replayed = replayed
        return flat

    # -- host-frame codec (the event-time watermark path) -------------------

    def _keys_path(self) -> str:
        return os.path.join(self.dir, "frame_keys.json")

    def _save_key_cols(self, key_cols: List[str]) -> None:
        """The frame codec's key columns, persisted once: load_frame
        needs them to replay deltas (drop touched keys, append
        upserts) without the caller in hand."""
        import json
        path = self._keys_path()
        if os.path.exists(path):
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"key_cols": list(key_cols)}, f)
        fsync_replace(tmp, path)

    def _load_key_cols(self) -> Optional[List[str]]:
        import json
        try:
            with open(self._keys_path()) as f:
                return list(json.load(f)["key_cols"])
        except (OSError, ValueError, KeyError):
            return None

    def commit_frame(self, version: int, pdf: Optional[pd.DataFrame],
                     prev: Optional[pd.DataFrame],
                     key_cols: List[str]) -> dict:
        """Persist the event-time host state table for `version` as an
        upsert/tombstone delta against `prev` (the committed state at
        `version - 1`), or a full snapshot on the cadence."""
        self._fire_seam()
        self._save_key_cols(key_cols)
        post = pdf if pdf is not None else pd.DataFrame()
        kind = self.kind_for(version)
        tombs = None
        if kind == "delta":
            ups, tombs = _diff_frames(prev, post, key_cols)
            if len(post) and len(ups) >= len(post):
                # full-churn guard (row-count proxy): every row
                # upserted means the delta IS the state — snapshot
                kind = "snapshot"
                tombs = None
            else:
                payload = ups
        if kind == "snapshot":
            payload = post
        path = self._path(kind, version, "parquet")
        tmp = path + ".tmp"
        payload.to_parquet(tmp)
        fsync_replace(tmp, path)
        nbytes = os.path.getsize(path)
        tomb_path = self._path("delta", version, "parquet", tomb=True)
        if tombs is not None and len(tombs):
            ttmp = tomb_path + ".tmp"
            tombs.to_parquet(ttmp)
            fsync_replace(ttmp, tomb_path)
            nbytes += os.path.getsize(tomb_path)
        elif os.path.exists(tomb_path):
            # replay wrote fewer tombstones than a torn earlier attempt
            os.remove(tomb_path)
        self._count_bytes(kind, nbytes)
        return {"kind": kind, "bytes": int(nbytes),
                "changed": (int(len(payload)) if kind == "delta"
                            else None)}

    def load_frame(self, version: int) -> Optional[pd.DataFrame]:
        if version < 0:
            return None
        snaps = [v for v in self.snapshot_versions() if v <= version]
        if not snaps:
            raise FileNotFoundError(
                f"no state snapshot at or below version {version} "
                f"under {self.snap_dir}")
        base = max(snaps)
        state = pd.read_parquet(self._path("snapshot", base, "parquet"))
        key_cols = self._load_key_cols()
        replayed = 0
        for v in range(base + 1, version + 1):
            ups = pd.read_parquet(self._path("delta", v, "parquet"))
            tomb_path = self._path("delta", v, "parquet", tomb=True)
            tombs = (pd.read_parquet(tomb_path)
                     if os.path.exists(tomb_path) else None)
            state = _apply_frame_delta(state, ups, tombs, key_cols)
            replayed += 1
        self.last_restore_replayed = replayed
        if not len(state):
            return state if len(state.columns) else None
        return state.reset_index(drop=True)

    # -- compaction ---------------------------------------------------------

    def prune(self, committed: int, retain: int) -> None:
        """Retire files no retained version's restore chain needs:
        restoring any version v >= floor uses the newest snapshot <= v,
        which is >= the newest snapshot <= floor — so snapshots before
        it and deltas at-or-before it are dead."""
        floor = committed - int(retain)
        snaps = [v for v in self.snapshot_versions() if v <= floor]
        if not snaps:
            return
        keep = max(snaps)
        for v in self.snapshot_versions():
            if v < keep:
                for ext in ("npz", "parquet"):
                    _rm(self._path("snapshot", v, ext))
        for v in self.delta_versions():
            if v <= keep:
                for ext in ("npz", "parquet"):
                    _rm(self._path("delta", v, ext))
                _rm(self._path("delta", v, "parquet", tomb=True))


def _rm(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _diff_tables(prev: Dict[str, np.ndarray],
                 post: Dict[str, np.ndarray]) -> Optional[dict]:
    """Changed-group delta between two flat table dicts sharing the
    group-domain leading axis. None when shapes/keys drifted (the
    caller snapshots instead). NaN-stable: an accumulator slot that
    stays NaN is NOT a change."""
    if prev is None or set(prev) != set(post):
        return None
    mask = None
    for name in sorted(post):
        a, b = np.asarray(prev[name]), np.asarray(post[name])
        if a.shape != b.shape:
            return None
        d = a != b
        if np.issubdtype(a.dtype, np.floating):
            d &= ~(np.isnan(a) & np.isnan(b))
        if d.ndim > 1:
            d = d.any(axis=tuple(range(1, d.ndim)))
        mask = d if mask is None else (mask | d)
    if mask is None:
        return None
    idx = np.nonzero(mask)[0].astype(np.int64)
    payload = {"__idx__": idx}
    for name in post:
        payload[name] = np.asarray(post[name])[idx]
    return payload


def _diff_frames(prev: Optional[pd.DataFrame], post: pd.DataFrame,
                 key_cols: List[str]):
    """(upserts, tombstone_keys) taking `prev` to `post`, both keyed
    (uniquely) by `key_cols` — new keys and changed rows upsert,
    vanished keys (watermark eviction) tombstone."""
    if prev is None or not len(prev):
        return post.reset_index(drop=True), None
    if not len(post):
        return (post.iloc[0:0].reset_index(drop=True),
                prev[key_cols].reset_index(drop=True))
    prev_i = prev.set_index(key_cols)
    post_i = post.set_index(key_cols)
    common = prev_i.index.intersection(post_i.index)
    new_keys = post_i.index.difference(prev_i.index)
    deleted = prev_i.index.difference(post_i.index)
    changed = common[:0]
    if len(common):
        a = prev_i.loc[common]
        b = post_i.loc[common]
        same = (a.values == b.values)
        # NaN == NaN is False elementwise; treat both-NaN as unchanged
        try:
            both_nan = pd.isna(a).values & pd.isna(b).values
            same = same | both_nan
        except TypeError:
            pass
        changed = common[~same.all(axis=1)]
    ups_idx = new_keys.append(changed)
    ups = post_i.loc[ups_idx].reset_index() if len(ups_idx) \
        else post.iloc[0:0]
    tombs = (prev_i.loc[deleted].reset_index()[key_cols]
             if len(deleted) else None)
    return ups.reset_index(drop=True)[list(post.columns)], tombs


def _apply_frame_delta(state: pd.DataFrame, ups: pd.DataFrame,
                       tombs: Optional[pd.DataFrame],
                       key_cols: Optional[List[str]]) -> pd.DataFrame:
    """Replay one delta: drop every touched key from `state`, then
    append the upsert rows (tombstoned keys simply stay dropped)."""
    touched = [t for t in (ups, tombs) if t is not None and len(t)]
    if not touched:
        return state
    if key_cols is None:
        # keys sidecar lost: the only safe fallback is tombstone
        # columns (they carry exactly the keys); without either the
        # delta cannot be applied
        if tombs is not None:
            key_cols = list(tombs.columns)
        else:
            raise FileNotFoundError(
                "state-store frame_keys.json missing: cannot replay "
                "event-time deltas without the key columns")
    if len(state):
        sidx = pd.MultiIndex.from_frame(state[key_cols]) \
            if len(key_cols) > 1 else pd.Index(state[key_cols[0]])
        drop = set()
        for t in touched:
            tidx = pd.MultiIndex.from_frame(t[key_cols]) \
                if len(key_cols) > 1 else pd.Index(t[key_cols[0]])
            drop.update(tidx)
        keep = ~sidx.isin(drop)
        state = state[np.asarray(keep)]
    if len(ups):
        ups = ups[list(state.columns)] if len(state.columns) else ups
        state = pd.concat([state, ups], ignore_index=True)
    return state
