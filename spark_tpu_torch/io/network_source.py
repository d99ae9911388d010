"""Socket network stream source: length-framed Arrow IPC over TCP (the
port of `spark_tpu/io/network_source.py`: host sockets and Arrow, no
tensor; the rows reach the device in the micro-batch loop).

The reference's production sources are network-offset-managed
(`KafkaSourceProvider.scala:50`): the broker owns a durable offset per
partition and the consumer commits the range each micro-batch covered.
This engine's analog keeps the durability on the CONSUMER side — every
frame read off the wire is fsync-persisted under the query checkpoint
BEFORE it counts, and the persisted frame count IS the source offset —
so the same offset/seen-log machinery the file source rides
(`streaming.py` `_MetadataLog`) gives the network tier exactly-once
replay for free.

Wire protocol (reusing `udf_worker/protocol.py`'s `>cI` framing, one
type byte + u32 big-endian payload length):

    consumer -> producer, once per connection:
        O frame, 8-byte big-endian payload = durable frame count
        (the offset handshake: "resume after this many frames")
    producer -> consumer, repeatedly:
        R frame, payload = one Arrow IPC stream (a record batch)
        X frame, empty payload = end of stream (optional)

The handshake makes reconnects exactly-once BY CONSTRUCTION: a
connection killed mid-frame loses only bytes that never became a
durable frame, and the next connection's handshake tells the producer
to resume at the durable count — zero loss (nothing durable is
skipped), zero duplication (nothing durable is resent).

Failure ladder (`latest_offset`, once per poll):

    idle    a read that times out waiting for the FIRST byte of a new
            frame = a quiet producer; return the offsets drained so
            far and keep the connection warm.
    stall   the same timeout MID-frame (header or payload partially
            read) = a dead or wedged peer; drop the connection.
    drop    EOF / connection reset / a framing violation
            (ProtocolError) also drop the connection.

Dropped connections climb a reconnect ladder — exponential backoff +
jitter via `failures.RetryPolicy`, budgeted by
`spark_tpu.streaming.source.network.maxReconnects` — counting
`streaming_reconnects` per re-established connection. An exhausted
ladder raises a TRANSIENT-shaped connection error for the trigger
supervisor to classify. A frame that arrives intact but fails to
decode as Arrow is QUARANTINED exactly like the file source's corrupt
file: the reason lands in its seen-log entry, the
`streaming_frames_quarantined` counter ticks, and every replay skips
it — one poison frame cannot wedge the stream.

Chaos seams: `stream_net_connect` fires before every connect attempt
(first connect and each ladder rung), `stream_net_recv` before every
frame read (testing/faults.py).

`FrameProducer` at the bottom is the in-process peer (tests and the
smoke run): it speaks the handshake, serves frames from the agreed
offset, and survives `kill_connection()` so reconnect scenarios are
one method call.
"""

from __future__ import annotations

import os
import select
import socket
import struct
import threading
import time
import warnings
from typing import Dict, List, Optional

import pandas as pd
import pyarrow as pa

from ..udf_worker.protocol import (MAX_FRAME_BYTES, _HEADER,
                                   ProtocolError, ipc_to_table,
                                   table_to_ipc)

MAX_RECONNECTS_KEY = "spark_tpu.streaming.source.network.maxReconnects"
CONNECT_TIMEOUT_KEY = \
    "spark_tpu.streaming.source.network.connectTimeoutMs"
IDLE_TIMEOUT_KEY = "spark_tpu.streaming.source.network.idleTimeoutMs"
BACKOFF_KEY = "spark_tpu.streaming.source.network.backoffMs"

FRAME_OFFSET = b"O"   # consumer->producer: resume-offset handshake
FRAME_RECORD = b"R"   # producer->consumer: one Arrow IPC record batch
FRAME_END = b"X"      # producer->consumer: end of stream

_OFFSET_STRUCT = struct.Struct(">Q")


class _Idle(Exception):
    """Timed out waiting for the first byte of a new frame: a quiet
    producer, not a failure."""


class _Stall(Exception):
    """Timed out mid-frame: the peer is dead or wedged."""


class NetworkStreamSource:
    """TCP frame source with consumer-side durable offsets (see module
    docstring). API-compatible with the other sources: `source_kind`,
    `attach_checkpoint`, `latest_offset`, `slice`, `to_df`."""

    source_kind = "network"

    def __init__(self, session, host: str, port: int,
                 schema_df: pd.DataFrame):
        self.session = session
        self.host = host
        self.port = int(port)
        from ..streaming import empty_table
        self._table = empty_table(schema_df)
        #: seen-frame log entries ({name, rows, quarantined}), the
        #: durable mirror under <checkpoint>/sources/0/; the offset is
        #: len(self._seen), exactly the file source's contract
        self._seen: List[dict] = []
        self._log = None
        self._frames_dir: Optional[str] = None
        #: decoded-frame cache (receipt-time decode); replays on a
        #: fresh query re-read the persisted frame files instead
        self._cache: Dict[int, pa.Table] = {}
        self._sock: Optional[socket.socket] = None
        self._had_connection = False
        self._ended = False

    # -- checkpoint binding -------------------------------------------------

    def attach_checkpoint(self, path: str) -> None:
        from ..streaming import _MetadataLog
        self._log = _MetadataLog(path, metrics=self.session.metrics)
        self._seen = self._log.read_all()
        self._frames_dir = os.path.join(path, "frames")
        os.makedirs(self._frames_dir, exist_ok=True)
        self._cache = {}
        self._ended = any(e.get("end") for e in self._seen)

    # -- socket plumbing ----------------------------------------------------

    def _conf_ms(self, key: str) -> float:
        return float(self.session.conf.get(key))

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    close = _drop_connection

    def _connect(self) -> None:
        """One connect attempt + offset handshake. The caller owns the
        reconnect ladder; a failure here is one consumed rung."""
        from ..testing import faults
        faults.fire("stream_net_connect")
        sock = socket.create_connection(
            (self.host, self.port),
            timeout=self._conf_ms(CONNECT_TIMEOUT_KEY) / 1e3)
        sock.settimeout(self._conf_ms(IDLE_TIMEOUT_KEY) / 1e3)
        payload = _OFFSET_STRUCT.pack(len(self._seen))
        sock.sendall(_HEADER.pack(FRAME_OFFSET, len(payload)) + payload)
        self._sock = sock
        if self._had_connection:
            self.session.metrics.counter("streaming_reconnects").inc()
        self._had_connection = True

    def _recv_exact(self, n: int, mid_frame: bool) -> bytes:
        """Read exactly n bytes; a timeout with NOTHING read yet and
        `mid_frame` unset is the quiet-producer signal (_Idle), any
        other timeout is a stall (_Stall)."""
        buf = b""
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except socket.timeout:
                if not buf and not mid_frame:
                    raise _Idle() from None
                raise _Stall(
                    f"peer stalled mid-frame after {len(buf)}/{n} "
                    f"bytes") from None
            if not chunk:
                raise EOFError(
                    f"Socket closed by peer after {len(buf)}/{n} "
                    f"frame bytes")
            buf += chunk
        return buf

    def _read_frame(self) -> tuple:
        """(type, payload) for the next frame, or raises _Idle/_Stall/
        EOFError/ProtocolError per the failure ladder."""
        header = self._recv_exact(_HEADER.size, mid_frame=False)
        ftype, length = _HEADER.unpack(header)
        if ftype not in (FRAME_RECORD, FRAME_END):
            raise ProtocolError(
                f"unexpected frame type {ftype!r} from producer "
                f"(cannot resync a byte stream; reconnecting)")
        if length > MAX_FRAME_BYTES:
            raise ProtocolError(
                f"frame length {length} exceeds MAX_FRAME_BYTES")
        payload = self._recv_exact(length, mid_frame=True) \
            if length else b""
        return ftype, payload

    # -- durable receipt ----------------------------------------------------

    def _persist(self, idx: int) -> None:
        if self._log is not None:
            self._log.add(idx, self._seen[idx])

    def _accept_frame(self, payload: bytes) -> None:
        """Persist one received frame durably, THEN count it: the frame
        file lands (fsync + atomic rename) before its seen-log entry,
        and the entry before the offset moves, so a crash anywhere
        leaves a prefix — the handshake count never covers bytes that
        could be lost."""
        idx = len(self._seen)
        name = f"frame-{idx:06d}.arrow"
        if self._frames_dir is not None:
            from ..execution.state_store import fsync_replace
            full = os.path.join(self._frames_dir, name)
            tmp = full + ".tmp"
            with open(tmp, "wb") as f:
                f.write(payload)
            fsync_replace(tmp, full)
        entry = {"name": name, "rows": 0, "quarantined": None}
        try:
            t = self._conform(ipc_to_table(payload))
            entry["rows"] = int(t.num_rows)
            self._cache[idx] = t
        except Exception as e:  # noqa: BLE001 — decode = quarantine
            entry["quarantined"] = f"{type(e).__name__}: {e}"[:200]
            self.session.metrics.counter(
                "streaming_frames_quarantined").inc()
            warnings.warn(
                f"quarantined poison network frame {idx} from "
                f"{self.host}:{self.port}: {entry['quarantined']}")
        self._seen.append(entry)
        self._persist(idx)

    def _conform(self, t: pa.Table) -> pa.Table:
        if t.schema == self._table.schema:
            return t
        return t.select(self._table.column_names).cast(self._table.schema)

    # -- the source contract ------------------------------------------------

    def latest_offset(self) -> int:
        """Drain every frame the producer has ready (bounded by the
        idle timeout) and return the durable frame count. Connection
        failures climb the reconnect ladder; the ladder's budget is
        per-poll, so a long-lived stream never exhausts it on
        accumulated history."""
        from ..execution.failures import RetryPolicy
        from ..testing import faults
        if self._ended:
            return len(self._seen)
        policy = RetryPolicy(
            int(self.session.conf.get(MAX_RECONNECTS_KEY)),
            self._conf_ms(BACKOFF_KEY))
        while True:
            if self._sock is None:
                try:
                    self._connect()
                except OSError as e:
                    self._drop_connection()
                    if policy.attempt_retry() is None:
                        raise ConnectionError(
                            f"network source {self.host}:{self.port}: "
                            f"connection attempt budget exhausted "
                            f"after {policy.attempts} reconnects "
                            f"({type(e).__name__}: {e})") from e
                continue
            try:
                faults.fire("stream_net_recv")
                ftype, payload = self._read_frame()
            except _Idle:
                return len(self._seen)
            except (_Stall, EOFError, ConnectionError, ProtocolError,
                    OSError) as e:
                self._drop_connection()
                if policy.attempt_retry() is None:
                    raise ConnectionError(
                        f"network source {self.host}:{self.port}: "
                        f"connection attempt budget exhausted after "
                        f"{policy.attempts} reconnects "
                        f"({type(e).__name__}: {e})") from e
                continue
            if ftype == FRAME_END:
                idx = len(self._seen)
                self._seen.append({"name": None, "rows": 0,
                                   "quarantined": None, "end": True})
                self._persist(idx)
                self._ended = True
                self._drop_connection()
                return len(self._seen)
            self._accept_frame(payload)

    def slice(self, start: int, end: int) -> pa.Table:
        """Rows of the durable frames in [start, end), skipping
        quarantined frames and the end marker — replays read the
        PERSISTED bytes, so a fresh query over the checkpoint sees
        byte-identical batches."""
        if end > len(self._seen):
            raise RuntimeError(
                f"network seen-frame log has {len(self._seen)} entries "
                f"but the planned offset range is [{start}, {end}): "
                f"frames covered by a planned batch vanished; cannot "
                f"recover exactly-once")
        tables = []
        for i in range(start, end):
            entry = self._seen[i]
            if entry.get("quarantined") or entry.get("end") \
                    or not entry.get("rows"):
                continue
            t = self._cache.get(i)
            if t is None:
                if self._frames_dir is None:
                    raise RuntimeError(
                        f"network frame {i} is not cached and no "
                        f"checkpoint is attached to re-read it from")
                with open(os.path.join(self._frames_dir,
                                       entry["name"]), "rb") as f:
                    t = self._conform(ipc_to_table(f.read()))
                self._cache[i] = t
            tables.append(t)
        if not tables:
            return self._table
        return pa.concat_tables(tables)

    def quarantined(self) -> List[dict]:
        return [dict(e, index=i) for i, e in enumerate(self._seen)
                if e.get("quarantined")]

    def to_df(self):
        from ..dataframe import DataFrame
        from ..streaming import _StreamSource
        return DataFrame(self.session, _StreamSource(self))


class FrameProducer:
    """In-process protocol peer for tests and smoke runs: listens on
    an ephemeral port, answers each connection's offset handshake by
    serving frames FROM THAT OFFSET, and exposes `kill_connection()` /
    `kill_connection_midframe()` so reconnect and stall scenarios are
    deterministic one-liners. Thread-confined state: the serve loop
    runs on one daemon thread; the driving test thread only appends
    payloads (GIL-atomic) and sets events."""

    def __init__(self):
        self._payloads: List[bytes] = []
        self._stop = threading.Event()
        self._end_when_drained = threading.Event()
        self._kill = threading.Event()
        self._kill_midframe = threading.Event()
        self._lsock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self.connections = 0

    def start(self) -> int:
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(2)
        self._lsock.settimeout(0.05)
        self.port = self._lsock.getsockname()[1]
        self._thread = threading.Thread(
            target=self._serve, daemon=True,
            name="spark-tpu-frame-producer")
        self._thread.start()
        return self.port

    def send(self, df) -> None:
        """Queue one frame (a pandas DataFrame or Arrow table)."""
        t = df if isinstance(df, pa.Table) \
            else pa.Table.from_pandas(df, preserve_index=False)
        self._payloads.append(table_to_ipc(t))

    def send_poison(self, payload: bytes = b"not arrow bytes") -> None:
        """Queue a frame whose payload will not decode (the
        quarantine path)."""
        self._payloads.append(bytes(payload))

    def end(self) -> None:
        """Send X once every queued frame has been served."""
        self._end_when_drained.set()

    def kill_connection(self) -> None:
        """Drop the live connection at the next frame boundary (the
        clean mid-stream kill; the consumer sees EOF)."""
        self._kill.set()

    def kill_connection_midframe(self) -> None:
        """Drop the live connection after sending only PART of the
        next frame (the stall/torn-frame kill)."""
        self._kill_midframe.set()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass

    # -- serve loop (producer daemon thread only) ---------------------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self.connections += 1
            try:
                self._serve_one(conn)
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _read_handshake(self, conn) -> int:
        buf = b""
        want = _HEADER.size + _OFFSET_STRUCT.size
        while len(buf) < want:
            chunk = conn.recv(want - len(buf))
            if not chunk:
                raise OSError("consumer closed before handshake")
            buf += chunk
        ftype, length = _HEADER.unpack(buf[:_HEADER.size])
        if ftype != FRAME_OFFSET or length != _OFFSET_STRUCT.size:
            raise OSError(f"bad handshake frame {ftype!r}/{length}")
        return _OFFSET_STRUCT.unpack(buf[_HEADER.size:])[0]

    def _serve_one(self, conn) -> None:
        conn.settimeout(5.0)
        idx = self._read_handshake(conn)
        while not self._stop.is_set():
            if self._kill.is_set():
                self._kill.clear()
                return
            if idx < len(self._payloads):
                p = self._payloads[idx]
                header = _HEADER.pack(FRAME_RECORD, len(p))
                if self._kill_midframe.is_set():
                    self._kill_midframe.clear()
                    conn.sendall(header + p[:max(1, len(p) // 2)])
                    return
                conn.sendall(header + p)
                idx += 1
                continue
            if self._end_when_drained.is_set():
                conn.sendall(_HEADER.pack(FRAME_END, 0))
                return
            # idle: the consumer never sends after the handshake, so a
            # readable socket means FIN/RST — a vanished consumer (the
            # tests' hard-crash simulation) must free this loop for the
            # next connection's accept, not wedge it polling forever
            readable, _, _ = select.select([conn], [], [], 0)
            if readable:
                try:
                    if not conn.recv(1):
                        return
                except OSError:
                    return
            time.sleep(0.002)
