"""Length-framed Arrow IPC protocol between the engine and UDF workers
(the port of `spark_tpu/udf_worker/protocol.py`).

The reference streams Arrow record batches to its Python workers over
sockets with a tiny control vocabulary around them
(`PythonRunner.scala:84` writes, `python/pyspark/worker.py:504` reads);
here the transport is the worker subprocess's stdin/stdout pipes and
the vocabulary is four typed frames:

    frame := type(1 byte) + length(4 bytes, big-endian) + payload

    PING  -> PONG   spawn handshake (parent times it: udf_worker_spawn_ms)
    EVAL  -> RESULT one batch: pickled spec + Arrow IPC stream in,
                    Arrow IPC stream of result columns back
    EVAL  -> ERROR  the user function raised: pickled {etype, message,
                    traceback} — the USER traceback, captured inside
                    the worker, not the pool's framing stack

IMPORT DISCIPLINE: this module is executed inside the worker child,
which must never import torch or spark_tpu_torch (the package __init__
imports torch, which costs a second or more of every spawn, and a
worker must never touch the card). Only stdlib + pyarrow here;
worker.py loads this file by path, not through the package.
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Tuple

import pyarrow as pa

FRAME_PING = b"P"
FRAME_PONG = b"O"
FRAME_EVAL = b"E"
FRAME_RESULT = b"R"
FRAME_ERROR = b"X"

#: sanity bound on one frame's payload (a corrupted length prefix must
#: not drive a multi-GB allocation): generous for real batches, which
#: are sliced by udf.arrow.maxRecordsPerBatch well below this
MAX_FRAME_BYTES = 1 << 31

_HEADER = struct.Struct(">cI")


class ProtocolError(RuntimeError):
    """Framing violation on the worker pipe (short read mid-frame,
    unknown frame type, oversized length prefix)."""


def write_frame(stream, ftype: bytes, payload: bytes) -> None:
    stream.write(_HEADER.pack(ftype, len(payload)))
    if payload:
        stream.write(payload)
    stream.flush()


def read_exact(stream, n: int) -> bytes:
    """Read exactly n bytes from a blocking stream; EOFError on a pipe
    closed mid-frame (the worker-died signal on the parent side)."""
    chunks = []
    got = 0
    while got < n:
        chunk = stream.read(n - got)
        if not chunk:
            raise EOFError(f"pipe closed after {got}/{n} frame bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(stream) -> Tuple[bytes, bytes]:
    header = read_exact(stream, _HEADER.size)
    ftype, length = _HEADER.unpack(header)
    if ftype not in (FRAME_PING, FRAME_PONG, FRAME_EVAL, FRAME_RESULT,
                     FRAME_ERROR):
        raise ProtocolError(f"unknown frame type {ftype!r}")
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {length} exceeds bound")
    payload = read_exact(stream, length) if length else b""
    return ftype, payload


# ---------------------------------------------------------------------------
# Payload (de)serialization
# ---------------------------------------------------------------------------

def table_to_ipc(table: pa.Table) -> bytes:
    buf = io.BytesIO()
    with pa.ipc.new_stream(buf, table.schema) as w:
        w.write_table(table)
    return buf.getvalue()


def ipc_to_table(data: bytes) -> pa.Table:
    with pa.ipc.open_stream(io.BytesIO(data)) as r:
        return r.read_all()


def encode_eval(spec: dict, table: pa.Table) -> bytes:
    """One EVAL payload: plain-pickled envelope; the user function
    inside `spec` is already a pickled BLOB (bytes, cloudpickle's where
    it is installed), so the envelope itself decodes with pickle
    alone."""
    return pickle.dumps({"spec": spec, "arrow": table_to_ipc(table)},
                        protocol=pickle.HIGHEST_PROTOCOL)


def decode_eval(payload: bytes) -> Tuple[dict, pa.Table]:
    env = pickle.loads(payload)
    return env["spec"], ipc_to_table(env["arrow"])


def encode_error(exc: BaseException, tb_text: str) -> bytes:
    return pickle.dumps({"etype": type(exc).__name__,
                         "message": str(exc)[:2000],
                         "traceback": tb_text[:8000]},
                        protocol=pickle.HIGHEST_PROTOCOL)


def decode_error(payload: bytes) -> dict:
    return pickle.loads(payload)
