"""UDF worker child: the out-of-process `pyspark/worker.py:504` loop
(the port of `spark_tpu/udf_worker/worker.py`).

Spawned as ``sys.executable <this file>`` by the pool (never ``-m``,
never `multiprocessing`): the child must NOT import torch or
spark_tpu_torch — the package __init__ imports torch, which costs a
second or more of every spawn, and a worker must never touch the card
(nor inherit the parent's CUDA context, as a forked child would).
protocol.py is loaded by file path for the same reason; the only
imports are stdlib + numpy/pandas/pyarrow (and cloudpickle, when the
user function was shipped with it).

Loop: read one frame from stdin; PING answers PONG (the spawn
handshake the pool times); EVAL deserializes the Arrow batch, applies
the user function (scalar row loop, vectorized pandas, or grouped-map
— NULL semantics exactly matching the in-process lane in
spark_tpu_torch/udf.py), and streams the typed result columns back as a
RESULT frame. A raising user function answers an ERROR frame carrying
the USER traceback captured here — the parent re-raises it as the
structured UdfError, so the caller sees the line in their lambda,
not the pool's framing stack. EOF on stdin exits cleanly (idle reap).
"""

from __future__ import annotations

import importlib.util
import os
import pickle
import sys
import traceback

import numpy as np
import pandas as pd
import pyarrow as pa


def _load_protocol():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "protocol.py")
    spec = importlib.util.spec_from_file_location("udf_worker_protocol",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: scalar return-type name -> numpy dtype (the worker-side mirror of
#: udf.py result_to_arrow's mapping; type NAMES cross the pipe, never
#: the engine's type objects)
_NP_TYPES = {"long": np.int64, "int": np.int32, "double": np.float64,
             "float": np.float32, "boolean": np.bool_}

_PA_TYPES = {np.dtype(np.int64): pa.int64(),
             np.dtype(np.int32): pa.int32(),
             np.dtype(np.float64): pa.float64(),
             np.dtype(np.float32): pa.float32(),
             np.dtype(np.bool_): pa.bool_()}


def _column_to_args(col: pa.ChunkedArray):
    """Arrow column -> (host array, validity|None), reconstructing the
    exact representation the in-process lane's _vec_to_host produces:
    object arrays for string/date/timestamp/decimal, typed numpy for
    the rest, validity split out — so both lanes run the user function
    over identical values and stay byte-parity."""
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    valid = None
    if arr.null_count:
        valid = ~np.asarray(arr.is_null())
    t = arr.type
    if (pa.types.is_string(t) or pa.types.is_large_string(t)
            or pa.types.is_date(t) or pa.types.is_timestamp(t)
            or pa.types.is_decimal(t) or pa.types.is_dictionary(t)
            or pa.types.is_null(t)):
        data = np.array(arr.to_pylist(), dtype=object)
    elif pa.types.is_boolean(t):
        data = np.asarray(arr.fill_null(False) if arr.null_count else arr)
    elif pa.types.is_floating(t):
        data = (arr.fill_null(0.0) if arr.null_count else arr).to_numpy(
            zero_copy_only=False)
    else:
        data = (arr.fill_null(0) if arr.null_count else arr).to_numpy(
            zero_copy_only=False)
    return data, valid


def _evaluate(fn, vectorized: bool, name: str, arg_arrays, arg_valids,
              n_rows: int):
    """The udf.evaluate_udf loop, verbatim semantics: scalar
    UDFs get Python None for NULLs and may return None; pandas UDFs
    get Series with the invalid slots masked."""
    if vectorized:
        series = []
        for a, v in zip(arg_arrays, arg_valids):
            s = pd.Series(a)
            if v is not None:
                s = s.where(pd.Series(v))
            series.append(s)
        out = fn(*series)
        if not isinstance(out, pd.Series):
            out = pd.Series(out)
        if len(out) != n_rows:
            raise RuntimeError(
                f"pandas UDF {name!r} returned {len(out)} rows "
                f"for {n_rows} input rows")
        valid = ~out.isna().to_numpy()
        return out, valid
    results = []
    valid = np.ones(n_rows, dtype=bool)
    for i in range(n_rows):
        args = []
        for a, v in zip(arg_arrays, arg_valids):
            if v is not None and not v[i]:
                args.append(None)
            else:
                x = a[i]
                args.append(x.item() if isinstance(x, np.generic) else x)
        r = fn(*args)
        if r is None:
            valid[i] = False
            results.append(None)
        else:
            results.append(r)
    return results, valid


def _result_array(rt_name: str, values, valid) -> pa.Array:
    """udf.result_to_arrow, keyed by type name."""
    if isinstance(values, pd.Series):
        values = values.to_numpy(dtype=object, na_value=None)
    cleaned = [None if not v else x for x, v in zip(values, valid)]
    if rt_name == "string":
        return pa.array([None if c is None else str(c) for c in cleaned],
                        type=pa.string())
    if rt_name == "date":
        return pa.array(cleaned, type=pa.date32())
    return pa.array(cleaned, type=_PA_TYPES[np.dtype(_NP_TYPES[rt_name])])


def _eval_batch(spec: dict, table: pa.Table) -> pa.Table:
    n = table.num_rows
    cols, names = [], []
    for i, u in enumerate(spec["udfs"]):
        fn = pickle.loads(u["fn"])
        arg_arrays, arg_valids = [], []
        for j in range(u["n_args"]):
            data, valid = _column_to_args(table.column(f"u{i}_a{j}"))
            arg_arrays.append(data)
            arg_valids.append(valid)
        values, valid = _evaluate(fn, u["vectorized"], u["name"],
                                  arg_arrays, arg_valids, n)
        cols.append(_result_array(u["rt"], values, valid))
        names.append(f"__udf_{spec['base'] + i}")
    return pa.table(cols, names=names)


def _eval_grouped(spec: dict, table: pa.Table) -> pa.Table:
    fn = pickle.loads(spec["fn"])
    out = fn(table.to_pandas().reset_index(drop=True))
    if not isinstance(out, pd.DataFrame):
        raise RuntimeError(
            f"grouped-map function returned {type(out).__name__}, "
            f"expected a pandas DataFrame")
    out = out[list(spec["fields"])]
    return pa.Table.from_pandas(out, preserve_index=False)


def main() -> int:
    proto = _load_protocol()
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    # anything user code prints must not corrupt the frame stream:
    # repoint fd 1 at stderr, keep the REAL stdout pipe privately
    stdout_fd = os.dup(sys.stdout.fileno())
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    out = os.fdopen(stdout_fd, "wb")
    while True:
        try:
            ftype, payload = proto.read_frame(stdin)
        except EOFError:
            return 0  # parent closed stdin: clean idle-reap exit
        if ftype == proto.FRAME_PING:
            proto.write_frame(out, proto.FRAME_PONG, b"")
            continue
        if ftype != proto.FRAME_EVAL:
            proto.write_frame(out, proto.FRAME_ERROR, proto.encode_error(
                RuntimeError(f"unexpected frame {ftype!r}"), ""))
            continue
        try:
            spec, table = proto.decode_eval(payload)
            if spec.get("kind") == "grouped_map":
                result = _eval_grouped(spec, table)
            else:
                result = _eval_batch(spec, table)
            proto.write_frame(out, proto.FRAME_RESULT,
                              proto.table_to_ipc(result))
        except BaseException as e:  # noqa: BLE001 — shipped to parent
            proto.write_frame(out, proto.FRAME_ERROR,
                              proto.encode_error(e, traceback.format_exc()))


if __name__ == "__main__":
    sys.exit(main())
