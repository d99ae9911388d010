"""Dense group-by sums: the hand-written CUDA kernels and their plain
PyTorch version (the counterpart of `spark_tpu/execution/pallas_groupby.py`).

`dense_groupby_sums(idx, int_rows, float_rows, domain)` returns exact
per-slot sums: int64 rows summed mod 2^64, float64 rows in float64, and
rows whose `idx` lies outside [0, domain) dropped. On CUDA tensors it
runs the launches that `plan_launches` lays out over the two kernels in
`csrc/dense_groupby.cu`:

- `dense_sums_smem` for domains of at most 512 slots (int and float
  rows), replacing `pallas_groupby._small_kernel` (:93). The kernel is
  bound by the bytes it reads, and has two variants, picked by domain:
  `private` (a thread-private column of shared memory per thread: no
  atomics, no warp votes) up to PRIVATE_DOMAIN slots, and `shared` (a
  table per warp with shared-memory atomics for ints and a fixed lane
  order for floats) above. Each block reduces its tables
  in a fixed order and float partials are summed in block order by a
  second kernel, so float sums repeat bit for bit between runs.
- `dense_sums_global` for 512 < domain <= 2^20 (int rows only): 64-bit
  atomics straight into the output; replaces
  `pallas_groupby._factored_kernel` (:162).

`plan_launches(domain, n_int, n_float)` is plain Python: it picks the
variant and cuts the rows into launches whose shared memory fits a
block's 227 KB. The source file's header says what bounds each variant on
an H100 and how the design answers it. On CPU tensors the wrapper runs
`dense_groupby_sums_plain` (`index_add_` with out-of-range rows masked),
the same function the kernels are held against; a CUDA tensor gets the
kernel or an exception, never the plain version.

The kernels are compiled on first use with `nvcc` into `_build/` next
to the package (a shared library with a plain C interface, loaded with
ctypes), so a checkout needs only the CUDA toolkit to run them.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

#: launches per kernel since the process started (or the caller reset
#: them); each wrapper adds one exactly where it launches its kernel
LAUNCHES = {"dense_sums_smem": 0, "dense_sums_global": 0}

#: the same launches by (kernel, CUDA device index): on a mesh each
#: shard launches on its own card
DEVICE_LAUNCHES = {}

#: the shards of a mesh launch from their own threads at once: the
#: counters take this lock, and so does each launch call, since
#: `dense_sums_smem` sets its kernel's dynamic shared-memory attribute
#: (a per-device setting, not a per-thread one) just before launching
_LAUNCH_LOCK = threading.Lock()


def _count_launch(kernel: str, device: torch.device) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[kernel] += 1
        key = (kernel, device.index)
        DEVICE_LAUNCHES[key] = DEVICE_LAUNCHES.get(key, 0) + 1

PRIVATE_DOMAIN = 48        # private variant: largest domain (chip_smoke.py
                           # phase 4 times it against shared around here)
SMEM_DOMAIN = 512          # shared variant (and dense_sums_smem): largest
MAX_DOMAIN = 1 << 20       # dense_sums_global: largest domain
MAX_ROWS_PER_LAUNCH = 32   # row pointers in one launch
SMEM_BUDGET = 227 * 1024   # shared memory one block may use on an H100
PRIVATE_WARPS = 16         # private: most warps in a block
PRIVATE_BLOCK_BYTES = 100 * 1024  # private: table bytes aimed at per block
SHARED_WARPS = 4           # shared: warps per block
SHARED_WARP_BYTES = 16 * 1024     # shared: most table bytes per warp
#: largest domain each variant is built for (the planner's cut-offs above
#: may be lower; `plan_variant` can still lay out any of these)
VARIANT_MAX_DOMAIN = {"private": 64, "shared": SMEM_DOMAIN,
                      "global": MAX_DOMAIN}
_VARIANT_CODE = {"private": 0, "shared": 1}

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dense_groupby.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libdense_groupby.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lib_lock = threading.Lock()


@dataclass(frozen=True)
class Launch:
    """One kernel launch: the variant, the int and float rows it sums
    (positions in the caller's lists), warps per block and the shared
    memory of one block (both 0 for `global`, which sets its own)."""
    variant: str
    ints: range
    floats: range
    warps: int
    smem_bytes: int


def smem_bytes(variant: str, domain: int, n_rows: int, warps: int) -> int:
    """Shared memory of one block; `dense_sums_smem_bytes` in the CUDA
    source computes the same."""
    if variant == "private":
        return warps * domain * 8 + warps * 32 * domain * 8
    if variant == "shared":
        return warps * n_rows * domain * 8
    return 0


def plan_variant(variant: str, domain: int, n_int: int, n_float: int
                 ) -> List[Launch]:
    """The launches of one variant for `n_int` int rows and `n_float`
    float rows at this domain, whichever variant `plan_launches` would
    pick. Rows go in order, ints first, in launches of near-equal size."""
    if variant not in VARIANT_MAX_DOMAIN:
        raise ValueError(f"unknown variant {variant!r}")
    if domain < 1 or domain > VARIANT_MAX_DOMAIN[variant]:
        raise ValueError(f"{variant} takes domains up to "
                         f"{VARIANT_MAX_DOMAIN[variant]}, not {domain}")
    if variant == "global":
        if n_float:
            raise ValueError("dense_sums_global takes int rows only")
        return [Launch("global", range(c, min(c + MAX_ROWS_PER_LAUNCH, n_int)),
                       range(0), 0, 0)
                for c in range(0, n_int, MAX_ROWS_PER_LAUNCH)]
    if variant == "shared":
        per_launch = min(MAX_ROWS_PER_LAUNCH, SHARED_WARP_BYTES // (8 * domain))
    else:
        per_launch = min(PRIVATE_WARPS, PRIVATE_BLOCK_BYTES // (33 * 8 * domain))
    per_launch = max(1, per_launch)
    total = n_int + n_float
    if total == 0:
        return []
    chunks = -(-total // per_launch)
    plan, start = [], 0
    for c in range(chunks):
        stop = start + total // chunks + (1 if c < total % chunks else 0)
        rows = stop - start
        # private: one warp per row, or per part of a row
        warps = SHARED_WARPS if variant == "shared" else \
            rows * (per_launch // rows)
        plan.append(Launch(
            variant, range(min(start, n_int), min(stop, n_int)),
            range(max(start, n_int) - n_int, max(stop, n_int) - n_int),
            warps, smem_bytes(variant, domain, rows, warps)))
        start = stop
    return plan


def plan_launches(domain: int, n_int: int, n_float: int) -> List[Launch]:
    """The launches `dense_groupby_sums` makes on a CUDA tensor: the
    variant by domain (cut-offs PRIVATE_DOMAIN and SMEM_DOMAIN), then
    `plan_variant`."""
    if domain <= PRIVATE_DOMAIN:
        variant = "private"
    elif domain <= SMEM_DOMAIN:
        variant = "shared"
    else:
        variant = "global"
    return plan_variant(variant, domain, n_int, n_float)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH) — the CUDA group-by kernels cannot be built")
    return path


def build(force: bool = False) -> Tuple[Path, float, str]:
    """Compile `csrc/dense_groupby.cu` for sm_90a into `_build/` unless an
    up-to-date library is there. Returns (library, seconds, compiler
    output); seconds is 0 when nothing was built."""
    if not force and LIBRARY.exists() and \
            LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, LIBRARY)
    return LIBRARY, seconds, log


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            ptrs = ctypes.POINTER(ctypes.c_void_p)
            lib.dense_sums_smem.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ptrs, ctypes.c_int, ptrs, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
            lib.dense_sums_smem.restype = ctypes.c_int
            lib.dense_sums_smem_bytes.argtypes = [ctypes.c_int] * 4
            lib.dense_sums_smem_bytes.restype = ctypes.c_longlong
            lib.dense_sums_global.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ptrs, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.dense_sums_global.restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr_array(tensors: Sequence[torch.Tensor]):
    arr = (ctypes.c_void_p * max(1, len(tensors)))()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, n: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, idx on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """`t`, or a copy of it when its data does not start on an `nbytes`
    boundary (the kernels load idx as 8-byte pairs, values as 16-byte)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def dense_groupby_sums_plain(idx: torch.Tensor, int_rows: Sequence,
                             float_rows: Sequence, domain: int
                             ) -> Tuple[List, List]:
    """Plain PyTorch version: `index_add_` into domain + 1 slots, the last
    one catching every out-of-range row, then dropped."""
    slot = torch.where((idx >= 0) & (idx < domain), idx,
                       torch.full_like(idx, domain)).long()

    def sums(r, dtype):
        out = torch.zeros(domain + 1, dtype=dtype, device=idx.device)
        return out.index_add_(0, slot, r.to(dtype))[:domain]

    return ([sums(r, torch.int64) for r in int_rows],
            [sums(r, torch.float64) for r in float_rows])


def dense_groupby_sums(idx: torch.Tensor, int_rows: Sequence,
                       float_rows: Sequence, domain: int,
                       int_widths: Optional[Sequence[int]] = None
                       ) -> Tuple[List, List]:
    """Exact per-group sums.

    idx: int32[N]; rows with idx outside [0, domain) are dropped.
    int_rows: int64[N] each; float_rows: float64[N] each.
    Returns ([int64[domain]], [float64[domain]]).

    `int_widths` is accepted for the JAX package's signature and not
    needed: that kernel splits int64 values into as few 8-bit limbs as
    each row's width allows, while these kernels add whole int64 values.

    CPU tensors go to `dense_groupby_sums_plain`; CUDA tensors run the
    launches of `plan_launches`: `dense_sums_smem` (domain <= 512) or
    `dense_sums_global` (int rows only, domain <= 2^20)."""
    if domain < 1 or domain > MAX_DOMAIN:
        raise ValueError(f"domain {domain} outside [1, {MAX_DOMAIN}]")
    if float_rows and domain > SMEM_DOMAIN:
        raise ValueError("float rows unsupported for large domains "
                         "(caller must fall back to scatter)")
    if idx.device.type == "cpu":
        return dense_groupby_sums_plain(idx, int_rows, float_rows, domain)
    if not idx.is_cuda:
        raise ValueError(f"dense_groupby_sums: unsupported device {idx.device}")
    return run_plan(plan_launches(domain, len(int_rows), len(float_rows)),
                    idx, int_rows, float_rows, domain)


def run_plan(plan: Sequence[Launch], idx: torch.Tensor, int_rows: Sequence,
             float_rows: Sequence, domain: int) -> Tuple[List, List]:
    """Runs the launches of `plan` (from `plan_launches`, or
    `plan_variant` to time one variant against another) on CUDA
    tensors and returns the sums as `dense_groupby_sums` does."""
    if not idx.is_cuda:
        raise ValueError(f"run_plan: idx is on {idx.device}, not CUDA")
    n = idx.shape[0] if idx.dim() == 1 else -1
    _check("idx", idx, torch.int32, n, idx.device)
    for k, r in enumerate(int_rows):
        _check(f"int_rows[{k}]", r, torch.int64, n, idx.device)
    for k, r in enumerate(float_rows):
        _check(f"float_rows[{k}]", r, torch.float64, n, idx.device)
    # ints accumulate with atomics into zeros; every float row that a
    # launch sums is written whole by its combine kernel
    int_out = torch.zeros((len(int_rows), domain), dtype=torch.int64,
                          device=idx.device)
    run = n > 0 and bool(plan)
    float_out = (torch.empty if run else torch.zeros)(
        (len(float_rows), domain), dtype=torch.float64, device=idx.device)
    if run:
        launch_plan(plan, idx, int_rows, float_rows, domain, int_out,
                    float_out)
    return list(int_out.unbind(0)), list(float_out.unbind(0))


def launch_plan(plan: Sequence[Launch], idx: torch.Tensor,
                int_rows: Sequence, float_rows: Sequence, domain: int,
                int_out: torch.Tensor, float_out: torch.Tensor) -> None:
    """The launches of `plan` alone, into outputs the caller allocated:
    the kernels add the int sums into `int_out` (int64 [rows, domain]) and
    write `float_out` (float64 [rows, domain]) whole. `run_plan` checks
    the inputs and allocates; a timer calls this to see only the
    kernels."""
    lib = _load()
    n = idx.shape[0]
    idx = _aligned(idx, 8)
    ints = [_aligned(r, 16) for r in int_rows]
    floats = [_aligned(r, 16) for r in float_rows]
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        sms = _sm_count(idx.device)
        for launch in plan:
            _launch(lib, launch, idx, n, domain, ints, floats, int_out,
                    float_out, stream, sms)


def _launch(lib, launch: Launch, idx, n, domain, int_rows, float_rows,
            int_out, float_out, stream, sms) -> None:
    ints = [int_rows[k] for k in launch.ints]
    if launch.variant == "global":
        with _LAUNCH_LOCK:
            rc = lib.dense_sums_global(idx.data_ptr(), n, domain,
                                       _ptr_array(ints), len(ints),
                                       int_out[launch.ints.start].data_ptr(),
                                       stream)
        if rc != 0:
            raise RuntimeError(f"dense_sums_global launch failed: {rc}")
        _count_launch("dense_sums_global", idx.device)
        return
    floats = [float_rows[k] for k in launch.floats]
    # block partials of the float rows: at most as many blocks as the
    # SMs can hold at once (32 blocks or 2048 threads each)
    scratch = torch.empty(
        (sms * min(32, 2048 // (32 * launch.warps)) * len(floats) * domain,),
        dtype=torch.float64, device=idx.device) if floats else None
    with _LAUNCH_LOCK:
        rc = lib.dense_sums_smem(
            idx.data_ptr(), n, domain, _ptr_array(ints), len(ints),
            _ptr_array(floats), len(floats),
            _VARIANT_CODE[launch.variant], launch.warps,
            int_out[launch.ints.start].data_ptr() if ints else None,
            float_out[launch.floats.start].data_ptr() if floats else None,
            scratch.data_ptr() if floats else None,
            scratch.numel() if floats else 0, stream)
    if rc != 0:
        raise RuntimeError(f"dense_sums_smem ({launch.variant}) launch "
                           f"failed: {rc}")
    _count_launch("dense_sums_smem", idx.device)
