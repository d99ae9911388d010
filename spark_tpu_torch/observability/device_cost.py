"""Device-memory accounting per executed attempt (the port's
counterpart of `spark_tpu/observability/xla_cost.py`).

The JAX package reads XLA's `cost_analysis()`/`memory_analysis()` off
the AOT-compiled stage. Eager torch compiles no stage, so there is no
such analysis and no count of flops or bytes accessed; this module
records what the CUDA caching allocator measures instead, per executed
attempt of a query's plan:

- `peak_hbm_bytes`: `torch.cuda.max_memory_allocated` after a
  `reset_peak_memory_stats` at the attempt's start, minus the bytes
  allocated at that start — the attempt's own working memory above
  what was resident (the loaded scans, the device table cache);
- `argument_bytes`: the bytes of the loaded scans the attempt read
  (the `argument_size_in_bytes` of the JAX package's analysis);
- `output_bytes`: the result batch's bytes (`output_size_in_bytes`).

The event fields are the JAX package's (`history.hbm_summary` and
`compile_summary` read them). Capture is gated by the same key and
meaning, `spark_tpu.sql.observability.xlaCost`: 'on' always, 'off'
never, 'auto' when an observability output is configured or the OOM
ladder is descending. On the CPU it records nothing and says why in
`memory_error`, as the JAX package does for a backend whose memory
analysis cannot answer.

The peak statistics are per device, not per thread: on a mesh whose
shards share one card the peak is the card's, for all shards, so the
capture resets once per attempt, before the shard threads start, and
on a mesh of several cards it takes the largest card's. Nothing here
catches an error of the query: only reading the statistics is guarded.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import torch

#: why a CPU attempt carries no measurement
CPU_REASON = ("device memory statistics are CUDA-only "
              "(torch.cuda.max_memory_allocated); a CPU attempt "
              "records none")


def batch_bytes(batch) -> int:
    """Device bytes of a columnar Batch: every column's data, validity,
    list offsets and element validity, and the selection mask. A join's
    lazily gathered column counts the bytes its gather will write, and
    is not gathered here."""
    total = 0
    for c in batch.columns.values():
        data = c._data
        if data is None and c.prov is not None:
            base, idx = c.prov[0], c.prov[2]
            total += idx.numel() * base.element_size()
        tensors = (data, c._validity, c.offsets, c.elem_validity)
        for t in tensors:
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    sel = batch.selection
    if isinstance(sel, torch.Tensor):
        total += sel.numel() * sel.element_size()
    return total


class AttemptCost:
    """One attempt's capture: construct at the attempt's start (it
    resets the peak statistics of every CUDA device in `devices`), call
    `finish` after the attempt's device work is done."""

    def __init__(self, devices: Iterable):
        self.t0 = time.perf_counter()
        self.devices = []
        for d in devices:
            d = torch.device(d)
            if d not in self.devices:
                self.devices.append(d)
        self.cuda = [d for d in self.devices if d.type == "cuda"]
        self.base: Dict[torch.device, int] = {}
        for d in self.cuda:
            torch.cuda.reset_peak_memory_stats(d)
            self.base[d] = torch.cuda.memory_allocated(d)

    def finish(self, argument_bytes: int, output_bytes: int) -> Dict:
        """The attempt's stage-cost record (without its key fields)."""
        out: Dict = {}
        if not self.cuda:
            out["memory_error"] = CPU_REASON
        else:
            try:
                peaks = [torch.cuda.max_memory_allocated(d) - self.base[d]
                         for d in self.cuda]
                out["peak_hbm_bytes"] = int(max(peaks))
                out["argument_bytes"] = int(argument_bytes)
                out["output_bytes"] = int(output_bytes)
                out["devices"] = [str(d) for d in self.cuda]
            except Exception as e:  # noqa: BLE001 — reading stats only
                out["memory_error"] = f"{type(e).__name__}: {e}"[:160]
        out["analysis_ms"] = round((time.perf_counter() - self.t0) * 1e3, 1)
        return out


def device_hbm_capacity(device=None) -> Optional[int]:
    """Total memory of `device` (the current CUDA device by default) in
    bytes, from `torch.cuda.mem_get_info`; None on the CPU or without
    CUDA."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    try:
        return int(torch.cuda.mem_get_info(device)[1])
    except Exception:  # noqa: BLE001 — a backend that cannot answer
        return None
