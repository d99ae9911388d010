"""Bounded in-memory per-query detail store behind the history API
(the port of `spark_tpu/service/query_history.py`).

The SQLAppStatusStore seat of the reference's UI/HistoryServer stack:
the service's status registry (`SqlService._records`) holds the light
lifecycle record every client polls, while THIS store holds the heavy
post-execution detail the timeline/plan endpoints serve — phase spans,
per-attempt device-memory records (`observability/device_cost.py`: the
JAX package's stage fields, `peak_hbm_bytes` measured by the CUDA
caching allocator), per-shard flight-recorder records,
the runtime-annotated plan tree — fed by the pooled sessions' status
listener at `on_query_end` (the same bus event the event-log writer
consumes, so a running service is debuggable over HTTP without
scraping JSONL files).

Entries are JSON-ready dicts keyed by the SERVICE query id; the store
is bounded (`spark_tpu.service.historySize`) and evicts oldest-first —
detail records are much heavier than status records, hence the
separate, smaller bound.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional

HISTORY_SIZE_KEY = "spark_tpu.service.historySize"


class QueryHistoryStore:
    def __init__(self, max_entries: int = 128):
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()

    def put(self, query_id: str, detail: Dict) -> None:
        with self._lock:
            self._entries[query_id] = detail
            self._entries.move_to_end(query_id)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def get(self, query_id: str) -> Optional[Dict]:
        with self._lock:
            return self._entries.get(query_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def detail_from_event(event) -> Dict:
    """Shape one QueryEndEvent into the stored detail dict (everything
    the timeline/plan endpoints serve, already JSON-serializable — the
    event record is the same dict the event-log line is written from)."""
    ev = event.event or {}
    return {
        "engine_query_id": event.query_id,
        "status": event.status,
        "ts": ev.get("ts"),
        "plan": ev.get("plan"),
        "plan_tree": ev.get("plan_tree"),
        "phase_times_s": ev.get("phase_times_s"),
        "spans": ev.get("spans") or [],
        "stages": ev.get("stages") or [],
        "shards": ev.get("shards") or [],
        "metrics": ev.get("metrics") or {},
        "predictions": ev.get("predictions") or [],
        "reorder": ev.get("reorder"),
        "analysis_findings": ev.get("analysis_findings") or [],
        "fault_summary": ev.get("fault_summary"),
        "error": ev.get("error"),
    }
