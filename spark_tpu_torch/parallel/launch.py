"""Start a cluster of engine processes on one host and collect what each
returns (the launcher the cluster's tests and `chip_smoke.py` use).

    from spark_tpu_torch.parallel.launch import run_cluster
    results = run_cluster("mymod:run", 2, "/tmp/run", device="cuda:0")

`run_cluster` starts P fresh interpreters (never forks of a process that
holds a CUDA context), each with the three `spark_tpu.sql.cluster.*`
keys (a free coordinator port on 127.0.0.1, P, its rank) and its
device: a pinned device (`device`, every process on it) or
the cards `visible_devices[rank]` names (CUDA_VISIBLE_DEVICES). Each
process builds a session, joins the cluster (`init_distributed`), and
calls `program(session, proc)`: `proc` holds the rank, the caller's
`args`, a `report` dict the program fills, `mark(name)`, which leaves a
file the parent can wait for, and `save(results)`, which writes what the
parent reads before the process is killed. What the program returns (a dict
of name -> `pyarrow.Table`) is written as Arrow IPC files beside a JSON
report: the rank, pid, device, init and spawn-to-ready seconds, the
tensor backends, the kernel launches, the bytes that crossed processes,
the JAX modules loaded (none may be), and the error, if the program
raised.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import pyarrow as pa

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A port free on 127.0.0.1 now (bound to port 0 and released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class ProcessResult:
    rank: int
    returncode: Optional[int]
    report: Dict = field(default_factory=dict)
    results: Dict[str, pa.Table] = field(default_factory=dict)
    log: str = ""
    #: seconds from the spawn to the process's exit (None: killed at the
    #: limit)
    wall_s: Optional[float] = None


def run_cluster(program: str, processes: int, out_dir: str,
                device: Optional[str] = None,
                visible_devices: Optional[Sequence[str]] = None,
                args=None, timeout_s: float = 600.0,
                pythonpath: Sequence[str] = (),
                kill_at: Optional[tuple] = None) -> List[ProcessResult]:
    """Run `program` ("module:function") in `processes` engine processes
    joined as one cluster; returns each one's result, by rank.

    A program sets its session's conf from `proc.args`; `kill_at` (rank,
    mark name, delay seconds) kills that rank with SIGKILL the delay
    after it makes that mark. Every process is gone when this returns:
    one still running at `timeout_s` is killed."""
    os.makedirs(out_dir, exist_ok=True)
    coordinator = f"127.0.0.1:{free_port()}"
    base = dict(os.environ)
    paths = [_REPO] + list(pythonpath)
    if base.get("PYTHONPATH"):
        paths.append(base["PYTHONPATH"])
    base["PYTHONPATH"] = os.pathsep.join(paths)
    procs, logs = [], []
    t0 = time.time()
    for rank in range(processes):
        rank_dir = os.path.join(out_dir, f"r{rank}")
        os.makedirs(rank_dir, exist_ok=True)
        e = dict(base)
        e["SPARK_TPU_LAUNCH_T0"] = repr(time.time())
        if visible_devices is not None:
            e["CUDA_VISIBLE_DEVICES"] = str(visible_devices[rank])
        cmd = [sys.executable, "-m", "spark_tpu_torch.parallel.launch",
               "--child", "--program", program, "--rank", str(rank),
               "--processes", str(processes), "--coordinator", coordinator,
               "--out", rank_dir, "--args-json", json.dumps(args)]
        if device is not None:
            cmd += ["--device", device]
        log = open(os.path.join(rank_dir, "process.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=e, stdout=log,
                                      stderr=subprocess.STDOUT,
                                      stdin=subprocess.DEVNULL))
    walls: List[Optional[float]] = [None] * processes
    killed_at = None
    try:
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                break
            if kill_at is not None and killed_at is None:
                rank, mark, delay = kill_at
                if os.path.exists(os.path.join(out_dir, f"r{rank}",
                                               f"mark-{mark}")):
                    time.sleep(delay)
                    procs[rank].send_signal(signal.SIGKILL)
                    killed_at = time.time()
            for r, p in enumerate(procs):
                if walls[r] is None and p.poll() is not None:
                    walls[r] = time.time() - t0
            time.sleep(0.02)
        for r, p in enumerate(procs):
            if walls[r] is None and p.poll() is not None:
                walls[r] = time.time() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    out = []
    for rank, p in enumerate(procs):
        rank_dir = os.path.join(out_dir, f"r{rank}")
        res = ProcessResult(rank, p.returncode, wall_s=walls[rank])
        path = os.path.join(rank_dir, "report.json")
        if os.path.exists(path):
            with open(path) as f:
                res.report = json.load(f)
        for name in res.report.get("results", []):
            with pa.OSFile(os.path.join(rank_dir, f"{name}.arrow")) as f:
                res.results[name] = pa.ipc.open_file(f).read_all()
        with open(os.path.join(rank_dir, "process.log")) as f:
            res.log = f.read()[-20000:]
        if killed_at is not None and kill_at[0] == rank:
            res.report.setdefault("killed_at", killed_at)
        out.append(res)
    return out


class Proc:
    """What a program gets besides its session."""

    def __init__(self, rank: int, out_dir: str, args, report: Dict):
        self.rank = rank
        self.out_dir = out_dir
        self.args = args
        #: the report written at exit (and by `save`); the program adds
        #: JSON-able fields
        self.report = report

    def mark(self, name: str) -> None:
        with open(os.path.join(self.out_dir, f"mark-{name}"), "w") as f:
            f.write(repr(time.time()))

    def save(self, results: Dict[str, pa.Table]) -> None:
        """Write `results` and the report now, as at exit: what the parent
        reads of a process it then kills."""
        for name, table in results.items():
            with pa.OSFile(os.path.join(self.out_dir, f"{name}.arrow"),
                           "wb") as f:
                with pa.ipc.new_file(f, table.schema) as w:
                    w.write_table(table)
        self.report["results"] = sorted(results)
        from ..execution import dense_groupby as D
        from .cluster import CLUSTER_STATS, current
        from .mesh import COPY_STATS
        cl = current()
        self.report["backends"] = [] if cl is None else \
            list(cl.backends_used)
        self.report["launches"] = dict(D.LAUNCHES)
        self.report["cluster_stats"] = {k: list(v)
                                        for k, v in CLUSTER_STATS.items()}
        self.report["copy_stats"] = {k: list(v)
                                     for k, v in COPY_STATS.items()}
        self.report["bad_modules"] = sorted(
            m for m in sys.modules if m in ("jax", "spark_tpu")
            or m.startswith(("jax.", "spark_tpu.")))
        tmp = os.path.join(self.out_dir, "report.json.tmp")
        with open(tmp, "w") as f:
            json.dump(self.report, f, default=str)
        os.replace(tmp, os.path.join(self.out_dir, "report.json"))


def _child(ns) -> int:
    t_spawn = float(os.environ.get("SPARK_TPU_LAUNCH_T0", time.time()))
    proc = Proc(ns.rank, ns.out, json.loads(ns.args_json),
                {"rank": ns.rank, "pid": os.getpid()})
    report = proc.report
    results: Dict[str, pa.Table] = {}
    code = 0
    try:
        from .. import SparkTpuSession
        from . import cluster, mesh
        builder = SparkTpuSession.builder()
        if ns.device:
            builder = builder.device(ns.device)
        builder = builder.config(cluster.COORDINATOR_KEY, ns.coordinator) \
            .config(cluster.NUM_PROCESSES_KEY, ns.processes) \
            .config(cluster.PROCESS_ID_KEY, ns.rank)
        session = builder.get_or_create()
        report["device"] = str(session.device)
        pinned = session.device if session.device_pinned else None
        report["global_devices"] = mesh.init_distributed(
            session.conf, pinned, mesh.pinned_pool_size(session.conf))
        report["init_s"] = cluster.current().init_s
        report["ready_s"] = time.time() - t_spawn
        module, fn = ns.program.split(":")
        results = getattr(importlib.import_module(module), fn)(
            session, proc) or {}
    except BaseException as e:  # noqa: BLE001 — reported, then exit 1
        report["error"] = {"type": type(e).__name__, "message": str(e),
                           "traceback": traceback.format_exc()[-4000:]}
        code = 1
    proc.save(results)
    from .cluster import current
    cl = current()
    if cl is not None and cl.lost:
        # the groups of a cluster that lost a peer cannot be torn down
        # with it (a teardown may wait on the peer): leave without it
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    return code


def main(argv=None) -> int:
    """The engine process's entry point (`run_cluster` starts it as
    `python -m spark_tpu_torch.parallel.launch --child ...`)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", action="store_true", required=True)
    ap.add_argument("--program", required=True)
    ap.add_argument("--processes", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="")
    ap.add_argument("--args-json", default="null")
    return _child(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
