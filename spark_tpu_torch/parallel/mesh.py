"""The mesh: the devices the engine schedules onto, and the rendezvous
its shards meet at (the port of `spark_tpu/parallel/mesh.py`).

One 1-D "data" axis, as in the JAX package. The JAX package runs one
process and `shard_map`s each stage over the mesh; every operator's
`compute(ctx, inputs)` then calls `lax` collectives on `ctx.axis_name`.
The port keeps that model in eager torch: `run_on_shards` runs one
Python thread per shard, each over its own stripe on its own device,
and the shards meet at a `ShardGroup` for every collective. The group is
a rendezvous among the threads; tensors move between cards with
`Tensor.to(device)`, which on one host is a peer copy (NVLink on an
H100 node). That is the counterpart of `shard_map`; `shard_batch_spec`
has no counterpart, since there is no `PartitionSpec`: the executor
pads each loaded leaf to a multiple of the shards and hands each shard
its contiguous stripe (`parallel/shuffle.py`).

Where the shards live: a session built without a device takes N
distinct cards, cuda:0 to cuda:N-1, and raises when fewer are visible;
a session built with one device (`device("cpu")`, `device("cuda:0")`)
places every shard on that device — the counterpart of the virtual CPU
devices the JAX package's tests force, reached only by naming the
device, never as a stand-in when cards are short.

What a mesh position's device id is (`Mesh.ids`, the ids
`spark_tpu.sql.mesh.excludeDevices` and a decommission name): on cards,
the CUDA ordinal. On a pinned mesh, a virtual id: the session's pool is
the virtual devices 0..P-1, P the largest mesh.size the session has run
(`pinned_pool`), and get_mesh takes the first mesh.size ids of that pool
that are not excluded. So a pinned session behaves as a host with P
devices, as the JAX package's tests' 8 virtual CPU devices do: at
mesh.size 8, excluding id 0 leaves a mesh of 7 (ids 1-7), excluding
0-6 leaves one device (no mesh), and draining position 3 excludes id 3,
lowers mesh.size to 7 and meshes over ids 0-2 and 4-7.

A shard that raises aborts the group, so the others leave their wait at
once (a waiting shard gets `MeshCollectiveError`); `run_on_shards` joins
every thread and raises the first error that is not such a consequence.
A rendezvous that times out breaks the group the same way.

Ordering of a peer copy: torch's copy between two cards runs on the
source card's current stream after a two-way event barrier between the
two cards' current streams (ATen's `copy_device_to_device`). Every shard
queues its work on its card's current stream, and the rendezvous orders
the host: a shard deposits its tensors only after queueing the work
that writes them. So each copy is ordered behind the source's work by
two CUDA events, with no host synchronise.

A mesh may span engine processes (`init_distributed`, the
`spark_tpu.sql.cluster.*` keys, `parallel/cluster.py`): every process
runs the same program, the global device list is every process's
devices ordered by process, then by local device, and the mesh takes its
first mesh.size positions. A position another process owns carries no
local device (`Mesh.devices[i]` is None); `run_on_shards` starts threads
for this process's positions only, and the group's collectives cross
processes through the cluster's process group. A position's device id
is then its index in that global list, so a drain and
`spark_tpu.sql.mesh.excludeDevices` name the same device in every
process: draining position 3 of two processes with two shards each
excludes global id 3 everywhere, lowers mesh.size to 3 in every process
and meshes over ids 0-2 (two positions in process 0, one in process 1).
A drain that would leave a process without a position is refused
(`elastic.pending_decommission`), as every process must drive a shard.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Set

import torch

AXIS = "data"

MESH_KEY = "spark_tpu.sql.mesh.size"
EXCLUDE_KEY = "spark_tpu.sql.mesh.excludeDevices"

#: seconds a shard waits at a rendezvous for the others before the group
#: breaks (a shard that raises breaks it at once)
RENDEZVOUS_TIMEOUT_S = 600.0


class MeshCollectiveError(RuntimeError):
    """A collective among the shards failed: the rendezvous broke (a
    peer shard raised, or the wait timed out) or a peer copy failed. The
    message holds "collective", the token `is_mesh_failure` reads."""


class Mesh:
    """The devices of the data axis, in shard order, with each position's
    device id (a card's ordinal, or a pinned mesh's virtual id; the
    position when not given). On a cluster each position also names the
    rank of the process that owns it (`ranks`), and a position another
    process owns has no local device (None)."""

    def __init__(self, devices: Sequence[Optional[torch.device]],
                 ids: Optional[Sequence[int]] = None,
                 ranks: Optional[Sequence[int]] = None, cluster=None,
                 backend: str = "local"):
        self.devices = tuple(None if d is None else torch.device(d)
                             for d in devices)
        self.ids = tuple(int(i) for i in ids) if ids is not None \
            else tuple(range(len(self.devices)))
        self.ranks = tuple(int(r) for r in ranks) if ranks is not None \
            else (0,) * len(self.devices)
        #: this process's `parallel.cluster.Cluster` (None: one process)
        self.cluster = cluster
        #: how tensors cross processes: "local" (one process), "gloo" or
        #: "nccl"
        self.backend = backend

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_positions(self) -> List[int]:
        """The positions this process drives, in order."""
        return [i for i, d in enumerate(self.devices) if d is not None]

    @property
    def local_devices(self) -> List[torch.device]:
        return [d for d in self.devices if d is not None]

    @property
    def rank_positions(self) -> List[List[int]]:
        """Per rank, the positions it owns (contiguous, in order)."""
        world = max(self.ranks) + 1 if self.ranks else 1
        return [[i for i, r in enumerate(self.ranks) if r == k]
                for k in range(world)]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={AXIS!r})"


def mesh_size(conf) -> int:
    return max(1, int(conf.get(MESH_KEY)))


def excluded_device_ids(conf) -> Set[int]:
    """Device ids never meshed over (spark_tpu.sql.mesh.excludeDevices).
    Malformed entries warn: a typo'd pin-out silently keeping the bad
    device in the mesh would be worse than noise."""
    spec = conf.get(EXCLUDE_KEY)
    out: Set[int] = set()
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.add(int(part))
        except ValueError:
            warnings.warn(f"ignoring non-integer entry {part!r} in "
                          f"device list {spec!r}")
    return out


def device_pool(device=None, pinned_pool: int = 0) -> List[int]:
    """The device ids a mesh may take: a pinned session's virtual ids
    0..pinned_pool-1, else the visible cards' ordinals."""
    if device is not None:
        return list(range(pinned_pool))
    return list(range(torch.cuda.device_count()
                      if torch.cuda.is_available() else 0))


def pinned_pool_size(conf) -> int:
    """The virtual devices a pinned session's process holds for a mesh
    of mesh.size: all of them in one process, its share
    (ceil(mesh.size / processes)) on a cluster. After a drain lowers
    mesh.size the session keeps its larger pool (`session.mesh_pool`
    holds the largest it ran), so the drained id stays in the global
    list, excluded, and the others keep their ids."""
    from .cluster import cluster_spec
    n = mesh_size(conf)
    spec = cluster_spec(conf)
    return n if spec is None else -(-n // spec[1])


def init_distributed(conf, device=None, pinned_pool: int = 0) -> int:
    """Join the cluster the `spark_tpu.sql.cluster.*` keys name, so the
    mesh spans every process's devices (the JAX package's
    `init_distributed`, over `torch.distributed`).

    Every process runs the SAME engine program, pointed at one
    coordinator:

        spark_tpu.sql.cluster.coordinator = host0:8476
        spark_tpu.sql.cluster.numProcesses = <processes>
        spark_tpu.sql.cluster.processId   = <this process's rank>

    Then set spark_tpu.sql.mesh.size to the GLOBAL device count. Returns
    the global device count (this process's local count without a
    coordinator); idempotent per process (`cluster.init`). A collective:
    every process calls it at the same point. `device` and `pinned_pool`
    name this process's pool as get_mesh takes them."""
    from . import cluster
    local = len(_local_pool(conf, device, pinned_pool))
    cl = cluster.init(conf, RENDEZVOUS_TIMEOUT_S)
    if cl is None:
        return local
    return sum(cl.all_gather_object(local, "init_distributed"))


def _local_pool(conf, device, pinned_pool: int) -> List[torch.device]:
    """This process's devices for a mesh: a pinned session's virtual
    devices (its pool, at least its share of mesh.size), else the
    visible cards."""
    if device is not None:
        return [torch.device(device)] * max(pinned_pool,
                                            pinned_pool_size(conf))
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(visible)]


def cluster_positions(pool_sizes: Sequence[int], n: int,
                      excluded: Set[int]) -> tuple:
    """The mesh a cluster forms from every process's pool size (in rank
    order): the global ids of its positions, the first n of the global
    pool that are not excluded, and each one's rank."""
    owner = [r for r, size in enumerate(pool_sizes) for _ in range(size)]
    chosen = [g for g in range(len(owner)) if g not in excluded][:n]
    return chosen, [owner[g] for g in chosen]


def _cluster_mesh(conf, cl, device, pinned_pool: int) -> Optional[Mesh]:
    """get_mesh on a cluster: the global list is every process's pool,
    ordered by rank (a position's id is its index there), and the mesh
    its first mesh.size positions that are not excluded. Every process
    reaches the same mesh, or the same error."""
    from .cluster import choose_backend, device_identity
    n = mesh_size(conf)
    local = _local_pool(conf, device, pinned_pool)
    pools = cl.all_gather_object([device_identity(d) for d in local],
                                 "mesh")
    total = sum(len(p) for p in pools)
    if total < n:
        raise RuntimeError(
            f"mesh.size={n} but only {total} devices visible across the "
            f"cluster's {cl.world} processes ({[len(p) for p in pools]} "
            f"each); lower {MESH_KEY} or give the processes more cards")
    owner = [(r, k) for r, p in enumerate(pools) for k in range(len(p))]
    # the global pool's sizes, which the failure ladder reads
    # (`elastic.healthy_device_count`) with no collective of its own
    cl.pool_sizes = [len(p) for p in pools]
    chosen, ranks = cluster_positions(cl.pool_sizes, n,
                                      excluded_device_ids(conf))
    if len(chosen) <= 1:
        return None
    missing = sorted(set(range(cl.world)) - set(ranks))
    if missing:
        raise RuntimeError(
            f"mesh.size={len(chosen)} leaves cluster process(es) "
            f"{missing} without a mesh position: every process must drive "
            f"a shard")
    devices = [local[owner[g][1]] if owner[g][0] == cl.rank else None
               for g in chosen]
    backend = choose_backend(pools)
    cl.note_backend(backend)
    return Mesh(devices, chosen, ranks, cluster=cl, backend=backend)


def get_mesh(conf, device=None, pinned_pool: int = 0) -> Optional[Mesh]:
    """The 1-D data mesh from conf, or None at mesh.size <= 1.

    `device` is the device a session was built with, if it was: every
    shard then sits on it, over the virtual ids of its pool of
    `pinned_pool` devices (at least mesh.size). Without one the mesh
    takes distinct cards; a pool short before exclusions is a setup
    error. Either way exclusions shrink the mesh to the surviving pool
    (<= 1 survivor: None). With a cluster coordinator set, the mesh
    spans the cluster's processes (`init_distributed`)."""
    n = mesh_size(conf)
    if n <= 1:
        return None
    from . import cluster
    cl = cluster.init(conf, RENDEZVOUS_TIMEOUT_S)
    if cl is not None:
        return _cluster_mesh(conf, cl, device, pinned_pool)
    if device is not None:
        ids = [i for i in device_pool(device, max(pinned_pool, n))
               if i not in excluded_device_ids(conf)]
        n = min(n, len(ids))
        if n <= 1:
            return None
        return Mesh([torch.device(device)] * n, ids[:n])
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        names = [torch.cuda.get_device_name(i) for i in range(min(visible, 4))]
        raise RuntimeError(
            f"mesh.size={n} but only {visible} devices visible "
            f"({names}...); build the session with "
            f"SparkTpuSession.builder().device('cuda:0') to place every "
            f"shard on one card, or lower {MESH_KEY}")
    pool = [torch.device("cuda", i) for i in range(visible)]
    excluded = excluded_device_ids(conf)
    if excluded:
        pool = [d for d in pool if d.index not in excluded]
        n = min(n, len(pool))
        if n <= 1:
            return None
    return Mesh(pool[:n], [d.index for d in pool[:n]])


def shard_hosts(mesh: Mesh) -> List[int]:
    """Per-shard host identity for telemetry records: the rank of the
    process that owns each position (0 for every shard of a one-process
    mesh), as the JAX package reads each device's `process_index`."""
    return list(mesh.ranks)


def device_scope(device: torch.device):
    """Make `device` current for the calling thread (a CUDA card), so
    the shard's work queues on that card's current stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


#: bytes and tensors copied between devices by the collectives, by
#: collective and exchange tag ("all_to_all e0", "all_gather e1",
#: "psum", "gather" for the result), since the process started or the
#: caller reset them (`reset_copy_stats`)
COPY_STATS: Dict[str, List[int]] = {}
_COPY_LOCK = threading.Lock()


def reset_copy_stats() -> None:
    with _COPY_LOCK:
        COPY_STATS.clear()


def gather_to(values: Sequence, device: torch.device, what: str) -> list:
    """Each shard's tensor moved to `device`, in shard order. A failed
    peer copy is a collective failure."""
    out = []
    moved = copies = 0
    for src, t in enumerate(values):
        if t.device == device:
            out.append(t)
            continue
        try:
            out.append(t.to(device))
        except Exception as e:  # noqa: BLE001 — re-raised as a mesh failure
            raise MeshCollectiveError(
                f"collective {what}: peer copy from shard {src} to "
                f"{device} failed: {type(e).__name__}: {e}") from e
        moved += t.numel() * t.element_size()
        copies += 1
    if copies:
        with _COPY_LOCK:
            stat = COPY_STATS.setdefault(what, [0, 0])
            stat[0] += moved
            stat[1] += copies
    return out


class ShardGroup:
    """The rendezvous of one mesh run: `exchange(i, value)` returns every
    shard's value in shard order once all shards have deposited theirs
    (the host half of every collective). Two barriers per exchange: the
    second keeps a fast shard's next deposit from overwriting a slot a
    slow shard has not read yet.

    On a cluster the group holds this process's positions only; the
    thread that completes the deposit barrier makes the cross-process
    call for all of them (`Cluster.merge`) before any is released.
    `exchange` carries host objects, `gather_tensors` tensor trees every
    shard receives whole, and `all_to_all` trees of `[n, ...]` send
    buffers (row j for position j). In one process the three are the
    same rendezvous."""

    def __init__(self, n: int, timeout_s: float = RENDEZVOUS_TIMEOUT_S,
                 mesh: Optional[Mesh] = None):
        self.n = n
        self.positions = mesh.local_positions if mesh is not None \
            else list(range(n))
        self._local = {p: k for k, p in enumerate(self.positions)}
        self._mesh = mesh if mesh is not None and mesh.cluster is not None \
            else None
        k = len(self.positions)
        self._barrier = threading.Barrier(
            k, timeout=timeout_s,
            action=self._merge if self._mesh is not None else None)
        self._read = threading.Barrier(k, timeout=timeout_s) \
            if self._mesh is not None else self._barrier
        self._slots: List[object] = [None] * k
        self._op = ("objects", "exchange")
        self._merged: List[object] = []
        self._error: Optional[BaseException] = None

    @property
    def cluster(self):
        """The process's cluster when the group spans processes."""
        return None if self._mesh is None else self._mesh.cluster

    def _merge(self) -> None:
        m = self._mesh
        op, what = self._op
        try:
            self._merged = m.cluster.merge(
                op, what, list(self._slots), m.rank_positions, m.backend,
                m.local_devices[0])
        except BaseException as e:  # noqa: BLE001 — every waiter raises it
            self._error = e
            raise

    def _wait(self, barrier, what: str) -> None:
        try:
            barrier.wait()
        except threading.BrokenBarrierError:
            if self._error is not None:
                raise self._error from None
            raise MeshCollectiveError(
                f"collective rendezvous broken at {what}: a peer shard "
                f"failed or the wait timed out") from None

    def _collect(self, i: int, value, op: str, what: str) -> list:
        self._slots[self._local[i]] = value
        self._op = (op, what)
        self._wait(self._barrier, "deposit")
        out = list(self._merged) if self._mesh is not None \
            else list(self._slots)
        self._wait(self._read, "read")
        return out

    def exchange(self, i: int, value) -> list:
        return self._collect(i, value, "objects", "exchange")

    def gather_tensors(self, i: int, value, what: str) -> list:
        return self._collect(i, value, "gather", what)

    def all_to_all(self, i: int, value, what: str) -> list:
        return self._collect(i, value, "all_to_all", what)

    def abort(self) -> None:
        self._barrier.abort()
        self._read.abort()


def run_on_shards(mesh: Mesh, fn: Callable[[int, ShardGroup], object],
                  timeout_s: float = RENDEZVOUS_TIMEOUT_S) -> list:
    """Run `fn(shard_index, group)` on one thread per shard, each under
    its device and a copy of the caller's context (cancel token, case
    sensitivity); return the results in shard order (the counterpart of
    `shard_map`). On a cluster only this process's positions run; the
    others' results stay None. The first shard error aborts the group;
    every thread
    is joined before the first original error is raised."""
    n = mesh.size
    group = ShardGroup(n, timeout_s, mesh)
    results: List[object] = [None] * n
    errors: List[BaseException] = []
    lock = threading.Lock()

    def body(i: int) -> None:
        try:
            with device_scope(mesh.devices[i]):
                results[i] = fn(i, group)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            with lock:
                errors.append(e)
            group.abort()

    threads = []
    for i in group.positions:
        ctx = contextvars.copy_context()
        t = threading.Thread(target=ctx.run, args=(body, i),
                             name=f"mesh-shard-{i}", daemon=True)
        threads.append(t)
        t.start()
    deadline = time.monotonic() + timeout_s + 60.0
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        group.abort()
        raise MeshCollectiveError(
            f"collective run did not finish: shard threads still alive "
            f"after {timeout_s:.0f}s")
    if errors:
        original = [e for e in errors
                    if not isinstance(e, MeshCollectiveError)]
        raise (original or errors)[0]
    return results
