"""The cluster transport: the process group under a mesh that spans
engine processes (the port of the JAX package's multi-host runtime,
`spark_tpu/parallel/mesh.py` `init_distributed`).

The model is the JAX package's. Every process runs the same engine
program with the three `spark_tpu.sql.cluster.*` keys set (coordinator
`host:port`, the number of processes P, this process's rank), and
`spark_tpu.sql.mesh.size` counts every process's devices, ordered by
process, then by local device, as `jax.devices()` is after
`jax.distributed.initialize`. One process drives all of its host's
devices, one shard thread each (`parallel/mesh.py`); between processes
the transport is a `torch.distributed` process group, made once per
process by `init` (`init_process_group` over `tcp://<coordinator>`).

Every cross-process collective is two levels: the local shard threads
meet at the local rendezvous (`mesh.ShardGroup`), and the one thread that
completes it makes the process-group call for all of them (`merge`).
Every collective is entered in the same order in every process, as under
`shard_map`. The operations:

- objects (`all_gather_object`): pickled host values (dictionary
  digests, block sizes, flags and metric maps) over a gloo group;
- tensors gathered by every shard (`merge` "gather"): each process packs
  its shards' tensors into one byte buffer, and the buffers are
  all-gathered;
- tensors routed to one shard each (`merge` "all_to_all"): each shard's
  `[n, ...]` send buffers are cut by destination process, and one
  `all_to_all_single` moves to each process only the rows its own shards
  receive.

The backend is chosen by the layout (`choose_backend`): NCCL where every
process owns distinct cards, gloo with tensors staged through host
memory where processes share a device (a CPU, or several processes
pinned to one card: NCCL refuses two ranks on one card). The choice is
printed once per process. NCCL that fails to come up where it was chosen
is an error, never a quiet switch to gloo. Objects always travel over
gloo.

Failures. Every wait polls its work and, every `ABORT_POLL_S`, the
group's store: a process whose shard raises writes its error under the
generation's abort key (`abort`; the first writer wins), and every other
process leaves its wait raising that same error, so every process takes
the same rung of the failure ladder. The groups are then renewed (a new
generation) at the next collective. A peer that closes its connections
(a process killed with -9), whose heartbeat stops (`HEARTBEAT_S`; an
NCCL wait never fails on a dead peer by itself, so the waits read the
heartbeats) or that does not answer within the group's timeout makes
the survivors raise `ClusterPeerLostError`, and every later collective
raises it at once: no rung can re-form a cluster that lost a process.
NCCL's own error handling is off (TORCH_NCCL_ASYNC_ERROR_HANDLING 0, so
its watchdog never ends the process): the cluster aborts an NCCL group
itself, when it loses a peer and when an abort retires the group.
"""

from __future__ import annotations

import base64
import contextlib
import datetime
import importlib
import pickle
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import MeshCollectiveError

COORDINATOR_KEY = "spark_tpu.sql.cluster.coordinator"
NUM_PROCESSES_KEY = "spark_tpu.sql.cluster.numProcesses"
PROCESS_ID_KEY = "spark_tpu.sql.cluster.processId"

#: seconds between two looks at the abort key while a collective waits
ABORT_POLL_S = 0.05
#: seconds a collective, or the group's rendezvous, waits for a peer
#: before the peer counts as lost (the mesh's rendezvous timeout)
CLUSTER_TIMEOUT_S = 600.0
#: seconds between two heartbeats a process writes to the store
HEARTBEAT_S = 1.0
#: seconds a peer's heartbeat may stay unchanged before a waiting
#: collective counts the peer as lost (twenty missed beats: a loaded host
#: must not lose a live peer; a dead one is still found within 30 s)
PEER_SILENCE_S = 20.0
_ALIVE_KEY = "spark_tpu/cluster/alive"
#: byte alignment of each tensor in a packed buffer (an int64 view of a
#: piece needs its offset a multiple of 8)
_ALIGN = 8
#: modules whose exceptions a peer rebuilds as themselves (others cross
#: as a MeshCollectiveError with their text)
_REBUILT_MODULES = ("builtins", "torch", "pyarrow", "spark_tpu_torch")


class ClusterPeerLostError(MeshCollectiveError):
    """A peer engine process is gone: it closed its connections (died)
    or did not answer within the group's timeout. The message holds
    "collective", so the failure taxonomy reads it as a mesh failure;
    the executor raises it at once, since no rung can re-form the
    cluster."""


def cluster_spec(conf) -> Optional[Tuple[str, int, int]]:
    """(coordinator, processes, rank) from conf, or None without a
    coordinator."""
    coord = str(conf.get(COORDINATOR_KEY) or "")
    if not coord:
        return None
    world = int(conf.get(NUM_PROCESSES_KEY))
    rank = int(conf.get(PROCESS_ID_KEY))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"{PROCESS_ID_KEY}={rank} is not a rank of "
                         f"{NUM_PROCESSES_KEY}={world}")
    return coord, world, rank


_CLUSTER: Optional["Cluster"] = None
_INIT_LOCK = threading.Lock()


def init(conf, timeout_s: float = CLUSTER_TIMEOUT_S) -> Optional["Cluster"]:
    """This process's cluster: `torch.distributed.init_process_group`
    over `tcp://<coordinator>` on the first call (idempotent per
    process), None without a coordinator."""
    global _CLUSTER
    spec = cluster_spec(conf)
    if spec is None:
        return None
    with _INIT_LOCK:
        if _CLUSTER is not None:
            if _CLUSTER.spec != spec:
                raise ValueError(f"this process already joined the "
                                 f"cluster {_CLUSTER.spec}; it cannot "
                                 f"join {spec}")
            return _CLUSTER
        import torch.distributed as dist
        coord, world, rank = spec
        t0 = time.perf_counter()
        if not dist.is_initialized():
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coord}", world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        _CLUSTER = Cluster(spec, time.perf_counter() - t0, timeout_s)
        _CLUSTER.start_heartbeat()
    return _CLUSTER


def current() -> Optional["Cluster"]:
    return _CLUSTER


def process_rank() -> int:
    """This process's rank (0 outside a cluster): the "host" of its
    shards in telemetry records."""
    return 0 if _CLUSTER is None else _CLUSTER.rank


#: bytes that crossed processes, by collective and tag: [sent, received,
#: calls, seconds in the process-group calls, bytes this process's
#: shards deposited]
CLUSTER_STATS: Dict[str, List[float]] = {}
_STATS_LOCK = threading.Lock()


def reset_cluster_stats() -> None:
    with _STATS_LOCK:
        CLUSTER_STATS.clear()


def _count(what: str, sent: int, received: int, seconds: float,
           deposited: int) -> None:
    with _STATS_LOCK:
        s = CLUSTER_STATS.setdefault(what, [0, 0, 0, 0.0, 0])
        s[0] += sent
        s[1] += received
        s[2] += 1
        s[3] += seconds
        s[4] += deposited


# ---------------------------------------------------------------------------
# Layout and backend
# ---------------------------------------------------------------------------

def device_identity(device: torch.device) -> str:
    """What says two processes hold the same device: "cpu", or a card's
    UUID."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return f"cuda-{torch.cuda.get_device_properties(index).uuid}"


def choose_backend(identities: Sequence[Sequence[str]]) -> str:
    """NCCL when every process holds only cards and no card is held
    twice (each process its own), else gloo."""
    flat = [i for per in identities for i in per]
    if flat and all(i.startswith("cuda-") for i in flat) \
            and len(set(flat)) == len(flat):
        return "nccl"
    return "gloo"


def _abort_nccl(group) -> None:
    """Abort an NCCL group's communicators: a collective queued on it
    ends, and the group is gone."""
    from torch.distributed import distributed_c10d as c10d
    c10d._abort_process_group(group)


# ---------------------------------------------------------------------------
# Packing tensors into byte buffers
# ---------------------------------------------------------------------------

def _flatten(x, leaves: list):
    """A picklable spec of `x` with its tensors replaced by leaf slots
    (appended to `leaves`): dicts, lists, tuples, None and host values
    nest."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("T", str(x.dtype).split(".")[-1], tuple(x.shape))
    if isinstance(x, dict):
        return ("D", [(k, _flatten(v, leaves)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return ("L" if isinstance(x, list) else "U",
                [_flatten(v, leaves) for v in x])
    return ("V", x)


def _leaf_specs(spec, out: list) -> list:
    kind = spec[0]
    if kind == "T":
        out.append((spec[1], spec[2]))
    elif kind == "D":
        for _, v in spec[1]:
            _leaf_specs(v, out)
    elif kind in ("L", "U"):
        for v in spec[1]:
            _leaf_specs(v, out)
    return out


def _unflatten(spec, it):
    kind = spec[0]
    if kind == "T":
        return next(it)
    if kind == "D":
        return {k: _unflatten(v, it) for k, v in spec[1]}
    if kind == "L":
        return [_unflatten(v, it) for v in spec[1]]
    if kind == "U":
        return tuple(_unflatten(v, it) for v in spec[1])
    return spec[1]


def _nbytes(dtype: str, shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    size = n * torch.empty((), dtype=getattr(torch, dtype)).element_size()
    return size + (-size) % _ALIGN


def _pack(tensors: Sequence[torch.Tensor], device: torch.device
          ) -> torch.Tensor:
    """The tensors' bytes, each padded to `_ALIGN`, as one uint8 tensor
    on `device` (cat on the tensors' own device when they share one,
    then one copy)."""
    if not tensors:
        return torch.empty((0,), dtype=torch.uint8, device=device)
    parts = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % _ALIGN
        parts.append(b)
        if pad:
            parts.append(torch.zeros((pad,), dtype=torch.uint8,
                                     device=b.device))
    devices = {p.device for p in parts}
    if len(devices) == 1:
        return torch.cat(parts).to(device)
    return torch.cat([p.to(device) for p in parts])


def _unpack(buf: torch.Tensor, specs) -> List[torch.Tensor]:
    """The tensors `specs` ((dtype, shape) each) read back from `buf`,
    views of it."""
    out, off = [], 0
    for dtype, shape in specs:
        dt = getattr(torch, dtype)
        n = 1
        for s in shape:
            n *= int(s)
        size = n * torch.empty((), dtype=dt).element_size()
        out.append(buf[off:off + size].view(dt).reshape(shape))
        off += size + (-size) % _ALIGN
    return out


# ---------------------------------------------------------------------------
# Errors across processes
# ---------------------------------------------------------------------------

def encode_error(exc: BaseException, rank: int) -> str:
    """A process's error as the text its peers rebuild it from."""
    cls = type(exc)
    state = {}
    for k, v in getattr(exc, "__dict__", {}).items():
        try:
            pickle.dumps(v)
        except Exception:  # noqa: BLE001 — unpicklable attributes stay home
            continue
        state[k] = v
    try:
        args = tuple(exc.args)
        pickle.dumps(args)
    except Exception:  # noqa: BLE001
        args = (str(exc),)
    raw = pickle.dumps((rank, cls.__module__, cls.__qualname__, args,
                        state, f"{cls.__name__}: {exc}"))
    return base64.b64encode(raw).decode("ascii")


def rebuild_error(payload, where: str) -> BaseException:
    """The error a peer wrote under the abort key: its own class where
    that class is the port's, torch's, pyarrow's or a builtin (so the
    failure ladder classifies it alike in every process), else a
    MeshCollectiveError naming it."""
    if isinstance(payload, bytes):
        payload = payload.decode("ascii")
    rank, module, qualname, args, state, text = pickle.loads(
        base64.b64decode(payload))
    exc: Optional[BaseException] = None
    if module.split(".")[0] in _REBUILT_MODULES:
        try:
            cls = importlib.import_module(module)
            for part in qualname.split("."):
                cls = getattr(cls, part)
            if isinstance(cls, type) and issubclass(cls, BaseException):
                exc = cls.__new__(cls)
                BaseException.__init__(exc, *args)
                exc.__dict__.update(state)
        except Exception:  # noqa: BLE001 — fall back to the text
            exc = None
    if exc is None:
        exc = MeshCollectiveError(
            f"collective {where} aborted by process {rank}: {text}")
    exc.cluster_origin = rank
    return exc


# ---------------------------------------------------------------------------
# The process's cluster
# ---------------------------------------------------------------------------

class Cluster:
    """This process's membership: its rank, the groups of the current
    generation, the abort key, and the lock that makes one mesh attempt
    at a time use the groups."""

    def __init__(self, spec: Tuple[str, int, int], init_s: float,
                 timeout_s: float):
        self.spec = spec
        self.coordinator, self.world, self.rank = spec
        #: seconds `init_process_group` took in this process
        self.init_s = init_s
        self.timeout_s = timeout_s
        #: the generation of the groups; an abort moves every process on
        self.gen = 0
        self._groups: Dict[str, object] = {}
        #: (group, work) of each wait left pending by an abort: the group
        #: must not be destroyed under it, so it is destroyed at the
        #: first renewal after the work ended (a gloo wait ends at the
        #: group's timeout at the latest; an aborted NCCL group ends its
        #: own)
        self._abandoned: List[Tuple[object, object]] = []
        #: retired gloo groups that an abandoned wait still holds
        self._doomed: List[object] = []
        #: each peer's last heartbeat read and when it changed
        self._beats: Dict[int, Tuple[object, float]] = {}
        self._peer_store = None
        self._aborted = False
        self._lost: Optional[str] = None
        #: the backends this process has printed
        self.backends_used: List[str] = []
        #: every process's device pool size, in rank order, as the last
        #: mesh formed gathered them (None before the first)
        self.pool_sizes: Optional[List[int]] = None
        #: one execution at a time in this process uses the groups, so
        #: the process's collectives keep the order every peer keeps
        #: (re-entrant: a scalar subquery runs inside its query)
        self.run_lock = threading.RLock()

    @property
    def lost(self) -> bool:
        """Whether this process lost a peer (every collective raises)."""
        return self._lost is not None

    # -- groups ----------------------------------------------------------

    def _store(self):
        from torch.distributed import distributed_c10d as c10d
        return c10d._get_default_store()

    def _abort_key(self) -> str:
        return f"spark_tpu/cluster/abort/{self.gen}"

    def _ready(self) -> None:
        """Raise for a lost peer; renew the groups after an abort."""
        if self._lost is not None:
            raise ClusterPeerLostError(self._lost)
        if self._aborted:
            self._retire()
            self.gen += 1
            self._aborted = False

    def _retire(self) -> None:
        """Drop this generation's groups after an abort: an NCCL group
        is aborted (a collective left waiting on it ends with it), a
        gloo group destroyed once no abandoned wait is pending on it."""
        import torch.distributed as dist
        for backend, g in self._groups.items():
            if backend == "nccl":
                _abort_nccl(g)
            else:
                self._doomed.append(g)
        self._groups = {}
        self._abandoned = [(g, w) for g, w in self._abandoned
                           if not w.is_completed()]
        busy = {id(g) for g, _w in self._abandoned}
        for g in self._doomed:
            if id(g) not in busy:
                dist.destroy_process_group(g)
        self._doomed = [g for g in self._doomed if id(g) in busy]

    def group(self, backend: str):
        """The group of this generation for `backend` (made on first use:
        every process reaches it at the same collective)."""
        self._ready()
        g = self._groups.get(backend)
        if g is None:
            import torch.distributed as dist
            if backend == "nccl" and not dist.is_nccl_available():
                raise RuntimeError(
                    "the mesh layout gives every process its own cards, "
                    "so the cluster chose NCCL, but this torch has no "
                    "NCCL")
            if backend == "nccl":
                # the cluster aborts its NCCL groups itself; the
                # watchdog's modes 1 and 3 would end this process
                import os
                os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
            g = dist.new_group(
                backend=backend,
                timeout=datetime.timedelta(seconds=self.timeout_s))
            self._groups[backend] = g
        return g

    def note_backend(self, backend: str) -> None:
        """Print the tensor backend a mesh layout chose, once per
        backend and process."""
        if backend not in self.backends_used:
            self.backends_used.append(backend)
            print(f"[cluster] rank {self.rank} of {self.world}: mesh "
                  f"tensors over {backend}", file=sys.stderr, flush=True)

    # -- waits and aborts ------------------------------------------------

    def start_heartbeat(self) -> None:
        """Write this process's heartbeat to the store every
        HEARTBEAT_S from a daemon thread, each store client its own (one
        writes the beats, one reads the peers' in the waits)."""
        if self.world == 1:
            return
        import torch.distributed as dist
        host, port = self.coordinator.rsplit(":", 1)

        def client():
            return dist.TCPStore(host, int(port), is_master=False,
                                 timeout=datetime.timedelta(
                                     seconds=PEER_SILENCE_S))

        self._peer_store = client()
        writer = client()
        key = f"{_ALIVE_KEY}/{self.rank}"
        writer.set(key, "0")

        def beat():
            n = 0
            while True:
                time.sleep(HEARTBEAT_S)
                n += 1
                try:
                    writer.set(key, str(n))
                except Exception:  # noqa: BLE001 — a slow or gone store:
                    pass  # beat again; a gone host fails the waits anyway
        threading.Thread(target=beat, daemon=True,
                         name=f"cluster-heartbeat-r{self.rank}").start()

    def _check_peers(self, what: str) -> None:
        """Lose the cluster when a peer's heartbeat has not changed for
        PEER_SILENCE_S (or the store cannot be read)."""
        if self._peer_store is None:
            return
        peers = [r for r in range(self.world) if r != self.rank]
        keys = [f"{_ALIVE_KEY}/{r}" for r in peers]
        try:
            if not self._peer_store.check(keys):
                return  # a peer still joining
            beats = self._peer_store.multi_get(keys)
        except Exception as e:  # noqa: BLE001 — the store's host is gone
            raise self._lose(what, f"{type(e).__name__}: {e}") from e
        now = time.monotonic()
        for r, b in zip(peers, beats):
            last = self._beats.get(r)
            if last is None or last[0] != b:
                self._beats[r] = (b, now)
            elif now - last[1] > PEER_SILENCE_S:
                raise self._lose(what, f"process {r} wrote no heartbeat "
                                       f"for {now - last[1]:.1f}s")

    def _lose(self, what: str, cause) -> ClusterPeerLostError:
        self._lost = (f"collective {what}: cluster peer process lost "
                      f"(rank {self.rank} of {self.world}): {cause}")
        nccl = self._groups.get("nccl")
        if nccl is not None:
            _abort_nccl(nccl)  # ends the NCCL work left waiting
        return ClusterPeerLostError(self._lost)

    def check_abort(self, what: str) -> None:
        """Raise the error a peer wrote under this generation's abort
        key, if one did."""
        if self._lost is not None:
            raise ClusterPeerLostError(self._lost)
        key = self._abort_key()
        try:
            store = self._store()
            if not store.check([key]):
                return
            payload = store.get(key)
        except Exception as e:  # noqa: BLE001 — the store's host is gone
            raise self._lose(what, f"{type(e).__name__}: {e}") from e
        self._aborted = True
        raise rebuild_error(payload, what)

    def _wait(self, work, what: str, group) -> None:
        """Wait for `work` on `group`, looking at the abort key every
        ABORT_POLL_S and at the peers' heartbeats every HEARTBEAT_S; a
        failed work, a silent peer or a wait past the timeout loses the
        peer."""
        t0 = time.monotonic()
        look = t0 + ABORT_POLL_S
        beat = t0 + HEARTBEAT_S
        spins = 0
        while not work.is_completed():
            spins += 1
            if spins > 200:
                time.sleep(0.0002)
            now = time.monotonic()
            if now < look:
                continue
            look = now + ABORT_POLL_S
            try:
                self.check_abort(what)
                if now >= beat:
                    beat = now + HEARTBEAT_S
                    self._check_peers(what)
                if now - t0 > self.timeout_s:
                    raise self._lose(what, f"no answer within "
                                           f"{self.timeout_s:.0f}s")
            except BaseException:
                self._abandoned.append((group, work))
                raise
        try:
            work.wait()
        except Exception as e:  # noqa: BLE001 — a peer closed its end
            self.check_abort(what)
            raise self._lose(what, f"{type(e).__name__}: {e}") from e

    def abort(self, exc: BaseException) -> BaseException:
        """Write this process's error under the abort key unless a peer
        wrote first; return the error every process raises (the first
        written)."""
        if self._lost is not None or isinstance(exc, ClusterPeerLostError):
            return exc
        self._aborted = True
        mine = encode_error(exc, self.rank)
        try:
            first = self._store().compare_set(self._abort_key(), "", mine)
        except Exception:  # noqa: BLE001 — the store's host is gone
            return exc
        if isinstance(first, bytes):
            first = first.decode("ascii")
        if first == mine or getattr(exc, "cluster_origin", None) is not None:
            return exc
        return rebuild_error(first, "abort")

    def begin_attempt(self) -> None:
        """At the start of a mesh attempt: an abort a peer already wrote
        for this generation fails this attempt too, before it makes any
        collective, so every process leaves the same attempt and renews
        its groups at the same next collective."""
        if self._aborted:
            return  # renewed at this attempt's first collective
        self.check_abort("attempt")

    # -- byte collectives --------------------------------------------------

    def _all_gather_bytes(self, buf: torch.Tensor, sizes: Sequence[int],
                          backend: str, what: str) -> List[torch.Tensor]:
        """Every process's buffer (`sizes` their byte counts, known to
        every process), on this process's buffer device."""
        import torch.distributed as dist
        m = max(sizes)
        if m == 0:
            return [buf[:0] for _ in sizes]
        if buf.numel() < m:
            buf = torch.cat([buf, torch.zeros((m - buf.numel(),),
                                              dtype=torch.uint8,
                                              device=buf.device)])
        outs = [torch.empty((m,), dtype=torch.uint8, device=buf.device)
                for _ in sizes]
        g = self.group(backend)
        self._wait(dist.all_gather(outs, buf, group=g, async_op=True), what,
                   g)
        return [o[:s] for o, s in zip(outs, sizes)]

    def all_gather_object(self, obj, what: str = "objects") -> list:
        """Every process's `obj`, in rank order (this process's own
        object as it is, the others unpickled)."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        size = torch.tensor([buf.numel()], dtype=torch.int64)
        sizes = [torch.zeros_like(size) for _ in range(self.world)]
        g = self.group("gloo")
        self._wait(dist.all_gather(sizes, size, group=g, async_op=True),
                   what, g)
        sizes = [int(s.item()) for s in sizes]
        parts = self._all_gather_bytes(buf, sizes, "gloo", what)
        out = [obj if r == self.rank else
               pickle.loads(parts[r].numpy().tobytes())
               for r in range(self.world)]
        _count(f"objects {what}", len(data) * (self.world - 1),
               sum(sizes) - len(data), time.perf_counter() - t0, 0)
        return out

    def _staging(self, backend: str, device: torch.device) -> torch.device:
        return device if backend == "nccl" else torch.device("cpu")

    # -- the leader's half of a shard collective ----------------------------

    def merge(self, op: str, what: str, slots: list,
              rank_positions: Sequence[Sequence[int]], backend: str,
              device: torch.device) -> list:
        """Every mesh position's value, in position order, for the local
        shards' deposits `slots` (positions `rank_positions[self.rank]`):
        `op` "objects" (host values), "gather" (tensor trees every shard
        receives whole) or "all_to_all" (trees of `[n, ...]` send buffers
        whose row j goes to position j: a remote source's tree arrives
        with each leaf as {position: row} for this process's positions).
        Tensors that arrive land on `device`."""
        if op == "objects":
            per_rank = self.all_gather_object(slots, what)
            return [v for vals in per_rank for v in vals]
        ctx = torch.cuda.device(device) if device.type == "cuda" \
            and backend == "nccl" else contextlib.nullcontext()
        with ctx:
            if op == "gather":
                return self._merge_gather(what, slots, backend, device)
            return self._merge_all_to_all(what, slots, rank_positions,
                                          backend, device)

    def _merge_gather(self, what, slots, backend, device) -> list:
        specs, leaves = [], []
        for v in slots:
            specs.append(_flatten(v, leaves))
        staging = self._staging(backend, device)
        buf = _pack(leaves, staging)
        metas = self.all_gather_object((specs, buf.numel()), what)
        t1 = time.perf_counter()
        parts = self._all_gather_bytes(buf, [m[1] for m in metas],
                                       backend, what)
        out = []
        received = 0
        for r, (r_specs, nbytes) in enumerate(metas):
            if r == self.rank:
                out.extend(slots)
                continue
            received += nbytes
            flat = []
            for s in r_specs:
                _leaf_specs(s, flat)
            tensors = iter(_unpack(parts[r].to(device), flat))
            out.extend(_unflatten(s, tensors) for s in r_specs)
        _count(what, buf.numel() * (self.world - 1), received,
               time.perf_counter() - t1, buf.numel())
        return out

    def _merge_all_to_all(self, what, slots, rank_positions, backend,
                          device) -> list:
        import torch.distributed as dist
        specs, leaves_by_slot = [], []
        for v in slots:
            leaves: list = []
            specs.append(_flatten(v, leaves))
            leaves_by_slot.append(leaves)
        staging = self._staging(backend, device)
        sends = []
        deposited = 0
        for r, positions in enumerate(rank_positions):
            if r == self.rank or not positions:
                sends.append(torch.empty((0,), dtype=torch.uint8,
                                         device=staging))
                continue
            lo, hi = positions[0], positions[-1] + 1
            pieces = [leaf[lo:hi] for leaves in leaves_by_slot
                      for leaf in leaves]
            sends.append(_pack(pieces, staging))
        for leaves in leaves_by_slot:
            for leaf in leaves:
                deposited += leaf.numel() * leaf.element_size()
        specs_all = self.all_gather_object(specs, what)
        t1 = time.perf_counter()
        mine = rank_positions[self.rank]
        k = len(mine)
        recv_specs, recv_sizes = [], []
        for r, r_specs in enumerate(specs_all):
            flat = []
            if r != self.rank:
                for s in r_specs:
                    for dtype, shape in _leaf_specs(s, []):
                        flat.append((dtype, (k,) + tuple(shape[1:])))
            recv_specs.append(flat)
            recv_sizes.append(sum(_nbytes(d, s) for d, s in flat))
        send_sizes = [int(s.numel()) for s in sends]
        # every process decides alike whether the call is made: from the
        # specs all of them hold
        if any(_nbytes(d, shp) for r_specs in specs_all for sp in r_specs
               for d, shp in _leaf_specs(sp, [])):
            out_buf = torch.empty((sum(recv_sizes),), dtype=torch.uint8,
                                  device=staging)
            g = self.group(backend)
            self._wait(dist.all_to_all_single(
                out_buf, torch.cat(sends), output_split_sizes=recv_sizes,
                input_split_sizes=send_sizes, group=g, async_op=True), what,
                g)
            recv = list(torch.split(out_buf, recv_sizes))
        else:
            recv = [torch.empty((0,), dtype=torch.uint8)
                    for _ in recv_sizes]
        out = []
        for r, r_specs in enumerate(specs_all):
            if r == self.rank:
                out.extend(slots)
                continue
            tensors = iter(_unpack(recv[r].to(device), recv_specs[r]))
            rows = iter([{p: t[j] for j, p in enumerate(mine)}
                         for t in tensors])
            out.extend(_unflatten(s, rows) for s in r_specs)
        _count(what, sum(send_sizes), sum(recv_sizes),
               time.perf_counter() - t1, deposited)
        return out
