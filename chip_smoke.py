"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, as below
    python3 chip_smoke.py --phases kernels,fuzz   # chosen phases (PHASES)
    python3 chip_smoke.py --phases kernels     # phases 1-3 only

Phases, in order; any failure exits non-zero before the last line.
Phases 1 and 2 always run; `--phases` names the others, from PHASES:
kernels (3), variants (4), main (5), sql (6), tpcds (7), window (8),
fuzz (9). Each query of phases 5-8 runs twice: a first run, after the
device table cache and the session's kept capacities are emptied, and a
warm run, which reuses the cached scans and the kept capacities. Both
must pass the query's checks; each prints its wall time and re-plan
attempts, and the cache's hits, misses, bytes and evictions after it.

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from `spark_tpu_torch/csrc` (nvcc),
   print each kernel's registers and shared memory, and the shared-memory
   atomics each kernel's SASS holds (cuobjdump, where the toolkit has it);
3. kernels: each kernel against its plain PyTorch version on the card at
   six shapes — (a) 6M rows into 12 slots, 9 int64 rows of mixed signs
   near +-2^62 (the sums wrap); (b) 6M rows into 1 slot; (c) 4M rows into
   512 slots, 2 int and 2 float64 rows, 1% of the indices out of range;
   (d) 16M rows into 65,536 slots, 3 int rows; (e) 6M rows into 25 slots,
   4 int rows; (f) as (e) with one slot more than the private variant's
   cut-off. Ints must be equal, floats within rtol 1e-12 of the plain
   float64 sum (another order), and two runs of (c) must give equal float
   sums. Each shape gives the wrapper's time (`ms`, CUDA events around
   one call) and the kernels' own device time (`kernel_ms`, CUDA events
   around the launches alone, queued behind a spin kernel so that the
   host's time is not counted);
4. variants: the private and shared variants of dense_sums_smem timed
   against each other at the domains around the planner's cut-off, and
   each checked with float rows, an odd row count and two runs that must
   agree;
5. main path, DataFrame programs: TPC-H SF1 generated with the port's
   datagen, Q1, Q6, Q3 and Q5 through `SparkTpuSession` on the card (their
   golden compare is phase 6's, whose SQL results must equal these);
   `range(16M).group_by(id % 65536)` with count, sum and avg against
   numpy. Each run starts with the kernel launch counters at 0 and must
   launch its kernel (Q3's path has no hand kernel: its aggregate takes
   the sort path). Each query is then run twice more per operator (a
   cold pass with the cache emptied, whose ScanExec time is printed as
   "cold ScanExec", and a cached pass), and once under torch.profiler
   for the card's busy share; each join
   reports the kernel it took (hash or sort), its hash-probe steps,
   whether its unique-build path held, and the query's re-plan attempts.
   Q3 and Q5 run again under `join.kernelMode=sort` and `=hash` and must
   give the same Arrow bytes as the default run;
6. main path, SQL: all 22 TPC-H queries as SQL text through
   `session.sql` on the same data, both runs of each compared with the
   port's pandas golden answer, and Q1, Q3, Q5 and Q6 with the DataFrame
   programs' results of phase 5 (columns in the DataFrame's order, Q5's
   rows by `n_name`). Each run starts with the launch counters at 0 and
   must launch the kernel `SQL_KERNELS` names; a query prints its runs'
   wall times, re-plan attempts, launches, joins and breakdown as phase
   5 does;
7. main path, TPC-DS: SF1 generated with the port's datagen (seed 42,
   2,878,376 store_sales rows), the 21 queries of `tpcds/sql_queries.py`
   through `session.sql`, each compared with the port's pandas golden
   and required to launch the kernel `TPCDS_KERNELS` names, with the
   same `[sql]`, `[joins]` and `[breakdown]` lines as phase 6; the six
   DataFrame forms must give their SQL text's rows, and q19 and q68 the
   same Arrow bytes under `join.kernelMode=sort` and `=hash`;
8. windows at SF1: one DataFrame program computes row_number, rank, lag
   and a 7-row running sum per customer and a 30-row running max per
   store over all of store_sales, against pandas, with its wall times
   and breakdown; a whole-partition float sum over the same rows,
   partitioned by customer, by store and not at all, must repeat bit
   for bit;
9. fuzz: the differential plan fuzzer (`testing/plan_fuzz.py`), seeds
   0-199 at maxRows 40, then seeds 0-49 at maxRows 4096, both under
   `aggregate.kernelMode=auto`, then seeds 0-999 at maxRows 40 under
   `=matmul` (FUZZ_RUNS): each seed's query through a CUDA session and a
   CPU session over the same source objects (so their cache keys differ
   by device alone), whose plans must print the same and whose results
   must agree bit for bit but for float sums within rtol 1e-12 plus atol
   1e-9; then the port's own `run_seed(ablate="one")` on the card.
   `[fuzz]` lines give the seeds, failures, seconds and how many seeds
   launched each kernel. Under `auto` few seeds reach a kernel (the
   generator seldom aggregates with sums alone over a dense key, and at
   maxRows 40 a batch stays under the kernel's 128 rows); `matmul` sends
   such aggregates to `dense_sums_smem` at any row count, and each
   `matmul` campaign must launch it from at least one seed, so that the
   kernel is held against its plain version on random data. A failure
   or a cache entry on another device than its key's fails the phase.
Then the kernels are timed again on the exact inputs the first run of
each query of phases 5-7 gave them.

The line before the last is a JSON object with one entry per kernel and
main-path input; the last line is `{"ok": true, "device": {...}}`, and
only a run of every phase prints it. A run of phases 3-4 alone
(`--phases kernels`) ends with one JSON line of the shapes' results
instead and reports floats that differ between two runs without failing;
it reads nothing of the package but the wrapper, its plain version, its
launch counters, `plan_launches`, `launch_plan` and `build`, so it also
times another checkout's kernels (one that has `launch_plan`).
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_SCALAR_OPS = 67e12      # H100 SXM non-tensor fp32 rate, as the ALU rate
FLOAT_RTOL = 1e-12
REPS = 20
#: spin cycles queued ahead of each kernel_ms sample, about 1 ms at the
#: H100's 1.98 GHz SM clock
SPIN_CYCLES = 2_000_000
SF = 1.0
RANGE_ROWS = 16_000_000
RANGE_MOD = 65536

REPLACES = {
    "dense_sums_smem": "spark_tpu/execution/pallas_groupby.py:93",
    "dense_sums_global": "spark_tpu/execution/pallas_groupby.py:162",
}
#: (kernel, main-path query whose inputs it is timed on)
KERNEL_INPUTS = [("dense_sums_smem", "q1"), ("dense_sums_smem", "q6"),
                 ("dense_sums_smem", "q5"), ("dense_sums_global", "range")]
#: main-path queries in run order, with the hand kernel each must launch
QUERY_KERNELS = {"q1": "dense_sums_smem", "q6": "dense_sums_smem",
                 "q3": None, "q5": "dense_sums_smem"}
#: the hand kernel each TPC-H SQL query must launch at SF1 (None: its
#: aggregates take the sort path). Q11's and Q22's keyless scalar
#: subqueries run through dense_sums_smem; Q21 groups by s_name, 10,000
#: names and a NULL slot, above dense_sums_smem's 512 slots.
SQL_KERNELS = {f"q{i}": None for i in range(1, 23)}
SQL_KERNELS.update({q: "dense_sums_smem" for q in (
    "q1", "q4", "q5", "q6", "q11", "q12", "q14", "q17", "q19", "q22")})
SQL_KERNELS["q21"] = "dense_sums_global"
#: the queries whose SQL result must equal the DataFrame program's
SQL_EQUALS_DATAFRAME = ("q1", "q3", "q5", "q6")
TPCDS_SF = 1.0
#: the hand kernels each TPC-DS query must launch at SF1 (none: its
#: aggregates take the sort path), from runs on the CPU at SF1: q7 groups
#: by i_item_id (18,001 slots with the NULL slot), q27's ROLLUP by
#: (i_item_id, s_state) and i_item_id, then its grand total; q43 by store
#: (35 slots); q48, q61 (twice) and q96 are keyless
TPCDS_KERNELS = {f"q{i}": () for i in (
    1, 3, 7, 19, 27, 42, 43, 48, 52, 55, 59, 61, 63, 65, 68, 73, 79, 89,
    93, 96, 98)}
TPCDS_KERNELS.update({q: ("dense_sums_smem",)
                      for q in ("q43", "q48", "q61", "q96")})
TPCDS_KERNELS["q7"] = ("dense_sums_global",)
TPCDS_KERNELS["q27"] = ("dense_sums_global", "dense_sums_smem")
#: TPC-DS queries with DataFrame forms, which must give the SQL rows
TPCDS_DATAFRAME = ("q3", "q7", "q42", "q52", "q55", "q96")
#: TPC-DS queries run under each join kernel, which must agree in bytes
TPCDS_KERNEL_MATRIX = ("q19", "q68")
#: the order of the SF1 window program's windows
WINDOW_ORDER = ("ss_sold_date_sk", "ss_ticket_number", "ss_item_sk")
JOIN_MODE = "spark_tpu.sql.join.kernelMode"
#: shape (f)'s domain: one slot above the private variant's cut-off
#: (`dense_groupby.PRIVATE_DOMAIN`, checked in phase 3), fixed here so that
#: `--phases kernels` times another checkout's kernels on the same inputs
ABOVE_CUTOFF = 49
#: (domain, variant, its neighbour) timed against each other in phase 4
VARIANT_PAIRS = [(16, "private", "shared"), (32, "private", "shared"),
                 (48, "private", "shared"), (56, "private", "shared"),
                 (64, "private", "shared")]
SOURCE = "spark_tpu_torch/csrc/dense_groupby.cu"
#: the phases `--phases` chooses from, in run order (device and build
#: always run)
PHASES = ("kernels", "variants", "main", "sql", "tpcds", "window", "fuzz")
#: the phases that drive the package's main path (run_phases)
MAIN_PHASES = ("main", "sql", "tpcds", "window", "fuzz")
#: phase 9's fuzz campaigns: (seeds, the generator's maxRows,
#: spark_tpu.sql.aggregate.kernelMode on both sessions)
FUZZ_RUNS = ((range(0, 200), 40, "auto"), (range(0, 50), 4096, "auto"),
             (range(0, 1000), 40, "matmul"))
AGG_MODE = "spark_tpu.sql.aggregate.kernelMode"


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of `reps` single-call CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(D, plan, idx, ints, floats, domain, reps: int = REPS) -> float:
    """Median over `reps` samples of the device time of the launches of
    `plan` alone (the float combine included), between two CUDA events.

    A spin kernel queued first keeps the card busy while the host
    enqueues the start event, the launches and the end event, so the
    host's time between launches is not counted. A sample in which the
    card had already reached the start event when the end event was
    enqueued is dropped and the spin doubled. The outputs are allocated
    once, outside the events, and the sums are not read."""
    import torch
    idx, ints, floats = (idx.clone(), [r.clone() for r in ints],
                         [r.clone() for r in floats])
    int_out = torch.zeros((len(ints), domain), dtype=torch.int64,
                          device=idx.device)
    float_out = torch.empty((len(floats), domain), dtype=torch.float64,
                            device=idx.device)

    def launch():
        D.launch_plan(plan, idx, ints, floats, domain, int_out, float_out)

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    cycles, times, dropped = SPIN_CYCLES, [], 0
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        launch()
        end.record()
        caught_up = start.query()
        end.synchronize()
        if not caught_up:
            times.append(start.elapsed_time(end))
            continue
        dropped += 1
        if dropped > reps:
            raise RuntimeError(f"the card caught up with the host in "
                               f"{dropped} samples, spin up to {cycles} "
                               "cycles")
        cycles *= 2
    if dropped:
        log(f"[timing] kernel_ms dropped {dropped} samples; spin raised to "
            f"{cycles} cycles")
    return statistics.median(times)


def bound_ms(idx, n_rows: int, domain: int) -> tuple:
    """Least time for the work on these inputs: the int32 index read once,
    the 8-byte values of the rows it keeps (idx in [0, domain)) read once
    and each output written once, against the HBM rate; one add per kept
    value against the scalar ALU rate. Returns (ms, what bounds it)."""
    n = idx.shape[0]
    live = int(((idx >= 0) & (idx < domain)).sum())
    nbytes = 4 * n + 8 * n_rows * live + 8 * n_rows * domain
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = live * n_rows / PEAK_SCALAR_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_sums(name, got, want) -> float:
    """Ints equal, floats within FLOAT_RTOL; returns the max abs error."""
    import torch
    err = 0.0
    for a, b in zip(got[0], want[0]):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{name}: {bad} int slots differ")
    for a, b in zip(got[1], want[1]):
        if not torch.allclose(a, b, rtol=FLOAT_RTOL, atol=0.0):
            raise AssertionError(
                f"{name}: float sums off by {float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()))
    return err


def measure(D, idx, ints, floats, domain):
    """Times of the kernel wrapper, the plain version and one index_add_
    per row kind (the library yardstick) on the same inputs."""
    import torch
    slot = torch.where((idx >= 0) & (idx < domain), idx,
                       torch.full_like(idx, domain)).long()
    stacked_i = torch.stack(ints) if ints else None
    stacked_f = torch.stack(floats) if floats else None

    def library():
        if stacked_i is not None:
            torch.zeros((len(ints), domain + 1), dtype=torch.int64,
                        device=idx.device).index_add_(1, slot, stacked_i)
        if stacked_f is not None:
            torch.zeros((len(floats), domain + 1), dtype=torch.float64,
                        device=idx.device).index_add_(1, slot, stacked_f)

    return {
        "ms": time_ms(lambda: D.dense_groupby_sums(idx, ints, floats, domain)),
        "kernel_ms": kernel_ms(
            D, D.plan_launches(domain, len(ints), len(floats)), idx, ints,
            floats, domain),
        "plain_ms": time_ms(
            lambda: D.dense_groupby_sums_plain(idx, ints, floats, domain)),
        "library_ms": time_ms(library),
    }


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return line, name


def phase_build():
    from spark_tpu_torch.execution import dense_groupby as D
    path, seconds, out = D.build(force=True)
    log(f"[build] {path.name} in {seconds:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "smem" in line or "spill" in line \
                or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")
    log_shared_atomics(path)
    return D


def log_shared_atomics(path) -> None:
    """The shared-memory atomic opcodes in each kernel's SASS: a 64-bit
    int add should be a native ATOMS.ADD.64, a float64 add a CAS loop."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[build] cuobjdump not found: SASS not read")
        return
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=120).stdout
    func = None
    ops = {}
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            ops[func] = set()
        elif func and "ATOMS" in line:
            ops[func].add(next(w for w in line.replace(";", " ").split()
                               if w.startswith("ATOMS")))
    for func, found in ops.items():
        log(f"[build]   sass {func}: "
            f"{', '.join(sorted(found)) or 'no shared atomics'}")


def make_inputs(seed: int):
    """Generators of seeded inputs on the card."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(n, k, big):
        lo, hi = (-(1 << 62), 1 << 62) if big else (-10**6, 10**6)
        return [torch.randint(lo, hi, (n,), generator=g, device=dev,
                              dtype=torch.int64) for _ in range(k)]

    def floats(n, k):
        return [torch.rand((n,), generator=g, device=dev,
                           dtype=torch.float64) * 1e3 for _ in range(k)]

    def index(n, domain, out_of_range=0.0):
        idx = torch.randint(0, domain, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        if out_of_range:
            drop = torch.rand((n,), generator=g, device=dev) < out_of_range
            idx = torch.where(drop, torch.full_like(idx, domain + 7), idx)
        return idx

    return ints, floats, index


def phase_kernels(D, strict: bool = True) -> list:
    """Shapes (a)-(f); returns one result per shape. With strict=False
    float sums that differ between two runs are reported, not fatal."""
    import torch
    ints, floats, index = make_inputs(1234)
    if strict and D.PRIVATE_DOMAIN + 1 != ABOVE_CUTOFF:
        raise AssertionError(f"shape (f) should sit at the cut-off "
                             f"{D.PRIVATE_DOMAIN} + 1, not {ABOVE_CUTOFF}")
    shapes = [
        ("a", 6_000_000, 12, lambda n: (ints(n, 9, True), []), 0.0),
        ("b", 6_000_000, 1, lambda n: (ints(n, 9, True), []), 0.0),
        ("c", 4_000_000, 512, lambda n: (ints(n, 2, False), floats(n, 2)),
         0.01),
        ("d", 16_000_000, 65536, lambda n: (ints(n, 3, False), []), 0.0),
        ("e", 6_000_000, 25, lambda n: (ints(n, 4, True), []), 0.0),
        ("f", 6_000_000, ABOVE_CUTOFF, lambda n: (ints(n, 4, True), []),
         0.0),
    ]
    results = []
    for label, n, domain, rows, oor in shapes:
        idx = index(n, domain, oor)
        ir, fr = rows(n)
        kernel = "dense_sums_smem" if domain <= D.SMEM_DOMAIN \
            else "dense_sums_global"
        before = D.LAUNCHES[kernel]
        got = D.dense_groupby_sums(idx, ir, fr, domain)
        torch.cuda.synchronize()
        launches = D.LAUNCHES[kernel] - before
        if launches < 1:
            raise AssertionError(f"shape {label}: {kernel} never launched")
        err = compare_sums(f"shape {label}", got,
                           D.dense_groupby_sums_plain(idx, ir, fr, domain))
        repeats = None
        if fr:
            again = D.dense_groupby_sums(idx, ir, fr, domain)
            repeats = all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
            if strict and not repeats:
                raise AssertionError(f"shape {label}: float sums differ "
                                     "between two runs")
        t = measure(D, idx, ir, fr, domain)
        b, _ = bound_ms(idx, len(ir) + len(fr), domain)
        log(f"[kernels] ({label}) {kernel} n={n} domain={domain} "
            f"int_rows={len(ir)} float_rows={len(fr)}: match "
            f"(max_abs_err={err:.3g}"
            + ("" if repeats is None else f", floats repeat: {repeats}")
            + f") ms={t['ms']:.4f} kernel_ms={t['kernel_ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
            f"bound_ms={b:.4f} share={b / t['kernel_ms']:.3f} "
            f"launches={launches}")
        results.append({"shape": label, "kernel": kernel, "n": n,
                        "domain": domain, "int_rows": len(ir),
                        "float_rows": len(fr), "bound_ms": b,
                        "floats_repeat": repeats, **t})
    return results


def phase_variants(D) -> None:
    """Each variant of dense_sums_smem against its neighbour around the
    planner's cut-offs (6M rows, 4 int rows near +-2^62, random slots),
    then each variant with float rows, an odd row count, 1% of the rows
    dropped and two runs whose float sums must be equal."""
    import torch
    ints, floats, index = make_inputs(99)
    n = 6_000_000
    ir = ints(n, 4, True)
    for domain, first, second in VARIANT_PAIRS:
        idx = index(n, domain)
        b, _ = bound_ms(idx, len(ir), domain)
        want = D.dense_groupby_sums_plain(idx, ir, [], domain)
        times = []
        for variant in (first, second):
            plan = D.plan_variant(variant, domain, len(ir), 0)
            compare_sums(f"{variant} at domain {domain}",
                         D.run_plan(plan, idx, ir, [], domain), want)
            times.append(kernel_ms(D, plan, idx, ir, [], domain))
        picked = D.plan_launches(domain, len(ir), 0)[0].variant
        log(f"[variants] domain={domain} {first} kernel_ms={times[0]:.4f} "
            f"{second} kernel_ms={times[1]:.4f} bound_ms={b:.4f}; "
            f"the planner picks {picked}")
    n = 2_000_001
    fi, ff = ints(n, 1, True), floats(n, 2)
    for variant, domain in (("private", 20), ("shared", 200)):
        idx = index(n, domain, 0.01)
        plan = D.plan_variant(variant, domain, 1, 2)
        got = D.run_plan(plan, idx, fi, ff, domain)
        err = compare_sums(f"{variant} with floats", got,
                           D.dense_groupby_sums_plain(idx, fi, ff, domain))
        again = D.run_plan(plan, idx, fi, ff, domain)
        if not all(torch.equal(a, b) for a, b in zip(got[1], again[1])):
            raise AssertionError(f"{variant}: float sums differ between "
                                 "two runs")
        log(f"[variants] {variant} domain={domain} n={n} 1 int + 2 float "
            f"rows, 1% dropped: match (max_abs_err={err:.3g}), float sums "
            f"equal in two runs")


def reset_state(session) -> None:
    """Empty the device table cache and the session's kept capacities,
    so that the next run is a first run: it loads every scan and starts
    from the planned capacities."""
    from spark_tpu_torch.io.device_cache import CACHE
    CACHE.clear()
    session._aqe_caps.clear()


def cache_stats() -> str:
    from spark_tpu_torch.io.device_cache import CACHE
    s = CACHE.stats()
    return (f"cache hits={s['hits']} misses={s['misses']} "
            f"bytes={s['bytes']} evictions={s['evictions']}")


def zero_launches(D) -> None:
    for k in D.LAUNCHES:
        D.LAUNCHES[k] = 0


def first_and_warm(D, session, make_df, current=None, label=None):
    """A first run of `make_df()` after `reset_state`, then a warm run
    (cached scans, kept capacities). Returns (first result, its
    QueryExecution, seconds, launches), then the same for the warm run.
    The first run's kernel inputs are kept under `label` (run_phases'
    `current`); the warm run's are not."""
    import torch
    out = []
    reset_state(session)
    for run in range(2):
        if current is not None:
            current[0] = label if run == 0 else None
        zero_launches(D)
        t0 = time.perf_counter()
        qe = make_df()._qe()
        got = qe.collect()
        torch.cuda.synchronize()
        out.append((got, qe, time.perf_counter() - t0, dict(D.LAUNCHES)))
    return out


def runs_text(first, warm) -> str:
    return (f"first run {first[2]:.3f} s (attempts {first[1].attempts}), "
            f"warm run {warm[2]:.3f} s (attempts {warm[1].attempts}); "
            f"{cache_stats()}")


def require_kernels(label, kernels, launches) -> None:
    if isinstance(kernels, str):
        kernels = (kernels,)
    for kernel in kernels or ():
        if launches[kernel] < 1:
            raise AssertionError(f"{label} did not launch {kernel}: "
                                 f"{launches}")


def phase_dataframes(D, S, Q, path, launches, current) -> dict:
    """Phase 5's TPC-H DataFrame programs: Q1, Q6, Q3, Q5, each a first
    and a warm run that must give the same rows, then Q3 and Q5 under
    each join kernel. Returns the first runs' results."""
    session = S.SparkTpuSession.builder().get_or_create()
    Q.register_tables(session, path)
    n_lineitem = session.table("lineitem").plan.source.estimated_rows()
    results = {}
    for q, kernel in QUERY_KERNELS.items():
        first, warm = first_and_warm(
            D, session, lambda: Q.QUERIES[q](session), current, q)
        results[q] = first[0]
        launches[q] = first[3]
        require_kernels(q, kernel, first[3])
        require_kernels(f"{q}'s warm run", kernel, warm[3])
        tables_match(f"{q}'s warm run against its first", warm[0], first[0])
        log(f"[main] {q}: {first[0].num_rows} rows; {runs_text(first, warm)}"
            f" ({n_lineitem / warm[2] / 1e6:.2f} M lineitem rows/s); "
            f"launches {launches[q]}")
        if q in ("q3", "q5"):
            log(f"[joins] {q}: {describe_joins(first[1])}")
        log(f"[breakdown] {q}: {breakdown(Q.QUERIES[q](session))}")
    join_kernel_parity(S, Q, path, results)
    return results


def phase_range(D, S, launches, current) -> None:
    """`range(16M).group_by(id % 65536)` with count, sum and avg against
    numpy: no scan, `dense_sums_global`."""
    import numpy as np
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.functions import col
    session = S.SparkTpuSession.builder().get_or_create()
    make = lambda: session.range(RANGE_ROWS).group_by(
        col("id") % RANGE_MOD).agg(F.count(), F.sum(col("id")),
                                   F.avg(col("id")))
    first, warm = first_and_warm(D, session, make, current, "range")
    launches["range"] = first[3]
    require_kernels("range group-by", "dense_sums_global", first[3])
    ids = np.arange(RANGE_ROWS, dtype=np.int64)
    keys = ids % RANGE_MOD
    cnt = np.bincount(keys, minlength=RANGE_MOD)
    total = np.zeros(RANGE_MOD, dtype=np.int64)
    np.add.at(total, keys, ids)
    for got in (first[0].to_pandas(), warm[0].to_pandas()):
        if not (np.array_equal(got.iloc[:, 0].to_numpy(),
                               np.arange(RANGE_MOD))
                and np.array_equal(got["count(*)"].to_numpy(), cnt)
                and np.array_equal(got["sum(id)"].to_numpy(), total)
                and np.allclose(got["avg(id)"].to_numpy(), total / cnt,
                                rtol=1e-15, atol=0)):
            raise AssertionError("range group-by disagrees with numpy")
    log(f"[main] range({RANGE_ROWS}).group_by(id % {RANGE_MOD}): "
        f"matches numpy; {first[0].num_rows} groups; "
        f"{runs_text(first, warm)} ({RANGE_ROWS / warm[2] / 1e6:.2f} M "
        f"rows/s); launches {launches['range']}")
    log(f"[breakdown] range: {breakdown(make())}")


def phase_sql(D, S, G, path, df_results, launches, current) -> None:
    """The 22 TPC-H queries as SQL text on the card: each run against the
    golden answer, Q1/Q3/Q5/Q6 against the DataFrame programs' results
    (when phase 5 ran), and each must launch the kernel SQL_KERNELS
    names. A query's launches are kept under `sql <q>`."""
    from spark_tpu_torch.tpch.queries import register_tables
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    session = S.SparkTpuSession.builder().get_or_create()
    register_tables(session, path)
    t_phase, warm_total = time.perf_counter(), 0.0
    for q, kernel in SQL_KERNELS.items():
        def golden(runs, q=q):
            t0 = time.perf_counter()
            gold = G.GOLDEN[q](path)
            seconds = time.perf_counter() - t0
            for got in runs:
                G.compare(G.normalize_decimals(got.to_pandas())[
                    gold.columns.tolist()].reset_index(drop=True), gold)
            if df_results is not None and q in SQL_EQUALS_DATAFRAME:
                want = df_results[q]
                mine = runs[0].select(want.column_names)
                if q == "q5":
                    mine, want = mine.sort_by("n_name"), want.sort_by("n_name")
                tables_match(f"SQL {q} against the DataFrame program", mine,
                             want)
                log(f"[sql] {q}: equals the DataFrame program's result")
            return seconds
        _, warm = run_sql_query(D, session, q, SQL_QUERIES[q], f"sql {q}",
                                kernel, launches, current, golden)
        warm_total += warm
    log(f"[sql] 22 queries in {time.perf_counter() - t_phase:.1f} s; "
        f"warm runs {warm_total:.3f} s in all")


def run_sql_query(D, session, q, text, label, kernels, launches, current,
                  golden):
    """One SQL query as phases 6 and 7 run it: a first run after
    `reset_state` and a warm run, each with the launch counters at 0 and
    each launching every kernel of `kernels` (a name, a tuple of names,
    or None); both results against the golden; then the `[sql]`,
    `[joins]` and `[breakdown]` lines. Returns the first run's result and
    the warm run's wall time."""
    from spark_tpu_torch.execution.executor import plan_nodes
    from spark_tpu_torch.plan.physical import JoinExec
    first, warm = first_and_warm(D, session, lambda: session.sql(text),
                                 current, label)
    launches[label] = first[3]
    require_kernels(label, kernels, first[3])
    require_kernels(f"{label}'s warm run", kernels, warm[3])
    golden_s = golden([first[0], warm[0]])
    log(f"[sql] {label}: both runs match golden (golden {golden_s:.2f} s); "
        f"{first[0].num_rows} rows; {runs_text(first, warm)}; launches "
        f"{launches[label]}")
    if plan_nodes(first[1].executed_plan, JoinExec):
        log(f"[joins] {label}: {describe_joins(first[1])}")
    log(f"[breakdown] {label}: {breakdown(session.sql(text))}")
    return first[0], warm[2]


def phase_tpcds(D, S, path, launches, current) -> None:
    """The 21 TPC-DS queries at SF1 on the card, each against its golden
    and launching the kernel TPCDS_KERNELS names (launches kept under
    `tpcds <q>`); the DataFrame forms against their SQL rows; q19 and q68
    under each join kernel."""
    from spark_tpu_torch.tpcds import golden as G
    from spark_tpu_torch.tpcds import queries as Q
    from spark_tpu_torch.tpcds.sql_queries import SQL_QUERIES
    session = S.SparkTpuSession.builder().get_or_create()
    Q.register_tables(session, path)
    results, warm_total = {}, 0.0
    t_phase = time.perf_counter()
    for q, kernel in TPCDS_KERNELS.items():
        def golden(runs, q=q):
            t0 = time.perf_counter()
            gold = G.GOLDEN[q](path)
            seconds = time.perf_counter() - t0
            for got in runs:
                G.compare(G.normalize_decimals(got.to_pandas())[
                    gold.columns.tolist()].reset_index(drop=True), gold,
                    float_atol=1e-4)
            return seconds
        results[q], warm = run_sql_query(
            D, session, q, SQL_QUERIES[q], f"tpcds {q}", kernel,
            launches, current, golden)
        warm_total += warm
    log(f"[tpcds] 21 queries in {time.perf_counter() - t_phase:.1f} s; "
        f"warm runs {warm_total:.3f} s in all")
    # the runs below are not the queries' own: their kernel inputs are
    # not reported
    for q in TPCDS_DATAFRAME:
        got = Q.QUERIES[q](session).collect()
        tables_match(f"TPC-DS {q}'s DataFrame form against its SQL",
                     results[q].select(got.column_names), got)
        log(f"[tpcds] {q} DataFrame form: equal to its SQL text's rows")
    for q in TPCDS_KERNEL_MATRIX:
        outs = {}
        for mode in ("sort", "hash"):
            s2 = S.SparkTpuSession.builder().config(
                JOIN_MODE, mode).get_or_create()
            Q.register_tables(s2, path)
            qe = s2.sql(SQL_QUERIES[q])._qe()
            outs[mode] = qe.collect()
            log(f"[joins] tpcds {q} kernelMode={mode}: "
                f"{describe_joins(qe)}")
        if not outs["sort"].equals(outs["hash"]):
            raise AssertionError(f"TPC-DS {q} differs between the sort "
                                 "and hash join kernels")
        tables_match(f"TPC-DS {q} under the join kernels",
                     outs["hash"], results[q])
        log(f"[tpcds] {q}: the same Arrow bytes under join.kernelMode="
            "sort and =hash, equal to the default run")


def phase_fuzz(D, S) -> None:
    """The differential plan fuzzer on the card (FUZZ_RUNS). Each seed's
    tables are registered in a CUDA session and a CPU session as the same
    source objects, so both sessions' scans share one identity stamp and
    their device-cache keys differ by the device alone. The seed's query
    then runs in both, each with its own copy of the generator's state:
    the plans must print the same before the run and the results agree
    as `plan_fuzz.result_mismatch` holds them (the CPU session takes the
    kernels' plain versions). Then the port's own
    `run_seed(ablate="one")` on the CUDA session. A campaign under
    `kernelMode=matmul` in which no seed launched dense_sums_smem fails.
    Any failure fails the phase, after the counts are printed."""
    import collections
    import random
    import torch
    from spark_tpu_torch.io.device_cache import CACHE
    from spark_tpu_torch.io.sources import ArrowTableSource
    from spark_tpu_torch.testing import plan_fuzz as PF
    cuda = S.SparkTpuSession.builder().get_or_create()
    cpu = S.SparkTpuSession.builder().device("cpu").get_or_create()
    failures = []
    for seeds, max_rows, mode in FUZZ_RUNS:
        for s in (cuda, cpu):
            s.conf.set(AGG_MODE, mode)
        t0 = time.perf_counter()
        launched = collections.Counter()
        failed = []
        for seed in seeds:
            try:
                rng = random.Random(seed)
                tables = PF.gen_tables(rng, max_rows)
                for name, tbl in tables.items():
                    source = ArrowTableSource(name, tbl)
                    cuda.register_table(name, source)
                    cpu.register_table(name, source)
                state = rng.getstate()
                dfs = []
                for s in (cuda, cpu):
                    r = random.Random()
                    r.setstate(state)
                    sql = PF.gen_sql(r, tables) if r.random() < 0.25 \
                        else None
                    dfs.append(s.sql(sql) if sql else
                               PF.gen_query(r, s, tables))
                zero_launches(D)
                gqe = dfs[0]._qe()
                plan = gqe.executed_plan.tree_string()
                got = gqe.collect()
                torch.cuda.synchronize()
                launched.update(k for k, n in D.LAUNCHES.items() if n)
                cqe = dfs[1]._qe()
                if cqe.executed_plan.tree_string() != plan:
                    raise AssertionError("the CPU session plans another "
                                         "physical plan")
                mismatch = PF.result_mismatch(got, cqe.collect())
                if mismatch is not None:
                    raise AssertionError(f"CUDA against CPU: {mismatch}")
                PF.run_seed(cuda, seed, ablate="one", max_rows=max_rows)
            except Exception as e:  # noqa: BLE001 — the phase collects
                failed.append((seed, f"{type(e).__name__}: {e}"))
        crossed = [k for k, (b, _) in CACHE._entries.items()
                   if b.device.type != torch.device(k[-1]).type]
        if crossed:
            failed.append((None, f"cache entries on another device than "
                                 f"their key's: {crossed[:3]}"))
        if mode == "matmul" and not launched["dense_sums_smem"]:
            failed.append((None, "no seed launched dense_sums_smem"))
        log(f"[fuzz] seeds {seeds.start}-{seeds.stop - 1} at maxRows "
            f"{max_rows}, kernelMode={mode}: {len(seeds)} seeds, "
            f"{len(failed)} failures, "
            f"{time.perf_counter() - t0:.1f} s; seeds that launched "
            + ", ".join(f"{k}: {launched[k]}" for k in D.LAUNCHES)
            + f"; {cache_stats()}")
        for seed, err in failed[:5]:
            log(f"[fuzz]   seed {seed}: {err[:400]}")
        failures += failed
    if failures:
        raise AssertionError(f"{len(failures)} fuzz failures, the first: "
                             f"{failures[0]}")


def run_phases(D, phases):
    """The main-path phases chosen (5-9); returns the per-kernel launch
    counts of each query's first run and the kernel inputs each query's
    first run handed the wrapper (for timing at those shapes)."""
    import spark_tpu_torch as S
    from spark_tpu_torch.tpch import golden as G
    from spark_tpu_torch.tpch import queries as Q
    from spark_tpu_torch.tpch.datagen import write_parquet

    captured = {}
    original = D.dense_groupby_sums
    #: the label of the query whose kernel inputs are kept (None: none)
    current = [None]

    def recording(idx, int_rows, float_rows, domain, int_widths=None):
        if current[0] is not None:
            kernel = "dense_sums_smem" if domain <= D.SMEM_DOMAIN \
                else "dense_sums_global"
            # each distinct input shape of a query's calls (q27's ROLLUP
            # gives dense_sums_global two domains), the last call's data
            shape = (idx.shape[0], domain, len(int_rows), len(float_rows))
            captured.setdefault((current[0], kernel), {})[shape] = (
                idx, list(int_rows), list(float_rows), domain)
        return original(idx, int_rows, float_rows, domain, int_widths)

    D.dense_groupby_sums = recording
    launches = {}
    try:
        if {"main", "sql"} & phases:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                path = write_parquet(tmp + "/tpch", SF)
                log(f"[main] TPC-H SF{SF} generated in "
                    f"{time.perf_counter() - t0:.1f} s")
                df_results = None
                if "main" in phases:
                    df_results = phase_dataframes(D, S, Q, path, launches,
                                                  current)
                if "sql" in phases:
                    phase_sql(D, S, G, path, df_results, launches, current)
        if "main" in phases:
            phase_range(D, S, launches, current)
        if {"tpcds", "window"} & phases:
            from spark_tpu_torch.tpcds.datagen import write_parquet as ds
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                path = ds(tmp + "/tpcds", TPCDS_SF)
                log(f"[tpcds] SF{TPCDS_SF} generated in "
                    f"{time.perf_counter() - t0:.1f} s")
                if "tpcds" in phases:
                    phase_tpcds(D, S, path, launches, current)
                if "window" in phases:
                    phase_window(D, S, path)
        if "fuzz" in phases:
            t0 = time.perf_counter()
            phase_fuzz(D, S)
            log(f"[fuzz] phase in {time.perf_counter() - t0:.1f} s")
    finally:
        D.dense_groupby_sums = original
    return launches, captured


def phase_window(D, S, path) -> None:
    """Five window functions over all of store_sales at SF1 — the
    "latest purchases per customer" shape: row_number, rank, lag and a
    7-row running sum of ss_net_paid per customer, and a 30-row running
    max of ss_sales_price per store, each ordered by (date, ticket,
    item) — against pandas; then a whole-partition float sum run twice,
    whose bits must repeat."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    import torch
    from spark_tpu_torch import functions as F
    from spark_tpu_torch import types as T
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.window import Window
    from spark_tpu_torch.tpcds.queries import register_tables
    session = S.SparkTpuSession.builder().get_or_create()
    register_tables(session, path)
    order = [col(c) for c in WINDOW_ORDER]
    by_cust = Window.partition_by(col("ss_customer_sk")).order_by(*order)
    by_store = Window.partition_by(col("ss_store_sk")).order_by(*order) \
        .rows_between(-29, 0)
    keys = ["ss_customer_sk", "ss_store_sk", *WINDOW_ORDER]

    def program():
        return session.table("store_sales").select(
            *[col(c) for c in keys], col("ss_net_paid"),
            col("ss_sales_price"),
            F.row_number().over(by_cust).alias("rn"),
            F.rank().over(by_cust).alias("rk"),
            F.lag(col("ss_net_paid")).over(by_cust).alias("prev_paid"),
            F.sum(col("ss_net_paid")).over(by_cust.rows_between(-6, 0))
            .alias("paid_7"),
            F.max(col("ss_sales_price")).over(by_store).alias("max_30"))

    first, warm_run = first_and_warm(D, session, program)
    got = first[0]
    tables_match("the window program's warm run against its first",
                 warm_run[0], got)
    n = got.num_rows

    # pandas: the same functions over the same rows, money in cents
    t0 = time.perf_counter()
    table = pq.read_table(path + "/store_sales.parquet",
                          columns=keys + ["ss_net_paid", "ss_sales_price"])

    def cents(arr):
        """Money in integer cents (NULLs as 0: the validity says which)."""
        return np.round(pc.fill_null(pc.cast(arr, pa.float64()), 0.0)
                        .to_numpy(zero_copy_only=False) * 100) \
            .astype(np.int64)

    import pandas as pd
    pdf = pd.DataFrame({c: table.column(c).to_pandas() for c in keys})
    pdf["paid"] = cents(table.column("ss_net_paid"))
    pdf["price"] = cents(table.column("ss_sales_price"))
    pdf["cust"] = pdf["ss_customer_sk"].fillna(-1).astype(np.int64)
    pdf = pdf.sort_values(["cust", *WINDOW_ORDER], kind="stable")
    g = pdf.groupby("cust", sort=False)
    pdf["rn"] = g.cumcount() + 1
    key = pdf.groupby(list(WINDOW_ORDER), sort=True).ngroup()
    pdf["rk"] = key.groupby(pdf["cust"]).rank(method="min").astype(np.int64)
    pdf["prev_paid"] = g["paid"].shift(1)
    pdf["paid_7"] = g["paid"].rolling(7, min_periods=1).sum() \
        .reset_index(level=0, drop=True)
    # ties keep the file's row order, as the port's stable sort does
    pdf = pdf.sort_index().sort_values(["ss_store_sk", *WINDOW_ORDER],
                                       kind="stable")
    pdf["max_30"] = pdf.groupby("ss_store_sk", sort=False)["price"] \
        .rolling(30, min_periods=1).max().reset_index(level=0, drop=True)
    # back to the file's row order, which the port's result keeps
    pdf = pdf.sort_index()
    pandas_s = time.perf_counter() - t0

    mine = got
    for name, want, money in (("rn", pdf["rn"], False),
                              ("rk", pdf["rk"], False),
                              ("prev_paid", pdf["prev_paid"], True),
                              ("paid_7", pdf["paid_7"], True),
                              ("max_30", pdf["max_30"], True)):
        arr = mine.column(name)
        valid = arr.is_valid().to_numpy(zero_copy_only=False)
        values = cents(arr) if money else \
            arr.to_numpy(zero_copy_only=False)
        w = want.to_numpy(dtype=np.float64, na_value=np.nan)
        if not (np.array_equal(valid, ~np.isnan(w))
                and np.array_equal(values[valid], w[valid].astype(np.int64))):
            raise AssertionError(f"window program: column {name} differs "
                                 "from pandas")
    log(f"[window] SF{TPCDS_SF} store_sales, {n} rows, five window "
        f"functions over two specs: match pandas (pandas {pandas_s:.1f} s); "
        f"{runs_text(first, warm_run)} ({n / warm_run[2] / 1e6:.2f} M "
        f"rows/s)")
    log(f"[breakdown] window: {breakdown(program())}")

    # small segments (~29 rows per customer), large ones (one per store)
    # and one segment of every row, where the order of the adds matters
    # most
    for what, keys in (("ss_customer_sk", [col("ss_customer_sk")]),
                       ("ss_store_sk", [col("ss_store_sk")]),
                       ("nothing", [])):
        whole = Window.partition_by(*keys)
        fsum = session.table("store_sales").select(
            F.sum(col("ss_net_paid").cast(T.DOUBLE)).over(whole).alias("s"))
        first, again = fsum.collect(), fsum.collect()
        if not first.equals(again):
            raise AssertionError("the whole-partition float window sum over "
                                 f"partition by {what} differs between two "
                                 "runs")
        log(f"[window] sum(double) over partition by {what}: the same bits "
            f"in two runs ({first.num_rows} rows)")


def tables_match(what, got, want) -> None:
    """Equal schemas and rows: every column equal, NULLs included, float
    columns within a relative FLOAT_RTOL."""
    import numpy as np
    import pyarrow as pa
    if got.schema != want.schema or got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.schema} with {got.num_rows} "
                             f"rows, expected {want.schema} with "
                             f"{want.num_rows}")
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        if pa.types.is_floating(w.type):
            gv = g.is_valid().to_numpy(zero_copy_only=False)
            wv = w.is_valid().to_numpy(zero_copy_only=False)
            if not (np.array_equal(gv, wv) and np.allclose(
                    g.to_numpy(zero_copy_only=False)[gv],
                    w.to_numpy(zero_copy_only=False)[wv],
                    rtol=FLOAT_RTOL, atol=0.0)):
                raise AssertionError(f"{what}: column {name} differs")
        elif not g.equals(w):
            raise AssertionError(f"{what}: column {name} differs")


def join_kernel_parity(S, Q, path, results) -> None:
    """Q3 and Q5 again under each join kernel: the Arrow results must
    equal the default run's, byte for byte."""
    import torch
    for q in ("q3", "q5"):
        for mode in ("sort", "hash"):
            session = S.SparkTpuSession.builder().config(
                JOIN_MODE, mode).get_or_create()
            Q.register_tables(session, path)
            qe = Q.QUERIES[q](session)._qe()
            t0 = time.perf_counter()
            got = qe.collect()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if not got.equals(results[q]):
                raise AssertionError(f"{q} under join.kernelMode={mode} "
                                     "differs from the default run")
            log(f"[joins] {q} kernelMode={mode}: equal to the default "
                f"run; first run {seconds:.3f} s; {describe_joins(qe)}")


def describe_joins(qe) -> str:
    """Per join of the last run: its tag and type, the kernel it took
    and why, the hash table's slots and insert and probe steps, whether
    the unique-build path held, and its output rows."""
    from spark_tpu_torch.execution.executor import plan_nodes
    from spark_tpu_torch.plan.physical import JoinExec
    m = qe.last_metrics
    parts = []
    for j in plan_nodes(qe.executed_plan, JoinExec):
        kernel, reason = j.last_kernel
        text = f"{j.tag} {j.how} {kernel} ({reason})"
        if kernel == "hash":
            text += (f" slots={m[f'join_table_slots_{j.tag}']} "
                     f"build_steps={m[f'join_build_steps_{j.tag}']} "
                     f"probe_steps={m[f'join_probe_steps_{j.tag}']}")
        uniq = "fell back" if j.unique_build is False else "held"
        text += f" unique-build {uniq}, rows={m.get(f'join_rows_{j.tag}')}"
        parts.append(text)
    return "; ".join(parts) + f"; attempts {qe.attempts}"


def breakdown(df) -> str:
    """Where one run of `df` spends its time. The query runs once to let
    the re-plan loop converge; then the converged plan runs twice with
    each physical operator timed on the host clock and the card
    synchronised around it (a node that several parents share runs once,
    as in the executor): a cold pass with the device table cache emptied
    first, whose ScanExec time (and the Parquet read alone) is reported
    as "cold", and a cached pass, whose times are reported per operator
    type, each join by its tag, and the Arrow egress after it. A join's
    payload columns are gathered lazily, by whichever operator reads them
    first, so that gather time lands there. Then a further run (warm:
    cached scans, kept capacities) under torch.profiler gives the card's
    busy time (the union of its kernel and copy intervals) against the
    run's wall time, and the kernels that took most of it."""
    import collections
    import torch
    from spark_tpu_torch.execution.executor import run_plan
    from spark_tpu_torch.io.device_cache import CACHE
    from spark_tpu_torch.io.sources import ParquetSource, _pushed_expression
    from spark_tpu_torch.plan import physical as P
    qe = df._qe()
    qe.execute_batch()

    def timed_pass(cold: bool):
        if cold:
            CACHE.clear()
        ctx = P.ExecContext(df.session.conf, df.session.device)
        times = collections.defaultdict(float)
        nodes = collections.Counter()
        joins = []

        def visit(node, compute):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = compute()
            torch.cuda.synchronize()
            name = type(node).__name__
            seconds = time.perf_counter() - t0
            times[name] += seconds
            nodes[name] += 1
            if isinstance(node, P.JoinExec):
                joins.append(f"{node.tag} {seconds * 1e3:.1f}")
            if cold and isinstance(node, P.ScanExec) \
                    and isinstance(node.source, ParquetSource):
                # the scan's host half alone: Parquet decode with pushdown
                t0 = time.perf_counter()
                node.source._dataset.to_table(
                    columns=None if node.required_columns is None
                    else list(node.required_columns),
                    filter=_pushed_expression(node.pushed_filters,
                                              node.source._dataset.schema))
                times["ScanExec: Parquet read"] += time.perf_counter() - t0
            return out

        batch = run_plan(qe.executed_plan, ctx, visit)
        t0 = time.perf_counter()
        batch.to_arrow()
        times["egress"] += time.perf_counter() - t0
        return times, nodes, joins

    cold_times, _, _ = timed_pass(cold=True)
    times, nodes, joins = timed_pass(cold=False)
    total = sum(t for n, t in times.items() if ":" not in n)
    parts = ", ".join(
        f"{n} {s * 1e3:.1f} ms" + (f" ({nodes[n]} nodes)" if nodes[n] > 1
                                   else "")
        for n, s in sorted(times.items(), key=lambda kv: -kv[1]))
    if "ScanExec" in cold_times:
        parts += (f"; cold ScanExec {cold_times['ScanExec'] * 1e3:.1f} ms"
                  + "".join(f" [{n[10:]} {t * 1e3:.1f} ms]"
                            for n, t in cold_times.items()
                            if n.startswith("ScanExec:")))
    if joins:
        parts += f"; joins, ms: {', '.join(joins)}"

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    busy_s = busy / 1e6
    by_name = collections.defaultdict(float)
    for e in events:
        by_name[e.name[:48]] += (e.time_range.end - e.time_range.start) / 1e3
    top = ", ".join(f"{n} {ms:.2f} ms" for n, ms in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    device = (f"card busy {busy_s * 1e3:.2f} ms of {wall * 1e3:.1f} ms wall "
              f"(idle share {1 - busy_s / wall:.4f}, {len(spans)} device "
              f"events; most device time: {top})" if spans else
              "card busy time not measured (the profiler saw no device "
              "events)")
    return f"total {total * 1e3:.1f} ms: {parts}; {device}"


def kernel_report(D, launches, captured, phases):
    """One entry per kernel and main-path input shape, measured on the
    inputs that query gave it: the DataFrame programs' of KERNEL_INPUTS
    (each must have been captured when phase 5 ran), then each TPC-H and
    TPC-DS SQL query's that launched a kernel. `launches` counts all of
    the query's launches of that kernel."""
    import torch
    entries = []
    programs = KERNEL_INPUTS if "main" in phases else []
    missing = [pair for pair in programs if (pair[1], pair[0]) not in captured]
    if missing:
        raise AssertionError(f"no kernel input captured for {missing}")
    sql = [(name, label) for label, name in captured
           if label.startswith(("sql ", "tpcds "))]
    inputs = [(name, q, x) for name, q in programs + sql
              for x in captured[(q, name)].values()]
    for name, q, (idx, ir, fr, domain) in inputs:
        got = D.dense_groupby_sums(idx, ir, fr, domain)
        torch.cuda.synchronize()
        err = compare_sums(f"{name} on {q} inputs", got,
                           D.dense_groupby_sums_plain(idx, ir, fr, domain))
        t = measure(D, idx, ir, fr, domain)
        b, by = bound_ms(idx, len(ir) + len(fr), domain)
        log(f"[report] {name} on {q}'s inputs: n={idx.shape[0]} "
            f"domain={domain} int_rows={len(ir)} float_rows={len(fr)} "
            f"ms={t['ms']:.4f} kernel_ms={t['kernel_ms']:.4f} "
            f"bound_ms={b:.4f} share={b / t['kernel_ms']:.3f} "
            f"launches={launches[q][name]}")
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[q][name],
            "max_abs_err": err, "ms": t["ms"], "kernel_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
            "share": b / t["kernel_ms"], "library_ms": t["library_ms"],
            "shape": {"query": q, "n": int(idx.shape[0]), "domain": domain,
                      "int_rows": len(ir), "float_rows": len(fr)}})
    return entries


def parse_phases(argv) -> set:
    """The phases `--phases a,b,...` (or `--phases=a,b`) names; all of
    PHASES without it."""
    for i, arg in enumerate(argv):
        if arg.startswith("--phases"):
            value = arg.split("=", 1)[1] if "=" in arg else argv[i + 1]
            chosen = {p.strip() for p in value.split(",") if p.strip()}
            unknown = chosen - set(PHASES) - {"device", "build"}
            if unknown:
                raise SystemExit(f"unknown phases {sorted(unknown)}; "
                                 f"choose from {', '.join(PHASES)}")
            return chosen & set(PHASES)
    return set(PHASES)


def main(argv) -> int:
    t_start = time.perf_counter()
    phases = parse_phases(argv)
    #: only phases 3-4: the kernel shapes line, floats that differ between
    #: two runs reported, not fatal (for timing another checkout's kernels)
    shapes_only = not phases & set(MAIN_PHASES)
    try:
        import torch
        smi_line, name = phase_device()
        D = phase_build()
        if "kernels" in phases:
            shapes = phase_kernels(D, strict=not shapes_only)
        if "variants" in phases:
            phase_variants(D)
        if not shapes_only:
            launches, captured = run_phases(D, phases)
            entries = kernel_report(D, launches, captured, phases)
        if any(m == "jax" or m.startswith(("jax.", "spark_tpu."))
               or m == "spark_tpu" for m in sys.modules):
            raise AssertionError("the JAX package or JAX was imported")
    except Exception:  # noqa: BLE001 — the smoke run's one boundary
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi_line, flush=True)
    if shapes_only:
        if "kernels" in phases:
            print(json.dumps({"shapes": shapes}), flush=True)
        return 0
    print(json.dumps({"kernels": entries}), flush=True)
    if phases != set(PHASES):
        # a run of chosen phases proves part of the contract, not all of it
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
