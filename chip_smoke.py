"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --kernels-only  # phases 1-3 only

Phases, in order; any failure exits non-zero before the last line:

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
   the sort path). Each query is then run once more per operator, and
   once under torch.profiler for the card's busy share; each join
   reports the kernel it took (hash or sort), its hash-probe steps,
   whether its unique-build path held, and the query's re-plan attempts.
   Q3 and Q5 run again under `join.kernelMode=sort` and `=hash` and must
   give the same Arrow bytes as the default run;
6. main path, SQL: all 22 TPC-H queries as SQL text through
   `session.sql` on the same data, each compared with the port's pandas
   golden answer, and Q1, Q3, Q5 and Q6 with the DataFrame programs'
   results of phase 5 (columns in the DataFrame's order, Q5's rows by
   `n_name`). Each query starts with the launch counters at 0 and must
   launch the kernel `SQL_KERNELS` names; it prints its first and second
   run's wall times, re-plan attempts, launches, joins and breakdown as
   phase 5 does. Then the kernels are timed again on the exact inputs
   each query of phases 5 and 6 gave them.

The line before the last is a JSON object with one entry per kernel and
main-path input; the last line is `{"ok": true, "device": {...}}`.
`--kernels-only` ends with one JSON line of the shapes' results instead;
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
JOIN_MODE = "spark_tpu.sql.join.kernelMode"
#: shape (f)'s domain: one slot above the private variant's cut-off
#: (`dense_groupby.PRIVATE_DOMAIN`, checked in phase 3), fixed here so that
#: --kernels-only times another checkout's kernels on the same inputs
ABOVE_CUTOFF = 49
#: (domain, variant, its neighbour) timed against each other in phase 4
VARIANT_PAIRS = [(16, "private", "shared"), (32, "private", "shared"),
                 (48, "private", "shared"), (56, "private", "shared"),
                 (64, "private", "shared")]
SOURCE = "spark_tpu_torch/csrc/dense_groupby.cu"


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


def phase_main_path(D):
    """Q1, Q6, Q3, Q5 and the range group-by through the session on the
    card, and Q3 and Q5 under each join kernel. Returns the per-kernel
    launch counts of the runs and the kernel inputs each query handed
    the wrapper (for timing at those shapes)."""
    import numpy as np
    import torch
    import spark_tpu_torch as S
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.tpch import golden as G
    from spark_tpu_torch.tpch import queries as Q
    from spark_tpu_torch.tpch.datagen import write_parquet

    captured = {}
    original = D.dense_groupby_sums

    def recording(idx, int_rows, float_rows, domain, int_widths=None):
        kernel = "dense_sums_smem" if domain <= D.SMEM_DOMAIN \
            else "dense_sums_global"
        captured[(current[0], kernel)] = (idx, list(int_rows),
                                          list(float_rows), domain)
        return original(idx, int_rows, float_rows, domain, int_widths)

    current = [None]
    D.dense_groupby_sums = recording
    launches = {}
    try:
        session = S.SparkTpuSession.builder().get_or_create()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            path = write_parquet(tmp + "/tpch", SF)
            log(f"[main] TPC-H SF{SF} generated in "
                f"{time.perf_counter() - t0:.1f} s")
            Q.register_tables(session, path)
            n_lineitem = session.table("lineitem").plan.source.estimated_rows()
            results = {}
            for q, kernel in QUERY_KERNELS.items():
                current[0] = q
                for k in D.LAUNCHES:
                    D.LAUNCHES[k] = 0
                t0 = time.perf_counter()
                qe = Q.QUERIES[q](session)._qe()
                results[q] = qe.collect()
                torch.cuda.synchronize()
                cold = time.perf_counter() - t0
                launches[q] = dict(D.LAUNCHES)
                if kernel is not None and launches[q][kernel] < 1:
                    raise AssertionError(f"{q} did not launch {kernel}")
                t0 = time.perf_counter()
                Q.QUERIES[q](session).to_pandas()
                torch.cuda.synchronize()
                warm = time.perf_counter() - t0
                log(f"[main] {q}: {results[q].num_rows} rows; first run "
                    f"{cold:.3f} s, second run {warm:.3f} s "
                    f"({n_lineitem / warm / 1e6:.2f} M lineitem rows/s); "
                    f"launches {launches[q]}; re-plan attempts "
                    f"{qe.attempts}")
                if q in ("q3", "q5"):
                    log(f"[joins] {q}: {describe_joins(qe)}")
                log(f"[breakdown] {q}: {breakdown(Q.QUERIES[q](session))}")
            join_kernel_parity(S, Q, path, results)
            phase_sql(D, S, G, path, results, launches, current)

        current[0] = "range"
        for k in D.LAUNCHES:
            D.LAUNCHES[k] = 0
        df = session.range(RANGE_ROWS).group_by(col("id") % RANGE_MOD).agg(
            F.count(), F.sum(col("id")), F.avg(col("id")))
        t0 = time.perf_counter()
        out = df.collect()
        cold = time.perf_counter() - t0
        launches["range"] = dict(D.LAUNCHES)
        if launches["range"]["dense_sums_global"] < 1:
            raise AssertionError("range group-by did not launch "
                                 "dense_sums_global")
        t0 = time.perf_counter()
        df.collect()
        warm = time.perf_counter() - t0
        ids = np.arange(RANGE_ROWS, dtype=np.int64)
        keys = ids % RANGE_MOD
        cnt = np.bincount(keys, minlength=RANGE_MOD)
        total = np.zeros(RANGE_MOD, dtype=np.int64)
        np.add.at(total, keys, ids)
        got = out.to_pandas()
        if not (np.array_equal(got.iloc[:, 0].to_numpy(), np.arange(RANGE_MOD))
                and np.array_equal(got["count(*)"].to_numpy(), cnt)
                and np.array_equal(got["sum(id)"].to_numpy(), total)
                and np.allclose(got["avg(id)"].to_numpy(), total / cnt,
                                rtol=1e-15, atol=0)):
            raise AssertionError("range group-by disagrees with numpy")
        log(f"[main] range({RANGE_ROWS}).group_by(id % {RANGE_MOD}): "
            f"matches numpy; {len(got)} groups; first run {cold:.3f} s, "
            f"second run {warm:.3f} s ({RANGE_ROWS / warm / 1e6:.2f} M rows/s);"
            f" launches {launches['range']}")
        log(f"[breakdown] range: {breakdown(df)}")
    finally:
        D.dense_groupby_sums = original
    return launches, captured


def phase_sql(D, S, G, path, df_results, launches, current) -> None:
    """The 22 TPC-H queries as SQL text on the card: each against the
    golden answer, Q1/Q3/Q5/Q6 against the DataFrame programs' results,
    and each must launch the kernel SQL_KERNELS names. A query's
    launches are kept under `sql <q>`."""
    import torch
    from spark_tpu_torch.execution.executor import plan_nodes
    from spark_tpu_torch.plan.physical import JoinExec
    from spark_tpu_torch.tpch.queries import register_tables
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    session = S.SparkTpuSession.builder().get_or_create()
    register_tables(session, path)
    t_phase = time.perf_counter()
    for q, kernel in SQL_KERNELS.items():
        label = f"sql {q}"
        current[0] = label
        for k in D.LAUNCHES:
            D.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        qe = session.sql(SQL_QUERIES[q])._qe()
        got = qe.collect()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches[label] = dict(D.LAUNCHES)
        if kernel is not None and launches[label][kernel] < 1:
            raise AssertionError(f"SQL {q} did not launch {kernel}: "
                                 f"{launches[label]}")
        t0 = time.perf_counter()
        session.sql(SQL_QUERIES[q]).collect()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        gold = G.GOLDEN[q](path)
        golden_s = time.perf_counter() - t0
        G.compare(G.normalize_decimals(got.to_pandas())[
            gold.columns.tolist()].reset_index(drop=True), gold)
        same = ""
        if q in SQL_EQUALS_DATAFRAME:
            want = df_results[q]
            mine = got.select(want.column_names)
            if q == "q5":
                mine, want = mine.sort_by("n_name"), want.sort_by("n_name")
            tables_match(f"SQL {q} against the DataFrame program", mine, want)
            same = "; equals the DataFrame program's result"
        log(f"[sql] {q}: matches golden (golden {golden_s:.2f} s){same}; "
            f"{got.num_rows} rows; first run {cold:.3f} s, second run "
            f"{warm:.3f} s; launches {launches[label]}; re-plan attempts "
            f"{qe.attempts}")
        if plan_nodes(qe.executed_plan, JoinExec):
            log(f"[joins] sql {q}: {describe_joins(qe)}")
        log(f"[breakdown] sql {q}: "
            f"{breakdown(session.sql(SQL_QUERIES[q]))}")
    log(f"[sql] 22 queries in {time.perf_counter() - t_phase:.1f} s")


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
    as in the executor), and the second pass is reported: per operator
    type, each join by its tag, and the Arrow egress after it. A join's
    payload columns are gathered lazily, by whichever operator reads them
    first, so that gather time lands there. Then a further run under
    torch.profiler gives the card's busy time (the union of its kernel
    and copy intervals) against the run's wall time, and the kernels
    that took most of it."""
    import collections
    import torch
    from spark_tpu_torch.execution.executor import run_plan
    from spark_tpu_torch.io.sources import ParquetSource, _pushed_expression
    from spark_tpu_torch.plan import physical as P
    qe = df._qe()
    qe.execute_batch()

    def timed_pass():
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
            if isinstance(node, P.ScanExec) \
                    and isinstance(node.source, ParquetSource):
                # the scan's host half alone: Parquet decode with pushdown
                t0 = time.perf_counter()
                node.source._dataset.to_table(
                    columns=list(node.required_columns),
                    filter=_pushed_expression(node.pushed_filters,
                                              node.source._dataset.schema))
                times["ScanExec: Parquet read"] += time.perf_counter() - t0
            return out

        batch = run_plan(qe.executed_plan, ctx, visit)
        t0 = time.perf_counter()
        batch.to_arrow()
        times["egress"] += time.perf_counter() - t0
        return times, nodes, joins

    timed_pass()
    times, nodes, joins = timed_pass()
    total = sum(t for n, t in times.items() if ":" not in n)
    parts = ", ".join(
        f"{n} {s * 1e3:.1f} ms" + (f" ({nodes[n]} nodes)" if nodes[n] > 1
                                   else "")
        for n, s in sorted(times.items(), key=lambda kv: -kv[1]))
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


def kernel_report(D, launches, captured):
    """One entry per kernel and main-path input, measured on the inputs
    that query gave it: the DataFrame programs' of KERNEL_INPUTS, then
    each SQL query's that launched a kernel."""
    import torch
    entries = []
    sql = [(name, label) for label, name in captured
           if label.startswith("sql ")]
    for name, q in KERNEL_INPUTS + sql:
        idx, ir, fr, domain = captured[(q, name)]
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


def main(argv) -> int:
    t_start = time.perf_counter()
    kernels_only = "--kernels-only" in argv
    try:
        import torch
        smi_line, name = phase_device()
        D = phase_build()
        shapes = phase_kernels(D, strict=not kernels_only)
        if not kernels_only:
            phase_variants(D)
            launches, captured = phase_main_path(D)
            entries = kernel_report(D, launches, captured)
        if any(m == "jax" or m.startswith(("jax.", "spark_tpu."))
               or m == "spark_tpu" for m in sys.modules):
            raise AssertionError("the JAX package or JAX was imported")
    except Exception:  # noqa: BLE001 — the smoke run's one boundary
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi_line, flush=True)
    if kernels_only:
        print(json.dumps({"shapes": shapes}), flush=True)
        return 0
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
