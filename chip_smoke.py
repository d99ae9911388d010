"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, as below
    python3 chip_smoke.py --phases kernels,fuzz   # chosen phases (PHASES)
    python3 chip_smoke.py --phases kernels     # phases 1-3 only
    python3 chip_smoke.py --phases ooc         # phase 12 (and 1-2)
    python3 chip_smoke.py --phases udf         # phase 13 (and 1-2)
    python3 chip_smoke.py --phases mesh        # phase 14 (and 1-2); on a
        # host with 4 cards its 4-card cases run too
    python3 chip_smoke.py --phases obs         # phase 15 (and 1-2)
    python3 chip_smoke.py --phases elastic     # phase 16 (and 1-2); on a
        # host with 4 cards its cases run on cuda:0-3
    python3 chip_smoke.py --phases stream      # phase 17 (and 1-2)
    python3 chip_smoke.py --phases analysis    # phase 18 (and 1-2)
    python3 chip_smoke.py --phases serve       # phase 19 (and 1-2)
    python3 chip_smoke.py --phases fleet       # phase 20 (and 1-2)
    python3 chip_smoke.py --phases libs        # phase 21 (and 1-2)
    python3 chip_smoke.py --phases cluster     # phase 22 (and 1-2); on a
        # host with 4 cards its two-cards-a-process cases run too

Phases, in order; any failure exits non-zero before the last line.
Phases 1 and 2 always run; `--phases` names the others, from PHASES:
kernels (3), variants (4), main (5), sql (6), tpcds (7), window (8),
fuzz (9), functions (10), etl (11), ooc (12), udf (13), mesh (14),
obs (15), elastic (16), stream (17), analysis (18), serve (19),
fleet (20), libs (21), cluster (22).
Each query of
phases 5-8, 10, 11's aggregates and 13 runs twice: a
first run, after the device table cache and the session's kept
capacities are emptied, and a warm run, which reuses the cached scans
and the kept capacities. Both
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
   cut-off. Ints must equal the plain version's, floats lie within rtol
   1e-12 of per-slot tree sums (`reference_sums`: the plain version's
   atomic float adds drift further on large slots), and two runs of (c)
   must give equal float sums. Each shape gives the wrapper's time (`ms`, CUDA events around
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
   for the card's busy share, then 9 more warm runs with the stage's
   dispatch wait polling and 9 blocking, interleaved (`[sync]` lines,
   the medians); each join
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
   wall times, re-plan attempts, launches and joins, and Q1, Q5 and Q21
   (`BREAKDOWN_QUERIES`; Q8 and Q18 cut to fit the full run in
   its time limit) their breakdown, as phase 5 does;
7. main path, TPC-DS: SF1 generated with the port's datagen (seed 42,
   2,878,376 store_sales rows), the 21 queries of `tpcds/sql_queries.py`
   through `session.sql`, each compared with the port's pandas golden
   and required to launch the kernel `TPCDS_KERNELS` names, with the
   same `[sql]` and `[joins]` lines as phase 6 (`[breakdown]` for q27
   and q61); the six
   DataFrame forms must give their SQL text's rows, and q19 and q68 the
   same Arrow bytes under `join.kernelMode=sort` and `=hash`;
8. windows at SF1: one DataFrame program computes row_number, rank, lag
   and a 7-row running sum per customer and a 30-row running max per
   store over all of store_sales, against pandas, with its wall times
   and breakdown; a whole-partition float sum over the same rows,
   partitioned by customer, by store and not at all, must repeat bit
   for bit;
9. fuzz: the differential plan fuzzer (`testing/plan_fuzz.py`), seeds
   0-199 at maxRows 40, then seeds 0-24 at maxRows 4096, both under
   `aggregate.kernelMode=auto`, then seeds 0-199 at maxRows 40 under
   `=matmul` (FUZZ_RUNS; cut from 50 and 1,000 seeds to fit the
   full run in its time limit; seeds 78 and 104 launch dense_sums_smem
   there): each seed's query through a CUDA session and a
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
10. functions: the function-library programs of
   `testing/function_queries.py` at SF1: F1 (lineitem moments: stddev,
   variance, corr, covar, skewness, kurtosis and count_if by
   (l_returnflag, l_linestatus), all sums, so `dense_sums_smem` with 11
   int and 26 float rows), F2 (percentile, median, first/last,
   bool_and/bool_or and date functions over 1994's lineitem by ship mode
   and quarter) and F3 (13 string, date, math and bit functions over
   TPC-DS customer joined to customer_address). Each a first and a warm
   run through `session.sql`, as phases 6-7 run a query, both against
   the pandas/numpy/scipy golden of `function_queries` (F1's moments
   within the bound it derives from the data, other floats within rtol
   1e-12, the rest exactly); F1 must launch `dense_sums_smem` in both
   runs. Then F1 once more under `aggregate.kernelMode=scatter`, which
   must launch no kernel and agree with the kernel's result within the
   same bound: the kernel's float rows held against the plain path at
   full width.
11. etl, on phase 5's TPC-H SF1 tables, every step held to its answer:
   the warehouse (`CREATE TABLE li_94 AS SELECT` Q1's columns of 1994's
   lineitem, `INSERT INTO li_94 SELECT` 1995's, Q1 over li_94 against
   pandas over the two years, launching `dense_sums_smem`; a fresh
   session over the warehouse gives the same bytes; SHOW TABLES,
   DESCRIBE and DROP TABLE); `cache()` of 1993-1996's lineitem, a
   Q1-shaped aggregate and a join to orders over it with the bytes they
   give without cache(), `__cached__` scans and a rising hit counter,
   `l_partkey, count(*)` against pandas, and Parquet plans again after
   `unpersist()`; `write.parquet` of orders x customer in every mode,
   read back; lineitem written as CSV and read with `read_csv`, Q1 and
   Q6 over it against pandas on the same Arrow table within rtol 1e-9
   (float columns: both launch `dense_sums_smem`); orders as JSON lines
   through `read_json`, counted and summed by status against pandas;
   `collect_list(l_linenumber)` and `collect_set(l_shipmode)` by
   l_orderkey (1,500,000 groups, 6,001,215 elements) against pandas'
   sorted lists and sets, size/element_at/array_contains over them, and
   `explode` back to lineitem's multiset; a count-min sketch of
   l_partkey equal to a CPU session's bit for bit and within eps*N, a
   Bloom filter of l_orderkey without false negatives; and
   `explain(extended=True, runtime=True)` of SQL Q5 with every section,
   rows out on every operator and `[joins]` agreeing with `reorder:`.
12. ooc, out-of-core execution and recovery: lineitem at SF10 (about
   60M rows, written in ten pieces by `write_lineitem_pieces` in a child
   process started with the run, so the writing overlaps phases 5-11;
   its seconds and this phase's wait for it printed), SQL Q1 and Q6 once
   each under the default conf (a warm run would ingest again, as the
   stream rides no device cache: cut to fit the full run in its time
   limit): each must stream (`InputExec(streamed_agg,...)`, one
   chunk of 2^24 rows per 2^24 rows the pushed filter passes: Q1 4, Q6
   1), launch `dense_sums_smem` exactly the chunks times the launches
   `plan_launches` plans for one chunk's input, and no other kernel, and
   equal an exact golden built from the
   generator's integer arrays piece by piece; each prints its wall
   times, per-chunk wait, decode, copy and update times, the prefetch
   wait, the peak allocated bytes beside the whole-input estimate, and
   the idle share of one profiled run. Q1 under
   `aggregate.kernelMode=scatter` launches no kernel and gives the same
   bytes; `range(2^26).group_by(id % 65536)` streams four chunks, with
   one chunk's planned `dense_sums_global` launches each, against the
   closed form; phase 5's
   SF1 data under `memory.deviceBudget` 65,536 and 2^20-row chunks
   gives each whole-input result's bytes (Q1, Q5 streamed, Q3 spilled,
   a top-10 and a plain chain through external collect). Faults:
   `stream_chunk:unavailable:2` and `ingest_prefetch:unavailable:1`,
   armed together on one SF10 Q1 run (one run, not two, to fit the full
   run in its time limit), replay one chunk each, two injected
   out-of-memory errors at an
   SF1 whole-table load climb the ladder to the 1-byte-budget re-plan,
   and SF10 Q1 forced to load whole under a memory fraction (printed)
   runs out of memory for real and lands on the stream, each with the
   clean bytes and the expected `fault_summary`. Last, a deadline of
   half Q1's warm time and a `session.cancel` from a timer thread each
   stop it within dispatchPollMs plus one chunk (printed), leave no
   prefetch thread, and a rerun gives the clean bytes.
13. udf, Python UDFs on phase 5's TPC-H SF1 tables, each program a first
   and a warm run in the in-process lane and then a first run in the
   worker lane (its warm runs cut to fit the full run in its time
   limit; `udf.mode=worker`, 2 workers, 10,000 rows per Arrow batch), whose
   bytes must equal the in-process lane's, and every run against pandas:
   U1, a pandas UDF `net(price, discount)` registered for SQL inside a
   Q1-shaped aggregate (sum and avg of it by l_returnflag, l_linestatus
   over 6M rows; floats within rtol 1e-9), which must hand
   `dense_sums_smem` a float row; U2, scalar UDFs as a group key
   (o_orderpriority's word) and in a filter (year of o_orderdate) over
   orders, totals exact; U3, scalar UDFs over customer's decimal
   c_acctbal and a date, exact; U4, `apply_in_pandas` over orders by
   o_orderpriority (5 groups) and a dense aggregate over its result,
   which must launch `dense_sums_smem`. Each run prints its phase times
   with the UDF stage split into the child's run, egress, evaluation and
   re-ingest, and its `udf_summary`; the worker lane its spawn times;
   the in-process lane a `[breakdown]` line. Then U5 on U1 in the worker
   lane: `udf_batch:fatal:3` replays one batch and
   `udf_worker_spawn:unavailable:1` recovers, each with U1's bytes; a
   raising UDF surfaces as UdfError with the worker's traceback; a
   cancel after the fifth batch raises QueryCancelledError and leaves no
   child process (read from /proc), and a rerun gives U1's bytes.
14. mesh, on phase 5's TPC-H SF1 tables: a session built with
   `device("cuda:0")` at `spark_tpu.sql.mesh.size` 4 (four shards, each
   on its own thread, all on one card) runs DataFrame and SQL Q1, Q3, Q5
   and Q6 and `range(16M).group_by(id % 65536)`, a first and a warm run
   each: every plan must show its ExchangeExecs, every run equal the
   golden (the range numpy's) and, when phase 5 ran, its one-card
   result, take no recovery action, and launch its kernel
   (`MESH_KERNELS`; `dense_sums_global` for the range) once per shard at
   least. Each prints its wall times, attempts, launches by card, and
   the SQL cases and the range (the DataFrame cases' cut to fit
   the full run in its time limit) a timed run's per-operator times (the
   slowest shard's), the bytes the
   collectives copied between cards with their rate against the NVLink
   bound, and each card's busy share under torch.profiler. Then
   `mesh:fatal:1` must gang-restart Q1 on the mesh (`mesh_restart` 1)
   and, with `meshRestart.enabled` false, re-plan it on one device
   (`mesh_fallback` 1), each with the golden; `shuffle:unavailable:1`
   must retry it, and a session built
   without a device at mesh.size 8 must raise "devices visible". With 4
   cards (`python3 chip_smoke.py --phases mesh` on a host with four)
   the same cases run on a session built without a device, whose shards
   sit on cuda:0-3 and must each launch the kernel on their own card;
   then the 22 TPC-H SQL queries at SF1 (first and warm, the golden,
   `SQL_KERNELS` on every card) and SF10 lineitem (written as phase 12
   writes it) through SQL Q1 and Q6, resident across the cards (the
   device cache's budget raised to `MESH_CACHE_BYTES`, so nothing
   streams), against phase 12's exact golden, with each card's peak
   allocated bytes.
15. obs, the observability spine on phase 5's TPC-H SF1 tables (written
   here when phase 15 runs alone): SQL Q1, Q5, Q6 and
   `range(16M).group_by(id % 65536)` in a session with every
   observability output on (event log, Chrome traces,
   `metrics.sink=prometheus,jsonl`, `observability.xlaCost=on`, and a
   torch.profiler trace of Q1's first run) and in one with every
   observability key off: a first run in each, then OBS_RUNS warm runs
   of each interleaved. Every run starts with the launch counters at 0
   and must launch its kernel (`OBS_KERNELS`); the first run in the
   `on` session is held to the golden (the range to numpy), and every
   other run must give its bytes. `[obs]` lines print each program's
   warm medians on and off and their ratio, its event's bytes and each
   observability step's own milliseconds a run (`OBS_STEPS`: the
   query-end post, `_build_event`, the event-log, trace, metrics-sink
   and flight-recorder listeners, the stage event, the cost capture).
   Then an injected `stage_run:fatal:1` must leave one flight-recorder
   bundle; the log must pass `scripts/events_tool.py validate` (a
   subprocess), replay through `spark_tpu_torch.history` with one line
   per execution, and give every execution a `peak_hbm_bytes` between 1
   byte and the card's capacity (`hbm_summary`, printed per query);
   every Chrome trace and the profile must parse; `metrics.prom` must
   count every execution's latency; and DF Q1 at 4 shards pinned to
   cuda:0 with `observability.shardSpans=on` must log one `transfer`
   record per shard for each exchange that routes rows.
16. elastic, the mesh stream and the elastic mesh on SF10 lineitem
   (phase 12's data, written here when phase 12 does not run) at
   mesh.size 4: on one card a session built with `device("cuda:0")`
   (four shards on it), on a host with four cards a session built
   without a device (the shards on cuda:0-3). The device cache stays at
   its default, below the scan, so every query streams per shard
   (`InputExec(streamed_partial_agg,...)`). SQL Q1 and Q6, a first and a
   warm run each, must equal phase 12's exact golden and launch
   `dense_sums_smem` once per shard and chunk at least (on every card of
   a mesh of cards); each prints its wall times, per chunk its host
   decode, host copy, stripe copies and each shard's device update,
   the per-shard telemetry records and the peak allocated bytes. Then
   Q1's recovery, each against the golden: `mesh_checkpoint:fatal:2`
   with a checkpoint every chunk must gang-restart once (no fallback)
   and resume on the mesh replaying at most one chunk; with every
   restart attempt failed at `mesh_restart` the query must land on one
   device and resume from the checkpoint (`resume_from_mesh_checkpoint`);
   `session.decommission_shards([3])` from a listener after chunk 1
   must drain at a boundary, leave mesh.size 3 (on cards, cuda:3
   excluded and the tail on three cards) and resume from the forced
   checkpoint; and in 2^22-row chunks (15; `straggler.minChunks` is 4)
   a `shard_chunk:slow` fault on shard 2 every chunk must make the
   rebalancer move rows off it (`shard_rebalance`, `rebalance_rows` >
   0). The phase prints its time.
17. stream, structured streaming over TPC-H SF1 lineitem (phase 5's
   data, written here when phase 17 runs alone) sorted by l_orderkey,
   with `l_ts` (l_shipdate as timestamp[us]) added, as 24 Parquet files
   that move into a watched directory 4 at a time, one
   `process_available()` (one trigger) a wave, every case on a session
   on the card. S1: `file_stream` in complete mode grouped by
   `pmod(l_orderkey, 2^20 - 1)` (2^20 slots with the NULL slot) with
   two decimal sums and a count, equal to pandas over the rows delivered
   after triggers 3 and 6, `dense_sums_global` launched every trigger,
   device memory after trigger 6 within the state's bytes of trigger
   1's, trigger 5 under torch.profiler for the idle share. S2: grouped
   by `pmod(l_suppkey, 200)` with sum, a decimal avg and a count and a
   HAVING count above it, exact against pandas after every trigger,
   `dense_sums_smem` every trigger. Each trigger of S1 and S2 prints its
   slice decode, ingest, update, state copy, diff and write, finalize
   and emit times (host clock, the card synchronised at each boundary),
   the delta's bytes, its launches and `memory_allocated`. S3:
   `with_watermark("l_ts", "30 days")` and `window("l_ts", "7 days")`
   in append mode into a FileStreamSink, against a numpy model of the
   watermark, equal to the same stream through a CPU session, and again
   with `state.spillBytes` 1 (the spill tier engaged) giving the same
   rows. S4: S1 over 3 files in 3 triggers, killed by a fatal fault at
   trigger 2 at each of the four `stream_*` seams and finished by a
   fresh query on the checkpoint: equal to the golden, committed batch
   ids 0, 1, ... once each, `streaming_restore_ms` printed. S5: S2's
   query unattended (`start(trigger_ms=200)`) over a socket fed with
   the 24 files' tables by a FrameProducer, one `stream_net_recv`
   failure and one killed connection mid-stream: equal to S2's result,
   every frame once, the status store showing the live stream.
18. analysis, static analysis on the card over phase 5's TPC-H SF1
   tables (written here when phase 18 runs alone), sessions with the
   analyzer on, `planChangeValidation=full` and `planChangeLog=true`.
   (a) The 22 SQL queries: each result equal to phase 6's first run (the
   golden, when phase 6 did not run), its launches equal to phase 6's,
   its findings, predictions and rule trace equal to a CPU session's
   over the same files; per query the `analyze` span, which must leave
   the launch counts, `memory_allocated` and the device cache's bytes
   unchanged, and the optimizer's ms under full against off (medians of
   3 warm plannings). (b) Under `analysis.strict`: the JAX package's
   strict shape (an int32 sum over 2^33 range rows) and a 64-group sum
   over a 6,001,215-row decimal(18,0) table near the type's top each
   raise AnalysisFindingError with no device work (launches, allocated
   bytes, cache bytes unchanged; no ingest or dispatch span); strict
   off, the decimal group sum runs through `dense_sums_smem` and equals
   a CPU session's. (c) The table's global decimal sum runs through
   `dense_sums_smem`, equals the CPU session and posts exactly one
   AnalysisEvent. (d) One session with every observability output on
   and four threads of 8 queries each over SQL Q1/Q5/Q6 and the range,
   a stateful streaming query triggering beside them, under lockwatch:
   every result equal to its single-thread result, the stream to
   pandas, the observed lock order consistent with the registry's ranks,
   no thread leaked; each lock's acquisitions, contention and longest
   hold, and what a watched acquire costs over a plain one.
19. serve, the SQL service (`spark_tpu_torch.service`) on the card over
   phase 5's TPC-H SF1 tables (written here when phase 19 runs alone)
   and a range view (RANGE_ROWS ids in one Arrow source) grouped by
   `pmod(id, 131072)`. Each query of Q1, Q3, Q5, Q6 and the range first
   runs single-threaded (a first and a warm `collect()`, against phase
   6's result, the golden or numpy; its kernel inputs kept under `serve
   <q>`). (a) A SqlService on the card, 2 slots, a queue of 16 and the
   card's whole memory as hbmBudget, started on 127.0.0.1: four client
   threads, one pooled session each, send each query three times over
   `POST /sql` (Q1 and Q6 in Arrow, the rest in JSON); every result must
   equal its single-thread run and both kernels must launch through the
   service. Per query: latency p50/p95, admission wait p50/p95 and the
   warm single-thread time; queries/s, max_memory_allocated, and one
   more round under torch.profiler for the card's busy share. (e) Phase
   18(d)'s four query threads through the four pooled sessions under
   `LockWatch.install_service`: results equal, every observed nesting an
   edge of the static lock graph, at least one under the session lease,
   no thread leaked; each lock's acquisitions, contention and longest
   hold. (f) /metrics, /status, /healthz/ready and /debug/bundle (one
   bundle per pooled session) answer. (b) With both slots held, an async
   burst of 24 gets 6 structured 429s (service_rejected rises by as
   many), the 18 accepted finish; on a one-slot service with a 300 ms
   queue timeout and one in-flight query a session, a session's second
   query is a 429 SESSION_QUOTA_EXCEEDED and a queued one a 503
   ADMISSION_TIMEOUT. (d) A DELETE of a running Q1 streamed in 16,384-row
   chunks gives QUERY_CANCELLED and memory_allocated as before it; a
   request-conf queryDeadlineMs gives QUERY_DEADLINE_EXCEEDED; phase 17's
   S2 (201 slots) over three lineitem files, unattended, shows under
   `GET /queries`' streams, stops on `DELETE /queries/stream-<n>`, equals
   pandas and logs one trigger record per committing tick. (c) The
   arbiter, a service per case and the device cache emptied first, with
   the card's total_memory printed beside its name and power limit:
   hbmBudget 4096 denies Q1's lease and Q1 streams to the same result;
   8 GiB grants it; one and a half Q1 scans' bytes runs two sessions' Q1
   at once, one resident and one streamed; hbmShare 0.25 streams the
   second of the greedy session's two scans. No lease or pin outlives a
   case.
20. fleet, the crash-only serving fleet (`spark_tpu_torch.service.fleet`)
   on the card over phase 5's TPC-H SF1 tables and phase 19's range view,
   held to phase 19's single-thread references (computed here when phase
   19 does not run). The parent's device cache is emptied first and the
   card's free memory read. (a) A FleetSupervisor with 2 workers (`python
   -m spark_tpu_torch.service.fleet --worker`, fresh interpreters, each
   its own CUDA context on cuda:0 with service.hbmBudget at half the free
   memory, PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True): four
   sessions send Q1, Q3, Q5, Q6 and the range through the
   router in two rounds; every result equals its reference and lands on
   its session's ring home, as its `q-w<i>g<gen>-` id says; /metrics
   merges both workers' series under `worker` labels. Each worker's
   spawn-to-ready seconds, per query the p50/p95 latency through the
   router beside phase 19's served p50 and the warm single-thread time,
   and queries/s. (b) While alpha's Q1 (sync, Arrow) and gamma's (async)
   run on their home worker, slowed by a `stage_run:slow` rule, that
   worker is SIGKILLed: alpha's read fails over once and returns 200
   byte-equal to (a)'s, gamma's id answers 503 WORKER_LOST, the pid is
   reaped, the worker respawns at generation 2 and reaches ready, Q1 on
   it is byte-equal again, and the card's free memory rises once the
   pid is reaped and, after the respawned worker serves its sessions'
   traffic (one round, cut from two to fit the time limit), is within 5% of its value at the fleet's start, before the
   kill (both read with every worker idle, its device table cache
   dropped and its cached blocks returned, through a watcher the
   workers' init module starts, and printed with what each worker still
   held; the same reading after (a) too; the failover target's Q1 scans
   are cached again before the kill). The failover latency
   and the respawn time. (c) A fleet whose init spec raises is
   quarantined after restartMaxPerWindow crashes, sheds POST /sql with
   503 FLEET_UNAVAILABLE and leaves one flight bundle per death. (d)
   shutdown() with a query in flight: new work gets 503 FLEET_DRAINING,
   the in-flight query equals its reference, the workers exit 0, no pid
   or `fleet*` thread is left. Each worker's init module reports at its
   exit (after its drain) its launches, device, max_memory_allocated and
   any JAX module loaded: none may be, and both kernels must have
   launched inside the workers.
21. libs, the ML and graph libraries on a session on the card over phase
   5's TPC-H SF1 tables (written here when phase 21 runs alone). ML on
   l_quantity, l_discount and l_tax as doubles, assembled by
   `VectorAssembler` through the engine over all 6,001,215 lineitem
   rows: `LinearRegression` of l_extendedprice against numpy's lstsq on
   the same matrix (rtol 1e-8); `LogisticRegression` of l_returnflag =
   'R' (25 steps of 0.005) and `KMeans` (k = 8, 10 iterations; both
   halved to fit the full run in its time limit) each
   against a float64 numpy run of the same algorithm from the same start
   (rtol 1e-9; k-means assignments equal wherever the two nearest
   centres differ by more than 1e-9). The graph: customers and suppliers
   (160,000 vertices), one edge per lineitem row from its order's
   customer to its supplier (6,001,215 edges): `page_rank` (20
   iterations) against numpy (rtol 1e-10, summing to n) and
   `connected_components` against scipy exactly. Each prints its wall
   time, its device part (CUDA events), the collect, the supersteps and
   their host reads, and max_memory_allocated.
22. cluster, the mesh across engine processes
   (`spark_tpu_torch/parallel/cluster.py`), over phase 5's TPC-H SF1
   tables: two engine processes started by
   `spark_tpu_torch.parallel.launch.run_cluster`, each pinned to cuda:0
   with two shards (mesh.size 4, tensors over gloo), run SQL Q1, Q3, Q5,
   Q6 and the range group-by, each a first and a warm run, against the
   goldens and, in bytes, against phase 14's one-process pinned mesh-4
   run (this phase's own when phase 14 does not run); each process must launch both kernels (counted in the
   process, reported at its exit). Then `mesh:fatal:1` in rank 1 alone:
   both ranks gang-restart to the golden, and with both rungs off both
   raise it within 30 s; and rank 1 killed with SIGKILL mid-query: rank
   0 raises ClusterPeerLostError within 30 s. Before the kill, the
   elastic mesh across the processes, SQL Q1 over SF10 lineitem (phase
   12's data, written here when no earlier phase wrote it) mesh-streamed
   per shard, each case on a fresh session with the per-shard telemetry
   on: the stream; then in phase 16's straggler chunks of 2^22 rows, a
   drain of position 3 requested from a listener in rank 1 alone after
   chunk 1 (both drain at the same chunk, mesh.size 3 after); position
   3 slowed 100 ms a chunk at the `shard_chunk` seam in rank 1 alone
   (both flag it at the same chunk and move the same rows);
   `mesh_checkpoint:fatal:2` in rank 1 alone with a checkpoint every
   chunk (both gang-restart from the same cursor, replaying at most one
   chunk). Each is held to the exact
   golden and the same outcome in both ranks, `dense_sums_smem` must
   launch in both, and the stream's bytes must equal phase 16's first
   one-process pinned Q1 stream (checked in phase 16, which runs later;
   without phase 16 this phase runs that stream itself and keeps its
   kernel inputs for the `cluster stream` row). Each rank prints its
   backend, its init_process_group and spawn-to-ready seconds, each
   query's walls, the bytes its warm runs received from the peer (and
   their rate), its launches, and per chunk of the stream its decode,
   stripe copy, update and agreement ms. On a host with 4 cards, two
   processes with two cards each (over NCCL) run the 22 SQL queries and
   SF10 Q1/Q6 resident against the goldens, then the same fault, the
   stream cases and the kill (a peer lost on NCCL is found by its
   stopped heartbeat).
Then the kernels are timed again on the exact inputs the first run of
each query of phases 5-7, 10-13 and 19 gave them (a chunk's input, for a
streamed query), on S1's and S2's trigger inputs, for phase 20 on
phase 19's Q1 and range inputs (the workers run the same plans on the
same data) under the launches the workers reported, and for phase 22 on
the one-process pinned mesh's Q1 and range inputs (phase 14's) under the
launches the engine processes reported, and on the one-process pinned
SF10 Q1 stream's shard chunk (phase 16's, or phase 22's own without
phase 16: the same chunks striped alike) under the launches of the two
processes' stream (the `cluster stream` row).

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

import datetime
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
#: runs of the plain version and the library call a timing takes (their
#: medians are yardsticks, some 100x the kernel's time on large inputs;
#: cut from REPS to fit the full run in its time limit)
YARDSTICK_REPS = 5
#: spin cycles queued ahead of each kernel_ms sample, about 1 ms at the
#: H100's 1.98 GHz SM clock
SPIN_CYCLES = 2_000_000
SF = 1.0
RANGE_ROWS = 16_000_000
RANGE_MOD = 65536
#: runs of each wait in phase 5's polling-against-blocking comparison
SYNC_PAIRS = 9
#: phase 12: the scale of the streamed lineitem, the chunks the range
#: stream cuts (streamingChunkRows, 2^24, by default; a scan's chunks
#: count the rows its pushed filter passes), and the range's rows
OOC_SF = 10
OOC_RANGE_CHUNKS = 4
OOC_RANGE_ROWS = 1 << 26

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
#: the queries of phases 6 and 7 that get a `[breakdown]` (four more runs
#: each: converge, cold pass, cached pass, profiled run), the ones
#: PERF.md's tables name; cut from every query to fit the full run in
#: its time limit. Phase 10's programs all get one.
BREAKDOWN_QUERIES = {"sql": ("q1", "q5", "q21"),
                     "tpcds": ("q27", "q61")}
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
PHASES = ("kernels", "variants", "main", "sql", "tpcds", "window", "fuzz",
          "functions", "etl", "ooc", "udf", "mesh", "obs", "elastic",
          "stream", "analysis", "serve", "fleet", "libs", "cluster")
#: the phases that drive the package's main path (run_phases)
MAIN_PHASES = ("main", "sql", "tpcds", "window", "fuzz", "functions", "etl",
               "ooc", "udf", "mesh", "obs", "elastic", "stream", "analysis",
               "serve", "fleet", "libs", "cluster")
#: the hand kernels each function-library program must launch at SF1
#: (F2's and F3's aggregates and functions run as torch ops: the
#: positional sort, the sort aggregate, the date and bit arithmetic)
FUNCTION_KERNELS = {"f1": ("dense_sums_smem",), "f2": (), "f3": ()}
#: phase 9's fuzz campaigns: (seeds, the generator's maxRows,
#: spark_tpu.sql.aggregate.kernelMode on both sessions)
FUZZ_RUNS = ((range(0, 200), 40, "auto"), (range(0, 25), 4096, "auto"),
             (range(0, 200), 40, "matmul"))
AGG_MODE = "spark_tpu.sql.aggregate.kernelMode"
#: phase 13: the UDF lane's key, and the worker lane's pool bound and rows
#: per Arrow batch
UDF_MODE = "spark_tpu.sql.udf.mode"
UDF_WORKER_CONF = (("spark_tpu.sql.udf.pool.maxWorkers", 2),
                   ("spark_tpu.sql.udf.arrow.maxRecordsPerBatch", 10_000))
#: the date U3's second UDF offsets by c_nationkey days
U3_START = datetime.date(1995, 1, 1)
#: the hand kernels each phase-13 program must launch at SF1 (U2's and
#: U3's are printed: U2's dense key over a UDF's strings, U3 no aggregate)
UDF_KERNELS = {"u1": ("dense_sums_smem",), "u2": (), "u3": (),
               "u4": ("dense_sums_smem",)}
#: phase 14: the mesh's shards, its queries (DataFrame and SQL) with the
#: kernel each must launch once per shard, the NVLink rate each way a
#: card (H100 SXM, NVLink 4: 18 links x 25 GB/s), and the device-cache
#: budget under which SF10 lineitem stays resident across the cards
MESH_KEY = "spark_tpu.sql.mesh.size"
MESH_SHARDS = 4
MESH_QUERIES = ("q1", "q3", "q5", "q6")
MESH_KERNELS = QUERY_KERNELS
NVLINK_BYTES_PER_S = 450e9
CACHE_KEY = "spark_tpu.sql.io.deviceCacheBytes"
MESH_CACHE_BYTES = 64 << 30
#: phase 15: the SQL queries it runs (with the range group-by), the
#: kernel each must launch, its warm runs per session, and the conf of
#: the session with every observability key off
OBS_SQL = ("q1", "q5", "q6")
OBS_KERNELS = {"q1": "dense_sums_smem", "q5": "dense_sums_smem",
               "q6": "dense_sums_smem", "range": "dense_sums_global"}
OBS_RUNS = 9
#: the observability steps phase 15 times (`obs_steps`), in print order
OBS_STEPS = ("query end", "_build_event", "event log", "trace write",
             "metrics sinks", "flight recorder", "stage event",
             "cost reset", "cost read")
#: phase 16: the elastic keys it sets, the chunk rows of its straggler
#: case (15 chunks of SF10 Q1), the straggling shard and its injected
#: wait a chunk
CKPT_KEY = "spark_tpu.execution.checkpoint.everyChunks"
RESTART_MAX_KEY = "spark_tpu.execution.meshRestart.maxRestarts"
SPANS_KEY = "spark_tpu.sql.observability.shardSpans"
CHUNK_KEY = "spark_tpu.sql.execution.streamingChunkRows"
ELASTIC_SLOW_CHUNK_ROWS = 1 << 22
ELASTIC_SLOW_SHARD = 2
ELASTIC_SLOW_MS = 100
OBS_OFF = (("spark_tpu.sql.metrics.enabled", False),
           ("spark_tpu.sql.observability.xlaCost", "off"),
           ("spark_tpu.sql.observability.shardSpans", "off"),
           ("spark_tpu.sql.status.enabled", False),
           ("spark_tpu.sql.flightRecorder.enabled", False))

#: phase 17: the feed's files and the files a trigger takes; S1's
#: modulus (2^20 - 1 value slots and the NULL slot a pmod key keeps:
#: dense_sums_global's full 2^20); S2's modulus and HAVING bound; S3's
#: watermark delay, window and spill budget (bytes: the event-time state
#: of weekly windows holds a few hundred bytes, so only a budget below
#: that engages the spill tier); S4's files, wave and seams (one file a
#: trigger, cut from two to fit the full run's time limit); S5's
#: trigger interval
STREAM_FILES = 24
STREAM_WAVE = 4
STREAM_S1_MOD = (1 << 20) - 1
STREAM_S2_MOD = 200
STREAM_S2_MIN_ROWS = 5000
STREAM_DELAY = "30 days"
STREAM_WINDOW = "7 days"
STREAM_SPILL_BYTES = 1
STREAM_S4_FILES = 3
STREAM_S4_WAVE = 1
STREAM_SEAMS = ("stream_source_list", "stream_offset_write",
                "stream_state_commit", "stream_sink_emit")
STREAM_S5_TRIGGER_MS = 200

#: phase 18: the conf of its sessions (the analyzer on, every rule
#: application validated, the change log's diffs kept), the validation
#: key its planning times toggle, the warm planning runs a mode (their
#: median is printed), the strict key; (b)-(c)'s decimal table: rows
#: (lineitem's at SF1), group modulus; (d): threads, queries a thread,
#: the programs they cycle through, the stream's key modulus, its
#: frames and rows a frame, its trigger interval
ANALYSIS_CONF = (("spark_tpu.sql.analysis.enabled", True),
                 ("spark_tpu.sql.planChangeValidation", "full"),
                 ("spark_tpu.sql.planChangeLog", True))
VALIDATION_KEY = "spark_tpu.sql.planChangeValidation"
ANALYSIS_RUNS = 3
STRICT_KEY = "spark_tpu.sql.analysis.strict"
DECIMAL_ROWS = 6_001_215
DECIMAL_GROUPS = 64
LOCKWATCH_THREADS = 4
LOCKWATCH_QUERIES = 8
LOCKWATCH_PROGRAMS = ("q1", "q5", "q6", "range")
LOCKWATCH_STREAM_MOD = 200
LOCKWATCH_FRAMES = 12
LOCKWATCH_FRAME_ROWS = 100_000
LOCKWATCH_TRIGGER_MS = 50
#: phase 19: the main service's admission bounds, the client sessions
#: (one thread each), the rounds each client runs, the queries (SQL
#: text, or "range") and the ones sent in Arrow format; the range view's
#: name and key modulus (131,072 keys, 131,073 slots with pmod's NULL
#: slot, on dense_sums_global); the async burst; the streamed cancel's
#: chunk rows; the stream's files, trigger interval and the lock stress's
#: queries a thread
SERVE_MAX_CONCURRENT = 2
SERVE_QUEUE_DEPTH = 16
SERVE_SESSIONS = ("alpha", "beta", "gamma", "delta")
SERVE_ROUNDS = 3
SERVE_QUERIES = ("q1", "q3", "q5", "q6", "range")
SERVE_ARROW = ("q1", "q6")
SERVE_RANGE_TABLE = "range16m"
SERVE_RANGE_MOD = 131072
SERVE_RANGE_SQL = (f"SELECT pmod(id, {SERVE_RANGE_MOD}) AS k, count(*) AS n, "
                   f"sum(id) AS s FROM {SERVE_RANGE_TABLE} "
                   f"GROUP BY pmod(id, {SERVE_RANGE_MOD})")
SERVE_BURST = 24
SERVE_CANCEL_CHUNK_ROWS = 16384
SERVE_STREAM_FILES = 3
SERVE_STREAM_TRIGGER_MS = 100
SERVE_STRESS_QUERIES = 8
#: phase 19(c): two lineitem scans in one query, each gated by the
#: arbiter (the greedy session's second scan passes its hbmShare)
SERVE_TWO_SCANS = (
    "SELECT l_returnflag AS k, sum(l_quantity) AS s FROM lineitem "
    "GROUP BY l_returnflag UNION ALL SELECT l_shipmode AS k, "
    "sum(l_extendedprice) AS s FROM lineitem GROUP BY l_shipmode")
HBM_KEY = "spark_tpu.service.hbmBudget"
HBM_SHARE_KEY = "spark_tpu.service.session.hbmShare"
BUDGET_KEY = "spark_tpu.sql.memory.deviceBudget"
DEADLINE_KEY = "spark_tpu.execution.queryDeadlineMs"


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


def reference_sums(D, idx, ints, floats, domain):
    """What the kernels' sums are held to: the plain version's int sums
    (exact in any order), and per-slot float sums by one `torch.sum`
    over each slot's values, a blocked tree reduction. The plain
    version's float sums are not the yardstick: `index_add_` adds one
    value at a time into a slot's running total with atomics, so each
    add rounds at the ulp of the total, and over the 1.5M rows of an F1
    slot that drifts past rtol 1e-12 of the exact sum (6.45e-12 on an
    H100 80GB HBM3). Returns (int sums, float sums, the plain version's
    float sums)."""
    import torch
    plain = D.dense_groupby_sums_plain(idx, ints, floats, domain)
    keep = (idx >= 0) & (idx < domain)
    order = torch.argsort(torch.where(keep, idx, torch.full_like(idx, domain)),
                          stable=True)
    counts = torch.bincount(idx[keep].long(), minlength=domain).tolist()
    tree = []
    for row in floats:
        parts = torch.split(row[order][:sum(counts)], counts)
        tree.append(torch.stack([p.sum() for p in parts]))
    return plain[0], tree, plain[1]


def compare_sums(name, got, want) -> float:
    """Ints equal, floats within FLOAT_RTOL of `reference_sums`' tree
    sums; returns the max abs error of the floats."""
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


def plain_float_error(want) -> float:
    """Largest relative distance of the plain version's float sums from
    the tree sums (reported, not checked)."""
    err = 0.0
    for plain, tree in zip(want[2], want[1]):
        scale = tree.abs().clamp_min(1e-300)
        err = max(err, float(((plain - tree).abs() / scale).max()))
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
            lambda: D.dense_groupby_sums_plain(idx, ints, floats, domain),
            reps=YARDSTICK_REPS, warmup=1),
        "library_ms": time_ms(library, reps=YARDSTICK_REPS, warmup=1),
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
    for i, card in enumerate(smi.stdout.strip().splitlines()):
        log(f"[device] cuda:{i}: {card.strip()}")
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
                           reference_sums(D, idx, ir, fr, domain))
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
                           reference_sums(D, idx, fi, ff, domain))
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
    D.DEVICE_LAUNCHES.clear()


def first_and_warm(D, session, make_df, current=None, label=None,
                   runs: int = 2):
    """A first run of `make_df()` after `reset_state`, then a warm run
    (cached scans, kept capacities). Returns (first result, its
    QueryExecution, seconds, launches), then the same for the warm run
    (None with `runs` 1). The first run's kernel inputs are kept under
    `label` (run_phases' `current`); the warm run's are not."""
    import torch
    out = []
    reset_state(session)
    for run in range(runs):
        if current is not None:
            current[0] = label if run == 0 else None
        zero_launches(D)
        t0 = time.perf_counter()
        qe = make_df()._qe()
        got = qe.collect()
        torch.cuda.synchronize()
        out.append((got, qe, time.perf_counter() - t0, dict(D.LAUNCHES)))
    if current is not None:
        current[0] = None
    return out + [None] * (2 - runs)


def runs_text(first, warm) -> str:
    return (f"first run {first[2]:.3f} s (attempts {first[1].attempts})"
            + ("" if warm is None else
               f", warm run {warm[2]:.3f} s (attempts {warm[1].attempts})")
            + f"; {cache_stats()}")


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
        poll, block = sync_cost(session, lambda: Q.QUERIES[q](session))
        log(f"[sync] {q}: warm run, median of {SYNC_PAIRS} each, "
            f"interleaved: dispatch wait polling {poll * 1e3:.2f} ms, "
            f"blocking {block * 1e3:.2f} ms (polling costs "
            f"{(poll - block) * 1e3:+.2f} ms)")
    join_kernel_parity(S, Q, path, results)
    return results


def sync_cost(session, make_df):
    """Warm wall times of `make_df()` with the stage's dispatch wait
    polling its CUDA event (dispatchPollMs at its default) and blocking
    on it (dispatchPollMs 0), SYNC_PAIRS runs of each, interleaved:
    the two medians, seconds."""
    import statistics
    import torch
    from spark_tpu_torch.execution.executor import DISPATCH_POLL_KEY
    default = session.conf.get(DISPATCH_POLL_KEY)
    times = {"poll": [], "block": []}
    try:
        for _ in range(SYNC_PAIRS):
            for mode, poll_ms in (("poll", default), ("block", 0)):
                session.conf.set(DISPATCH_POLL_KEY, poll_ms)
                t0 = time.perf_counter()
                make_df()._qe().collect()
                torch.cuda.synchronize()
                times[mode].append(time.perf_counter() - t0)
    finally:
        session.conf.set(DISPATCH_POLL_KEY, default)
    return (statistics.median(times["poll"]),
            statistics.median(times["block"]))


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


def phase_sql(D, S, G, path, df_results, launches, current,
              results) -> None:
    """The 22 TPC-H queries as SQL text on the card: each run against the
    golden answer, Q1/Q3/Q5/Q6 against the DataFrame programs' results
    (when phase 5 ran), and each must launch the kernel SQL_KERNELS
    names. A query's launches are kept under `sql <q>`, its first run's
    result in `results` (phase 18 holds its runs to them)."""
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
        results[q], warm = run_sql_query(D, session, q, SQL_QUERIES[q],
                                         f"sql {q}", kernel, launches,
                                         current, golden)
        warm_total += warm
    log(f"[sql] 22 queries in {time.perf_counter() - t_phase:.1f} s; "
        f"warm runs {warm_total:.3f} s in all")


def run_sql_query(D, session, q, text, label, kernels, launches, current,
                  golden):
    """One SQL query as phases 6 and 7 run it: a first run after
    `reset_state` and a warm run, each with the launch counters at 0 and
    each launching every kernel of `kernels` (a name, a tuple of names,
    or None); both results against the golden; then the `[sql]`,
    `[joins]` and (for BREAKDOWN_QUERIES) `[breakdown]` lines. Returns the
    first run's result and the warm run's wall time."""
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
    phase, name = label.split(" ", 1)
    if name in BREAKDOWN_QUERIES.get(phase, (name,)):
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


def phase_functions(D, S, names, path, launches, current) -> None:
    """Phase 10 for the programs `names` over the data at `path`: each a
    first and a warm run against its golden (launches kept under
    `functions <name>`), then F1 under kernelMode=scatter against the
    kernel's result."""
    from spark_tpu_torch.testing import function_queries as FQ
    if FQ.SUITE[names[0]] == "tpch":
        from spark_tpu_torch.tpch.queries import register_tables
    else:
        from spark_tpu_torch.tpcds.queries import register_tables
    session = S.SparkTpuSession.builder().get_or_create()
    register_tables(session, path)
    results, bounds = {}, {}
    for name in names:
        def golden(runs, name=name):
            t0 = time.perf_counter()
            answer, bounds[name] = FQ.golden(name, path)
            seconds = time.perf_counter() - t0
            for run, got in zip(("first", "warm"), runs):
                FQ.compare(got, answer, bounds[name],
                           f"{name}'s {run} run against its golden")
            return seconds
        results[name], _warm = run_sql_query(
            D, session, name, FQ.QUERIES[name], f"functions {name}",
            FUNCTION_KERNELS[name], launches, current, golden)
    if "f1" in names:
        import numpy as np
        import torch
        plain = S.SparkTpuSession.builder().config(
            AGG_MODE, "scatter").get_or_create()
        register_tables(plain, path)
        zero_launches(D)
        got = plain.sql(FQ.QUERIES["f1"]).collect()
        torch.cuda.synchronize()
        if any(D.LAUNCHES.values()):
            raise AssertionError(f"F1 under kernelMode=scatter launched a "
                                 f"kernel: {D.LAUNCHES}")
        FQ.compare_tables(got, results["f1"], bounds["f1"],
                          "F1 under kernelMode=scatter against the kernel")
        worst = max(float(np.nanmax(
            np.abs(got.column(c).to_numpy(zero_copy_only=False)
                   - results["f1"].column(c).to_numpy(zero_copy_only=False))
            / bounds["f1"][c].to_numpy())) for c in FQ.F1_MOMENTS)
        log(f"[functions] f1 under kernelMode=scatter: no kernel launched, "
            f"agrees with dense_sums_smem's result (largest difference "
            f"{worst:.3g} of its bound)")


#: phase 11's lineitem columns for the warehouse table and the cached
#: frame (Q1's, and the keys its joins and counts read)
ETL_Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                  "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
ETL_CACHED_COLUMNS = ("l_orderkey", "l_partkey") + ETL_Q1_COLUMNS
#: the hand kernels each phase-11 aggregate must launch at SF1
ETL_KERNELS = {"etl warehouse q1": ("dense_sums_smem",),
               "etl cached q1": ("dense_sums_smem",),
               "etl csv q1": ("dense_sums_smem",),
               "etl csv q6": ("dense_sums_smem",)}
ETL_SEED = 42


def year_filter(lo: str, hi: str) -> str:
    return (f"l_shipdate >= date '{lo}' AND l_shipdate < date '{hi}'")


def q1_pandas(l):
    """TPC-H Q1's aggregate over the pandas frame `l` (floats), rows
    already filtered, in the engine's column order and sort."""
    l = l.assign(disc_price=l["l_extendedprice"] * (1 - l["l_discount"]),
                 charge=l["l_extendedprice"] * (1 - l["l_discount"])
                 * (1 + l["l_tax"]))
    out = (l.groupby(["l_returnflag", "l_linestatus"], as_index=False)
           .agg(sum_qty=("l_quantity", "sum"),
                sum_base_price=("l_extendedprice", "sum"),
                sum_disc_price=("disc_price", "sum"),
                sum_charge=("charge", "sum"),
                avg_qty=("l_quantity", "mean"),
                avg_price=("l_extendedprice", "mean"),
                avg_disc=("l_discount", "mean"),
                count_order=("l_quantity", "size")))
    return out.sort_values(["l_returnflag", "l_linestatus"]) \
        .reset_index(drop=True)


def timed(fn):
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def etl_query(D, session, label, make, launches, current):
    """One phase-11 aggregate as phases 6-7 run a query: a first run
    after `reset_state` and a warm run, each launching the kernels
    ETL_KERNELS names, then its breakdown; returns the first run's
    result."""
    first, warm = first_and_warm(D, session, make, current, label)
    launches[label] = first[3]
    kernels = ETL_KERNELS.get(label, ())
    require_kernels(label, kernels, first[3])
    require_kernels(f"{label}'s warm run", kernels, warm[3])
    tables_match(f"{label}'s warm run against its first", warm[0], first[0])
    log(f"[etl] {label}: {first[0].num_rows} rows; {runs_text(first, warm)}"
        f"; launches {first[3]}")
    log(f"[breakdown] {label}: {breakdown(make())}")
    return first[0]


def phase_etl(D, S, path, launches, current) -> None:
    """Phase 11 on the TPC-H SF1 tables at `path`: the warehouse (CTAS,
    INSERT, Q1 over the table, a fresh session, SHOW/DESCRIBE/DROP),
    cache(), the writer and the CSV/JSON readers, arrays, the sketches
    and explain. Every step checks its answer."""
    import os
    with tempfile.TemporaryDirectory() as tmp:
        session = S.SparkTpuSession.builder() \
            .config("spark_tpu.sql.warehouse.dir", tmp + "/warehouse") \
            .config("spark_tpu.sql.checkpoint.dir", tmp + "/checkpoints") \
            .get_or_create()
        from spark_tpu_torch.tpch.queries import register_tables
        register_tables(session, path)
        t0 = time.perf_counter()
        etl_warehouse(D, S, session, path, tmp, launches, current)
        log(f"[etl] warehouse steps in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        etl_cache(D, session, path, launches, current)
        log(f"[etl] cache() steps in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        etl_io(D, S, session, path, tmp, launches, current)
        log(f"[etl] writer and reader steps in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        etl_arrays(session, path)
        log(f"[etl] array steps in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        etl_sketches(S, session, path)
        log(f"[etl] sketch steps in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        etl_explain(session)
        log(f"[etl] explain in {time.perf_counter() - t0:.1f} s")
        if os.path.exists(os.path.join(tmp, "warehouse", "li_94")):
            raise AssertionError("DROP TABLE left li_94's directory")


def etl_warehouse(D, S, session, path, tmp, launches, current) -> None:
    import os
    import pandas as pd
    from spark_tpu_torch.tpch import golden as G
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    cols = ", ".join(ETL_Q1_COLUMNS)
    _, ctas_s = timed(lambda: session.sql(
        f"CREATE TABLE li_94 AS SELECT {cols} FROM lineitem WHERE "
        + year_filter("1994-01-01", "1995-01-01")))
    _, insert_s = timed(lambda: session.sql(
        f"INSERT INTO li_94 SELECT {cols} FROM lineitem WHERE "
        + year_filter("1995-01-01", "1996-01-01")))
    text = SQL_QUERIES["q1"].replace("lineitem", "li_94")
    got = etl_query(D, session, "etl warehouse q1",
                    lambda: session.sql(text), launches, current)
    l = G._read(path, "lineitem")
    two_years = l[(l["l_shipdate"] >= pd.Timestamp("1994-01-01").date())
                  & (l["l_shipdate"] < pd.Timestamp("1996-01-01").date())]
    want = q1_pandas(two_years)
    G.compare(G.normalize_decimals(got.to_pandas()), want)
    rows = int(want["count_order"].sum())
    log(f"[etl] CREATE TABLE li_94 AS SELECT (1994) {ctas_s:.3f} s, "
        f"INSERT INTO li_94 SELECT (1995) {insert_s:.3f} s; Q1 over li_94 "
        f"({rows} rows) matches pandas")
    fresh = S.SparkTpuSession.builder().config(
        "spark_tpu.sql.warehouse.dir", tmp + "/warehouse").get_or_create()
    again, fresh_s = timed(lambda: fresh.sql(text).collect())
    if not again.equals(got):
        raise AssertionError("a fresh session over the warehouse differs")
    tables = session.sql("SHOW TABLES").to_pandas()
    want_tables = sorted([("li_94", False)] + [
        (n, True) for n in ("lineitem", "orders", "customer", "supplier",
                            "nation", "region", "part", "partsupp")])
    if sorted(zip(tables["tableName"], tables["isTemporary"])) \
            != want_tables:
        raise AssertionError(f"SHOW TABLES: {tables.to_dict('list')}")
    desc = session.sql("DESCRIBE li_94").to_pandas()
    want_desc = [("l_returnflag", "string"), ("l_linestatus", "string"),
                 ("l_quantity", "DecimalType(precision=19, scale=2)"),
                 ("l_extendedprice", "DecimalType(precision=19, scale=2)"),
                 ("l_discount", "DecimalType(precision=19, scale=2)"),
                 ("l_tax", "DecimalType(precision=19, scale=2)"),
                 ("l_shipdate", "date")]
    if list(zip(desc["col_name"], desc["data_type"])) != want_desc:
        raise AssertionError(f"DESCRIBE li_94: {desc.to_dict('list')}")
    session.sql("DROP TABLE li_94")
    if os.path.exists(os.path.join(tmp, "warehouse", "li_94")) \
            or "li_94" in session.catalog:
        raise AssertionError("DROP TABLE li_94 left the table behind")
    log(f"[etl] a fresh session reads the same bytes ({fresh_s:.3f} s); "
        f"SHOW TABLES and DESCRIBE li_94 as expected; DROP TABLE removed "
        f"its directory")


def etl_cache(D, session, path, launches, current) -> None:
    import numpy as np
    import pandas as pd
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.functions import col, to_date
    from spark_tpu_torch.tpch import golden as G

    def frame():
        return session.table("lineitem").filter(
            (col("l_shipdate") >= to_date("1993-01-01"))
            & (col("l_shipdate") < to_date("1997-01-01"))).select(
            *[col(c) for c in ETL_CACHED_COLUMNS])

    def q1_shape(df):
        disc = col("l_extendedprice") * (F.lit(1) - col("l_discount"))
        return df.group_by(col("l_returnflag"), col("l_linestatus")).agg(
            F.sum(col("l_quantity")).alias("sum_qty"),
            F.sum(disc).alias("sum_disc_price"),
            F.avg(col("l_discount")).alias("avg_disc"),
            F.count().alias("count_order")) \
            .sort(col("l_returnflag"), col("l_linestatus"))

    def with_orders(df):
        return df.join(session.table("orders"), left_on="l_orderkey",
                       right_on="o_orderkey") \
            .group_by(col("o_orderpriority")).agg(
                F.sum(col("l_extendedprice")).alias("revenue"),
                F.count().alias("lines")).sort(col("o_orderpriority"))

    plain = {"q1": q1_shape(frame()).collect(),
             "orders": with_orders(frame()).collect()}
    cached = frame().cache()
    hits = session.result_cache_hits
    _, fill_s = timed(lambda: cached.count())
    results = {}
    for name, build in (("q1", q1_shape), ("orders", with_orders)):
        planned = session.result_cache_hits
        qe = build(cached)._qe()
        if "ScanExec(__cached__" not in qe.executed_plan.tree_string():
            raise AssertionError(f"cached {name} does not scan __cached__")
        if session.result_cache_hits != planned:
            raise AssertionError("planning alone counted a cache hit")
        label = f"etl cached {name}"
        results[name] = etl_query(D, session, label,
                                  lambda: build(cached), launches, current)
        # the cached table holds decimals at egress precision (19, as
        # in the JAX package), so decimal sums over it type wider: the
        # values must be the same bytes at the uncached types
        if not results[name].cast(plain[name].schema).equals(plain[name]):
            raise AssertionError(f"cached {name} differs from the run "
                                 "without cache()")
    if session.result_cache_hits <= hits:
        raise AssertionError("the cache hit counter did not rise")
    log(f"[etl] cache(): 1993-1996 lineitem materialized in {fill_s:.3f} s "
        f"({session._data_cache.nbytes} bytes); the Q1-shaped aggregate "
        f"and the join to orders give the bytes they give without "
        f"cache() (decimal sums typed "
        f"{results['q1'].schema.field('sum_qty').type} against "
        f"{plain['q1'].schema.field('sum_qty').type}); "
        f"{session.result_cache_hits - hits} cache hits")
    counts = etl_query(
        D, session, "etl cached partkey",
        lambda: cached.group_by(col("l_partkey")).agg(
            F.count().alias("n")).sort(col("l_partkey")),
        launches, current)
    l = G._read(path, "lineitem")
    keys = l["l_partkey"].to_numpy()[
        (l["l_shipdate"] >= pd.Timestamp("1993-01-01").date())
        & (l["l_shipdate"] < pd.Timestamp("1997-01-01").date())]
    uniq, n = np.unique(keys, return_counts=True)
    if not (np.array_equal(counts.column("l_partkey").to_numpy(), uniq)
            and np.array_equal(counts.column("n").to_numpy(), n)):
        raise AssertionError("l_partkey counts over the cached frame differ "
                             "from pandas")
    log(f"[etl] l_partkey counts over the cached frame ({len(uniq)} keys) "
        f"match pandas; kernels {launches['etl cached partkey']}")
    cached.unpersist()
    plan = q1_shape(frame())._qe().executed_plan.tree_string()
    if "__cached__" in plan or "ScanExec(lineitem" not in plan:
        raise AssertionError(f"after unpersist() the plan is\n{plan}")
    log("[etl] after unpersist() the query plans from Parquet again")


def etl_io(D, S, session, path, tmp, launches, current) -> None:
    import os
    import numpy as np
    import pandas as pd
    import pyarrow as pa
    import pyarrow.csv as pa_csv
    import pyarrow.parquet as pq
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.tpch import golden as G
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    joined = session.sql(
        "SELECT o_orderkey, o_custkey, o_totalprice, o_orderdate, "
        "o_orderpriority, c_name, c_mktsegment FROM orders JOIN customer "
        "ON o_custkey = c_custkey")
    table, query_s = timed(lambda: joined.collect())
    out = os.path.join(tmp, "joined")
    times = {}
    for mode, rows in (("error", 1), ("overwrite", 1), ("append", 2),
                       ("ignore", 2)):
        _, times[mode] = timed(lambda: joined.write.mode(mode).parquet(out))
        back = session.read_parquet(out).collect()
        if back.num_rows != rows * table.num_rows:
            raise AssertionError(f"write mode {mode}: {back.num_rows} rows")
        if rows == 1 and not back.equals(table):
            raise AssertionError(f"write mode {mode}: read back differs")
    try:
        joined.write.parquet(out)
    except FileExistsError:
        pass
    else:
        raise AssertionError("write mode error wrote over an existing path")
    log(f"[etl] orders x customer: {table.num_rows} rows ({query_s:.3f} s); "
        f"write.parquet " + ", ".join(f"{m} {s:.3f} s"
                                      for m, s in times.items())
        + "; read back with the same bytes; mode error raised on the "
        "existing path")

    lineitem = pq.read_table(os.path.join(path, "lineitem.parquet"))
    csv_path = os.path.join(tmp, "lineitem.csv")
    _, write_s = timed(lambda: pa_csv.write_csv(lineitem, csv_path))
    _, parquet_s = timed(lambda: pq.read_table(
        os.path.join(path, "lineitem.parquet")))
    reader = S.SparkTpuSession.builder().get_or_create()
    csv_df, read_s = timed(lambda: reader.read_csv(csv_path, "lineitem"))
    reader.register_table("lineitem", csv_df.plan.source)
    csv_table = csv_df.plan.source.table
    log(f"[etl] lineitem as CSV: {os.path.getsize(csv_path)} bytes written "
        f"in {write_s:.3f} s; read_csv {read_s:.3f} s against the Parquet "
        f"read {parquet_s:.3f} s")
    l = csv_table.to_pandas()
    ship = l["l_shipdate"]
    want_q1 = q1_pandas(l[ship <= pd.Timestamp("1998-09-02").date()])
    q6 = l[(ship >= pd.Timestamp("1994-01-01").date())
           & (ship < pd.Timestamp("1995-01-01").date())
           & (l["l_discount"] >= 0.05 - 1e-9)
           & (l["l_discount"] <= 0.07 + 1e-9) & (l["l_quantity"] < 24)]
    want_q6 = pd.DataFrame({"revenue": [
        (q6["l_extendedprice"] * q6["l_discount"]).sum()]})
    for q, want in (("q1", want_q1), ("q6", want_q6)):
        got = etl_query(D, reader, f"etl csv {q}",
                        lambda q=q: reader.sql(SQL_QUERIES[q]), launches,
                        current)
        G.compare(got.to_pandas(), want, float_rtol=1e-9, float_atol=0.0)
    log("[etl] Q1 and Q6 over the CSV lineitem (float columns) match "
        "pandas on the same Arrow table within rtol 1e-9")

    orders = pq.read_table(os.path.join(path, "orders.parquet"),
                           columns=["o_orderkey", "o_custkey",
                                    "o_orderstatus", "o_totalprice",
                                    "o_orderpriority"])
    orders = orders.set_column(3, "o_totalprice",
                               orders.column(3).cast(pa.float64()))
    odf = orders.to_pandas()
    json_path = os.path.join(tmp, "orders.jsonl")
    _, jwrite_s = timed(lambda: odf.to_json(json_path, orient="records",
                                            lines=True))
    jdf, jread_s = timed(lambda: reader.read_json(json_path, "orders_json"))
    got = jdf.group_by(col("o_orderstatus")).agg(
        F.count().alias("n"), F.sum(col("o_totalprice")).alias("total")) \
        .sort(col("o_orderstatus")).to_pandas()
    want = (odf.groupby("o_orderstatus", as_index=False)
            .agg(n=("o_orderkey", "size"), total=("o_totalprice", "sum"))
            .sort_values("o_orderstatus").reset_index(drop=True))
    G.compare(got, want, float_rtol=1e-9, float_atol=0.0)
    if int(got["n"].sum()) != len(odf) or jdf.count() != len(odf):
        raise AssertionError("read_json lost rows")
    log(f"[etl] orders as JSON lines ({len(odf)} rows): written in "
        f"{jwrite_s:.3f} s, read_json {jread_s:.3f} s; count and "
        f"sum(o_totalprice) by o_orderstatus match pandas")


def etl_arrays(session, path) -> None:
    import numpy as np
    import pyarrow as pa
    import pandas as pd
    import pyarrow.compute as pc
    from spark_tpu_torch.tpch import golden as G
    collect = ("SELECT l_orderkey, collect_list(l_linenumber) AS ln, "
               "collect_set(l_shipmode) AS modes FROM lineitem "
               "GROUP BY l_orderkey")
    qe = session.sql(collect)._qe()
    got, first_s = timed(lambda: qe.collect())
    got, warm_s = timed(lambda: session.sql(collect).collect())
    got = got.sort_by("l_orderkey")
    l = G._read(path, "lineitem")
    okey = l["l_orderkey"].to_numpy()
    lnum = l["l_linenumber"].to_numpy()
    order = np.lexsort((lnum, okey))
    uniq, counts = np.unique(okey, return_counts=True)
    ln = got.column("ln").combine_chunks()
    if not (np.array_equal(got.column("l_orderkey").to_numpy(), uniq)
            and np.array_equal(ln.value_lengths().to_numpy(), counts)
            and np.array_equal(ln.flatten().to_numpy(), lnum[order])):
        raise AssertionError("collect_list(l_linenumber) differs from "
                             "pandas' sorted per-order lists")
    # collect_set(l_shipmode) as (order, mode code) pairs: its elements
    # come in dictionary-code order, so the sets are compared as sets
    modes = got.column("modes").combine_chunks()
    codes, names = pd.factorize(l["l_shipmode"], sort=True)
    names = np.asarray(names, dtype=str)
    mode_str = pc.cast(modes.flatten(), pa.string()).to_numpy(
        zero_copy_only=False).astype(str)
    got_pairs = np.repeat(uniq, modes.value_lengths().to_numpy()) \
        * len(names) + np.searchsorted(names, mode_str)
    want_pairs = np.unique(okey * len(names) + codes)
    if not (len(got_pairs) == len(want_pairs)
            and np.array_equal(np.sort(got_pairs), want_pairs)):
        raise AssertionError("collect_set(l_shipmode) differs from pandas' "
                             "per-order sets")
    n_elems = int(ln.value_lengths().to_numpy().sum())
    log(f"[etl] collect_list/collect_set by l_orderkey: {got.num_rows} "
        f"groups, {n_elems} elements, equal to pandas' sorted lists and "
        f"sets; first run {first_s:.3f} s, warm {warm_s:.3f} s")
    derived = session.sql(
        f"SELECT l_orderkey, size(ln) AS n, element_at(ln, -1) AS last, "
        f"array_contains(modes, 'AIR') AS air FROM ({collect}) c "
        f"ORDER BY l_orderkey").collect()
    frame = pd.DataFrame({"k": okey, "ln": lnum,
                          "air": codes == np.searchsorted(names, "AIR")})
    per = frame.groupby("k").agg(n=("ln", "size"), last=("ln", "max"),
                                 air=("air", "any"))
    if not (np.array_equal(derived.column("n").to_numpy(), per["n"])
            and np.array_equal(derived.column("last").to_numpy(),
                               per["last"])
            and np.array_equal(derived.column("air").to_numpy(
                zero_copy_only=False), per["air"])):
        raise AssertionError("size / element_at / array_contains over the "
                             "collected lists differ from pandas")
    exploded, explode_s = timed(lambda: session.sql(
        f"SELECT l_orderkey, explode(ln) AS l_linenumber FROM "
        f"({collect}) c").collect())
    ek = exploded.column("l_orderkey").to_numpy()
    ev = exploded.column("l_linenumber").to_numpy()
    eorder = np.lexsort((ev, ek))
    if not (len(ek) == len(okey) and np.array_equal(ek[eorder], okey[order])
            and np.array_equal(ev[eorder], lnum[order])):
        raise AssertionError("explode(ln) does not give back lineitem's "
                             "(l_orderkey, l_linenumber) multiset")
    log(f"[etl] size, element_at(-1) and array_contains(modes, 'AIR') "
        f"match pandas; explode(ln) gives back {len(ek)} rows, the same "
        f"multiset per order ({explode_s:.3f} s)")
    log(f"[breakdown] etl collect: {breakdown(session.sql(collect))}")
    log(f"[breakdown] etl explode: " + breakdown(session.sql(
        f"SELECT l_orderkey, explode(ln) AS l_linenumber FROM "
        f"({collect}) c")))


def etl_sketches(S, session, path) -> None:
    import numpy as np
    import torch
    from spark_tpu_torch.tpch import golden as G
    from spark_tpu_torch.tpch.queries import register_tables
    l = G._read(path, "lineitem")
    eps, confidence = 0.001, 0.99
    cms, cms_s = timed(lambda: session.table("lineitem").stat
                       .count_min_sketch("l_partkey", eps, confidence))
    cpu = S.SparkTpuSession.builder().device("cpu").get_or_create()
    register_tables(cpu, path)
    ref = cpu.table("lineitem").stat.count_min_sketch("l_partkey", eps,
                                                      confidence)
    if not torch.equal(cms.table.cpu(), ref.table):
        raise AssertionError("count-min counters differ between the card "
                             "and the CPU")
    parts = l["l_partkey"].to_numpy()
    exact = np.bincount(parts)
    rng = np.random.default_rng(ETL_SEED)
    probe = rng.choice(np.unique(parts), 1000, replace=False)
    est = cms.estimate(torch.from_numpy(probe).to(
        cms.table.device)).cpu().numpy()
    if not (est >= exact[probe]).all():
        raise AssertionError("a count-min estimate is below the count")
    within = float((est <= exact[probe] + eps * len(parts)).mean())
    if within < confidence:
        raise AssertionError(f"only {within} of the estimates are within "
                             f"eps*N")
    log(f"[etl] count_min_sketch(l_partkey) in {cms_s:.3f} s: "
        f"{cms.depth}x{cms.width} counters equal the CPU session's bit for "
        f"bit; 1000 estimates never below the count, {within:.3f} within "
        f"eps*N")
    bf, bf_s = timed(lambda: session.table("lineitem").stat
                     .bloom_filter("l_orderkey", 1_500_000))
    keys = np.unique(l["l_orderkey"].to_numpy())
    dev = bf.bits.device
    if not bool(bf.might_contain(torch.from_numpy(keys).to(dev)).all()):
        raise AssertionError("the bloom filter has a false negative")
    absent = np.setdiff1d(rng.integers(1, 4 * int(keys.max()), 300_000),
                          keys)[:100_000]
    fp = float(bf.might_contain(torch.from_numpy(absent).to(dev))
               .float().mean())
    log(f"[etl] bloom_filter(l_orderkey, 1500000) in {bf_s:.3f} s: no "
        f"false negative over {len(keys)} keys; false-positive rate "
        f"{fp:.4f} on {len(absent)} absent keys (fpp 0.03)")


def etl_explain(session) -> None:
    import contextlib
    import io
    from spark_tpu_torch.execution.executor import plan_nodes
    from spark_tpu_torch.plan.physical import JoinExec
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    df = session.sql(SQL_QUERIES["q5"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        df.explain(extended=True, runtime=True)
    text = buf.getvalue()
    for section in ("== Logical Plan ==", "== Optimized Logical Plan ==",
                    "== Physical Plan (runtime metrics) ==",
                    "== Join Reorder =="):
        if section not in text:
            raise AssertionError(f"explain lacks {section}")
    physical = text.split("== Physical Plan (runtime metrics) ==")[1] \
        .split("== Join Reorder ==")[0].strip().splitlines()
    bare = [ln for ln in physical if "rows out:" not in ln
            and not ln.strip().startswith("ScanExec")]
    if bare:
        raise AssertionError(f"operators without rows out: {bare[:3]}")
    qe = df._qe()
    qe.execute_batch()
    joins = [j for j in plan_nodes(qe.executed_plan, JoinExec)
             if not j.creation_side]
    decisions = qe.reorder_decisions
    reordered = sum(len(d["relations"]) - 1 for d in decisions)
    reorder_line = qe.explain().split("== Join Reorder ==\n")[1] \
        .splitlines()[0].strip()
    changed = any(d["changed"] for d in decisions)
    if reordered != len(joins) or \
            reorder_line.startswith("reorder: yes") != changed:
        raise AssertionError(f"the [joins] lines ({len(joins)} joins) and "
                             f"'{reorder_line}' disagree: {decisions}")
    log(f"[etl] explain(extended=True, runtime=True) of SQL Q5: every "
        f"section, rows out on each of {len(physical)} operators "
        f"({sum('ScanExec' in ln for ln in physical)} scans loaded as "
        f"inputs); {reorder_line}: {len(joins)} joins in "
        f"{len(decisions)} region(s)")
    log(f"[joins] etl q5: {describe_joins(qe)}")
    log("[etl] explain text:\n" + text)


# ---------------------------------------------------------------------------
# Phase 12: out-of-core execution and recovery
# ---------------------------------------------------------------------------

WRITE_LINEITEM_FLAG = "--write-lineitem"


def write_lineitem(tmp: str, sf: float) -> None:
    """`tmp`/lineitem.parquet at scale `sf` (`write_lineitem_pieces`) and
    its exact Q1/Q6 golden (`q1_q6_golden`) as `tmp`/golden.json, with
    the seconds the writing took. The body of the child process that
    `Sf10.start` runs."""
    from spark_tpu_torch.tpch.datagen import write_lineitem_pieces
    on_piece, ans = q1_q6_golden()
    t0 = time.perf_counter()
    write_lineitem_pieces(tmp + "/lineitem.parquet", sf, on_piece=on_piece)
    ans["seconds"] = time.perf_counter() - t0
    with open(tmp + "/golden.json", "w") as f:
        json.dump(ans, f)


class Sf10:
    """SF10 lineitem and its exact Q1/Q6 golden (`write_lineitem`),
    written under `tmp` by a child process that `start` begins, so the
    writing overlaps the phases before the first that reads it; shared
    by phases 12, 14, 16 and 22."""

    def __init__(self, tmp: str, sf: float = OOC_SF):
        self.tmp = tmp
        self.sf = sf
        self._proc = None
        self._data = None

    def start(self) -> None:
        import os
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), WRITE_LINEITEM_FLAG,
             self.tmp, str(self.sf)], env=env)

    def stop(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()

    def get(self, tag: str):
        """(the Parquet path, the golden's dict)."""
        if self._data is None:
            if self._proc is None:
                self.start()
            t0 = time.perf_counter()
            if self._proc.wait() != 0:
                raise RuntimeError(f"writing SF{self.sf} lineitem failed: "
                                   f"exit code {self._proc.returncode}")
            with open(self.tmp + "/golden.json") as f:
                ans = json.load(f)
            ans["q1"] = {int(g): acc for g, acc in ans["q1"].items()}
            log(f"[{tag}] SF{self.sf} lineitem: {ans['rows']} rows generated "
                f"in {ans['seconds']:.1f} s in a child process started with "
                f"the run; waited {time.perf_counter() - t0:.1f} s for it")
            self._data = (self.tmp + "/lineitem.parquet", ans)
        return self._data


def q1_q6_golden():
    """Exact SQL Q1/Q6 answers built piece by piece from the generator's
    integer arrays: numpy int64 partial sums over one piece at most
    (far below 2^63), added across pieces as Python ints. Returns
    (on_piece callback, the answers' dict)."""
    import numpy as np
    from spark_tpu_torch.tpch.datagen import EPOCH
    q1_cut = int((np.datetime64("1998-09-02", "D") - EPOCH).astype(int))
    q6_lo = int((np.datetime64("1994-01-01", "D") - EPOCH).astype(int))
    q6_hi = int((np.datetime64("1995-01-01", "D") - EPOCH).astype(int))
    ans = {"q1": {}, "q6": 0, "rows": 0, "q6_rows": 0}

    def on_piece(p):
        ans["rows"] += len(p["qty"])
        qty, ext, disc, tax = p["qty"], p["extended"], p["discount"], p["tax"]
        keep = p["ship"] <= q1_cut
        group = p["returnflag"] * 2 + p["linestatus"]
        disc_price = ext * (100 - disc)
        charge = disc_price * (100 + tax)
        for g in np.unique(group[keep]):
            m = keep & (group == g)
            acc = ans["q1"].setdefault(int(g), [0] * 6)
            for i, v in enumerate((qty * 100, ext, disc_price, charge, disc)):
                acc[i] += int(v[m].sum())
            acc[5] += int(m.sum())
        m6 = ((p["ship"] >= q6_lo) & (p["ship"] < q6_hi) & (disc >= 5)
              & (disc <= 7) & (qty < 24))
        ans["q6"] += int((ext[m6] * disc[m6]).sum())
        ans["q6_rows"] += int(m6.sum())

    return on_piece, ans


def expected_chunks(q, ans) -> int:
    """The chunks a stream of `q` cuts: the rows its pushed filter lets
    through the Parquet reader, over streamingChunkRows (2^24)."""
    rows = ans["q6_rows"] if q == "q6" else \
        sum(acc[5] for acc in ans["q1"].values())
    return -(-rows // (1 << 24))


def check_q1_q6(q, table, ans) -> None:
    """Sums and counts equal the golden to the last unit of their scale;
    an average lies within one unit of its scale (6) of sum/count."""
    from decimal import Decimal
    from spark_tpu_torch.tpch.datagen import LINESTATUS, RETURNFLAGS
    rows = table.to_pylist()
    if q == "q6":
        want = Decimal(ans["q6"]).scaleb(-4)
        if len(rows) != 1 or rows[0]["revenue"] != want:
            raise AssertionError(f"SF10 q6 gave {rows}, golden {want}")
        return
    want = {(RETURNFLAGS[g // 2], LINESTATUS[g % 2]): acc
            for g, acc in ans["q1"].items()}
    if len(rows) != len(want):
        raise AssertionError(f"SF10 q1: {len(rows)} groups, golden "
                             f"{len(want)}")
    for r in rows:
        qty, ext, dp, ch, disc, n = want[(r["l_returnflag"],
                                          r["l_linestatus"])]
        exact = {"sum_qty": Decimal(qty).scaleb(-2),
                 "sum_base_price": Decimal(ext).scaleb(-2),
                 "sum_disc_price": Decimal(dp).scaleb(-4),
                 "sum_charge": Decimal(ch).scaleb(-6), "count_order": n}
        for k, v in exact.items():
            if r[k] != v:
                raise AssertionError(f"SF10 q1 {k} of {r['l_returnflag']}"
                                     f"{r['l_linestatus']}: {r[k]} != {v}")
        for k, s in (("avg_qty", Decimal(qty).scaleb(-2)),
                     ("avg_price", Decimal(ext).scaleb(-2)),
                     ("avg_disc", Decimal(disc).scaleb(-2))):
            if abs(r[k] - s / n) > Decimal("0.000001"):
                raise AssertionError(f"SF10 q1 {k}: {r[k]} vs {s / n}")


def device_busy(prof):
    """The card's busy seconds in a torch.profiler trace (the union of
    its kernel and copy intervals), and its device events."""
    import torch
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6, events


def busy_text(busy_s: float, events, wall: float) -> str:
    if not events:
        return ("card busy time not measured (the profiler saw no device "
                "events)")
    return (f"card busy {busy_s * 1e3:.2f} ms of {wall * 1e3:.1f} ms wall "
            f"(idle share {1 - busy_s / wall:.4f}, {len(events)} device "
            f"events)")


def stall_s(r) -> float:
    """The consumer's wait for a chunk's decode: its whole wait for the
    chunk less the copy to the card it ran itself."""
    return max(0.0, r["wait_s"] - r.get("copy_s", 0.0))


def chunk_lines(qe) -> str:
    """Per chunk of the query's stream: its host decode (on the prefetch
    thread), the consumer's stall for it, its copy to the card, and its
    update's host and device time."""
    parts = []
    for stream in qe.stream_stats:
        for i, r in enumerate(stream["chunks"]):
            ev = r.get("events")
            upd = ev[0].elapsed_time(ev[1]) if ev is not None else None
            parts.append(
                f"chunk {i}: decode {r.get('decode_s', 0) * 1e3:.1f} ms, "
                f"stall {stall_s(r) * 1e3:.1f} ms, copy "
                f"{r.get('copy_s', 0) * 1e3:.1f} ms, update host "
                f"{r['update_s'] * 1e3:.1f} ms"
                + (f" / device {upd:.1f} ms" if upd is not None else ""))
    return "; ".join(parts)


def n_chunks(qe) -> int:
    return sum(len(s["chunks"]) for s in qe.stream_stats)


def require_stream(label, qe, kind, chunks=None) -> None:
    text = qe.spliced_plan.tree_string()
    if f"InputExec({kind}," not in text:
        raise AssertionError(f"{label} did not splice InputExec({kind}: "
                             f"{text}")
    if chunks is not None and n_chunks(qe) != chunks:
        raise AssertionError(f"{label} streamed {n_chunks(qe)} chunks, "
                             f"expected {chunks}")


def prefetch_threads():
    import threading
    deadline = time.monotonic() + 10
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith("spark-tpu-torch-ingest")]
        if not alive or time.monotonic() > deadline:
            return alive
        time.sleep(0.01)


def plan_size(D, captured, label, kernel) -> int:
    """The launches one wrapper call makes on `label`'s kernel inputs
    (`plan_launches` on each input shape its first run gave `kernel`;
    every shape must plan the same number)."""
    sizes = {len(D.plan_launches(domain, n_int, n_float))
             for _, domain, n_int, n_float in captured[(label, kernel)]}
    if len(sizes) != 1:
        raise AssertionError(f"{label}: {kernel}'s inputs plan "
                             f"{sorted(sizes)} launches a call")
    return sizes.pop()


def require_launches(label, counts, kernel, want) -> None:
    """Exactly `want` launches of `kernel` and none of the other."""
    expected = {k: (want if k == kernel else 0) for k in counts}
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, expected "
                             f"{expected}")


def phase_ooc(D, S, sf1_path, launches, current, captured, sf10) -> None:
    """Phase 12: SF10 lineitem streamed (Q1/Q6 against the exact golden,
    one dense_sums_smem launch per chunk), Q1 under kernelMode=scatter,
    the range stream, phase 5's SF1 data under a small deviceBudget,
    injected faults, one real out-of-memory error, a deadline and a
    cancel."""
    import torch
    from spark_tpu_torch.io.device_cache import estimated_scan_bytes
    from spark_tpu_torch.io.sources import ParquetSource
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    path, ans = sf10.get("ooc")
    session = S.SparkTpuSession.builder().get_or_create()
    session.register_table("lineitem", ParquetSource(path, "lineitem"))
    results, warm_s = {}, {}
    for q in ("q1", "q6"):
        reset_state(session)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        # one run: a warm run would ingest again, as the stream rides no
        # device cache
        first, _ = first_and_warm(
            D, session, lambda: session.sql(SQL_QUERIES[q]), current,
            f"ooc {q}", runs=1)
        launches[f"ooc {q}"] = first[3]
        chunks = expected_chunks(q, ans)
        # one wrapper call per chunk: its launch plan, once a chunk
        per_chunk = plan_size(D, captured, f"ooc {q}", "dense_sums_smem")
        got, qe, seconds, counts = first
        label = f"SF{OOC_SF} {q}"
        require_stream(label, qe, "streamed_agg", chunks)
        require_launches(label, counts, "dense_sums_smem",
                         chunks * per_chunk)
        if qe.fault_summary:
            raise AssertionError(f"{label}: {qe.fault_summary}")
        check_q1_q6(q, got, ans)
        results[q], warm_s[q] = got, seconds
        leaf = [n for n in plan_leaves(qe.executed_plan)][0]
        stall = sum(stall_s(r) for st in qe.stream_stats
                    for r in st["chunks"])
        log(f"[ooc] {q} SF{OOC_SF}: equals the golden; first run "
            f"{seconds:.3f} s ({ans['rows'] / seconds / 1e6:.2f} M "
            f"rows/s); {n_chunks(qe)} chunks, {per_chunk} launches a "
            f"chunk, launches {counts}; peak allocated "
            f"{torch.cuda.max_memory_allocated() - base:,} bytes over "
            f"{base:,} held, whole-input estimate "
            f"{estimated_scan_bytes(leaf):,} bytes; prefetch stall "
            f"{stall * 1e3:.1f} ms")
        log(f"[ooc] {q} chunks: {chunk_lines(qe)}")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.sql(SQL_QUERIES[q]).collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log(f"[ooc] {q} profiled run: "
            f"{busy_text(*device_busy(prof), wall)}")
    ooc_scatter(D, S, path, results["q1"])
    ooc_range(D, S, launches, current, captured)
    ooc_budget(D, S, sf1_path)
    ooc_faults(D, session, sf1_path, S, results["q1"])
    ooc_cancel(session, results["q1"], warm_s["q1"],
               expected_chunks("q1", ans))


def plan_leaves(node):
    if not node.children:
        yield node
    for c in node.children:
        yield from plan_leaves(c)


def ooc_scatter(D, S, path, want) -> None:
    """SF10 Q1 under aggregate.kernelMode=scatter: no kernel launch, and
    the bytes of the kernel's run."""
    import torch
    from spark_tpu_torch.io.sources import ParquetSource
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    session = S.SparkTpuSession.builder().config(
        AGG_MODE, "scatter").get_or_create()
    session.register_table("lineitem", ParquetSource(path, "lineitem"))
    zero_launches(D)
    t0 = time.perf_counter()
    qe = session.sql(SQL_QUERIES["q1"])._qe()
    got = qe.collect()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require_stream("SF10 q1 under scatter", qe, "streamed_agg")
    if any(D.LAUNCHES.values()):
        raise AssertionError(f"q1 under kernelMode=scatter launched "
                             f"{dict(D.LAUNCHES)}")
    if not got.equals(want):
        raise AssertionError("SF10 q1 under kernelMode=scatter differs from "
                             "the kernel's bytes")
    log(f"[ooc] q1 SF{OOC_SF} kernelMode=scatter: no launch, the same Arrow "
        f"bytes as the kernel's run; {seconds:.3f} s")


def ooc_range(D, S, launches, current, captured) -> None:
    """range(2^26).group_by(id % 65536) with count, sum and avg: four
    chunks of 2^24 rows synthesized on the card, one wrapper call of
    dense_sums_global per chunk, against the closed form."""
    import numpy as np
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.functions import col
    session = S.SparkTpuSession.builder().get_or_create()
    rows, mod = OOC_RANGE_ROWS, RANGE_MOD
    make = lambda: session.range(rows).group_by(col("id") % mod).agg(
        F.count(), F.sum(col("id")), F.avg(col("id")))
    first, warm = first_and_warm(D, session, make, current, "ooc range")
    launches["ooc range"] = first[3]
    per_key = rows // mod
    keys = np.arange(mod, dtype=np.int64)
    total = per_key * keys + mod * (per_key * (per_key - 1) // 2)
    per_chunk = plan_size(D, captured, "ooc range", "dense_sums_global")
    for run, (got, qe, seconds, counts) in (("first", first),
                                            ("warm", warm)):
        require_stream(f"range {run} run", qe, "streamed_agg",
                       OOC_RANGE_CHUNKS)
        require_launches(f"range {run} run", counts, "dense_sums_global",
                         OOC_RANGE_CHUNKS * per_chunk)
        pdf = got.to_pandas().sort_values(got.column_names[0])
        if not (np.array_equal(pdf.iloc[:, 0].to_numpy(), keys)
                and (pdf["count(*)"].to_numpy() == per_key).all()
                and np.array_equal(pdf["sum(id)"].to_numpy(), total)
                and np.allclose(pdf["avg(id)"].to_numpy(), total / per_key,
                                rtol=1e-15, atol=0)):
            raise AssertionError(f"range stream {run} run disagrees with "
                                 "the closed form")
    log(f"[ooc] range({rows}).group_by(id % {mod}): equals the closed form; "
        f"{OOC_RANGE_CHUNKS} chunks, launches {first[3]}; first run "
        f"{first[2]:.3f} s, warm run {warm[2]:.3f} s "
        f"({rows / warm[2] / 1e6:.1f} M rows/s)")
    log(f"[ooc] range warm run chunks: {chunk_lines(warm[1])}")


def ooc_budget(D, S, path) -> None:
    """Phase 5's SF1 data under a small deviceBudget and 2^20-row chunks:
    Q1 and Q5 stream directly, Q3 spills its partials, an ORDER BY ...
    LIMIT and a plain chain go through external collect; each gives its
    whole-input run's bytes."""
    import torch
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.tpch import queries as Q
    whole = S.SparkTpuSession.builder().get_or_create()
    Q.register_tables(whole, path)
    small = S.SparkTpuSession.builder().config(
        "spark_tpu.sql.memory.deviceBudget", 1 << 16).config(
        "spark_tpu.sql.execution.streamingChunkRows", 1 << 20).get_or_create()
    Q.register_tables(small, path)
    cases = {
        "q1": (lambda s: Q.QUERIES["q1"](s), "streamed_agg", None),
        "q5": (lambda s: Q.QUERIES["q5"](s), "streamed_agg", None),
        "q3": (lambda s: Q.QUERIES["q3"](s), "spilled_partials", None),
        "top10": (lambda s: s.table("lineitem").select(
            col("l_orderkey"), col("l_linenumber"),
            col("l_extendedprice")).sort(col("l_extendedprice").desc(),
                                         col("l_orderkey"),
                                         col("l_linenumber")).limit(10),
            None, None),
        # a residual filter (not pushed into the reader), so that the
        # chain runs on every chunk
        "chain": (lambda s: s.table("lineitem").filter(
            col("l_extendedprice") * col("l_discount") > 300).select(
            col("l_orderkey"), col("l_linenumber"),
            (col("l_extendedprice") * col("l_discount")).alias("d")),
            None, ["l_orderkey", "l_linenumber"]),
    }
    for name, (make, kind, order) in cases.items():
        want = make(whole)._qe().collect()
        qe = make(small)._qe()
        t0 = time.perf_counter()
        got = qe.collect()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if kind is not None:
            require_stream(f"SF1 {name} under the budget", qe, kind)
        elif "external" not in qe.phase_times:
            raise AssertionError(f"SF1 {name} did not take external collect")
        if order:
            got, want = got.sort_by([(c, "ascending") for c in order]), \
                want.sort_by([(c, "ascending") for c in order])
        if not got.equals(want):
            raise AssertionError(f"SF1 {name} under the budget differs from "
                                 "its whole-input run")
        log(f"[ooc] SF1 {name} under deviceBudget=65536: "
            f"{'InputExec(' + kind + ')' if kind else 'external collect'}, "
            f"{n_chunks(qe)} chunks, {got.num_rows} rows equal to the "
            f"whole-input run; {seconds:.3f} s")


def ooc_faults(D, session, sf1_path, S, clean_q1) -> None:
    """Faults on the card, each recovering to the clean bytes: a chunk
    replay, a prefetch decode replay, two injected out-of-memory errors
    climbing to the spill re-plan, and one real out-of-memory error."""
    import torch
    from spark_tpu_torch.io.device_cache import CACHE, estimated_scan_bytes
    from spark_tpu_torch.testing import faults
    from spark_tpu_torch.tpch import queries as Q
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES

    def run(sess, make, spec, want, summary, label, kind="streamed_agg"):
        with faults.inject(sess.conf, spec) as plan:
            qe = make()._qe()
            t0 = time.perf_counter()
            got = qe.collect()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        if not plan.fired_log:
            raise AssertionError(f"{label}: the fault never fired")
        if qe.fault_summary != summary:
            raise AssertionError(f"{label}: fault_summary "
                                 f"{qe.fault_summary}, expected {summary}")
        require_stream(label, qe, kind)
        if not got.equals(want):
            raise AssertionError(f"{label}: differs from the clean run")
        log(f"[ooc] {label}: {spec} -> {qe.fault_summary}, the clean bytes; "
            f"{seconds:.3f} s")
        return qe

    q1 = lambda: session.sql(SQL_QUERIES["q1"])
    run(session, q1,
        "stream_chunk:unavailable:2,ingest_prefetch:unavailable:1",
        clean_q1, {"chunk_retry": 2},
        f"SF{OOC_SF} q1 chunk and prefetch replays")
    sf1 = S.SparkTpuSession.builder().get_or_create()
    Q.register_tables(sf1, sf1_path)
    sf1_q1 = lambda: Q.QUERIES["q1"](sf1)
    want = sf1_q1()._qe().collect()
    CACHE.clear()
    # one injected failure is absorbed by rung 1 (evict and retry); the
    # second reaches rung 2, the 1-byte-budget re-plan
    run(sf1, sf1_q1,
        "scan_load:resource_exhausted:1,scan_load:resource_exhausted:2",
        want, {"oom_cache_evict": 1, "oom_spill_reroute": 1},
        "SF1 q1 whole-input load, injected out-of-memory")

    # the real one: SF10 q1 forced to load whole, under a memory fraction
    # that holds the stream but not the whole table
    CACHE.clear()
    sf1 = None
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    held = torch.cuda.memory_reserved()
    fraction = (held + (2 << 30)) / total
    session.conf.set("spark_tpu.sql.io.deviceCacheBytes", 1 << 40)
    torch.cuda.set_per_process_memory_fraction(fraction)
    try:
        qe = q1()._qe()
        t0 = time.perf_counter()
        got = qe.collect()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        session.conf.set("spark_tpu.sql.io.deviceCacheBytes", 6 << 30)
    first_error = qe.fault_events[0].get("error", "") if qe.fault_events \
        else ""
    if not first_error.startswith("OutOfMemoryError"):
        raise AssertionError(f"the whole load did not run out of memory: "
                             f"{qe.fault_events}")
    if qe.fault_summary != {"oom_cache_evict": 1, "oom_spill_reroute": 1}:
        raise AssertionError(f"real out-of-memory: {qe.fault_summary}")
    require_stream("SF10 q1 after a real out-of-memory error", qe,
                   "streamed_agg")
    if not got.equals(clean_q1):
        raise AssertionError("SF10 q1 after the real out-of-memory error "
                             "differs from the clean run")
    leaf = list(plan_leaves(qe.executed_plan))[0]
    log(f"[ooc] real out-of-memory: memory fraction {fraction:.4f} of "
        f"{total:,} bytes ({held:,} held before), whole-input estimate "
        f"{estimated_scan_bytes(leaf):,} bytes; {first_error[:120]}; ladder "
        f"{qe.fault_summary}, landed on the stream ({n_chunks(qe)} chunks "
        f"of 2^22 rows), the clean bytes; {seconds:.3f} s; fraction "
        f"restored to 1.0")


def ooc_cancel(session, clean_q1, warm_s, chunks) -> None:
    """SF10 q1 under a deadline of half its clean run's time, then
    cancelled by session.cancel from a timer thread at the same point:
    each stops within dispatchPollMs plus one chunk, leaves no prefetch
    thread, and a rerun gives the clean bytes."""
    import threading
    import torch
    from spark_tpu_torch.execution import lifecycle
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    poll_ms = float(session.conf.get("spark_tpu.execution.dispatchPollMs"))
    chunk_s = warm_s / chunks
    bound_s = poll_ms / 1e3 + chunk_s
    half = warm_s / 2
    session.conf.set("spark_tpu.execution.queryDeadlineMs", half * 1e3)
    try:
        t0 = time.perf_counter()
        try:
            session.sql(SQL_QUERIES["q1"]).collect()
            raise AssertionError("the deadline did not stop SF10 q1")
        except lifecycle.QueryDeadlineError as e:
            late = time.perf_counter() - t0 - half
            seen = {"deadline": str(e)}
    finally:
        session.conf.set("spark_tpu.execution.queryDeadlineMs", 0.0)
    torch.cuda.synchronize()
    qe = session.sql(SQL_QUERIES["q1"])._qe()
    fired = {}

    def cancel():
        fired["t"] = time.perf_counter()
        fired["ok"] = session.cancel(qe.query_id)

    timer = threading.Timer(half, cancel)
    timer.start()
    try:
        qe.collect()
        raise AssertionError("session.cancel did not stop SF10 q1")
    except lifecycle.QueryCancelledError as e:
        cancel_late = time.perf_counter() - fired["t"]
        seen["cancel"] = str(e)
    finally:
        timer.cancel()
    torch.cuda.synchronize()
    if not fired.get("ok"):
        raise AssertionError("session.cancel found no running query")
    left = prefetch_threads()
    if left:
        raise AssertionError(f"prefetch threads left behind: {left}")
    for what, lat in (("deadline", late), ("cancel", cancel_late)):
        if lat > bound_s:
            raise AssertionError(f"{what} landed {lat * 1e3:.1f} ms late "
                                 f"({seen[what]}), over dispatchPollMs + "
                                 f"one chunk ({bound_s * 1e3:.1f} ms)")
    again = session.sql(SQL_QUERIES["q1"]).collect()
    if not again.equals(clean_q1):
        raise AssertionError("SF10 q1 after the cancel differs from the "
                             "clean run")
    log(f"[ooc] deadline {half * 1e3:.1f} ms: QueryDeadlineError "
        f"{late * 1e3:.1f} ms after it ({seen['deadline']}); session.cancel "
        f"at {half * 1e3:.1f} ms: QueryCancelledError "
        f"{cancel_late * 1e3:.1f} ms after it ({seen['cancel']}) "
        f"(bound: dispatchPollMs {poll_ms:.0f} ms + one chunk "
        f"{chunk_s * 1e3:.1f} ms); no prefetch thread left; "
        "the rerun gives the clean bytes")


# ---------------------------------------------------------------------------
# Phase 13: Python UDFs
# ---------------------------------------------------------------------------

U1_SQL = """
SELECT l_returnflag, l_linestatus,
       sum(net(CAST(l_extendedprice AS DOUBLE), CAST(l_discount AS DOUBLE)))
           AS s,
       avg(net(CAST(l_extendedprice AS DOUBLE), CAST(l_discount AS DOUBLE)))
           AS a,
       count(*) AS n
FROM lineitem WHERE l_shipdate <= DATE '1998-09-02'
GROUP BY l_returnflag, l_linestatus ORDER BY 1, 2"""


def udf_programs(session, apply_s):
    """Phase 13's programs over the session's TPC-H tables, by name: each
    a function giving the DataFrame of one run (U4's runs its grouped map
    as it builds the frame, and appends its seconds to `apply_s`). `net`
    is registered for SQL here. Every function is defined in this script,
    so the worker lane ships it by value."""
    import pandas as pd
    from spark_tpu_torch import functions as F
    from spark_tpu_torch import types as T
    from spark_tpu_torch.functions import col
    session.udf.register(
        "net", F.pandas_udf(lambda p, d: p * (1 - d), "double"))
    prio = F.udf(lambda s: s.split("-")[1].strip(), "string")
    late = F.udf(lambda d: d.year >= 1995, "boolean")
    tier = F.udf(lambda b: int(b // 1000), "long")
    stamp = F.udf(lambda b, d: f"{d.isoformat()}:{b}", "string")
    start = F.to_date(U3_START.isoformat())

    def ratio(g):
        price = g["price"]
        return pd.DataFrame({"o_orderpriority": g["o_orderpriority"],
                             "o_orderkey": g["o_orderkey"],
                             "ratio": price / price.mean()})

    def u4():
        t0 = time.perf_counter()
        mapped = (session.table("orders")
                  .select(col("o_orderpriority"), col("o_orderkey"),
                          col("o_totalprice").cast(T.DOUBLE).alias("price"))
                  .group_by(col("o_orderpriority"))
                  .apply_in_pandas(ratio, "o_orderpriority string, "
                                          "o_orderkey long, ratio double"))
        apply_s.append(time.perf_counter() - t0)
        return (mapped.group_by(col("o_orderpriority"))
                .agg(F.sum(col("ratio")).alias("s"),
                     F.count(col("o_orderkey")).alias("n"))
                .order_by(col("o_orderpriority")))

    return {
        "u1": lambda: session.sql(U1_SQL),
        "u2": lambda: (session.table("orders")
                       .filter(late(col("o_orderdate")))
                       .group_by(prio(col("o_orderpriority")).alias("prio"))
                       .agg(F.sum(col("o_totalprice")).alias("total"),
                            F.count(col("o_orderkey")).alias("n"))
                       .order_by(col("prio"))),
        "u3": lambda: (session.table("customer")
                       .select(col("c_custkey"),
                               tier(col("c_acctbal")).alias("tier"),
                               stamp(col("c_acctbal"),
                                     F.date_add(start, col("c_nationkey")))
                               .alias("stamp"))
                       .order_by(col("c_custkey"))),
        "u4": u4,
    }


def udf_goldens(path) -> dict:
    """pandas answers of U1-U4 from the Parquet files: U1's floats, U2's
    totals in exact cents, U3's strings from the Decimal objects, U4's
    per-priority sums of price over its mean."""
    import os
    import pandas as pd
    import pyarrow as pa
    import pyarrow.parquet as pq

    def read(table, columns):
        return pq.read_table(os.path.join(path, f"{table}.parquet"),
                             columns=columns)

    li = read("lineitem", ["l_returnflag", "l_linestatus", "l_extendedprice",
                           "l_discount", "l_shipdate"])
    li = li.filter(pa.compute.less_equal(
        li["l_shipdate"], pa.scalar(datetime.date(1998, 9, 2))))
    l = pd.DataFrame({
        "l_returnflag": li["l_returnflag"].to_numpy(),
        "l_linestatus": li["l_linestatus"].to_numpy(),
        "p": li["l_extendedprice"].cast(pa.float64()).to_numpy(),
        "d": li["l_discount"].cast(pa.float64()).to_numpy()})
    l["net"] = l["p"] * (1 - l["d"])
    u1 = (l.groupby(["l_returnflag", "l_linestatus"], as_index=False)
          .agg(s=("net", "sum"), a=("net", "mean"), n=("net", "size"))
          .sort_values(["l_returnflag", "l_linestatus"])
          .reset_index(drop=True))
    o = read("orders", ["o_orderkey", "o_orderpriority", "o_orderdate",
                        "o_totalprice"]).to_pandas()
    price = o["o_totalprice"].astype(float)
    o = o.assign(price=price, cents=(price * 100).round().astype("int64"),
                 prio=o["o_orderpriority"].str.split("-").str[1].str.strip())
    late = o[pd.to_datetime(o["o_orderdate"]).dt.year >= 1995]
    u2 = (late.groupby("prio", as_index=False)
          .agg(cents=("cents", "sum"), n=("o_orderkey", "size"))
          .sort_values("prio").reset_index(drop=True))
    c = read("customer", ["c_custkey", "c_acctbal", "c_nationkey"])
    bal = c["c_acctbal"].to_pylist()
    days = [U3_START + datetime.timedelta(days=k)
            for k in c["c_nationkey"].to_pylist()]
    u3 = {"c_custkey": c["c_custkey"].to_pylist(),
          "tier": [int(b // 1000) for b in bal],
          "stamp": [f"{d.isoformat()}:{b}" for b, d in zip(bal, days)]}
    o["ratio"] = o["price"] / o.groupby("o_orderpriority")["price"] \
        .transform("mean")
    u4 = (o.groupby("o_orderpriority", as_index=False)
          .agg(s=("ratio", "sum"), n=("o_orderkey", "size"))
          .sort_values("o_orderpriority").reset_index(drop=True))
    return {"u1": u1, "u2": u2, "u3": u3, "u4": u4}


def check_udf(q, got, want) -> None:
    """One phase-13 result against its pandas answer: U1's and U4's floats
    within rtol 1e-9, the rest exactly."""
    import decimal
    import numpy as np
    out = got.to_pandas()
    if q == "u3":
        for name, values in want.items():
            if got.column(name).to_pylist() != values:
                raise AssertionError(f"{q}: column {name} differs from "
                                     f"pandas")
        return
    keys = {"u1": ["l_returnflag", "l_linestatus"], "u2": ["prio"],
            "u4": ["o_orderpriority"]}[q]
    for k in keys + ["n"]:
        if out[k].tolist() != want[k].tolist():
            raise AssertionError(f"{q}: column {k} differs from pandas: "
                                 f"{out[k].tolist()} vs {want[k].tolist()}")
    if q == "u2":
        cents = [int(v * 100) for v in out["total"]]
        if cents != want["cents"].tolist() or not all(
                isinstance(v, decimal.Decimal) for v in out["total"]):
            raise AssertionError(f"u2: totals {cents} vs pandas "
                                 f"{want['cents'].tolist()}")
        return
    for k in {"u1": ("s", "a"), "u4": ("s",)}[q]:
        if not np.allclose(out[k], want[k], rtol=1e-9, atol=0.0):
            raise AssertionError(f"{q}: column {k} {out[k].tolist()} vs "
                                 f"pandas {want[k].tolist()}")


def child_processes():
    """Live (not zombie) child processes of this process, from /proc:
    [(pid, command name)]."""
    import os
    me = os.getpid()
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue  # exited while listed
        # the command name sits in parentheses and may hold spaces
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == me and state != "Z":
            out.append((int(entry), stat[stat.index("(") + 1:
                                         stat.rindex(")")]))
    return out


def udf_times(qe) -> str:
    """A run's phase times (ms) and its udf_summary."""
    pt = qe.phase_times
    split = ", ".join(f"{k[4:]} {pt[k] * 1e3:.1f}" for k in
                      ("udf_child", "udf_egress", "udf_eval", "udf_ingest")
                      if k in pt)
    main = ", ".join(f"{k} {pt[k] * 1e3:.1f}" for k in
                     ("python_udfs", "ingest", "execution", "egress")
                     if k in pt)
    s = qe.udf_summary or {}
    return (f"phase ms: {main} (python_udfs: {split}); udf_summary: "
            f"batches {s.get('batches')}, rows {s.get('rows')}, exec_ms "
            f"{s.get('exec_ms')}, restarts {s.get('worker_restarts')}")


def set_lane(session, lane) -> None:
    session.conf.set(UDF_MODE, lane)
    if lane == "worker":
        for key, value in UDF_WORKER_CONF:
            session.conf.set(key, value)


def phase_udf(D, S, path, launches, current, captured) -> dict:
    """Phase 13 on the TPC-H SF1 tables at `path`: U1-U4 a first and a
    warm run in each lane, the worker lane byte-equal to the in-process
    lane and both to pandas; then U5, recovery on U1's query in the
    worker lane. Returns U1's in-process result."""
    import torch
    from spark_tpu_torch.tpch import queries as Q
    session = S.SparkTpuSession.builder().get_or_create()
    Q.register_tables(session, path)
    apply_s = []
    programs = udf_programs(session, apply_s)
    t0 = time.perf_counter()
    goldens = udf_goldens(path)
    log(f"[udf] pandas answers in {time.perf_counter() - t0:.1f} s")
    metrics = session.metrics
    results = {}
    for q, make in programs.items():
        kernels = UDF_KERNELS[q]
        for lane in ("inprocess", "worker"):
            set_lane(session, lane)
            spawn0 = metrics.counter("udf_worker_spawn_ms").value
            batches0 = metrics.counter("udf_batches").value
            del apply_s[:]
            label = f"udf {q}" if lane == "inprocess" else None
            # the worker lane runs once (its warm runs cut to fit the
            # full run in its time limit)
            first, warm = first_and_warm(
                D, session, make, current, label,
                runs=2 if lane == "inprocess" else 1)
            for run, r in (("first", first), ("warm", warm)):
                if r is None:
                    continue
                check_udf(q, r[0], goldens[q])
                require_kernels(f"{q} {lane} {run} run", kernels, r[3])
            if warm is not None:
                tables_match(f"{q} {lane} warm run against its first",
                             warm[0], first[0])
            if lane == "inprocess":
                results[q] = first[0]
                launches[label] = first[3]
            elif not first[0].equals(results[q]):
                raise AssertionError(f"{q}: the worker lane's bytes differ "
                                     f"from the in-process lane's")
            if q == "u1" and lane == "inprocess" and not any(
                    shape[3] >= 1 for shape in
                    captured[(label, "dense_sums_smem")]):
                raise AssertionError("u1 gave dense_sums_smem no float row")
            spawned = metrics.counter("udf_worker_spawn_ms").value - spawn0
            pool = session._udf_pool
            log(f"[udf] {q} {lane}: {first[0].num_rows} rows; "
                f"{runs_text(first, warm)}; launches {first[3]}"
                + (f"; worker spawns {spawned} ms in all, idle workers' "
                   f"spawn ms {[round(h.spawn_ms, 1) for h in pool._idle]}"
                   if lane == "worker" else ""))
            log(f"[udf] {q} {lane} first run {udf_times(first[1])}")
            if warm is not None:
                log(f"[udf] {q} {lane} warm run {udf_times(warm[1])}")
            if apply_s:
                log(f"[udf] {q} {lane} apply_in_pandas (5 groups, before "
                    f"the aggregate's run): "
                    f"{', '.join(f'{t:.3f} s' for t in apply_s)} (first"
                    f"{'' if warm is None else ', warm'} run); udf_batches "
                    f"{metrics.counter('udf_batches').value - batches0}")
            if lane == "inprocess":
                set_lane(session, lane)
                log(f"[breakdown] udf {q}: {breakdown(make(), warm[1])}")
    set_lane(session, "worker")
    udf_recovery(session, results["u1"])
    session._udf_pool.shutdown()  # the phase leaves no worker running
    torch.cuda.synchronize()
    return results["u1"]


def udf_recovery(session, clean_u1) -> None:
    """U5, worker lane, U1's query: a worker killed mid-batch replays one
    batch, a failed spawn is retried, a user exception surfaces with the
    worker's traceback, and a cancel mid-UDF leaves no child process; each
    run that finishes gives U1's bytes."""
    import threading
    from spark_tpu_torch.execution import lifecycle
    from spark_tpu_torch.testing import faults
    from spark_tpu_torch.udf_worker import UdfError
    metrics = session.metrics
    pool = session._udf_pool
    for spec, prep in (("udf_batch:fatal:3", None),
                       ("udf_worker_spawn:unavailable:1", pool.shutdown)):
        if prep is not None:
            prep()  # the next checkout spawns
        replayed0 = metrics.counter("rec_chunks_replayed").value
        restarts0 = metrics.counter("udf_worker_restarts").value
        t0 = time.perf_counter()
        with faults.inject(session.conf, spec) as plan:
            qe = session.sql(U1_SQL)._qe()
            got = qe.collect()
        seconds = time.perf_counter() - t0
        site, nth = spec.split(":")[0], int(spec.split(":")[2])
        if plan.fired_log != [(site, nth, spec.split(":")[1])]:
            raise AssertionError(f"{spec}: fired {plan.fired_log}")
        replayed = metrics.counter("rec_chunks_replayed").value - replayed0
        if replayed != 1 or not got.equals(clean_u1):
            raise AssertionError(f"{spec}: {replayed} batches replayed, "
                                 f"bytes equal {got.equals(clean_u1)}")
        log(f"[udf] u5 {spec}: one batch replayed, U1's bytes; "
            f"fault_summary {qe.fault_summary}; worker restarts "
            f"{metrics.counter('udf_worker_restarts').value - restarts0}; "
            f"{seconds:.3f} s")

    def boom(p, d):
        raise ValueError("user bug in u5")

    from spark_tpu_torch import functions as F
    session.udf.register("boom", F.pandas_udf(boom, "double"))
    try:
        session.sql("SELECT sum(boom(CAST(l_extendedprice AS DOUBLE), "
                    "CAST(l_discount AS DOUBLE))) AS s "
                    "FROM lineitem").collect()
        raise AssertionError("u5: the raising UDF did not fail the query")
    except UdfError as e:
        if "in boom" not in e.worker_traceback or e.etype != "ValueError":
            raise AssertionError(f"u5: {e!r} without the worker's traceback")
        log(f"[udf] u5 user exception: {e}; worker traceback ends "
            f"{e.worker_traceback.strip().splitlines()[-1]!r}")

    qe = session.sql(U1_SQL)._qe()
    out, fired = {}, {}

    def run():
        try:
            out["table"] = qe.collect()
        except Exception as e:  # noqa: BLE001 — inspected below
            out["error"] = e

    batches0 = metrics.counter("udf_batches").value
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    deadline = time.monotonic() + 300
    while metrics.counter("udf_batches").value - batches0 < 5:
        if time.monotonic() > deadline or not thread.is_alive():
            raise AssertionError("u5: U1 never reached its fifth batch")
        time.sleep(0.002)
    fired["t"] = time.perf_counter()
    at = metrics.counter("udf_batches").value - batches0
    if not session.cancel(qe.query_id):
        raise AssertionError("u5: session.cancel found no running query")
    thread.join(60)
    late = time.perf_counter() - fired["t"]
    if thread.is_alive() or not isinstance(
            out.get("error"), lifecycle.QueryCancelledError):
        raise AssertionError(f"u5: the cancel gave {out}")
    left = child_processes()
    if left:
        raise AssertionError(f"u5: child processes outlived the cancel: "
                             f"{left}")
    again_qe = session.sql(U1_SQL)._qe()
    if not again_qe.collect().equals(clean_u1):
        raise AssertionError("u5: U1 after the cancel differs")
    log(f"[udf] u5 cancel after {at} batches (of "
        f"{again_qe.udf_summary['batches']}): "
        f"QueryCancelledError {late * 1e3:.1f} ms after it ({out['error']}); "
        f"no child process left (/proc); the rerun gives U1's bytes")


def mesh_session(S, path, pinned: bool):
    """A session at mesh.size MESH_SHARDS over the TPC-H tables at
    `path`: pinned to cuda:0 (every shard on one card) or built without a
    device (the shards on cuda:0..3)."""
    from spark_tpu_torch.tpch.queries import register_tables
    builder = S.SparkTpuSession.builder()
    if pinned:
        builder = builder.device("cuda:0")
    session = builder.get_or_create()
    session.conf.set(MESH_KEY, MESH_SHARDS)
    register_tables(session, path)
    return session


def card_launches(D) -> dict:
    """This run's launches by kernel and CUDA device index."""
    return {f"{k}@cuda:{i}": n for (k, i), n in sorted(D.DEVICE_LAUNCHES.items())}


def require_shard_launches(label, kernels, counts, per_card, cards) -> None:
    """Each kernel of `kernels` launched once per shard at least, and on
    a mesh of distinct cards on every card."""
    if isinstance(kernels, str):
        kernels = (kernels,)
    for kernel in kernels or ():
        if counts[kernel] < MESH_SHARDS:
            raise AssertionError(f"{label}: {kernel} launched "
                                 f"{counts[kernel]} times, fewer than the "
                                 f"{MESH_SHARDS} shards")
        for i in cards:
            if per_card.get(f"{kernel}@cuda:{i}", 0) < 1:
                raise AssertionError(f"{label}: no {kernel} launch on "
                                     f"cuda:{i}: {per_card}")


def mesh_first_and_warm(D, session, make_df, current, label):
    """`first_and_warm` with each run's launches by card as a fifth
    item; neither run may take a recovery action (a mesh fallback
    would be a silent one-device run)."""
    import gc
    import torch
    out = []
    reset_state(session)
    # pinned SQL Q5 at 4 shards peaks near the card's capacity: return
    # the blocks the caching allocator still holds split from earlier
    # work, so that a run's large allocations find whole segments
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for run in range(2):
        current[0] = label if run == 0 else None
        zero_launches(D)
        t0 = time.perf_counter()
        qe = make_df()._qe()
        got = qe.collect()
        torch.cuda.synchronize()
        out.append((got, qe, time.perf_counter() - t0, dict(D.LAUNCHES),
                    card_launches(D)))
        if qe.fault_summary:
            raise AssertionError(f"{label}: {qe.fault_summary}")
        if "ExchangeExec(" not in qe.executed_plan.tree_string():
            raise AssertionError(f"{label}: no ExchangeExec in the plan")
    current[0] = None
    return out


def mesh_breakdown(session, make_df, cards) -> str:
    """Where a warm mesh run's time goes: one run with every operator of
    every shard timed on the host clock, the shard's card synchronised
    around it (an exchange's time includes its wait for the slowest
    shard at the rendezvous), reported per operator type as the slowest
    shard's total; then each exchange by its tag: its time (the slowest
    shard's), the bytes its collectives copied between cards, its rate
    and the NVLink bound for those bytes (NVLINK_BYTES_PER_S into each
    card, the cards receiving at once); then a run under
    torch.profiler for each card's busy share."""
    import collections
    import threading
    import torch
    import spark_tpu_torch.execution.executor as E
    from spark_tpu_torch.parallel import mesh as M
    per_shard = collections.defaultdict(float)
    lock = threading.Lock()
    orig = E.run_plan

    def timed_run_plan(root, ctx, visit=None, loaded=None):
        def timed(node, compute):
            torch.cuda.synchronize(ctx.device)
            t0 = time.perf_counter()
            out = compute()
            torch.cuda.synchronize(ctx.device)
            seconds = time.perf_counter() - t0
            with lock:
                per_shard[(ctx.shard_index, type(node).__name__)] += seconds
                if type(node).__name__ == "ExchangeExec":
                    per_shard[(ctx.shard_index, f"exchange {node.tag}")] \
                        += seconds
            return out
        return orig(root, ctx, timed, loaded)

    M.reset_copy_stats()
    E.run_plan = timed_run_plan
    try:
        t0 = time.perf_counter()
        make_df().collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        E.run_plan = orig
    ops = collections.defaultdict(float)  # the slowest shard's total
    for (_, name), seconds in per_shard.items():
        ops[name] = max(ops[name], seconds)
    parts = ", ".join(f"{n} {s * 1e3:.1f} ms" for n, s in
                      sorted(ops.items(), key=lambda kv: -kv[1])
                      if not n.startswith("exchange "))
    copied = dict(M.COPY_STATS)
    total = sum(v[0] for v in copied.values())
    exchanges = []
    for name in sorted((n for n in ops if n.startswith("exchange ")),
                       key=lambda n: int(n.split(" e")[1])):
        tag = name.split(" ")[1]
        nbytes = sum(v[0] for k, v in copied.items()
                     if k.split(" ")[-1] == tag)
        seconds = ops[name]
        exchanges.append(
            f"{tag} {seconds * 1e3:.1f} ms, {nbytes:,} B"
            + (f" at {nbytes / max(seconds, 1e-9) / 1e9:.2f} GB/s, bound "
               f"{nbytes / (len(cards) * NVLINK_BYTES_PER_S) * 1e3:.4f} ms"
               if nbytes else ""))
    moved = ("exchanges: " + "; ".join(exchanges) if exchanges
             else "no exchange")
    moved += (f"; peer copies {total:,} B in "
              f"{sum(v[1] for v in copied.values())} copies"
              + (f", the result's gather {copied['gather'][0]:,} B"
                 if "gather" in copied else "")
              if total else "; no peer copies (every shard on one card)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        make_df().collect()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy, events = device_busy_by_card(prof)
    if events:
        cards_text = ", ".join(
            f"cuda:{i} busy {busy.get(i, 0.0) * 1e3:.2f} ms (idle share "
            f"{1 - busy.get(i, 0.0) / pwall:.4f})" for i in cards)
        busy_part = (f"profiled run {pwall * 1e3:.1f} ms wall: {cards_text}"
                     f", {events} device events")
    else:
        busy_part = ("card busy time not measured (the profiler saw no "
                     "device events)")
    return (f"timed run {wall * 1e3:.1f} ms wall: {parts}; {moved}; "
            f"{busy_part}")


def device_busy_by_card(prof):
    """Each card's busy seconds in a torch.profiler trace (the union of
    its kernel and copy intervals), and the count of device events."""
    import collections
    import torch
    spans = collections.defaultdict(list)
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans[e.device_index].append((e.time_range.start,
                                          e.time_range.end))
            n += 1
    busy = {}
    for dev, ss in spans.items():
        total, end = 0.0, float("-inf")
        for s, e in sorted(ss):
            if e > end:
                total += e - max(s, end)
                end = e
        busy[dev] = total / 1e6
    return busy, n


def mesh_golden(G, path, q, got) -> None:
    gold = G.GOLDEN[q](path)
    G.compare(G.normalize_decimals(got.to_pandas())[
        gold.columns.tolist()].reset_index(drop=True), gold)


def mesh_range_check(got) -> None:
    import numpy as np
    ids = np.arange(RANGE_ROWS, dtype=np.int64)
    keys = ids % RANGE_MOD
    cnt = np.bincount(keys, minlength=RANGE_MOD)
    total = np.zeros(RANGE_MOD, dtype=np.int64)
    np.add.at(total, keys, ids)
    got = got.to_pandas().sort_values(got.column_names[0])
    if not (np.array_equal(got.iloc[:, 0].to_numpy(), np.arange(RANGE_MOD))
            and np.array_equal(got["count(*)"].to_numpy(), cnt)
            and np.array_equal(got["sum(id)"].to_numpy(), total)
            and np.allclose(got["avg(id)"].to_numpy(), total / cnt,
                            rtol=1e-15, atol=0)):
        raise AssertionError("mesh range group-by disagrees with numpy")


def mesh_cases(D, S, G, Q, path, df_results, launches, current, pinned,
               refs=None):
    """The mesh cases on one session: DataFrame and SQL Q1/Q3/Q5/Q6 and
    the range group-by, each a first and a warm run against the golden
    (and phase 5's one-card results when it ran), each launching its
    kernel once per shard (on every card of a mesh of cards). `refs`
    receives the SQL queries' and the range's first-run results, by
    query, with the label their kernel inputs are kept under."""
    import torch
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    where = "1 card" if pinned else f"{MESH_SHARDS} cards"
    cards = [0] if pinned else list(range(MESH_SHARDS))
    session = mesh_session(S, path, pinned)
    cases = [(f"df {q}", q, (lambda q=q: Q.QUERIES[q](session)))
             for q in MESH_QUERIES]
    cases += [(f"sql {q}", q, (lambda q=q: session.sql(SQL_QUERIES[q])))
              for q in MESH_QUERIES]
    cases.append(("range", "range", lambda: session.range(RANGE_ROWS)
                  .group_by(col("id") % RANGE_MOD)
                  .agg(F.count(), F.sum(col("id")), F.avg(col("id")))))
    for name, q, make in cases:
        label = f"mesh {where} {name}"
        first, warm = mesh_first_and_warm(D, session, make, current, label)
        launches[label] = first[3]
        kernel = "dense_sums_global" if q == "range" else MESH_KERNELS[q]
        for run in (first, warm):
            require_shard_launches(label, kernel, run[3], run[4], cards)
            if q == "range":
                mesh_range_check(run[0])
            else:
                mesh_golden(G, path, q, run[0])
        if refs is not None and not name.startswith("df "):
            refs[q] = (first[0], label)
        if df_results is not None and q in df_results:
            mine, want = first[0], df_results[q]
            if name.startswith("sql "):
                mine = mine.select(want.column_names)
            if q == "q5":
                mine, want = mine.sort_by("n_name"), want.sort_by("n_name")
            tables_match(f"{label} against the one-card run", mine, want)
        log(f"[mesh] {label}: golden{' and the one-card run' if df_results and q in df_results else ''} "
            f"match; {first[0].num_rows} rows; {runs_text(first, warm)}; "
            f"launches {first[4]}; peak allocated on cuda:0 "
            f"{torch.cuda.max_memory_allocated():,} bytes")
        if not name.startswith("df "):
            # the SQL forms' breakdowns stand for the DataFrame forms'
            # (cut to fit the full run in its time limit)
            log(f"[mesh] {label} breakdown: "
                f"{mesh_breakdown(session, make, cards)}")
    return session


def mesh_faults(G, session, path, Q) -> None:
    """On a mesh session: `mesh:fatal:1` gang-restarts the mesh
    (mesh_restart 1, no fallback) with the golden, and with the restart
    off re-plans on one device (mesh_fallback 1) with the golden;
    `shuffle:unavailable:1` retries with the golden and no fallback."""
    import warnings
    from spark_tpu_torch.testing import faults
    restart_key = "spark_tpu.execution.meshRestart.enabled"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for restart, action in ((True, "mesh_restart"),
                                (False, "mesh_fallback")):
            session.conf.set(restart_key, restart)
            with faults.inject(session.conf, "mesh:fatal:1") as plan:
                qe = Q.QUERIES["q1"](session)._qe()
                got = qe.collect()
            other = "mesh_fallback" if restart else "mesh_restart"
            if plan.fired_log != [("mesh", 1, "fatal")] or \
                    qe.fault_summary.get(action) != 1 or \
                    other in qe.fault_summary or \
                    (qe.last_metrics.get("mesh_fallback") == 1) == restart:
                raise AssertionError(f"mesh:fatal:1 with restarts "
                                     f"{restart} gave {plan.fired_log}, "
                                     f"{qe.fault_summary}")
            mesh_golden(G, path, "q1", got)
            log(f"[mesh] mesh:fatal:1 on q1, meshRestart.enabled="
                f"{restart}: {'gang-restarted on the mesh' if restart else 're-planned on one device'} "
                f"(fault_summary {qe.fault_summary}), golden")
        session.conf.set(restart_key, True)
        with faults.inject(session.conf, "shuffle:unavailable:1") as plan:
            qe = Q.QUERIES["q1"](session)._qe()
            got = qe.collect()
        if not plan.fired_log or \
                qe.fault_summary.get("transient_retry", 0) < 1 or \
                "mesh_fallback" in qe.fault_summary:
            raise AssertionError(f"shuffle:unavailable:1 gave "
                                 f"{plan.fired_log}, {qe.fault_summary}")
        mesh_golden(G, path, "q1", got)
        log(f"[mesh] shuffle:unavailable:1 on q1: retried "
            f"(fault_summary {qe.fault_summary}), golden")


def mesh_short_pool(S) -> None:
    """A session built without a device at mesh.size 8 with fewer cards
    raises the 'devices visible' diagnostic instead of running."""
    import torch
    session = S.SparkTpuSession.builder().get_or_create()
    session.conf.set(MESH_KEY, 8)
    try:
        session.range(100).collect()
    except RuntimeError as e:
        if "devices visible" not in str(e):
            raise
        log(f"[mesh] mesh.size=8 on {torch.cuda.device_count()} card(s), "
            f"no device given: raises ({str(e)[:80]}...)")
        return
    raise AssertionError("mesh.size=8 ran on too few cards")


def mesh_sql22(D, S, G, path, launches, current) -> None:
    """The 22 TPC-H SQL queries at SF1 on a mesh of cards, a first and a
    warm run each against the golden, each launching SQL_KERNELS' kernel
    on every card."""
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    session = mesh_session(S, path, pinned=False)
    cards = list(range(MESH_SHARDS))
    t_phase, warm_total = time.perf_counter(), 0.0
    for q, kernel in SQL_KERNELS.items():
        label = f"mesh sql22 {q}"
        make = lambda q=q: session.sql(SQL_QUERIES[q])
        first, warm = mesh_first_and_warm(D, session, make, current, label)
        launches[label] = first[3]
        for run in (first, warm):
            require_shard_launches(label, kernel, run[3], run[4], cards)
            mesh_golden(G, path, q, run[0])
        warm_total += warm[2]
        log(f"[mesh] {label}: both runs match golden; {first[0].num_rows} "
            f"rows; {runs_text(first, warm)}; launches {first[4]}")
        log(f"[mesh] {label} breakdown: "
            f"{mesh_breakdown(session, make, cards)}")
    log(f"[mesh] 22 SQL queries on {MESH_SHARDS} cards in "
        f"{time.perf_counter() - t_phase:.1f} s; warm runs "
        f"{warm_total:.3f} s in all")


def mesh_sf10(D, S, launches, current, sf10) -> None:
    """SF10 lineitem resident across the cards (not streamed) through SQL
    Q1 and Q6, a first and a warm run each against phase 12's exact
    golden, with each card's peak allocated bytes."""
    import torch
    from spark_tpu_torch.io.sources import ParquetSource
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    cards = list(range(MESH_SHARDS))
    path, ans = sf10.get("mesh")
    session = S.SparkTpuSession.builder().get_or_create()
    session.conf.set(MESH_KEY, MESH_SHARDS)
    session.conf.set(CACHE_KEY, MESH_CACHE_BYTES)
    session.register_table("lineitem", ParquetSource(path, "lineitem"))
    for q in ("q1", "q6"):
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        label = f"mesh sf{OOC_SF} {q}"
        first, warm = mesh_first_and_warm(
            D, session, lambda q=q: session.sql(SQL_QUERIES[q]),
            current, label)
        launches[label] = first[3]
        for run in (first, warm):
            if "InputExec(streamed" in run[1].spliced_plan.tree_string():
                raise AssertionError(f"{label} streamed")
            require_shard_launches(label, "dense_sums_smem", run[3],
                                   run[4], cards)
            check_q1_q6(q, run[0], ans)
        tables_match(f"{label} warm run", warm[0], first[0])
        peaks = ", ".join(
            f"cuda:{i} {torch.cuda.max_memory_allocated(i):,}"
            for i in cards)
        log(f"[mesh] SF{OOC_SF} {q} resident on {MESH_SHARDS} cards: "
            f"equals the golden; {runs_text(first, warm)} "
            f"({ans['rows'] / warm[2] / 1e6:.2f} M rows/s warm); "
            f"launches {first[4]}; peak allocated bytes {peaks}")
        log(f"[mesh] SF{OOC_SF} {q} breakdown: "
            f"{mesh_breakdown(session, lambda q=q: session.sql(SQL_QUERIES[q]), cards)}")
    from spark_tpu_torch.io.device_cache import CACHE
    CACHE.clear()


def phase_mesh(D, S, G, path, df_results, launches, current, sf10,
               refs=None) -> None:
    """Phase 14: the mesh. On every run, a session pinned to cuda:0 at
    mesh.size 4 (every shard on one card), its faults and the short-pool
    diagnostic; with 4 cards, the same cases on cuda:0-3, the 22 SQL
    queries and SF10 Q1/Q6 resident across the cards."""
    import torch
    from spark_tpu_torch.tpch import queries as Q
    t0 = time.perf_counter()
    session = mesh_cases(D, S, G, Q, path, df_results, launches, current,
                         pinned=True, refs=refs)
    mesh_faults(G, session, path, Q)
    mesh_short_pool(S)
    log(f"[mesh] one card: {time.perf_counter() - t0:.1f} s")
    if torch.cuda.device_count() < MESH_SHARDS:
        log(f"[mesh] {torch.cuda.device_count()} card(s): the "
            f"{MESH_SHARDS}-card cases run on a host with {MESH_SHARDS} "
            f"cards (--phases mesh)")
        return
    t0 = time.perf_counter()
    mesh_cases(D, S, G, Q, path, df_results, launches, current,
               pinned=False)
    mesh_sql22(D, S, G, path, launches, current)
    mesh_sf10(D, S, launches, current, sf10)
    log(f"[mesh] {MESH_SHARDS} cards: {time.perf_counter() - t0:.1f} s")

def obs_session(S, path, confs):
    """A one-card session over the TPC-H tables at `path` with `confs`."""
    from spark_tpu_torch.tpch.queries import register_tables
    session = S.SparkTpuSession.builder().get_or_create()
    for key, value in confs:
        session.conf.set(key, value)
    register_tables(session, path)
    return session


def obs_programs():
    """Phase 15's programs: label -> make(session) -> DataFrame."""
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    out = {q: (lambda s, q=q: s.sql(SQL_QUERIES[q])) for q in OBS_SQL}
    out["range"] = lambda s: s.range(RANGE_ROWS).group_by(
        col("id") % RANGE_MOD).agg(F.count(), F.sum(col("id")),
                                   F.avg(col("id")))
    return out


def obs_steps() -> dict:
    """The observability steps phase 15 times: step -> (owner, attribute).
    `query end` is the whole post (the event's build and every built-in
    listener); the listeners are its parts."""
    from spark_tpu_torch.execution.executor import QueryExecution
    from spark_tpu_torch.observability import sinks
    from spark_tpu_torch.observability.device_cost import AttemptCost
    from spark_tpu_torch.observability.flight_recorder import FlightRecorder
    return {"query end": (QueryExecution, "_post_query_end"),
            "_build_event": (QueryExecution, "_build_event"),
            "event log": (sinks.EventLogListener, "on_query_end"),
            "trace write": (sinks.ChromeTraceListener, "on_query_end"),
            "metrics sinks": (sinks.MetricsSinkListener, "on_query_end"),
            "flight recorder": (FlightRecorder, "on_query_end"),
            "stage event": (QueryExecution, "_post_stage_completed"),
            "cost reset": (AttemptCost, "__init__"),
            "cost read": (AttemptCost, "finish")}


def obs_run(D, session, make, kernel, label):
    """One run of `make(session)` with the launch counters at 0; it must
    launch `kernel`. Returns (Arrow result, seconds)."""
    import torch
    zero_launches(D)
    t0 = time.perf_counter()
    got = make(session)._qe().collect()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require_kernels(label, kernel, dict(D.LAUNCHES))
    return got, seconds


def phase_obs(D, S, G, path, launches, current, capture) -> None:
    """Phase 15: the observability spine on the card. SQL Q1, Q5, Q6 and
    the range group-by in a session with every output on (event log,
    Chrome traces, `metrics.sink=prometheus,jsonl`, `xlaCost=on`, a
    torch.profiler trace for Q1's first run) and one with every
    observability key off; every run gives the golden answer (the
    first through the golden, the rest by bytes equal to it), the same
    bytes in both sessions, and launches its kernel. Then the checks:
    the log validates under `scripts/events_tool.py` and replays
    through `history`; `hbm_summary` gives every execution a peak
    between 1 byte and the card's capacity; every trace parses; the
    Prometheus file counts every execution's latency; an injected
    `stage_run:fatal:1` leaves a flight-recorder bundle; and DF Q1 at 4
    shards pinned to cuda:0 writes `transfer` records for its
    exchanges. `capture` keeps each program's first kernel inputs
    (under `obs <label>`) for the kernel report."""
    import os
    import statistics
    import torch
    from spark_tpu_torch import history
    from spark_tpu_torch.execution.executor import QueryExecution
    from spark_tpu_torch.observability import sinks
    from spark_tpu_torch.observability.device_cost import \
        device_hbm_capacity
    from spark_tpu_torch.observability.metrics import parse_prometheus
    from spark_tpu_torch.testing import faults
    from spark_tpu_torch.tpch import queries as Q
    t_phase = time.perf_counter()
    programs = obs_programs()
    with tempfile.TemporaryDirectory() as tmp:
        on_confs = (
            ("spark_tpu.sql.eventLog.dir", f"{tmp}/ev"),
            ("spark_tpu.sql.trace.dir", f"{tmp}/tr"),
            ("spark_tpu.sql.metrics.sink", "prometheus,jsonl"),
            ("spark_tpu.sql.metrics.dir", f"{tmp}/m"),
            ("spark_tpu.sql.observability.xlaCost", "on"),
            ("spark_tpu.sql.flightRecorder.dir", f"{tmp}/fr"))
        on = obs_session(S, path, on_confs)
        off = obs_session(S, path, OBS_OFF)
        # each observability step's own time per warm run of the `on`
        # session (summed over a run's calls), and each event's bytes
        label = [None]
        cost = {k: {step: [] for step in OBS_STEPS} | {"bytes": []}
                for k in programs}
        originals = {step: getattr(owner, attr)
                     for step, (owner, attr) in obs_steps().items()}

        def timed(step, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if label[0] is not None:
                    calls = cost[label[0]][step]
                    calls[-1] += time.perf_counter() - t0
                    if step == "_build_event":
                        cost[label[0]]["bytes"].append(len(json.dumps(
                            out, default=sinks.json_default)))
                return out
            return wrapper

        for step, (owner, attr) in obs_steps().items():
            setattr(owner, attr, timed(step, originals[step]))
        executions = 0
        try:
            for name, make in programs.items():
                kernel = OBS_KERNELS[name]
                if name == "q1":
                    on.conf.set("spark_tpu.sql.profile.dir", f"{tmp}/prof")
                current[0] = f"obs {name}" if capture else None
                zero_launches(D)
                first, _ = obs_run(D, on, make, kernel, f"obs {name}")
                launches[f"obs {name}"] = dict(D.LAUNCHES)
                current[0] = None
                on.conf.set("spark_tpu.sql.profile.dir", "")
                executions += 1
                if name == "range":
                    mesh_range_check(first)
                else:
                    mesh_golden(G, path, name, first)
                got, _ = obs_run(D, off, make, kernel, f"obs {name} off")
                tables_match(f"obs {name}: off against on", got, first)
                times = {"on": [], "off": []}
                for _ in range(OBS_RUNS):
                    for mode, session in (("on", on), ("off", off)):
                        label[0] = name if mode == "on" else None
                        if mode == "on":
                            for step in OBS_STEPS:
                                cost[name][step].append(0.0)
                        got, seconds = obs_run(D, session, make, kernel,
                                               f"obs {name} {mode}")
                        label[0] = None
                        executions += mode == "on"
                        times[mode].append(seconds)
                        if not got.equals(first):
                            raise AssertionError(
                                f"obs {name} ({mode}): bytes differ from "
                                f"the first run's")
                t_on = statistics.median(times["on"])
                t_off = statistics.median(times["off"])
                c = cost[name]
                steps = ", ".join(
                    f"{step} {statistics.median(c[step]) * 1e3:.3f}"
                    for step in OBS_STEPS)
                log(f"[obs] {name}: warm wall, median of {OBS_RUNS}: "
                    f"everything on {t_on * 1e3:.2f} ms, everything off "
                    f"{t_off * 1e3:.2f} ms, ratio {t_on / t_off:.4f}; "
                    f"event {statistics.median(c['bytes']):.0f} bytes; "
                    f"ms a run: {steps}; equal bytes on and off, "
                    f"{kernel} launched every run")
        finally:
            for step, (owner, attr) in obs_steps().items():
                setattr(owner, attr, originals[step])
        # an injected fatal: its error line, and a bundle
        with faults.inject(on.conf, "stage_run:fatal:1"):
            try:
                programs["q6"](on)._qe().collect()
            except faults.FaultInjected:
                pass
            else:
                raise AssertionError("obs: stage_run:fatal:1 did not raise")
        bundles = [b for b in os.listdir(f"{tmp}/fr")
                   if b.startswith(f"bundle-{on.app_id}-")]
        if len(bundles) != 1:
            raise AssertionError(f"obs: bundles after the fatal: {bundles}")
        with open(f"{tmp}/fr/{bundles[0]}/MANIFEST.json") as f:
            manifest = json.load(f)
        if manifest["reason"] != "fatal" or \
                "FaultInjected" not in manifest["error"]:
            raise AssertionError(f"obs: bundle manifest {manifest}")
        log(f"[obs] stage_run:fatal:1: bundle {bundles[0]} with "
            f"{len(manifest['files'])} files ({', '.join(manifest['files'])})")
        # the log: valid, replayed, one line per execution, peaks in range
        tool = subprocess.run(
            [sys.executable, "scripts/events_tool.py", "validate",
             f"{tmp}/ev"], capture_output=True, text=True, timeout=120)
        if tool.returncode != 0:
            raise AssertionError(f"obs: events_tool validate: "
                                 f"{tool.stdout[-2000:]}{tool.stderr[-2000:]}")
        events = history.read_event_log(f"{tmp}/ev")
        statuses = list(events["status"])
        if statuses != ["ok"] * executions + ["error"]:
            raise AssertionError(f"obs: logged statuses {statuses}")
        capacity = device_hbm_capacity(on.device)
        hbm = history.hbm_summary(events)
        # the fatal fired before its attempt ran: no stage of its own
        if len(hbm) != executions or not all(
                1 <= p <= capacity for p in hbm["peak_hbm_bytes"]):
            raise AssertionError(f"obs: hbm_summary {hbm.to_dict('list')}"
                                 f" against capacity {capacity}")
        peaks = hbm.groupby("plan", sort=False)["peak_hbm_bytes"].max()
        for plan, peak in peaks.items():
            log(f"[obs] peak {peak:,} bytes of {capacity:,} "
                f"({peak / capacity:.4f}): {plan[:60]}")
        # traces parse; the profile is a Chrome trace too
        traces = sorted(os.listdir(f"{tmp}/tr"))
        for name in traces:
            with open(f"{tmp}/tr/{name}") as f:
                if not json.load(f)["traceEvents"]:
                    raise AssertionError(f"obs: empty trace {name}")
        (prof,) = os.listdir(f"{tmp}/prof")
        with open(f"{tmp}/prof/{prof}") as f:
            prof_events = len(json.load(f)["traceEvents"])
        # the metrics file counts every execution (the fatal's too)
        prom = parse_prometheus(f"{tmp}/m/metrics.prom")
        n = executions + 1
        if prom.get("spark_tpu_status_latency_ms_count") != n or \
                prom.get("spark_tpu_queries_total") != n:
            raise AssertionError(
                f"obs: metrics.prom counts "
                f"{prom.get('spark_tpu_status_latency_ms_count')} latencies,"
                f" {prom.get('spark_tpu_queries_total')} queries; ran {n}")
        log(f"[obs] log: {len(events)} lines valid and replayed, "
            f"{os.path.getsize(f'{tmp}/ev/app-{on.app_id}.jsonl'):,} bytes;"
            f" {len(traces)} traces parse; profile trace {prof_events} "
            f"events; metrics.prom counts {n} latencies")
        obs_mesh_transfers(D, S, G, path, Q, tmp)
    log(f"[obs] phase in {time.perf_counter() - t_phase:.1f} s")


def obs_mesh_transfers(D, S, G, path, Q, tmp) -> None:
    """DF Q1 at 4 shards pinned to cuda:0 with shardSpans on: each of
    its exchanges gives one transfer record per shard, in the log."""
    from spark_tpu_torch import history
    session = mesh_session(S, path, pinned=True)
    session.conf.set("spark_tpu.sql.observability.shardSpans", "on")
    session.conf.set("spark_tpu.sql.eventLog.dir", f"{tmp}/mesh_ev")
    zero_launches(D)
    qe = Q.QUERIES["q1"](session)._qe()
    got = qe.collect()
    require_shard_launches("obs mesh q1", "dense_sums_smem",
                           dict(D.LAUNCHES), card_launches(D), [0])
    mesh_golden(G, path, "q1", got)
    transfer = [r for r in qe.spans.shard_records
                if r["phase"] == "transfer"]
    sources = sorted({r["source"] for r in transfer})
    by_source = {src: [r["rows"] for r in transfer if r["source"] == src]
                 for src in sources}
    # one record per shard for each exchange that routes rows (a hash or
    # range exchange; a gather's rows are the result's)
    if not sources or any(len(rows) != MESH_SHARDS
                          for rows in by_source.values()) \
            or not sum(sum(rows) for rows in by_source.values()):
        raise AssertionError(f"obs mesh q1: transfer records {by_source}")
    shards = history.shard_summary(history.read_event_log(
        f"{tmp}/mesh_ev"))
    if len(shards) != len(transfer):
        raise AssertionError("obs mesh q1: the log lacks its records")
    log(f"[obs] mesh DF Q1, {MESH_SHARDS} shards on cuda:0: "
        + "; ".join(f"{src} rows by shard {rows}"
                    for src, rows in by_source.items()))


# ---------------------------------------------------------------------------
# Phase 16: the mesh stream and the elastic mesh
# ---------------------------------------------------------------------------

def elastic_session(S, path, pinned: bool, confs=()):
    """A session at mesh.size MESH_SHARDS over SF10 lineitem with the
    per-shard telemetry on: pinned to cuda:0, or built without a device
    (the shards on cuda:0..3)."""
    from spark_tpu_torch.io.sources import ParquetSource
    builder = S.SparkTpuSession.builder()
    if pinned:
        builder = builder.device("cuda:0")
    session = builder.get_or_create()
    session.conf.set(MESH_KEY, MESH_SHARDS)
    session.conf.set(SPANS_KEY, "on")
    for key, value in confs:
        session.conf.set(key, value)
    session.register_table("lineitem", ParquetSource(path, "lineitem"))
    return session


def mesh_chunk_records(qe) -> list:
    """Per chunk of the query's mesh streams, in this process, in ms: the
    host decode, the consumer's stall, the host copy (Arrow to host
    tensors), the slowest local shard's stripe copy to its card, the
    update's host time, each local shard's device update (CUDA events on
    its card) and the agreements' time (the drain request and, on a
    cluster, the per-shard records' gather)."""
    out = []
    for stream in qe.stream_stats:
        if stream["kind"] != "mesh":
            continue
        for r in stream["chunks"]:
            out.append({
                "decode": r.get("decode_s", 0.0) * 1e3,
                "stall": stall_s(r) * 1e3,
                "copy": r.get("copy_s", 0.0) * 1e3,
                "stripe": max(r["stripe_copy_s"]) * 1e3,
                "update": r["update_s"] * 1e3,
                "device": [ev[0].elapsed_time(ev[1])
                           for ev in r.get("shard_events") or ()
                           if ev is not None],
                "agree": r["agree_s"] * 1e3})
    return out


def elastic_chunk_lines(qe) -> str:
    """`mesh_chunk_records` as text, without the agreements."""
    return "; ".join(
        f"chunk {i}: decode {c['decode']:.1f} ms, stall {c['stall']:.1f} "
        f"ms, host copy {c['copy']:.1f} ms, stripe copy {c['stripe']:.1f} "
        f"ms, update host {c['update']:.1f} ms"
        + (f", device by shard {'/'.join(f'{x:.2f}' for x in c['device'])}"
           f" ms" if c["device"] else "")
        for i, c in enumerate(mesh_chunk_records(qe)))


def compute_records(qe) -> list:
    return [r for r in qe.spans.shard_records if r["phase"] == "compute"]


def shard_record_text(qe) -> str:
    """The per-shard telemetry: records, live rows and summed wait by
    shard."""
    by = {}
    for r in compute_records(qe):
        n, rows, wait = by.get(r["shard"], (0, 0, 0.0))
        by[r["shard"]] = (n + 1, rows + r["rows"], wait + r["wait_ms"])
    return ", ".join(f"shard {i}: {n} records, {rows:,} rows, wait "
                     f"{wait:.1f} ms" for i, (n, rows, wait) in
                     sorted(by.items()))


def run_q1(session, spec=""):
    """SQL Q1 once (under the fault spec when given): (result, qe,
    seconds, fired rules)."""
    import torch
    import warnings
    from spark_tpu_torch.testing import faults
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    fired = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the ladder's warnings
        t0 = time.perf_counter()
        if spec:
            with faults.inject(session.conf, spec) as plan:
                qe = session.sql(SQL_QUERIES["q1"])._qe()
                got = qe.collect()
                fired = list(plan.fired_log)
        else:
            qe = session.sql(SQL_QUERIES["q1"])._qe()
            got = qe.collect()
        torch.cuda.synchronize()
    return got, qe, time.perf_counter() - t0, fired


def elastic_streams(D, S, path, ans, launches, current, pinned, cards):
    """Case 1: SQL Q1 and Q6 streamed per shard, a first and a warm run
    each. Returns Q1's warm seconds and its first run's result."""
    import torch
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    where = "1 card" if pinned else f"{MESH_SHARDS} cards"
    session = elastic_session(S, path, pinned)
    for q in ("q1", "q6"):
        label = f"elastic {where} {q}"
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        base = {i: torch.cuda.memory_allocated(i) for i in cards}
        first, warm = mesh_first_and_warm(
            D, session, lambda q=q: session.sql(SQL_QUERIES[q]), current,
            label)
        launches[label] = first[3]
        chunks = expected_chunks(q, ans)
        for run in (first, warm):
            require_stream(label, run[1], "streamed_partial_agg", chunks)
            require_shard_launches(label, "dense_sums_smem", run[3], run[4],
                                   cards)
            if run[3]["dense_sums_smem"] < MESH_SHARDS * chunks:
                raise AssertionError(
                    f"{label}: {run[3]['dense_sums_smem']} launches, fewer "
                    f"than one per shard and chunk ({MESH_SHARDS} x "
                    f"{chunks})")
            check_q1_q6(q, run[0], ans)
        tables_match(f"{label} warm run", warm[0], first[0])
        peaks = ", ".join(
            f"cuda:{i} {torch.cuda.max_memory_allocated(i) - base[i]:,}"
            for i in cards)
        log(f"[elastic] {label} streamed per shard: equals the golden; "
            f"{runs_text(first, warm)} ({ans['rows'] / warm[2] / 1e6:.2f} M "
            f"rows/s warm); {n_chunks(warm[1])} chunks; launches "
            f"{first[4]}; peak allocated bytes over those held {peaks}")
        log(f"[elastic] {label} warm run chunks: "
            f"{elastic_chunk_lines(warm[1])}")
        log(f"[elastic] {label} warm run per-shard telemetry: "
            f"{shard_record_text(warm[1])}")
        if q == "q1":
            q1_s, q1_got = warm[2], first[0]
    return q1_s, q1_got


def elastic_kill(D, S, path, ans, pinned, cards, clean_s) -> None:
    """Case 2: a shard lost at the 2nd snapshot, a checkpoint every
    chunk: one gang restart, no fallback, a resume on the mesh that
    replays at most one chunk."""
    session = elastic_session(S, path, pinned, ((CKPT_KEY, 1),))
    zero_launches(D)
    got, qe, seconds, fired = run_q1(session, "mesh_checkpoint:fatal:2")
    fs = qe.fault_summary
    restore = [ev for ev in qe.fault_events
               if ev["action"] == "checkpoint_restore"]
    if fired != [("mesh_checkpoint", 2, "fatal")] or \
            fs.get("mesh_restart") != 1 or "mesh_fallback" in fs or \
            len(restore) != 1 or restore[0].get("driver") != "mesh" or \
            restore[0]["chunks_replayed"] > 1:
        raise AssertionError(f"kill case: fired {fired}, {fs}, {restore}")
    check_q1_q6("q1", got, ans)
    require_shard_launches("kill case", "dense_sums_smem", dict(D.LAUNCHES),
                           card_launches(D), cards)
    log(f"[elastic] kill mid-stream (mesh_checkpoint:fatal:2, a checkpoint "
        f"a chunk): restarted on the mesh, resumed at chunk "
        f"{restore[0]['cursor']} replaying {restore[0]['chunks_replayed']} "
        f"chunk(s); equals the golden; {seconds:.3f} s against the clean "
        f"warm run's {clean_s:.3f} s (+{seconds - clean_s:.3f} s); "
        f"fault_summary {fs}; launches {card_launches(D)}")


def elastic_exhausted(S, path, ans, pinned) -> None:
    """Case 3: every restart attempt fails at its seam: the query lands
    on one device and resumes from the checkpoint."""
    session = elastic_session(S, path, pinned, ((CKPT_KEY, 1),))
    limit = int(session.conf.get(RESTART_MAX_KEY))
    spec = "mesh_checkpoint:fatal:2," + ",".join(
        f"mesh_restart:fatal:{i}" for i in range(1, limit + 1))
    got, qe, seconds, fired = run_q1(session, spec)
    fs = qe.fault_summary
    text = qe.spliced_plan.tree_string()
    if fs.get("mesh_restart") != limit or fs.get("mesh_fallback") != 1 or \
            fs.get("checkpoint_restore") != 1 or \
            "InputExec(spilled_partials," not in text:
        raise AssertionError(f"restart budget case: fired {fired}, {fs}, "
                             f"{text}")
    check_q1_q6("q1", got, ans)
    log(f"[elastic] restart budget spent ({limit} failed restarts): landed "
        f"on one device and resumed from the checkpoint "
        f"(resume_from_mesh_checkpoint); equals the golden; {seconds:.3f} "
        f"s; fault_summary {fs}")


def elastic_drain(D, S, path, ans, pinned, cards) -> None:
    """Case 4: shard 3 drained from a listener after chunk 1: the drain
    applies at a chunk boundary, mesh.size drops to 3 (on cards, cuda:3
    excluded) and the stream resumes from the forced checkpoint."""
    from spark_tpu_torch.observability import QueryListener
    session = elastic_session(S, path, pinned)

    class Drainer(QueryListener):
        done = False

        def on_shard_records(self, event):
            if not self.done and event.chunk >= 1:
                self.done = True
                session.decommission_shards([3])

    drainer = Drainer()
    session.add_listener(drainer)
    zero_launches(D)
    try:
        got, qe, seconds, _ = run_q1(session)
    finally:
        session.remove_listener(drainer)
    fs = qe.fault_summary
    by_chunk = {}
    for r in compute_records(qe):
        by_chunk.setdefault(r["chunk"], set()).add(r["shard"])
    last = by_chunk.get(max(by_chunk)) if by_chunk else None
    mesh_after = int(session.conf.get(MESH_KEY))
    excluded = session.conf.get("spark_tpu.sql.mesh.excludeDevices")
    if not drainer.done or fs.get("decommission") != 1 or \
            fs.get("checkpoint_restore") != 1 or mesh_after != 3 or \
            excluded != "3" or last != {0, 1, 2}:
        raise AssertionError(f"drain case: {fs}, mesh.size {mesh_after}, "
                             f"excluded {excluded!r}, shards by chunk "
                             f"{by_chunk}")
    check_q1_q6("q1", got, ans)
    per_card = card_launches(D)
    if not pinned and any(per_card.get(f"dense_sums_smem@cuda:{i}", 0) < 1
                          for i in cards[:3]):
        raise AssertionError(f"drain case: launches {per_card}")
    log(f"[elastic] decommission of shard 3 after chunk 1: drained at a "
        f"boundary, mesh.size {mesh_after}, excluded device ids "
        f"{excluded!r}, shards by chunk "
        f"{ {c: sorted(v) for c, v in sorted(by_chunk.items())} }; resumed "
        f"from the forced checkpoint; equals the golden; {seconds:.3f} s; "
        f"fault_summary {fs}; launches {per_card}")


def elastic_straggler(S, path, ans, pinned) -> None:
    """Case 5: 2^22-row chunks, shard 2 slowed every chunk by the
    `shard_chunk` seam: the monitor flags it and the rebalancer moves
    rows off it."""
    session = elastic_session(S, path, pinned,
                              ((CHUNK_KEY, ELASTIC_SLOW_CHUNK_ROWS),))
    rows = sum(acc[5] for acc in ans["q1"].values())
    chunks = -(-rows // ELASTIC_SLOW_CHUNK_ROWS)
    spec = ",".join(
        f"shard_chunk:slow:{c * MESH_SHARDS + ELASTIC_SLOW_SHARD + 1}:"
        f"{ELASTIC_SLOW_MS}" for c in range(chunks))
    moved0 = session.metrics.counter("rebalance_rows").value
    got, qe, seconds, fired = run_q1(session, spec)
    moved = session.metrics.counter("rebalance_rows").value - moved0
    fs = qe.fault_summary
    mine = sorted((r["chunk"], r["rows"]) for r in compute_records(qe)
                  if r["shard"] == ELASTIC_SLOW_SHARD)
    if fs.get("shard_rebalance") != 1 or moved <= 0 or \
            n_chunks(qe) != chunks:
        raise AssertionError(f"straggler case: {fs}, rebalance_rows "
                             f"{moved}, {n_chunks(qe)} chunks, shard "
                             f"{ELASTIC_SLOW_SHARD} rows {mine}")
    check_q1_q6("q1", got, ans)
    log(f"[elastic] straggler (shard {ELASTIC_SLOW_SHARD} slowed "
        f"{ELASTIC_SLOW_MS} ms a chunk, {chunks} chunks of "
        f"{ELASTIC_SLOW_CHUNK_ROWS} rows): flagged and rebalanced, "
        f"rebalance_rows {moved:,}; shard {ELASTIC_SLOW_SHARD} live rows by "
        f"chunk {[n for _, n in mine]}; equals the golden; {seconds:.3f} s;"
        f" fault_summary {fs}")


def phase_elastic(D, S, launches, current, sf10, captured,
                  cluster_stream) -> None:
    """Phase 16: the mesh stream and the elastic mesh on SF10 lineitem at
    mesh.size 4: pinned to cuda:0 on a one-card host, on cuda:0-3 on a
    host with four cards. When phase 22 ran, its two-process streams'
    results must equal the Q1 stream's first-run bytes, and that
    stream's kernel inputs stand for a shard's chunk in the two
    processes."""
    import torch
    path, ans = sf10.get("elastic")
    pinned = torch.cuda.device_count() < MESH_SHARDS
    cards = [0] if pinned else list(range(MESH_SHARDS))
    t0 = time.perf_counter()
    q1_s, q1_got = elastic_streams(D, S, path, ans, launches, current,
                                   pinned, cards)
    if cluster_stream.get("results"):
        where = "1 card" if pinned else f"{MESH_SHARDS} cards"
        label = f"elastic {where} q1"
        for i, got in enumerate(cluster_stream["results"]):
            if not got.equals(q1_got):
                raise AssertionError(f"phase 22's stream {i}: not the "
                                     f"one-process stream's bytes")
        captured[(CLUSTER_STREAM_LABEL, "dense_sums_smem")] = \
            captured[(label, "dense_sums_smem")]
        log(f"[elastic] phase 22's {len(cluster_stream['results'])} "
            f"two-process SF{OOC_SF} q1 streams (one per rank and run) equal "
            f"{label}'s run in bytes")
    elastic_kill(D, S, path, ans, pinned, cards, q1_s)
    elastic_exhausted(S, path, ans, pinned)
    elastic_drain(D, S, path, ans, pinned, cards)
    elastic_straggler(S, path, ans, pinned)
    log(f"[elastic] {'4 shards on 1 card' if pinned else '4 cards'}: "
        f"{time.perf_counter() - t0:.1f} s")


def stream_session(S, device=None):
    """A fresh session for a phase-17 case (the card unless `device`)."""
    builder = S.SparkTpuSession.builder()
    if device is not None:
        builder = builder.device(device)
    return builder.get_or_create()


def unscaled(values, scale: int):
    """Decimal values (Python Decimals, from a result's pandas column)
    as their unscaled int64 integers, exactly."""
    import numpy as np
    return np.array([int(v.scaleb(scale)) for v in values], dtype=np.int64)


def arrow_unscaled(col):
    """A decimal128 Arrow column's unscaled integers, read from its
    16-byte little-endian words (every value here fits the low word)."""
    import numpy as np
    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64)
    words = words[2 * arr.offset: 2 * (arr.offset + len(arr))]
    if (words[1::2] != np.where(words[0::2] < 0, -1, 0)).any():
        raise AssertionError("decimal value beyond 64 bits")
    return words[0::2].copy()


class StreamData:
    """Phase 17's feed: TPC-H SF1 lineitem in l_orderkey order, with
    `l_ts` (l_shipdate as timestamp[us]), cut into STREAM_FILES Parquet
    files under `staging`, and the integer columns the goldens need."""

    def __init__(self, path: str, staging: str):
        import os
        import numpy as np
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.parquet as pq
        t0 = time.perf_counter()
        table = pq.read_table(os.path.join(path, "lineitem.parquet"))
        table = table.take(pc.sort_indices(
            table, sort_keys=[("l_orderkey", "ascending")]))
        days = table.column("l_shipdate").cast(pa.int32()).to_numpy()
        ts = days.astype(np.int64) * 86_400_000_000
        table = table.append_column("l_ts", pa.array(ts, pa.timestamp("us")))
        self.schema = table.schema
        self.rows = table.num_rows
        self.cols = {
            "orderkey": table.column("l_orderkey").to_numpy(),
            "suppkey": table.column("l_suppkey").to_numpy(),
            "qty": arrow_unscaled(table.column("l_quantity")),
            "price": arrow_unscaled(table.column("l_extendedprice")),
            "disc": arrow_unscaled(table.column("l_discount")),
            "ts": ts}
        bounds = np.linspace(0, self.rows, STREAM_FILES + 1).astype(np.int64)
        self.bounds = bounds
        os.makedirs(staging, exist_ok=True)
        self.files = []
        self.tables = []
        for i in range(STREAM_FILES):
            part = table.slice(int(bounds[i]), int(bounds[i + 1] - bounds[i]))
            name = os.path.join(staging, f"lineitem-{i:03d}.parquet")
            pq.write_table(part, name)
            self.files.append(name)
            self.tables.append(part)
        log(f"[stream] feed: {self.rows:,} lineitem rows in l_orderkey "
            f"order as {STREAM_FILES} Parquet files of "
            f"{int(bounds[1] - bounds[0]):,} rows, written in "
            f"{time.perf_counter() - t0:.1f} s")

    def upto(self, n_files: int) -> dict:
        end = int(self.bounds[n_files])
        return {k: v[:end] for k, v in self.cols.items()}


class Watched:
    """A watched directory the feed's files move into, a wave at a time
    (an atomic rename: a file is whole when the source first lists it)."""

    def __init__(self, data: StreamData, root: str, files=None):
        import os
        import shutil
        self.dir = os.path.join(root, "in")
        os.makedirs(self.dir, exist_ok=True)
        self.pending = []
        for i, src in enumerate(files if files is not None else data.files):
            dst = os.path.join(root, f"staged-{i:03d}.parquet")
            shutil.copyfile(src, dst)
            self.pending.append(dst)
        self.moved = 0

    def wave(self, n: int) -> int:
        import os
        for src in self.pending[self.moved:self.moved + n]:
            os.rename(src, os.path.join(self.dir, os.path.basename(src)))
        self.moved = min(len(self.pending), self.moved + n)
        return self.moved


def s1_query(F, src, ck, sink=None):
    return (src.to_df()
            .group_by(F.pmod(F.col("l_orderkey"), STREAM_S1_MOD).alias("g"))
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.sum(F.col("l_extendedprice")).alias("sum_price"),
                 F.count().alias("n"))
            .write_stream(ck, sink_path=sink))


def s2_query(F, src, ck):
    return (src.to_df()
            .group_by(F.pmod(F.col("l_suppkey"), STREAM_S2_MOD).alias("g"))
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.avg(F.col("l_discount")).alias("avg_disc"),
                 F.count().alias("n"))
            .filter(F.col("n") >= STREAM_S2_MIN_ROWS)
            .write_stream(ck))


def s3_query(F, src, ck, sink):
    return (src.to_df()
            .with_watermark("l_ts", STREAM_DELAY)
            .group_by(F.window(F.col("l_ts"), STREAM_WINDOW).alias("w"))
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.count().alias("n"))
            .write_stream(ck, output_mode="append", sink_path=sink))


def check_s1(label, got, cols) -> None:
    """S1's complete-mode result against pandas over the rows delivered."""
    import numpy as np
    import pandas as pd
    want = (pd.DataFrame({"g": cols["orderkey"] % STREAM_S1_MOD,
                          "q": cols["qty"], "p": cols["price"]})
            .groupby("g").agg(q=("q", "sum"), p=("p", "sum"),
                              n=("q", "size")).reset_index())
    got = got.sort_values("g").reset_index(drop=True)
    for name, g, w in (("keys", got["g"].to_numpy(), want["g"].to_numpy()),
                       ("sum_qty", unscaled(got["sum_qty"], 2),
                        want["q"].to_numpy()),
                       ("sum_price", unscaled(got["sum_price"], 2),
                        want["p"].to_numpy()),
                       ("count", got["n"].to_numpy(), want["n"].to_numpy())):
        if len(g) != len(w) or not np.array_equal(g, w):
            raise AssertionError(f"{label}: {name} differ from pandas "
                                 f"({len(g)} against {len(w)} groups)")


def s2_golden(cols):
    """S2's answer: per supplier bucket the exact sums, the HALF_UP
    decimal(19,6) average of l_discount, the count, then the HAVING."""
    import numpy as np
    import pandas as pd
    want = (pd.DataFrame({"g": cols["suppkey"] % STREAM_S2_MOD,
                          "q": cols["qty"], "d": cols["disc"]})
            .groupby("g").agg(q=("q", "sum"), d=("d", "sum"),
                              n=("q", "size")).reset_index())
    want = want[want["n"] >= STREAM_S2_MIN_ROWS].reset_index(drop=True)
    avg = []
    for d, n in zip(want["d"].tolist(), want["n"].tolist()):
        quo, rem = divmod(d * 10_000, n)  # scale 2 -> scale 6
        avg.append(quo + (1 if 2 * rem >= n else 0))
    want["avg"] = np.array(avg, dtype=np.int64)
    return want


def check_s2(label, got, cols) -> None:
    import numpy as np
    want = s2_golden(cols)
    got = got.sort_values("g").reset_index(drop=True)
    for name, g, w in (("keys", got["g"].to_numpy(), want["g"].to_numpy()),
                       ("sum_qty", unscaled(got["sum_qty"], 2),
                        want["q"].to_numpy()),
                       ("avg_disc", unscaled(got["avg_disc"], 6),
                        want["avg"].to_numpy()),
                       ("count", got["n"].to_numpy(), want["n"].to_numpy())):
        if len(g) != len(w) or not np.array_equal(g, w):
            raise AssertionError(f"{label}: {name} differ from pandas "
                                 f"({len(g)} against {len(w)} groups)")


def s3_model(data: StreamData, waves):
    """The watermark model of S3 in numpy, trigger by trigger: rows older
    than the watermark at the trigger's start drop; the watermark moves
    to the batch's newest l_ts less the delay; a window is emitted once,
    when its end falls at or below the watermark. Returns the emitted
    windows ({start_us: [sum_qty, count]}) and the dropped rows."""
    import numpy as np
    from spark_tpu_torch.expr_fns import parse_duration_us
    delay = parse_duration_us(STREAM_DELAY)
    dur = parse_duration_us(STREAM_WINDOW)
    wm = -(1 << 62)
    state, emitted, dropped = {}, {}, 0
    lo = 0
    for n_files in waves:
        hi = int(data.bounds[n_files])
        ts = data.cols["ts"][lo:hi]
        qty = data.cols["qty"][lo:hi]
        lo = hi
        keep = ts >= wm
        dropped += int((~keep).sum())
        w = (ts[keep] // dur) * dur
        keys, inv = np.unique(w, return_inverse=True)
        sums = np.zeros(len(keys), np.int64)
        np.add.at(sums, inv, qty[keep])
        counts = np.bincount(inv, minlength=len(keys))
        for k, s, c in zip(keys.tolist(), sums.tolist(), counts.tolist()):
            acc = state.setdefault(k, [0, 0])
            acc[0] += s
            acc[1] += c
        wm = max(wm, int(ts.max()) - delay)
        for k in [k for k in state if k + dur <= wm]:
            emitted[k] = state.pop(k)
    return emitted, dropped


def s3_rows(sink_pdf):
    """A sink's S3 rows as {window start us: [sum_qty, count]}."""
    import numpy as np
    starts = sink_pdf["w"].to_numpy().astype("datetime64[us]") \
        .astype(np.int64)
    return {int(k): [int(s), int(c)] for k, s, c in zip(
        starts, unscaled(sink_pdf["sum_qty"], 2), sink_pdf["n"])}


def run_waves(D, q, watched, waves, label, records, prof_at=None,
              per_trigger=None):
    """Move each wave into the watched directory and run one
    `process_available()`: one trigger a wave. Returns per-trigger dicts
    (phase times, launches, allocated bytes, wall)."""
    import torch
    q.sync_phases = True
    out = []
    for i, n in enumerate(waves):
        watched.wave(n)
        before = dict(D.LAUNCHES)
        n_records = len(records)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if prof_at == i:
            # the card's activity alone: tracing every host op of a
            # trigger's Python would stretch its wall several times over
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                q.process_available()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"[stream] {label} trigger {i + 1} profiled: "
                f"{busy_text(*device_busy(prof), wall)}")
        else:
            q.process_available()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        new = records[n_records:]
        if len(new) != 1:
            raise AssertionError(f"{label} wave {i + 1}: {len(new)} "
                                 f"batches committed, expected one")
        t = dict(q.last_times or {})
        t.update(wall_ms=wall * 1e3, record=new[0],
                 allocated=torch.cuda.memory_allocated(),
                 launches={k: D.LAUNCHES[k] - before[k] for k in before})
        out.append(t)
        if per_trigger is not None:
            per_trigger(i, q)
    return out


def trigger_line(label, i, t) -> str:
    r = t["record"]
    return (f"[stream] {label} trigger {i + 1}: rows {r['rows_in']:,}, "
            f"slice decode {t.get('decode', 0):.1f} ms, ingest "
            f"{t.get('ingest', 0):.1f} ms, update {t.get('update', 0):.1f}"
            f" ms, state save: copy {t.get('state_copy', 0):.1f} ms, diff "
            f"{t.get('state_diff', 0):.1f} ms, write "
            f"{t.get('state_write', 0):.1f} ms ({r['kind']}, "
            f"{r['state_bytes']:,} bytes, changed groups "
            f"{r['changed_groups']}), finalize {t.get('finalize', 0):.1f} "
            f"ms, emit {t.get('emit', 0):.2f} ms; wall {t['wall_ms']:.1f} "
            f"ms; launches {t['launches']}; memory_allocated "
            f"{t['allocated']:,} bytes")


class BatchRecords:
    """A listener keeping every committed batch's `streaming` record."""

    def __init__(self):
        from spark_tpu_torch.observability import QueryListener

        class _L(QueryListener):
            def on_streaming_batch(inner, event):
                self.records.append(event.record)

        self.records = []
        self.listener = _L()


def stream_s1(D, S, data, tmp, launches, current) -> None:
    """S1: the per-order running total at dense_sums_global's full
    domain, checked after triggers 3 and 6."""
    import os
    rec = BatchRecords()
    session = stream_session(S)
    session.add_listener(rec.listener)
    root = os.path.join(tmp, "s1")
    watched = Watched(data, root)
    src = session.file_stream(watched.dir, schema_df=data.schema)
    q = s1_query(S.functions, src, os.path.join(root, "ck"))
    waves = [STREAM_WAVE * (i + 1) for i in range(STREAM_FILES // STREAM_WAVE)]
    state_bytes = []

    def after(i, q):
        if i == 0:
            state_bytes.append(sum(
                t.numel() * t.element_size()
                for t in [q._tables[0]] + [a for row in q._tables[1]
                                           for a in row]))
        if i + 1 in (3, 6):
            check_s1(f"S1 after trigger {i + 1}", q.latest(),
                     data.upto(waves[i]))

    zero_launches(D)
    current[0] = "stream s1"
    try:
        per = run_waves(D, q, watched, [STREAM_WAVE] * len(waves), "S1",
                        rec.records, prof_at=4, per_trigger=after)
    finally:
        current[0] = None
    launches["stream s1"] = dict(D.LAUNCHES)
    for i, t in enumerate(per):
        log(trigger_line("S1", i, t))
        if t["launches"]["dense_sums_global"] < 1:
            raise AssertionError(f"S1 trigger {i + 1} did not launch "
                                 f"dense_sums_global: {t['launches']}")
    growth = per[-1]["allocated"] - per[0]["allocated"]
    if abs(growth) > state_bytes[0]:
        raise AssertionError(
            f"S1: device memory moved {growth:,} bytes from trigger 1 to "
            f"trigger 6, more than the state's {state_bytes[0]:,}")
    log(f"[stream] S1: equals pandas after triggers 3 and 6; state "
        f"{state_bytes[0]:,} bytes on the card ({STREAM_S1_MOD + 1} slots); "
        f"memory_allocated moved {growth:+,} bytes from trigger 1 to 6; "
        f"launches {launches['stream s1']}")


def stream_s2(D, S, data, tmp, launches, current):
    """S2: the supplier dashboard (201 slots, dense_sums_smem's shared
    variant) with a HAVING above it, exact against pandas."""
    import os
    rec = BatchRecords()
    session = stream_session(S)
    session.add_listener(rec.listener)
    root = os.path.join(tmp, "s2")
    watched = Watched(data, root)
    src = session.file_stream(watched.dir, schema_df=data.schema)
    q = s2_query(S.functions, src, os.path.join(root, "ck"))
    n_waves = STREAM_FILES // STREAM_WAVE

    def after(i, q):
        check_s2(f"S2 after trigger {i + 1}", q.latest(),
                 data.upto(STREAM_WAVE * (i + 1)))

    zero_launches(D)
    current[0] = "stream s2"
    try:
        per = run_waves(D, q, watched, [STREAM_WAVE] * n_waves, "S2",
                        rec.records, per_trigger=after)
    finally:
        current[0] = None
    launches["stream s2"] = dict(D.LAUNCHES)
    for i, t in enumerate(per):
        log(trigger_line("S2", i, t))
        if t["launches"]["dense_sums_smem"] < 1:
            raise AssertionError(f"S2 trigger {i + 1} did not launch "
                                 f"dense_sums_smem: {t['launches']}")
    log(f"[stream] S2: equals pandas after every trigger; launches "
        f"{launches['stream s2']}")
    return q.latest()


def stream_s3_run(S, data, root, device=None, spill=None):
    """One S3 run over the 24 files (6 triggers); returns the sink's rows,
    the query and the seconds it took."""
    import os
    from spark_tpu_torch.streaming import SPILL_BYTES_KEY, read_sink
    session = stream_session(S, device)
    if spill is not None:
        session.conf.set(SPILL_BYTES_KEY, spill)
    watched = Watched(data, root)
    src = session.file_stream(watched.dir, schema_df=data.schema)
    sink = os.path.join(root, "sink")
    q = s3_query(S.functions, src, os.path.join(root, "ck"), sink)
    t0 = time.perf_counter()
    for _ in range(STREAM_FILES // STREAM_WAVE):
        watched.wave(STREAM_WAVE)
        q.process_available()
    seconds = time.perf_counter() - t0
    got = read_sink(sink)
    return got.sort_values("w").reset_index(drop=True), q, seconds, session


def stream_s3(S, data, tmp) -> None:
    """S3: weekly windows of l_ts under a 30-day watermark, append mode
    into a FileStreamSink: against the watermark model, against a CPU
    session of the port, and spilled against resident."""
    import os
    import pandas as pd
    waves = [STREAM_WAVE * (i + 1) for i in range(STREAM_FILES // STREAM_WAVE)]
    want, dropped = s3_model(data, waves)
    got, q, sec, _ = stream_s3_run(S, data, os.path.join(tmp, "s3"))
    if s3_rows(got) != want:
        raise AssertionError(f"S3: the sink's {len(got)} windows differ "
                             f"from the watermark model's {len(want)}")
    cpu, _, cpu_sec, _ = stream_s3_run(S, data, os.path.join(tmp, "s3cpu"),
                                       device="cpu")
    pd.testing.assert_frame_equal(got, cpu)
    spilled, qs, sp_sec, ss = stream_s3_run(
        S, data, os.path.join(tmp, "s3spill"), spill=STREAM_SPILL_BYTES)
    if qs._spill is None:
        raise AssertionError("S3 spilled run never engaged the spill tier")
    pd.testing.assert_frame_equal(spilled, got)
    log(f"[stream] S3: {len(got)} windows emitted, equal to the watermark "
        f"model ({dropped:,} late rows dropped) and to a CPU session's "
        f"sink; card run {sec:.2f} s, CPU run {cpu_sec:.2f} s; spilled "
        f"run (spillBytes {STREAM_SPILL_BYTES}) {sp_sec:.2f} s, "
        f"{ss.metrics.counter('streaming_spill_bytes').value:,} bytes "
        f"spilled, the same rows; the card run's triggers: "
        f"{q.last_times}")


def stream_s4(S, data, tmp) -> None:
    """S4: S1 over 3 files in 3 triggers, fatal at trigger 2 at each
    stream_* seam, finished by a fresh query on the checkpoint."""
    import os
    from spark_tpu_torch.streaming import FileStreamSink
    from spark_tpu_torch.testing import faults
    files = data.files[:STREAM_S4_FILES]
    want = data.upto(STREAM_S4_FILES)
    for seam in STREAM_SEAMS:
        rec = BatchRecords()
        session = stream_session(S)
        session.add_listener(rec.listener)
        root = os.path.join(tmp, f"s4-{seam}")
        watched = Watched(data, root, files)
        ck, sink = os.path.join(root, "ck"), os.path.join(root, "sink")

        def build():
            src = session.file_stream(watched.dir, schema_df=data.schema)
            return s1_query(S.functions, src, ck, sink)

        t0 = time.perf_counter()
        q = build()
        watched.wave(STREAM_S4_WAVE)
        q.process_available()
        watched.wave(STREAM_S4_WAVE)
        try:
            with faults.inject(session.conf, f"{seam}:fatal:1"):
                q.process_available()
            raise AssertionError(f"S4 {seam}: the fault never fired")
        except faults.FaultInjected:
            pass
        del q
        restore0 = session.metrics.counter("streaming_restore_ms").value
        q2 = build()
        restore = session.metrics.counter("streaming_restore_ms").value \
            - restore0
        watched.wave(STREAM_S4_WAVE)
        q2.process_available()
        check_s1(f"S4 {seam}", q2.latest(), want)
        ids = [r["batch_id"] for r in rec.records]
        if ids != list(range(len(ids))):
            raise AssertionError(f"S4 {seam}: committed batch ids {ids}")
        manifest = sorted(FileStreamSink(session, sink, "complete")
                          ._manifest._ids())
        if len(set(manifest)) != len(manifest):
            raise AssertionError(f"S4 {seam}: sink manifest {manifest}")
        if restore <= 0:
            raise AssertionError(f"S4 {seam}: no streaming_restore_ms")
        log(f"[stream] S4 {seam}: fatal at trigger 2, a fresh query "
            f"restored in {restore:.1f} ms (streaming_restore_ms) and "
            f"finished; equals the golden; committed batch ids {ids}; "
            f"{time.perf_counter() - t0:.2f} s")


def stream_s5(S, data, tmp, s2_result) -> None:
    """S5: S2's query unattended (start(trigger_ms)) over a socket fed by
    a FrameProducer, one injected stream_net_recv drop and one killed
    connection mid-stream; the status store shows the live stream."""
    import os
    import pandas as pd
    from spark_tpu_torch import streaming
    from spark_tpu_torch.io.network_source import FrameProducer
    from spark_tpu_torch.observability.status_store import StatusStore
    from spark_tpu_torch.testing import faults
    session = stream_session(S)
    prod = FrameProducer()
    port = prod.start()
    t0 = time.perf_counter()
    try:
        src = session.network_stream("127.0.0.1", port, data.schema)
        root = os.path.join(tmp, "s5")
        q = s2_query(S.functions, src, os.path.join(root, "ck"))
        q.start(trigger_ms=STREAM_S5_TRIGGER_MS)
        live = []
        sent = 0
        rc0 = session.metrics.counter("streaming_reconnects").value

        def wait_for(n):
            deadline = time.monotonic() + 60
            while q._committed_end < n and time.monotonic() < deadline:
                if q.status != "RUNNING":
                    raise AssertionError(f"S5: {q.status} "
                                         f"{q.exception()}")
                live.append(StatusStore._streaming_lag()
                            .get("streams_live", 0.0))
                time.sleep(0.02)
            if q._committed_end < n:
                raise AssertionError(f"S5: committed {q._committed_end} "
                                     f"of {n} frames")

        def send_wave():
            nonlocal sent
            for t in data.tables[sent:sent + STREAM_WAVE]:
                prod.send(t)
            sent += STREAM_WAVE
            wait_for(sent)

        for wave in range(STREAM_FILES // STREAM_WAVE):
            if wave == 2:
                # one transient drop of the socket reader mid-stream
                with faults.inject(session.conf,
                                   "stream_net_recv:unavailable:1"):
                    send_wave()
            else:
                send_wave()
            if wave == 3:
                prod.kill_connection()
        prod.end()
        wait_for(sent + 1)  # the end-of-stream marker
        restarts = q.state()["restarts"]
        q.stop()
    finally:
        prod.close()
    if q.status != "STOPPED":
        raise AssertionError(f"S5: {q.status} {q.exception()}")
    got = q.latest().sort_values("g").reset_index(drop=True)
    check_s2("S5", got, data.upto(STREAM_FILES))
    pd.testing.assert_frame_equal(
        got, s2_result.sort_values("g").reset_index(drop=True))
    reconnects = session.metrics.counter("streaming_reconnects").value - rc0
    seen = [e for e in src._seen if not e.get("end")]
    if len(seen) != STREAM_FILES or src.quarantined():
        raise AssertionError(f"S5: {len(seen)} frames seen, "
                             f"{len(src.quarantined())} quarantined")
    if restarts < 1 or reconnects < 1 or max(live) < 1:
        raise AssertionError(f"S5: restarts {restarts}, reconnects "
                             f"{reconnects}, streams_live {max(live)}")
    if streaming.live_queries():
        raise AssertionError("S5: a stream is still live after stop()")
    log(f"[stream] S5: {STREAM_FILES} frames over localhost, "
        f"{q.state()['ticks']} ticks at {STREAM_S5_TRIGGER_MS} ms, "
        f"{q._committed_batch + 1} batches; the injected stream_net_recv "
        f"drop restarted the tick ({restarts} restart), the killed "
        f"connection reconnected ({reconnects}); equals S2's golden and "
        f"its file-stream result, no frame lost or repeated; the status "
        f"store showed streams_live {max(live):.0f} while it ran; "
        f"{time.perf_counter() - t0:.1f} s")


def phase_stream(D, S, path, tmp, launches, current) -> None:
    """Phase 17: structured streaming over TPC-H SF1 lineitem (S1-S5)."""
    import os
    t0 = time.perf_counter()
    data = StreamData(path, os.path.join(tmp, "stream-feed"))
    stream_s1(D, S, data, tmp, launches, current)
    s2 = stream_s2(D, S, data, tmp, launches, current)
    stream_s3(S, data, tmp)
    stream_s4(S, data, tmp)
    stream_s5(S, data, tmp, s2)
    log(f"[stream] phase cases in {time.perf_counter() - t0:.1f} s")


def findings_key(findings):
    """Findings as comparable tuples: code, severity, op, message,
    detail."""
    return [(f.code, f.severity, f.op, f.message, f.detail)
            for f in findings or []]


def trace_key(records):
    """A rule trace without its timings."""
    return [(r["batch"], r["rule"], r["invocations"], r["effective"],
             r.get("diff")) for r in records or []]


def same_trace(a, b) -> bool:
    """Two rule traces alike: the same records, and the same diff text
    but for numbers within FLOAT_RTOL of each other. A scalar
    subquery's result enters the plan as a literal before optimization,
    and the card adds a float sum in another order than the CPU (SQL
    Q11's HAVING bound)."""
    import math
    import re
    number = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")
    ka, kb = trace_key(a), trace_key(b)
    if [k[:4] for k in ka] != [k[:4] for k in kb]:
        return False
    for (*_, da), (*_, db) in zip(ka, kb):
        if da == db:
            continue
        if da is None or db is None \
                or number.split(da) != number.split(db):
            return False
        for x, y in zip(number.findall(da), number.findall(db)):
            if not math.isclose(float(x), float(y), rel_tol=FLOAT_RTOL):
                return False
    return True


class no_gc:
    """Keep the cyclic garbage collector off inside: a tensor some earlier
    object cycle held must not be freed in the middle of a span whose
    device bytes are being compared. (No collection first: with the
    heap of the earlier phases a `gc.collect()` takes a large share of
    a second, and phase 18 compares 134 spans.)"""

    def __enter__(self):
        import gc
        gc.disable()
        return self

    def __exit__(self, *exc):
        import gc
        gc.enable()
        return False


def device_state(D):
    """What device work would change: the kernels' launch counts (by
    card too), the card's allocated bytes and the device table cache's
    bytes."""
    import torch
    from spark_tpu_torch.io.device_cache import CACHE
    return (dict(D.LAUNCHES), torch.cuda.memory_allocated(),
            CACHE.stats()["bytes"], dict(D.DEVICE_LAUNCHES))


def analysis_session(S, path, device=None):
    """A session (the card unless `device`) with ANALYSIS_CONF over the
    TPC-H tables at `path`."""
    from spark_tpu_torch.tpch.queries import register_tables
    builder = S.SparkTpuSession.builder()
    if device is not None:
        builder = builder.device(device)
    session = builder.get_or_create()
    register_tables(session, path)
    for key, value in ANALYSIS_CONF:
        session.conf.set(key, value)
    return session


def analysis_sql(D, S, G, path, sql_results, launches) -> None:
    """Phase 18(a): the 22 TPC-H SQL queries on the card under the
    analyzer, full validation and the change log. Each result equals
    phase 6's first run (its golden's when phase 6 did not run); each
    query's findings, predictions and rule trace equal those of a CPU
    session of the port over the same files (planned there, not run: a
    first run analyzes the plan before anything of the run touches it);
    each query's launches equal phase 6's first run's. Then, warm,
    ANALYSIS_RUNS plannings a validation mode: the `analyze` span, which
    must leave the launch counts, the allocated bytes and the device
    cache as they were, and the optimizer's time."""
    import statistics
    import torch
    from spark_tpu_torch.analysis import analyze_plan
    from spark_tpu_torch.analysis.predictions import predict_plan
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    cuda = analysis_session(S, path)
    cpu = analysis_session(S, path, "cpu")
    t_all = time.perf_counter()
    totals = {"full": [0.0, 0.0], "off": [0.0, 0.0]}
    for q, kernel in SQL_KERNELS.items():
        text = SQL_QUERIES[q]
        zero_launches(D)
        t0 = time.perf_counter()
        qe = cuda.sql(text)._qe()
        got = qe.collect()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs = dict(D.LAUNCHES)
        held_to = "phase 6's first run" if q in sql_results else "the golden"
        if q in sql_results:
            tables_match(f"analysis {q} against phase 6's first run", got,
                         sql_results[q])
        else:
            gold = G.GOLDEN[q](path)
            G.compare(G.normalize_decimals(got.to_pandas())[
                gold.columns.tolist()].reset_index(drop=True), gold)
        require_kernels(f"analysis {q}", kernel, runs)
        want = launches.get(f"sql {q}")
        if want is not None and runs != want:
            raise AssertionError(f"analysis {q}: launches {runs}, phase "
                                 f"6's first run {want}")
        t_cpu = time.perf_counter()
        cqe = cpu.sql(text)._qe()
        root = cqe.executed_plan
        if findings_key(qe.analysis_findings) != findings_key(
                analyze_plan(root, cpu.conf, 1)):
            raise AssertionError(f"analysis {q}: findings "
                                 f"{qe.analysis_findings} differ from a "
                                 f"CPU session's")
        if qe.plan_predictions != predict_plan(root, cpu.conf, 1):
            raise AssertionError(f"analysis {q}: predictions differ from "
                                 f"a CPU session's")
        if not same_trace(qe.rule_trace, cqe.rule_trace):
            pairs = [(a, b) for a, b in zip(trace_key(qe.rule_trace),
                                            trace_key(cqe.rule_trace))
                     if a != b]
            raise AssertionError(
                f"analysis {q}: rule trace differs from a CPU session's "
                f"({len(qe.rule_trace)} and {len(cqe.rule_trace)} records); "
                f"first difference: {pairs[:1]}")
        cpu_s = time.perf_counter() - t_cpu
        t_warm = time.perf_counter()
        times = {}
        for mode in ("full", "off"):
            cuda.conf.set(VALIDATION_KEY, mode)
            opt, ana = [], []
            for _ in range(ANALYSIS_RUNS):
                pqe = cuda.sql(text)._qe()
                pqe.executed_plan  # scalar subqueries run in here
                torch.cuda.synchronize()
                with no_gc():
                    before = device_state(D)
                    pqe._analyze_plan_phase()
                    torch.cuda.synchronize()
                    after = device_state(D)
                if after != before:
                    raise AssertionError(
                        f"analysis {q}: the analyze span did device work: "
                        f"{before} -> {after}")
                opt.append(pqe.phase_times["optimization"] * 1e3)
                ana.append([sp.dur_ms for sp in pqe.spans.spans
                            if sp.name == "analyze"][0])
            times[mode] = (statistics.median(opt), statistics.median(ana))
            totals[mode][0] += times[mode][0]
            totals[mode][1] += times[mode][1]
        cuda.conf.set(VALIDATION_KEY, "full")
        warm_s = time.perf_counter() - t_warm
        log(f"[analysis] {q}: {seconds:.3f} s (CPU planning {cpu_s:.3f} s, "
            f"warm plannings {warm_s:.3f} s), equals {held_to}; findings "
            f"{[f.code for f in qe.analysis_findings]}, "
            f"{len(qe.plan_predictions or [])} predictions and the rule "
            f"trace equal a CPU session's; launches {runs}; warm, median "
            f"of {ANALYSIS_RUNS}: analyze {times['full'][1]:.3f} ms; "
            f"optimize {times['full'][0]:.2f} ms under full against "
            f"{times['off'][0]:.2f} off")
    log(f"[analysis] 22 queries in {time.perf_counter() - t_all:.1f} s; "
        f"analyze {totals['full'][1]:.2f} ms in all; optimize "
        f"{totals['full'][0]:.1f} ms in all under full against "
        f"{totals['off'][0]:.1f} off (medians summed)")


def decimal_table_file(tmp) -> str:
    """(b)-(c)'s table as Parquet: DECIMAL_ROWS rows, `k` = i mod
    DECIMAL_GROUPS (int32) and `d` = 9e17 + (i mod 1000) as
    decimal(18,0): values near the type's top, so that the footer's
    min/max bound the value bits at 60 and any sum past 16 rows can
    wrap the int64 accumulator."""
    import os
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    i = np.arange(DECIMAL_ROWS, dtype=np.int64)
    d = pa.array(9 * 10**17 + (i % 1000)).cast(pa.decimal128(19, 0)) \
        .cast(pa.decimal128(18, 0), safe=False)
    file = os.path.join(tmp, "analysis_decimal.parquet")
    pq.write_table(pa.table({"k": (i % DECIMAL_GROUPS).astype(np.int32),
                             "d": d}), file)
    return file


def analysis_strict(D, S, tmp) -> None:
    """Phase 18(b) and (c). (b): under `analysis.strict`, the JAX
    package's shape (an int32 column summed over 2^33 range rows, here by
    a 64-slot key) and the decimal table's sum by `pmod(k, 64)` each raise
    AnalysisFindingError before any device work: the launch counts, the
    allocated bytes and the device cache's bytes as they were, no ingest
    or dispatch span; strict off, the decimal group sum runs through
    dense_sums_smem and equals a CPU session's (both wrap the int64
    accumulator alike). (c): the decimal table's global sum (the JAX
    package's `test_overflow_finding_decimal_executes` at lineitem's
    width) runs through dense_sums_smem, equals the CPU session and
    posts exactly one AnalysisEvent."""
    import torch
    from spark_tpu_torch.analysis import AnalysisFindingError
    from spark_tpu_torch.io.sources import ParquetSource
    from spark_tpu_torch.observability import QueryListener
    F, T = S.functions, S.types
    col = F.col
    t0 = time.perf_counter()
    file = decimal_table_file(tmp)
    log(f"[analysis] decimal table: {DECIMAL_ROWS:,} rows written in "
        f"{time.perf_counter() - t0:.1f} s")
    cuda = S.SparkTpuSession.builder().get_or_create()
    cpu = S.SparkTpuSession.builder().device("cpu").get_or_create()
    for s in (cuda, cpu):
        s.register_table("ana_dec", ParquetSource(file, "ana_dec"))

    def grouped(s):
        # a pmod key gives the aggregate its static domain: the dense
        # path, hence dense_sums_smem (65 slots with the NULL slot)
        return s.table("ana_dec") \
            .group_by(F.pmod(col("k"), DECIMAL_GROUPS).alias("g")) \
            .agg(F.sum(col("d")).alias("s")).sort(col("g"))

    def range_int32(s):
        return (s.range(1 << 33)
                .select(F.pmod(col("id"), DECIMAL_GROUPS).alias("k"),
                        col("id").cast(T.INT).alias("v"))
                .group_by(col("k")).agg(F.sum(col("v")).alias("s")))

    cuda.conf.set(STRICT_KEY, True)
    for label, make in (("2^33-row int32 range", range_int32),
                        ("decimal group sum", grouped)):
        zero_launches(D)
        torch.cuda.synchronize()
        with no_gc():
            before = device_state(D)
            qe = make(cuda)._qe()
            try:
                qe.collect()
            except AnalysisFindingError as e:
                codes = [f.code for f in e.findings]
            else:
                raise AssertionError(f"strict {label}: did not raise")
            torch.cuda.synchronize()
            after = device_state(D)
        if after != before or "SUM_I64_OVERFLOW" not in codes:
            raise AssertionError(f"strict {label}: {codes}, device "
                                 f"{before} -> {after}")
        spans = {sp.name for sp in qe.spans.spans}
        if {"ingest", "dispatch", "streaming"} & spans:
            raise AssertionError(f"strict {label}: spans {spans}")
        log(f"[analysis] strict: {label} raised {codes} with launches "
            f"{before[0]}, allocated {before[1]:,} B and cache "
            f"{before[2]:,} B unchanged, spans {sorted(spans)}")
    cuda.conf.set(STRICT_KEY, False)
    zero_launches(D)
    qe = grouped(cuda)._qe()
    got = qe.collect()
    torch.cuda.synchronize()
    require_kernels("strict off: decimal group sum", "dense_sums_smem",
                    D.LAUNCHES)
    tables_match("strict off: decimal group sum against a CPU session",
                 got, grouped(cpu).collect())
    log(f"[analysis] strict off: decimal group sum ran, {got.num_rows} "
        f"groups equal a CPU session's; findings "
        f"{[f.code for f in qe.analysis_findings]}; launches "
        f"{dict(D.LAUNCHES)}")

    class Collect(QueryListener):
        def __init__(self):
            self.events = []

        def on_analysis(self, event):
            self.events.append(event)

    listener = Collect()
    cuda.add_listener(listener)
    zero_launches(D)
    qe = cuda.table("ana_dec").agg(F.sum(col("d")).alias("s"))._qe()
    got = qe.collect()
    torch.cuda.synchronize()
    cuda.remove_listener(listener)
    require_kernels("decimal global sum", "dense_sums_smem", D.LAUNCHES)
    tables_match("decimal global sum against a CPU session", got,
                 cpu.table("ana_dec").agg(F.sum(col("d")).alias("s"))
                 .collect())
    if len(listener.events) != 1 or "SUM_I64_OVERFLOW" not in [
            f["code"] for f in listener.events[0].findings]:
        raise AssertionError(f"decimal global sum: on_analysis "
                             f"{[e.findings for e in listener.events]}")
    codes = [f["code"] for f in listener.events[0].findings]
    log(f"[analysis] decimal global sum: {got.column(0)[0]} equals a CPU "
        f"session's; one AnalysisEvent ({codes}); launches "
        f"{dict(D.LAUNCHES)}")


def analysis_stress(D, S, path, tmp) -> None:
    """Phase 18(d): one session on the card with every observability
    output on, LOCKWATCH_THREADS threads each running LOCKWATCH_QUERIES
    queries cycling through Q1/Q5/Q6 (SQL) and the range, while a
    stateful streaming query (pmod key, 201 slots on dense_sums_smem)
    triggers on its supervised thread, all under lockwatch: every result
    equals its single-thread result, the stream equals pandas, the
    observed acquisition order is consistent with the registry's ranks,
    no prefetch or trigger thread outlives its query. Prints each lock's
    acquisitions, contention and longest hold."""
    import os
    import threading
    import numpy as np
    import pandas as pd
    import torch
    from spark_tpu_torch import streaming
    from spark_tpu_torch.testing import faults
    from spark_tpu_torch.testing.lockwatch import LockWatch
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    F = S.functions
    col = F.col
    session = analysis_session(S, path)
    for key, value in (
            ("spark_tpu.sql.eventLog.dir", os.path.join(tmp, "ana-events")),
            ("spark_tpu.sql.trace.dir", os.path.join(tmp, "ana-traces")),
            ("spark_tpu.sql.metrics.sink", "prometheus,jsonl"),
            ("spark_tpu.sql.metrics.dir", os.path.join(tmp, "ana-metrics")),
            ("spark_tpu.sql.observability.xlaCost", "on")):
        session.conf.set(key, value)

    def program(name):
        if name == "range":
            return (session.range(RANGE_ROWS)
                    .group_by((col("id") % RANGE_MOD).alias("k"))
                    .agg(F.count().alias("n"), F.sum(col("id")).alias("s"))
                    .sort(col("k")))
        return session.sql(SQL_QUERIES[name])

    alone = {n: program(n).collect() for n in LOCKWATCH_PROGRAMS}
    rng = np.random.default_rng(18)
    frames = [pd.DataFrame({"k": rng.integers(0, 1 << 30,
                                              LOCKWATCH_FRAME_ROWS),
                            "v": rng.integers(0, 1000,
                                              LOCKWATCH_FRAME_ROWS)})
              for _ in range(LOCKWATCH_FRAMES)]
    src = streaming.MemoryStream(session, frames[0].head(0))
    query = (src.to_df()
             .group_by(F.pmod(col("k"), LOCKWATCH_STREAM_MOD).alias("g"))
             .agg(F.sum(col("v")).alias("sv"), F.count().alias("n"))
             .write_stream(os.path.join(tmp, "ana-stream")))
    watch = LockWatch()
    watch.install_session(session)
    watch.install_query(query)
    faults.arm(session.conf)
    watch.install_faults()
    results, errors = [], []
    t0 = time.perf_counter()
    try:
        query.start(trigger_ms=LOCKWATCH_TRIGGER_MS)

        def run(offset):
            try:
                for i in range(LOCKWATCH_QUERIES):
                    name = LOCKWATCH_PROGRAMS[(offset + i)
                                              % len(LOCKWATCH_PROGRAMS)]
                    results.append((name, program(name).collect()))
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=run, args=(i,),
                                    name=f"analysis-stress-{i}")
                   for i in range(LOCKWATCH_THREADS)]
        for t in threads:
            t.start()
        for frame in frames:
            src.add_data(frame)
            time.sleep(LOCKWATCH_TRIGGER_MS / 1e3)
        for t in threads:
            t.join(300)
        if any(t.is_alive() for t in threads):
            raise AssertionError("lockwatch stress: a query thread wedged")
        total = LOCKWATCH_FRAMES * LOCKWATCH_FRAME_ROWS
        deadline = time.monotonic() + 60
        while query.latest() is None or int(query.latest()["n"].sum()) \
                < total:
            if time.monotonic() > deadline or query.exception() is not None:
                raise AssertionError(f"lockwatch stress: the stream fell "
                                     f"behind: {query.exception()}")
            time.sleep(0.05)
        query.stop()
        seconds = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"lockwatch stress: {errors[:3]}")
        if len(results) != LOCKWATCH_THREADS * LOCKWATCH_QUERIES:
            raise AssertionError(f"lockwatch stress: {len(results)} results")
        for name, table in results:
            tables_match(f"lockwatch stress {name} against its single-"
                         f"thread result", table, alone[name])
        whole = pd.concat(frames)
        want = whole.groupby(whole["k"] % LOCKWATCH_STREAM_MOD).agg(
            sv=("v", "sum"), n=("v", "size"))
        got = query.latest().set_index("g").sort_index()
        if not (np.array_equal(got["sv"].to_numpy(), want["sv"].to_numpy())
                and np.array_equal(got["n"].to_numpy(),
                                   want["n"].to_numpy())):
            raise AssertionError("lockwatch stress: the stream differs "
                                 "from pandas")
        watch.assert_order_consistent()
        watch.assert_no_thread_leak()
        watch.assert_no_thread_leak(prefix="spark-tpu-stream-trigger")
        report = watch.report()
        acquires = sum(st["acquires"] for st in report["locks"].values())
        extra_us = watched_acquire_cost_us()
        log(f"[analysis] lockwatch overhead: {extra_us:.2f} us a watched "
            f"acquire over a plain one, x {acquires} acquisitions = "
            f"{extra_us * acquires / 1e3:.1f} ms of the stress's "
            f"{seconds * 1e3:.0f} ms")
        log(f"[analysis] lockwatch: {len(results)} queries on "
            f"{LOCKWATCH_THREADS} threads and {len(query.results())} "
            f"stream batches in {seconds:.1f} s equal their single-thread "
            f"results and pandas; edges {report['edges'] or 'none'}; order "
            f"consistent, no thread leak")
        for lock_id, st in report["locks"].items():
            log(f"[analysis] lock {lock_id}: {st['acquires']} acquisitions, "
                f"{st['contended']} contended, wait "
                f"{st['wait_s'] * 1e3:.2f} ms, longest hold "
                f"{st['max_hold_s'] * 1e3:.3f} ms")
    finally:
        query.stop()
        watch.uninstall()
        faults.reset()
        torch.cuda.synchronize()


def watched_acquire_cost_us(n: int = 100_000) -> float:
    """What lockwatch adds to one acquire-release pair: the median of 5
    timings of `n` pairs on a watched lock less a plain lock's, per
    pair, in microseconds (host clock)."""
    import statistics
    import threading
    from spark_tpu_torch.testing.lockwatch import LockWatch

    class Box:
        def __init__(self):
            self.lock = threading.Lock()

    plain, watched = Box(), Box()
    watch = LockWatch()
    watch.watch_attr(watched, "lock", "metrics.counter")
    out = {}
    try:
        for name, box in (("plain", plain), ("watched", watched)):
            samples = []
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(n):
                    with box.lock:
                        pass
                samples.append(time.perf_counter() - t0)
            out[name] = statistics.median(samples)
    finally:
        watch.uninstall()
    return (out["watched"] - out["plain"]) / n * 1e6


def phase_analysis(D, S, G, path, tmp, sql_results, launches) -> None:
    """Phase 18: static analysis on the card, (a)-(d)."""
    t0 = time.perf_counter()
    analysis_sql(D, S, G, path, sql_results, launches)
    log(f"[analysis] (a) in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    analysis_strict(D, S, tmp)
    log(f"[analysis] (b)-(c) in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    analysis_stress(D, S, path, tmp)
    log(f"[analysis] (d) in {time.perf_counter() - t1:.1f} s")


# ---------------------------------------------------------------------------
# Phase 19: the SQL service
# ---------------------------------------------------------------------------


def serve_range_source():
    """The range view: RANGE_ROWS ids in one Arrow source, registered in
    every pooled session (one source object, so one device cache entry)."""
    import numpy as np
    import pyarrow as pa
    from spark_tpu_torch.io.sources import ArrowTableSource
    return ArrowTableSource(SERVE_RANGE_TABLE, pa.table(
        {"id": np.arange(RANGE_ROWS, dtype=np.int64)}))


def serve_init(path, range_source):
    """The pooled sessions' init hook: the TPC-H tables and the range
    view."""
    from spark_tpu_torch.tpch.queries import register_tables

    def init(session):
        register_tables(session, path)
        session.register_table(SERVE_RANGE_TABLE, range_source)
    return init


def serve_sql(q: str) -> str:
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    return SERVE_RANGE_SQL if q == "range" else SQL_QUERIES[q]


def check_serve_range(what, table) -> None:
    """The range view's group-by against numpy's closed form."""
    import numpy as np
    ids = np.arange(RANGE_ROWS, dtype=np.int64)
    keys = ids % SERVE_RANGE_MOD
    cnt = np.bincount(keys, minlength=SERVE_RANGE_MOD)
    total = np.zeros(SERVE_RANGE_MOD, dtype=np.int64)
    np.add.at(total, keys, ids)
    got = table.to_pandas().sort_values("k")
    if not (np.array_equal(got["k"].to_numpy(), np.arange(SERVE_RANGE_MOD))
            and np.array_equal(got["n"].to_numpy(), cnt)
            and np.array_equal(got["s"].to_numpy(), total)):
        raise AssertionError(f"{what}: the range group-by disagrees with "
                             f"numpy")


def rows_match(what, got, want) -> None:
    """JSON rows (lists of dicts) equal: floats within FLOAT_RTOL, the
    rest exactly."""
    import math
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, expected "
                             f"{len(want)}")
    for g, w in zip(got, want):
        if list(g) != list(w):
            raise AssertionError(f"{what}: columns {list(g)}")
        for k, v in w.items():
            ok = (math.isclose(g[k], v, rel_tol=FLOAT_RTOL, abs_tol=0.0)
                  if isinstance(v, float) and isinstance(g[k], float)
                  else g[k] == v)
            if not ok:
                raise AssertionError(f"{what}: {k} = {g[k]!r}, expected "
                                     f"{v!r}")


def http(port, method, path, body=None, timeout=600):
    """(status, headers, payload) of one request to the service: the
    JSON body decoded, else the raw bytes (an Arrow stream, metrics)."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status, headers = r.read(), r.status, r.headers
    except urllib.error.HTTPError as e:
        raw, status, headers = e.read(), e.code, e.headers
    if (headers.get("Content-Type") or "").startswith("application/json"):
        return status, headers, json.loads(raw)
    return status, headers, raw


def serve_service(confs, init, device):
    """A SqlService (not started) over `confs`, its sessions on
    `device`."""
    from spark_tpu_torch.config import Conf
    from spark_tpu_torch.service.server import SqlService
    conf = Conf()
    for key, value in confs:
        conf.set(key, value)
    return SqlService(conf, init_session=init, device=device)


def counter(svc, name: str) -> int:
    return int(svc.metrics.snapshot()["counters"].get(name, 0))


def pct(values, p: float) -> float:
    """The p-th percentile (nearest rank) of `values`."""
    import math
    s = sorted(values)
    return s[max(0, math.ceil(p / 100 * len(s)) - 1)]


def poll_terminal(svc, qid, timeout_s=120.0) -> dict:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rec = svc.query_snapshot(qid)
        if rec and rec.get("status") not in ("submitted", "running"):
            return rec
        time.sleep(0.01)
    raise AssertionError(f"{qid} never finished: {svc.query_snapshot(qid)}")


def require_drained(label, svc) -> None:
    """After a case: no lease held and no device-cache pin left."""
    from spark_tpu_torch.io.device_cache import CACHE
    leased = svc.arbiter.leased_bytes
    if leased or CACHE._pins:
        raise AssertionError(f"{label}: {leased} bytes still leased, pins "
                             f"{CACHE._pins}")


def serve_references(D, S, G, path, init, sql_results, launches, current,
                     device) -> dict:
    """Phase 19's single-thread baseline: each SERVE_QUERIES query a
    first and a warm `collect()` on a plain session over the same tables,
    each against phase 6's first run (the golden when phase 6 did not
    run; numpy for the range). The first runs' kernel inputs are kept
    under `serve <q>`. Returns {q: (result, warm seconds)}."""
    session = S.SparkTpuSession.builder().device(device).get_or_create()
    init(session)
    out = {}
    for q in SERVE_QUERIES:
        label = f"serve {q}"
        first, warm = first_and_warm(D, session,
                                     lambda q=q: session.sql(serve_sql(q)),
                                     current, label)
        launches[label] = first[3]
        kernel = "dense_sums_global" if q == "range" else SQL_KERNELS[q]
        require_kernels(label, kernel, first[3])
        require_kernels(f"{label}'s warm run", kernel, warm[3])
        tables_match(f"{label}'s warm run against its first", warm[0],
                     first[0])
        if q == "range":
            check_serve_range(label, first[0])
        elif q in sql_results:
            tables_match(f"{label} against phase 6's result", first[0],
                         sql_results[q])
        else:
            gold = G.GOLDEN[q](path)
            G.compare(G.normalize_decimals(first[0].to_pandas())[
                gold.columns.tolist()].reset_index(drop=True), gold)
        out[q] = (first[0], warm[2])
        log(f"[serve] {label} single-thread: {first[0].num_rows} rows, "
            f"{runs_text(first, warm)}; launches {first[3]}")
    return out


def serve_clients(svc, refs, rounds):
    """SERVE_SESSIONS client threads, one session each, each sending
    every SERVE_QUERIES query `rounds` times through `POST /sql` (the
    SERVE_ARROW ones in Arrow format, the rest in JSON); every result
    must equal its single-thread reference. Returns {q: [(latency s,
    admission wait s)]} and the wall seconds."""
    import threading
    import pyarrow as pa
    from spark_tpu_torch.service.server import _table_rows
    want_rows = {q: _table_rows(refs[q][0]) for q in SERVE_QUERIES
                 if q not in SERVE_ARROW}
    lat = {q: [] for q in SERVE_QUERIES}
    errors = []

    def client(name):
        try:
            for _ in range(rounds):
                for q in SERVE_QUERIES:
                    fmt = "arrow" if q in SERVE_ARROW else "json"
                    t0 = time.perf_counter()
                    status, headers, body = http(
                        svc.port, "POST", "/sql",
                        {"sql": serve_sql(q), "session": name,
                         "format": fmt})
                    wall = time.perf_counter() - t0
                    if status != 200:
                        raise AssertionError(f"{q}: HTTP {status} {body}")
                    if fmt == "arrow":
                        qid = headers["X-Query-Id"]
                        tables_match(f"served {q} ({name})",
                                     pa.ipc.open_stream(body).read_all(),
                                     refs[q][0])
                    else:
                        qid = body["query_id"]
                        if body["columns"] != refs[q][0].column_names:
                            raise AssertionError(f"{q}: columns "
                                                 f"{body['columns']}")
                        rows_match(f"served {q} ({name})", body["rows"],
                                   want_rows[q])
                    rec = svc.query_snapshot(qid)
                    lat[q].append((wall, rec["started_ts"]
                                   - rec["submitted_ts"]))
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(n,),
                                name=f"serve-client-{n}")
               for n in SERVE_SESSIONS]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve: a client thread wedged")
    if errors:
        raise AssertionError(f"serve clients: {errors[:3]}")
    return lat, wall


def serve_parity(D, svc, refs) -> dict:
    """Phase 19(a): the concurrent clients, SERVE_ROUNDS rounds with the
    launch counters at 0 (both kernels must launch through the service),
    then one more round under torch.profiler for the card's busy share.
    Returns each query's served p50 latency, ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    zero_launches(D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, wall = serve_clients(svc, refs, SERVE_ROUNDS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    served = dict(D.LAUNCHES)
    require_kernels("the served queries", ("dense_sums_smem",
                                           "dense_sums_global"), served)
    n = sum(len(v) for v in lat.values())
    log(f"[serve] (a) {len(SERVE_SESSIONS)} sessions x {SERVE_ROUNDS} "
        f"rounds x {len(SERVE_QUERIES)} queries = {n} served in "
        f"{wall:.3f} s ({n / wall:.2f} queries/s), every result equal to "
        f"its single-thread run; launches through the service {served}; "
        f"max_memory_allocated {peak:,} bytes")
    for q in SERVE_QUERIES:
        w = [x[0] * 1e3 for x in lat[q]]
        a = [x[1] * 1e3 for x in lat[q]]
        log(f"[serve] (a) {q} ({'arrow' if q in SERVE_ARROW else 'json'}): "
            f"latency p50 {pct(w, 50):.1f} ms p95 {pct(w, 95):.1f} ms; "
            f"admission wait p50 {pct(a, 50):.1f} ms p95 {pct(a, 95):.1f} "
            f"ms; warm single-thread collect() {refs[q][1] * 1e3:.1f} ms")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = serve_clients(svc, refs, 1)
        torch.cuda.synchronize()
    log(f"[serve] (a) one more round under the profiler, "
        f"{len(SERVE_SESSIONS)} sessions: "
        f"{busy_text(*device_busy(prof), wall)}")
    return {q: pct([x[0] * 1e3 for x in lat[q]], 50) for q in SERVE_QUERIES}


def serve_stress(svc, refs) -> None:
    """Phase 19(e): phase 18(d)'s four query threads (Q1/Q5/Q6 and the
    range, SERVE_STRESS_QUERIES each) through four pooled sessions under
    lockwatch: every result equal to its single-thread run, every
    observed nesting an edge of the static lock graph, at least one
    nesting under the service's session lease, no thread leaked."""
    import os
    import threading
    from spark_tpu_torch.analysis.concurrency import lockorder
    from spark_tpu_torch.testing.lockwatch import LockWatch
    programs = ("q1", "q5", "q6", "range")
    watch = LockWatch()
    watch.install_service(svc)
    results, errors = [], []

    def run(i, name):
        try:
            for k in range(SERVE_STRESS_QUERIES):
                q = programs[(i + k) % len(programs)]
                _, table = svc.submit(serve_sql(q), session=name)
                results.append((q, table))
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=run, args=(i, n),
                                    name=f"serve-stress-{n}")
                   for i, n in enumerate(SERVE_SESSIONS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        seconds = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve stress: a query thread wedged")
        if errors:
            raise AssertionError(f"serve stress: {errors[:3]}")
        for q, table in results:
            tables_match(f"serve stress {q} against its single-thread run",
                         table, refs[q][0])
        edges = watch.edges()
        static, _ = lockorder.build_graph(
            os.path.dirname(os.path.abspath(__file__)))
        unknown = set(edges) - set(static)
        if unknown:
            raise AssertionError(f"serve stress: observed nestings outside "
                                 f"the static graph: {sorted(unknown)}")
        nested = sorted(e for e in edges if e[0] == "service.session")
        if not nested:
            raise AssertionError(f"serve stress: no nesting under "
                                 f"service.session: {sorted(edges)}")
        watch.assert_order_consistent()
        watch.assert_no_thread_leak()
        report = watch.report()
        log(f"[serve] (e) lockwatch: {len(results)} queries on "
            f"{len(SERVE_SESSIONS)} pooled sessions in {seconds:.1f} s "
            f"equal their single-thread runs; {len(edges)} observed "
            f"nestings, all in the static graph ({len(static)} edges), "
            f"{len(nested)} under service.session; order consistent, no "
            f"thread leak")
        log(f"[serve] (e) edges: {report['edges']}")
        for lock_id, st in report["locks"].items():
            log(f"[serve] (e) lock {lock_id}: {st['acquires']} "
                f"acquisitions, {st['contended']} contended, wait "
                f"{st['wait_s'] * 1e3:.2f} ms, longest hold "
                f"{st['max_hold_s'] * 1e3:.3f} ms")
    finally:
        watch.uninstall()


def serve_endpoints(svc) -> None:
    """Phase 19(f): /metrics, /status, /healthz/ready and /debug/bundle
    answer; the bundle holds one directory per pooled session."""
    import os
    from spark_tpu_torch.observability.metrics import parse_prometheus_text
    status, _, text = http(svc.port, "GET", "/metrics")
    parsed = parse_prometheus_text(text.decode())
    if status != 200 or parsed.get(
            "spark_tpu_service_queries_submitted", 0) < 1:
        raise AssertionError(f"/metrics: {status}")
    status, _, st = http(svc.port, "GET", "/status")
    if status != 200 or not st["enabled"] or "arbiter" not in \
            st["providers"]:
        raise AssertionError(f"/status: {status} {st}")
    status, _, ready = http(svc.port, "GET", "/healthz/ready")
    if status != 200 or ready != {"ready": True}:
        raise AssertionError(f"/healthz/ready: {status} {ready}")
    status, _, db = http(svc.port, "GET", "/debug/bundle")
    names = sorted(b["session"] for b in db["bundles"])
    if status != 200 or names != sorted(svc.pool.sessions()) or not all(
            os.path.isfile(os.path.join(b["path"], "MANIFEST.json"))
            for b in db["bundles"]):
        raise AssertionError(f"/debug/bundle: {status} {db}")
    log(f"[serve] (f) /metrics ({len(parsed)} samples), /status "
        f"({st['queries_total']} queries, providers "
        f"{sorted(st['providers'])}), /healthz/ready and /debug/bundle "
        f"({len(names)} bundles, one per pooled session: {names}) answer")


def serve_burst(svc) -> None:
    """Phase 19(b), first half: with both execution slots held, an async
    burst of SERVE_BURST Q6 submissions past maxConcurrent + queueDepth
    gets structured 429s, as many as `service_rejected` rose; released,
    every accepted one finishes."""
    before = counter(svc, "service_rejected")
    svc.admission.acquire("hold-1")
    svc.admission.acquire("hold-2")
    accepted, rejected = [], []
    try:
        for i in range(SERVE_BURST):
            status, _, body = http(svc.port, "POST", "/sql", {
                "sql": serve_sql("q6"), "mode": "async",
                "session": SERVE_SESSIONS[i % len(SERVE_SESSIONS)]})
            if status == 202:
                accepted.append(body["query_id"])
            elif status == 429 and body["error"] == "ADMISSION_REJECTED":
                rejected.append(body)
            else:
                raise AssertionError(f"burst: HTTP {status} {body}")
    finally:
        svc.admission.release()
        svc.admission.release()
    bound = SERVE_MAX_CONCURRENT + SERVE_QUEUE_DEPTH
    rose = counter(svc, "service_rejected") - before
    if len(accepted) != bound or len(rejected) != SERVE_BURST - bound \
            or rose != len(rejected):
        raise AssertionError(f"burst: {len(accepted)} accepted, "
                             f"{len(rejected)} 429s, service_rejected "
                             f"rose {rose}")
    statuses = [poll_terminal(svc, qid)["status"] for qid in accepted]
    if set(statuses) != {"ok"}:
        raise AssertionError(f"burst: accepted queries ended {statuses}")
    log(f"[serve] (b) async burst of {SERVE_BURST}: {len(accepted)} "
        f"accepted (the bound {bound}) and all ok, {len(rejected)} "
        f"structured 429 ADMISSION_REJECTED, service_rejected rose "
        f"{rose}")


def serve_timeout_and_quota(init, device) -> None:
    """Phase 19(b), second half, on a service of one slot, a 300 ms
    queue timeout and one in-flight query a session: a session's second
    submission is a 429 SESSION_QUOTA_EXCEEDED, and a query queued past
    the timeout a 503 ADMISSION_TIMEOUT."""
    svc = serve_service((("spark_tpu.service.port", 0),
                         ("spark_tpu.service.maxConcurrent", 1),
                         ("spark_tpu.service.queueDepth", 4),
                         ("spark_tpu.service.queueTimeoutMs", 300),
                         ("spark_tpu.service.session.maxConcurrent", 1)),
                        init, device).start()
    try:
        svc.pool.get_or_create("q")  # its init outside the timed windows
        svc.pool.get_or_create("t")
        svc.admission.acquire("hold")
        try:
            s1, _, b1 = http(svc.port, "POST", "/sql", {
                "sql": serve_sql("q6"), "session": "q", "mode": "async"})
            s2, _, b2 = http(svc.port, "POST", "/sql", {
                "sql": serve_sql("q6"), "session": "q"})
        finally:
            svc.admission.release()
        if s1 != 202 or s2 != 429 or b2["error"] != "SESSION_QUOTA_EXCEEDED":
            raise AssertionError(f"quota: {s1} {b1}; {s2} {b2}")
        if poll_terminal(svc, b1["query_id"])["status"] != "ok":
            raise AssertionError("quota: the admitted query failed")
        svc.admission.acquire("hold")
        try:
            t0 = time.perf_counter()
            s3, _, b3 = http(svc.port, "POST", "/sql", {
                "sql": serve_sql("q6"), "session": "t"})
            waited = time.perf_counter() - t0
        finally:
            svc.admission.release()
        if s3 != 503 or b3["error"] != "ADMISSION_TIMEOUT":
            raise AssertionError(f"timeout: {s3} {b3}")
        log(f"[serve] (b) a session's second in-flight query: 429 "
            f"SESSION_QUOTA_EXCEEDED; queued past 300 ms: 503 "
            f"ADMISSION_TIMEOUT after {waited * 1e3:.0f} ms")
    finally:
        svc.stop()


def serve_cancel_deadline(svc) -> None:
    """Phase 19(d), first half: a DELETE of a running SF1 Q1 (streamed in
    SERVE_CANCEL_CHUNK_ROWS-row chunks) ends it QUERY_CANCELLED with the
    card's allocated bytes back at their value before it; a request-conf
    queryDeadlineMs gives QUERY_DEADLINE_EXCEEDED."""
    import gc
    import torch
    slow = {BUDGET_KEY: 1, CHUNK_KEY: SERVE_CANCEL_CHUNK_ROWS}
    svc.pool.get_or_create("cancel")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    status, _, body = http(svc.port, "POST", "/sql", {
        "sql": serve_sql("q1"), "session": "cancel", "mode": "async",
        "conf": slow})
    qid = body["query_id"]
    deadline = time.monotonic() + 60
    while svc.query_snapshot(qid)["status"] == "submitted":
        if time.monotonic() > deadline:
            raise AssertionError("cancel: the query never started")
        time.sleep(0.01)
    time.sleep(0.5)
    t0 = time.perf_counter()
    code, _, resp = http(svc.port, "DELETE", f"/queries/{qid}")
    rec = poll_terminal(svc, qid, timeout_s=60)
    stopped = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if code != 200 or rec["status"] != "cancelled" or \
            rec["error"]["error"] != "QUERY_CANCELLED":
        raise AssertionError(f"cancel: {code} {resp}; {rec}")
    if after != before:
        raise AssertionError(f"cancel: memory_allocated {after:,} bytes "
                             f"after, {before:,} before")
    t0 = time.perf_counter()
    s2, _, b2 = http(svc.port, "POST", "/sql", {
        "sql": serve_sql("q1"), "session": "deadline",
        "conf": dict(slow, **{DEADLINE_KEY: 200})})
    if s2 != 504 or b2["error"] != "QUERY_DEADLINE_EXCEEDED":
        raise AssertionError(f"deadline: {s2} {b2}")
    log(f"[serve] (d) DELETE of a running streamed Q1: QUERY_CANCELLED "
        f"{stopped * 1e3:.0f} ms after the request, memory_allocated "
        f"{after:,} bytes as before; queryDeadlineMs 200: 504 "
        f"QUERY_DEADLINE_EXCEEDED after {(time.perf_counter() - t0) * 1e3:.0f}"
        f" ms")


def serve_stream(S, svc, path, tmp) -> None:
    """Phase 19(d), second half: phase 17's S2 (201 slots) over
    SERVE_STREAM_FILES files of lineitem moved into a watched directory
    one a trigger, unattended; the live loop shows under `GET /queries`'
    streams, `DELETE /queries/stream-<n>` stops it, and its event log
    holds one trigger record per committing tick."""
    import os
    import numpy as np
    import pyarrow.parquet as pq
    from spark_tpu_torch import history as H
    table = pq.read_table(os.path.join(path, "lineitem.parquet"))
    root = os.path.join(tmp, "serve-stream")
    watched = os.path.join(root, "in")
    os.makedirs(watched)
    bounds = np.linspace(0, table.num_rows,
                         SERVE_STREAM_FILES + 1).astype(np.int64)
    staged = []
    for i in range(SERVE_STREAM_FILES):
        name = os.path.join(root, f"part-{i}.parquet")
        pq.write_table(table.slice(int(bounds[i]),
                                   int(bounds[i + 1] - bounds[i])), name)
        staged.append(name)
    session = stream_session(S)
    ev_dir = os.path.join(root, "events")
    session.conf.set("spark_tpu.sql.eventLog.dir", ev_dir)
    src = session.file_stream(watched, schema_df=table.schema)
    q = s2_query(S.functions, src, os.path.join(root, "ck"))
    q.start(trigger_ms=SERVE_STREAM_TRIGGER_MS)
    try:
        for i, name in enumerate(staged):
            os.rename(name, os.path.join(watched, os.path.basename(name)))
            deadline = time.monotonic() + 120
            while q._committed_batch < i:
                if time.monotonic() > deadline or q.exception() is not None:
                    raise AssertionError(f"stream: batch {i} never "
                                         f"committed: {q.exception()}")
                time.sleep(0.01)
        _, _, listing = http(svc.port, "GET", "/queries")
        live = [r for r in listing["streams"] if r["id"] == q._live_id]
        if not live or live[0]["status"] != "RUNNING":
            raise AssertionError(f"stream: not listed: {listing['streams']}")
        code, _, body = http(svc.port, "DELETE", f"/queries/{q._live_id}")
        if code != 200 or body["query_status"] != "STOPPED":
            raise AssertionError(f"stream: DELETE gave {code} {body}")
        cols = {"suppkey": table.column("l_suppkey").to_numpy(),
                "qty": arrow_unscaled(table.column("l_quantity")),
                "disc": arrow_unscaled(table.column("l_discount"))}
        check_s2("the served stream", q.latest(), cols)
    finally:
        q.stop()
        session.conf.set("spark_tpu.sql.eventLog.dir", "")
    ss = H.streaming_summary(H.read_event_log(ev_dir))
    trig = ss[ss["record"] == "trigger"]
    batches = ss[ss["record"] == "batch"]
    if len(batches) != SERVE_STREAM_FILES or \
            int(trig["batches_run"].sum()) != len(batches):
        raise AssertionError(f"stream: {len(batches)} batch records, "
                             f"trigger records {trig.to_dict('records')}")
    log(f"[serve] (d) stream S2 over {SERVE_STREAM_FILES} files: listed "
        f"under GET /queries, stopped by DELETE {live[0]['id']}, equal to "
        f"pandas; {len(trig)} trigger records for {len(batches)} "
        f"committed batches")


def serve_arbiter(S, path, init, refs, device) -> None:
    """Phase 19(c): the arbiter over the card's memory, each case on a
    service of its own (its arbiter installed at first use), the device
    cache emptied first: a 4096-byte pool denies Q1's lease and Q1
    streams; an 8 GiB pool grants it; a pool of one and a half Q1 scans
    runs two sessions' Q1 at once (the first parked by a listener at its
    query's end, lease still held, while the second runs), one resident
    and one streamed; a session's 0.25 hbmShare streams the second of
    its query's two scans.
    Every result equals its single-thread run, and no lease or pin
    outlives its case."""
    import threading
    import torch
    from spark_tpu_torch.execution.executor import plan_nodes
    from spark_tpu_torch.io.device_cache import CACHE, estimated_scan_bytes
    from spark_tpu_torch.plan.physical import ScanExec
    dev = torch.device(device)
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"[serve] (c) {card_line()}: torch.cuda total_memory "
        f"{total:,} bytes; service.hbmBudget is a byte count of it that "
        f"the arbiter leases estimated scan footprints from, and "
        f"session.hbmShare a fraction of hbmBudget one session may hold")
    plain = S.SparkTpuSession.builder().device(device).get_or_create()
    init(plain)

    def scans(text):
        return [estimated_scan_bytes(leaf) for leaf in plan_nodes(
            plain.sql(text)._qe().executed_plan, ScanExec)]

    def streamed(svc, rid) -> bool:
        return "InputExec(" in (svc.history.get(rid) or {}).get(
            "plan_tree", "")

    def case(label, confs, run):
        CACHE.clear()
        svc = serve_service(confs, init, device)
        try:
            run(svc)
            require_drained(label, svc)
        finally:
            svc.stop()

    def starved(svc):
        rec, table = svc.submit(serve_sql("q1"), session="starved")
        tables_match("Q1 under a 4096-byte pool", table, refs["q1"][0])
        if counter(svc, "arbiter_lease_denied") < 1 or \
                not streamed(svc, rec["id"]):
            raise AssertionError("4096-byte pool: Q1 was not denied "
                                 "residency")
        if svc.history.get(rec["id"]).get("fault_summary"):
            raise AssertionError("4096-byte pool: Q1 recovered from a "
                                 "fault")
        log(f"[serve] (c) hbmBudget 4096: Q1 denied "
            f"({counter(svc, 'arbiter_lease_denied')} denials), streamed, "
            f"equal to its single-thread run, no out-of-memory; "
            f"{rec['elapsed_ms']} ms")

    def roomy(svc):
        rec, table = svc.submit(serve_sql("q1"), session="roomy")
        tables_match("Q1 under an 8 GiB pool", table, refs["q1"][0])
        if counter(svc, "arbiter_lease_granted") < 1 or \
                streamed(svc, rec["id"]):
            raise AssertionError("8 GiB pool: Q1's lease not granted")
        log(f"[serve] (c) hbmBudget 8 GiB: "
            f"{counter(svc, 'arbiter_lease_granted')} leases granted, Q1 "
            f"resident; {rec['elapsed_ms']} ms")

    est = scans(serve_sql("q1"))[0]

    def pair(svc):
        from spark_tpu_torch.observability import QueryListener
        holding, release = threading.Event(), threading.Event()

        class Hold(QueryListener):
            """Parks session a at its query's end, where its lease is
            still held, until session b's Q1 has run."""

            def on_query_end(self, event):
                if not holding.is_set():
                    holding.set()
                    release.wait(120)

        svc.pool.get_or_create("a").session.add_listener(Hold())
        out, errors = {}, []

        def run_a():
            try:
                out["a"] = svc.submit(serve_sql("q1"), session="a")
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(f"a: {type(e).__name__}: {e}")

        ta = threading.Thread(target=run_a)
        ta.start()
        try:
            if not holding.wait(120):
                raise AssertionError(f"pair: a never finished: {errors}")
            out["b"] = svc.submit(serve_sql("q1"), session="b")
        finally:
            release.set()
            ta.join(120)
        if errors:
            raise AssertionError(f"pair: {errors}")
        kinds = {}
        for name, (rec, table) in sorted(out.items()):
            tables_match(f"Q1 of session {name} in the pair", table,
                         refs["q1"][0])
            kinds[name] = "streamed" if streamed(svc, rec["id"]) \
                else "resident"
        if kinds != {"a": "resident", "b": "streamed"}:
            raise AssertionError(f"pair: {kinds}")
        log(f"[serve] (c) hbmBudget {est * 3 // 2:,} (1.5 Q1 scans of "
            f"{est:,} estimated bytes): two sessions' Q1 at once, session "
            f"a resident and parked at its query's end with its lease, "
            f"session b denied and streamed; both equal; granted "
            f"{counter(svc, 'arbiter_lease_granted')}, denied "
            f"{counter(svc, 'arbiter_lease_denied')}")

    two = scans(SERVE_TWO_SCANS)
    share_cap = max(two) + min(two) // 2
    want_two = plain.sql(SERVE_TWO_SCANS).collect()

    def greedy(svc):
        rec, table = svc.submit(SERVE_TWO_SCANS, session="greedy")
        tables_match("the two-scan query under hbmShare", table, want_two)
        tree = svc.history.get(rec["id"])["plan_tree"]
        if counter(svc, "session_quota_rejections") != 1 or \
                tree.count("InputExec(") != 1:
            raise AssertionError(f"hbmShare: {tree}")
        log(f"[serve] (c) hbmShare 0.25 of {4 * share_cap:,} bytes: the "
            f"greedy session's first scan ({two[0]:,} bytes) resident, its "
            f"second ({two[1]:,}) denied past the share and streamed; "
            f"equal to its single-thread run")

    no_cache = (CACHE_KEY, 0)
    case("4096-byte pool", ((HBM_KEY, 4096),), starved)
    case("8 GiB pool", ((HBM_KEY, 8 << 30),), roomy)
    case("the pair", ((HBM_KEY, est * 3 // 2), no_cache), pair)
    case("hbmShare", ((HBM_KEY, 4 * share_cap), (HBM_SHARE_KEY, 0.25),
                      no_cache), greedy)
    log("[serve] (c) after every case: 0 bytes leased, no pin left")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi gave nothing"


def phase_serve(D, S, G, path, tmp, sql_results, launches, current,
                device="cuda:0"):
    """Phase 19: the SQL service on the card, (a)-(f). Returns the
    single-thread references and (a)'s served p50 ms by query."""
    import os
    import torch
    t0 = time.perf_counter()
    init = serve_init(path, serve_range_source())
    refs = serve_references(D, S, G, path, init, sql_results, launches,
                            current, device)
    total = torch.cuda.get_device_properties(torch.device(device)) \
        .total_memory
    svc = serve_service((
        ("spark_tpu.service.host", "127.0.0.1"),
        ("spark_tpu.service.port", 0),
        ("spark_tpu.service.maxConcurrent", SERVE_MAX_CONCURRENT),
        ("spark_tpu.service.queueDepth", SERVE_QUEUE_DEPTH),
        (HBM_KEY, total),
        ("spark_tpu.sql.flightRecorder.dir", os.path.join(tmp, "serve-fr"))),
        init, device).start()
    log(f"[serve] references in {time.perf_counter() - t0:.1f} s; service "
        f"on 127.0.0.1:{svc.port}, {SERVE_MAX_CONCURRENT} slots, queue "
        f"{SERVE_QUEUE_DEPTH}, hbmBudget {total:,} bytes (the whole card)")
    try:
        t1 = time.perf_counter()
        served_p50 = serve_parity(D, svc, refs)
        log(f"[serve] (a) in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        serve_stress(svc, refs)
        log(f"[serve] (e) in {time.perf_counter() - t1:.1f} s")
        serve_endpoints(svc)
        t1 = time.perf_counter()
        serve_burst(svc)
        serve_timeout_and_quota(init, device)
        log(f"[serve] (b) in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        serve_cancel_deadline(svc)
        serve_stream(S, svc, path, tmp)
        log(f"[serve] (d) in {time.perf_counter() - t1:.1f} s")
        require_drained("the main service", svc)
    finally:
        svc.stop()
    t1 = time.perf_counter()
    serve_arbiter(S, path, init, refs, device)
    log(f"[serve] (c) in {time.perf_counter() - t1:.1f} s")
    return refs, served_p50


# ---------------------------------------------------------------------------
# Phase 20: the serving fleet
# ---------------------------------------------------------------------------

#: the workers' init module: the TPC-H tables and the range view in every
#: pooled session; at the worker's exit (after its drain) a report of its
#: launches, device, peak memory and any JAX module it loaded; and a
#: watcher that, when asked (`fleet_trim`), drops the worker's device
#: table cache and returns its cached, unused device blocks, so that the
#: card's free memory then counts the workers themselves
FLEET_INIT_SRC = '''\
import atexit
import json
import os
import sys
import threading
import time

import numpy as np
import pyarrow as pa

PATH = {path!r}
REPORT = {report!r}
RANGE_TABLE = {table!r}
RANGE_ROWS = {rows!r}
_STATE = {{}}


def _report():
    import torch
    from spark_tpu_torch.execution import dense_groupby as D
    device = _STATE["device"]
    bad = sorted(m for m in sys.modules if m in ("jax", "spark_tpu")
                 or m.startswith(("jax.", "spark_tpu.")))
    out = {{"pid": os.getpid(),
           "worker": int(os.environ.get("SPARK_TPU_FLEET_IDX", "-1")),
           "conf": json.loads(os.environ.get("SPARK_TPU_FLEET_CONF", "{{}}")),
           "device": str(device), "launches": dict(D.LAUNCHES),
           "max_memory_allocated": torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0,
           "bad_modules": bad}}
    with open(os.path.join(REPORT, f"hook-{{os.getpid()}}.json"), "w") as f:
        json.dump(out, f)


def _trim_watch():
    import torch
    request, done = os.path.join(REPORT, "trim-request"), 0
    while True:
        time.sleep(0.05)
        try:
            with open(request) as f:
                n = int(f.read())
        except (OSError, ValueError):
            continue
        if n > done:
            import gc
            from spark_tpu_torch.io.device_cache import CACHE
            CACHE.clear()
            gc.collect()  # batches held in reference cycles
            held = [0, 0]
            if _STATE["device"].type == "cuda":
                torch.cuda.synchronize(_STATE["device"])
                torch.cuda.empty_cache()
                held = [torch.cuda.memory_allocated(_STATE["device"]),
                        torch.cuda.memory_reserved(_STATE["device"])]
            done = n
            ack = os.path.join(REPORT, f"trim-{{os.getpid()}}-{{n}}")
            with open(ack + ".tmp", "w") as f:
                json.dump(held, f)
            os.replace(ack + ".tmp", ack)


def init(session):
    from spark_tpu_torch.io.sources import ArrowTableSource
    from spark_tpu_torch.tpch.queries import register_tables
    register_tables(session, PATH)
    if "source" not in _STATE:
        _STATE["source"] = ArrowTableSource(RANGE_TABLE, pa.table(
            {{"id": np.arange(RANGE_ROWS, dtype=np.int64)}}))
        _STATE["device"] = session.device
        atexit.register(_report)
        threading.Thread(target=_trim_watch, daemon=True,
                         name="chip-fleet-trim").start()
    session.register_table(RANGE_TABLE, _STATE["source"])
'''
#: an init spec whose import raises: every spawn of its worker dies at boot
FLEET_BAD_INIT_SRC = 'raise RuntimeError("chip fleet: this init never loads")\n'
FLEET_WORKERS = 2
FLEET_ROUNDS = 2
#: the slow rules' milliseconds: a worker arms one fault plan for the
#: whole process and keeps its hit counts while the spec is unchanged, so
#: each slowed query gets a spec of its own
FLEET_SLOW_MS = (5000, 5001, 5002)
FLEET_ALLOC_KEY = "PYTORCH_CUDA_ALLOC_CONF"
FLEET_ALLOC = "expandable_segments:True"
FLEET_KEYS = (("spark_tpu.service.fleet.healthIntervalMs", 100),
              ("spark_tpu.service.fleet.restartBackoffMs", 100))


def fleet_trim(sup, report_dir, n) -> dict:
    """Ask every ready worker to drop its device table cache and return
    its cached, unused device blocks (the init module's watcher: CACHE
    .clear(), torch.cuda.empty_cache()) and wait until each has: the
    card's free memory then counts the workers themselves, not which
    tables their caches' LRU order kept nor how their caching allocators
    happened to grow."""
    import os
    pids = [st["pid"] for st in (w.snapshot() for w in sup._workers)
            if st["state"] == "ready"]
    tmp = os.path.join(report_dir, "trim-request.tmp")
    with open(tmp, "w") as f:
        f.write(str(n))
    os.replace(tmp, os.path.join(report_dir, "trim-request"))
    fleet_wait(lambda: all(os.path.exists(os.path.join(
        report_dir, f"trim-{pid}-{n}")) for pid in pids), 60,
        f"workers {pids} returning their cached blocks")
    held = {}
    for pid in pids:
        with open(os.path.join(report_dir, f"trim-{pid}-{n}")) as f:
            held[pid] = json.load(f)
    return held


def fleet_free_bytes(device="cuda:0") -> int:
    import torch
    return int(torch.cuda.mem_get_info(torch.device(device))[0])


def fleet_supervisor(dirs, init_spec, workers, extra=(),
                     device="cuda:0"):
    """A FleetSupervisor (not started) on `device`, its conf leaving
    service.hbmBudget unset (each worker then gets the card's free
    memory over the worker count)."""
    from spark_tpu_torch.config import Conf
    from spark_tpu_torch.service.fleet import FleetSupervisor
    conf = Conf()
    for key, value in (("spark_tpu.service.port", 0),
                       ("spark_tpu.service.fleet.workers", workers),
                       ("spark_tpu.service.fleet.init", init_spec),
                       ("spark_tpu.service.fleet.dir", dirs["fleet"]),
                       *FLEET_KEYS, *extra):
        conf.set(key, value)
    return FleetSupervisor(conf, device=device)


def fleet_wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"fleet: timed out waiting for {what}")


def pid_gone(pid) -> bool:
    import os
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def fleet_check(what, q, status, headers, body, refs):
    """One routed result against its single-thread reference; returns
    the worker index, the query id and the raw Arrow bytes (or None)."""
    import pyarrow as pa
    from spark_tpu_torch.service.server import _table_rows
    if status != 200:
        raise AssertionError(f"{what}: HTTP {status} {body}")
    if q in SERVE_ARROW:
        tables_match(what, pa.ipc.open_stream(body).read_all(), refs[q][0])
        return int(headers["X-Fleet-Worker"]), headers["X-Query-Id"], body
    if body["columns"] != refs[q][0].column_names:
        raise AssertionError(f"{what}: columns {body['columns']}")
    rows_match(what, body["rows"], _table_rows(refs[q][0]))
    return int(headers["X-Fleet-Worker"]), body["query_id"], None


def fleet_clients(sup, refs, sessions, rounds):
    """One client thread per session, each sending every SERVE_QUERIES
    query `rounds` times through the router (SERVE_ARROW in Arrow, the
    rest in JSON); every result must equal its single-thread run and
    land on the session's ring home, as its `q-w<i>g<gen>-` id says.
    Returns {q: [(round, latency s)]}, the wall seconds and {(session,
    q): Arrow bytes of its last run}."""
    import re
    import threading
    lat = {q: [] for q in SERVE_QUERIES}
    raw, errors = {}, []

    def client(name):
        try:
            home = sup._route(name)[0]
            gen = sup._workers[home].snapshot()["generation"]
            for rnd in range(rounds):
                for q in SERVE_QUERIES:
                    fmt = "arrow" if q in SERVE_ARROW else "json"
                    t0 = time.perf_counter()
                    status, headers, body = http(
                        sup.port, "POST", "/sql",
                        {"sql": serve_sql(q), "session": name,
                         "format": fmt})
                    lat[q].append((rnd, time.perf_counter() - t0))
                    widx, qid, data = fleet_check(
                        f"fleet {q} ({name})", q, status, headers, body,
                        refs)
                    m = re.match(r"^q-w(\d+)g(\d+)-", qid)
                    if widx != home or not m or \
                            (int(m.group(1)), int(m.group(2))) != (home, gen):
                        raise AssertionError(
                            f"{name} {q}: served by worker {widx} as "
                            f"{qid}, its ring home is w{home}g{gen}")
                    if data is not None:
                        raw[(name, q)] = data
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(f"{name}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(n,),
                                name=f"fleet-client-{n}") for n in sessions]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("fleet: a client thread wedged")
    if errors:
        raise AssertionError(f"fleet clients: {errors[:3]}")
    return lat, wall, raw


def fleet_start(sup):
    """Start the fleet; returns each worker's spawn-to-ready seconds."""
    t0 = time.perf_counter()
    sup.start()
    ready = {}

    def all_ready():
        for w in sup._workers:
            if w.idx not in ready and w.snapshot()["state"] == "ready":
                ready[w.idx] = time.perf_counter() - t0
        return len(ready) == len(sup._workers)

    fleet_wait(all_ready, 300, f"{len(sup._workers)} workers ready")
    for w in sup._workers:
        args = w.snapshot()["proc"].args
        if args[1:] != ["-m", "spark_tpu_torch.service.fleet", "--worker"]:
            raise AssertionError(f"fleet: worker started as {args}")
    return ready


def fleet_routing(sup, refs, served_p50):
    """Phase 20(a): four sessions, FLEET_ROUNDS rounds, through the
    router; /metrics merges both workers' series."""
    from spark_tpu_torch.observability.metrics import parse_prometheus_text
    lat, wall, raw = fleet_clients(sup, refs, SERVE_SESSIONS, FLEET_ROUNDS)
    n = sum(len(v) for v in lat.values())
    homes = {s: sup._route(s)[0] for s in SERVE_SESSIONS}
    log(f"[fleet] (a) {len(SERVE_SESSIONS)} sessions x {FLEET_ROUNDS} "
        f"rounds x {len(SERVE_QUERIES)} queries = {n} routed in {wall:.3f} s "
        f"({n / wall:.2f} queries/s); ring homes {homes}; every result "
        f"equal to its single-thread run, every id its home's")
    for q in SERVE_QUERIES:
        w = [x * 1e3 for _, x in lat[q]]
        last = [x * 1e3 for r, x in lat[q] if r == FLEET_ROUNDS - 1]
        log(f"[fleet] (a) {q} ({'arrow' if q in SERVE_ARROW else 'json'}): "
            f"latency p50 {pct(w, 50):.1f} ms p95 {pct(w, 95):.1f} ms "
            f"(round {FLEET_ROUNDS}, every scan cached in the workers: p50 "
            f"{pct(last, 50):.1f} ms p95 {pct(last, 95):.1f} ms); "
            f"phase 19 served p50 "
            + (f"{served_p50[q]:.1f} ms" if q in served_p50 else "not run")
            + f"; warm single-thread collect() {refs[q][1] * 1e3:.1f} ms")
    status, _, text = http(sup.port, "GET", "/metrics")
    parsed = parse_prometheus_text(text.decode())
    per_worker = {i: parsed.get(
        f'spark_tpu_service_admitted{{worker="{i}"}}', 0)
        for i in range(len(sup._workers))}
    if status != 200 or min(per_worker.values()) < 1 or \
            parsed.get("spark_tpu_fleet_requests_proxied", 0) < n:
        raise AssertionError(f"fleet /metrics: {status} {per_worker}")
    log(f"[fleet] (a) /metrics merges both workers: service_admitted by "
        f"worker {per_worker}, fleet_requests_proxied "
        f"{parsed['spark_tpu_fleet_requests_proxied']:.0f}")
    return raw


def fleet_idle(sup, report_dir, n, device):
    """The card's free memory with every worker idle, its table cache
    dropped and its cached blocks returned (`fleet_trim` number n), and
    what each worker still held then. A worker's watcher starts with its
    first pooled session: a session homed on each worker is opened
    first (SHOW TABLES, no device work)."""
    import torch
    for w in sup._workers:
        name = next(f"idle-{i}" for i in range(1000)
                    if sup._route(f"idle-{i}")[0] == w.idx)
        status, _, body = http(sup.port, "POST", "/sql",
                               {"sql": "SHOW TABLES", "session": name})
        if status != 200:
            raise AssertionError(f"fleet: SHOW TABLES {status} {body}")
    held = fleet_trim(sup, report_dir, n)
    torch.cuda.synchronize()
    return fleet_free_bytes(device), held


def fleet_kill(sup, refs, raw, device, report_dir, idle_start):
    """Phase 20(b): SIGKILL alpha's home worker while a slowed Q1 of
    alpha's (sync) and of gamma's (async) run on it."""
    import os
    import signal
    import threading
    import torch
    home = sup._route("alpha")[0]
    if sup._route("gamma")[0] != home:
        raise AssertionError("fleet: gamma is not homed with alpha")
    pid = sup._workers[home].snapshot()["pid"]
    free_start, held_start = idle_start
    free_before, held_before = fleet_idle(sup, report_dir, 2, device)
    # warm the failover target again: its scans back in its cache
    over = sup._route("alpha")[1]
    warm = next(s for s in SERVE_SESSIONS if sup._route(s)[0] == over)
    status, headers, body = http(sup.port, "POST", "/sql", {
        "sql": serve_sql("q1"), "session": warm, "format": "arrow"})
    fleet_check(f"fleet (b) {warm}'s Q1", "q1", status, headers, body, refs)
    torch.cuda.synchronize()
    raw_prekill = fleet_free_bytes(device)
    out = []
    status, _, sub = http(sup.port, "POST", "/sql", {
        "sql": serve_sql("q1"), "session": "gamma", "mode": "async",
        "conf": {"spark_tpu.faults.inject":
                 f"stage_run:slow:1:{FLEET_SLOW_MS[0]}"}})
    if status != 202:
        raise AssertionError(f"fleet async submit: {status} {sub}")

    def running(session, qid=None):
        _, _, listing = http(sup.port, "GET", "/queries")
        return any(q.get("status") == "running"
                   and q.get("session") == session
                   and qid in (None, q.get("id"))
                   for q in listing.get("queries", []))

    fleet_wait(lambda: running("gamma", sub["query_id"]), 120,
               "gamma's Q1 running")
    time.sleep(0.5)  # gamma's rule has fired: alpha may arm its own
    t = threading.Thread(target=lambda: out.append(http(
        sup.port, "POST", "/sql", {
            "sql": serve_sql("q1"), "session": "alpha", "format": "arrow",
            "conf": {"spark_tpu.faults.inject":
                     f"stage_run:slow:1:{FLEET_SLOW_MS[1]}"}})),
        daemon=True)
    t.start()
    fleet_wait(lambda: running("alpha") and running(
        "gamma", sub["query_id"]), 120, "alpha's and gamma's Q1 running")
    t_kill = time.perf_counter()
    os.kill(pid, signal.SIGKILL)
    t.join(600)
    failover_s = time.perf_counter() - t_kill
    if t.is_alive() or not out:
        raise AssertionError("fleet: the failed-over query wedged")
    status, headers, body = out[0]
    over, _, data = fleet_check("fleet (b) failed-over Q1", "q1", status,
                                headers, body, refs)
    if headers.get("X-Fleet-Failover") != "1" or over == home:
        raise AssertionError(f"fleet (b): no failover: {dict(headers)}")
    if data != raw[("alpha", "q1")]:
        raise AssertionError("fleet (b): failed-over Q1 is not byte-equal "
                             "to (a)'s")
    status, _, err = http(sup.port, "GET", f"/queries/{sub['query_id']}")
    if status != 503 or err.get("error") != "WORKER_LOST" or \
            err.get("worker") != home:
        raise AssertionError(f"fleet (b) async: {status} {err}")
    fleet_wait(lambda: pid_gone(pid), 60, f"killed pid {pid} reaped")
    torch.cuda.synchronize()
    free_reaped = fleet_free_bytes(device)
    fleet_wait(lambda: sup._workers[home].snapshot()["state"] == "ready"
               and sup._workers[home].snapshot()["generation"] == 2, 300,
               "the respawned worker ready")
    respawn_s = time.perf_counter() - t_kill
    status, headers, body = http(sup.port, "POST", "/sql", {
        "sql": serve_sql("q1"), "session": "alpha", "format": "arrow"})
    widx, qid, data = fleet_check("fleet (b) Q1 on the respawned worker",
                                  "q1", status, headers, body, refs)
    if widx != home or not qid.startswith(f"q-w{home}g2-") or \
            data != raw[("alpha", "q1")]:
        raise AssertionError(f"fleet (b): respawned Q1 {widx} {qid}")
    # the respawned worker serves its sessions' traffic of (a) again
    homed = tuple(s for s in SERVE_SESSIONS if sup._route(s)[0] == home)
    fleet_clients(sup, refs, homed, 1)
    free_after, held_after = fleet_idle(sup, report_dir, 3, device)
    log(f"[fleet] (b) SIGKILL of worker {home} (pid {pid}) mid-Q1: alpha's "
        f"read failed over to worker {over} and returned 200 byte-equal "
        f"to (a) {failover_s:.3f} s after the kill (the retry runs the "
        f"request again, its {FLEET_SLOW_MS[1]} ms slow rule included); "
        f"gamma's async Q1 answers 503 WORKER_LOST; respawned at "
        f"generation 2 and ready {respawn_s:.3f} s after the kill, Q1 on "
        f"it byte-equal again; card free memory {raw_prekill:,} bytes just "
        f"before the kill, {free_reaped:,} once the pid was reaped; with "
        f"the workers idle, their table caches dropped and cached blocks "
        f"returned: {free_start:,} at the fleet's start, {free_before:,} "
        f"after (a), {free_after:,} after the respawned worker served "
        f"{homed} ({(free_after - free_start) / free_start:+.4f} against "
        f"the start); the workers' allocated and reserved bytes then, by "
        f"pid: {held_start}, {held_before}, {held_after}")
    if free_reaped <= raw_prekill:
        raise AssertionError("fleet (b): the killed worker's memory was "
                             "not returned to the card")
    if abs(free_after - free_start) > 0.05 * free_start:
        raise AssertionError("fleet (b): free memory after the respawn is "
                             "not within 5% of its value before the kill")


def fleet_flap_start(dirs, device):
    """Phase 20(c), started beside (b) (its crashing spawns overlap the
    kill): a fleet whose init spec's import raises. Returns it and its
    start time."""
    sup = fleet_supervisor(dirs, "chip_fleet_bad:init", 1, extra=(
        ("spark_tpu.service.fleet.restartMaxPerWindow", 2),
        ("spark_tpu.service.fleet.restartBackoffMs", 50)), device=device)
    return sup.start(), time.perf_counter()


def fleet_flap(dirs, sup, t0):
    """Phase 20(c): the fleet of `fleet_flap_start` is quarantined after
    restartMaxPerWindow crashes; its traffic sheds with a structured 503
    and every death left a flight bundle."""
    import os
    from spark_tpu_torch.observability.metrics import parse_prometheus_text
    try:
        fleet_wait(lambda: sup._workers[0].snapshot()["state"]
                   == "quarantined", 300, "the flap breaker's quarantine")
        status, _, err = http(sup.port, "POST", "/sql",
                              {"sql": serve_sql("q6"), "session": "alpha"})
        if status != 503 or err.get("error") != "FLEET_UNAVAILABLE":
            raise AssertionError(f"fleet (c): {status} {err}")
        _, _, text = http(sup.port, "GET", "/metrics")
        prom = parse_prometheus_text(text.decode())
        lost = int(prom.get("spark_tpu_fleet_worker_lost", 0))
        bundles = sorted(os.listdir(os.path.join(dirs["fleet"], "bundles")))
        told = []
        for b in bundles:
            with open(os.path.join(dirs["fleet"], "bundles", b,
                                   "stderr.txt")) as f:
                told.append(f.read())
        if lost < 2 or len(bundles) != lost or not all(
                "this init never loads" in s for s in told) or \
                prom.get("spark_tpu_fleet_quarantined", 0) < 1:
            raise AssertionError(f"fleet (c): {lost} deaths, bundles "
                                 f"{bundles}")
        log(f"[fleet] (c) a worker whose init raises: {lost} crashes, "
            f"quarantined {time.perf_counter() - t0:.1f} s after the start, "
            f"POST /sql 503 FLEET_UNAVAILABLE, one flight bundle per "
            f"death ({len(bundles)}), each with the traceback")
    finally:
        sup.stop()


def fleet_drain(sup, refs, report_dir):
    """Phase 20(d): shutdown() with a query in flight; returns the
    workers' hook reports."""
    import json
    import os
    import threading
    procs = [w.snapshot()["proc"] for w in sup._workers]
    pids = [p.pid for p in procs]
    out, shut = [], []
    t = threading.Thread(target=lambda: out.append(http(
        sup.port, "POST", "/sql", {
            "sql": serve_sql("q1"), "session": "delta",
            "format": "arrow", "conf": {"spark_tpu.faults.inject":
                                        f"stage_run:slow:1:{FLEET_SLOW_MS[2]}"}})),
        daemon=True)
    t.start()
    fleet_wait(lambda: any(
        q.get("status") == "running" and q.get("session") == "delta"
        for q in http(sup.port, "GET", "/queries")[2].get("queries", [])),
        120, "delta's Q1 running")
    t0 = time.perf_counter()
    ts = threading.Thread(target=lambda: shut.append(sup.shutdown()),
                          daemon=True)
    ts.start()
    fleet_wait(lambda: http(sup.port, "POST", "/sql", {
        "sql": serve_sql("q6"), "session": "beta"}, timeout=30)[2].get(
        "error") == "FLEET_DRAINING", 30, "the drain's 503 FLEET_DRAINING")
    t.join(600)
    ts.join(600)
    if ts.is_alive() or shut != [True] or not out:
        raise AssertionError(f"fleet (d): shutdown {shut}")
    status, headers, body = out[0]
    fleet_check("fleet (d) the in-flight Q1", "q1", status, headers, body,
                refs)
    codes = [p.returncode for p in procs]
    if codes != [0] * len(procs) or not all(pid_gone(p) for p in pids):
        raise AssertionError(f"fleet (d): worker exits {codes}")
    leaked = [th.name for th in threading.enumerate()
              if th.name.startswith(sup.thread_prefix)]
    if leaked:
        raise AssertionError(f"fleet (d): threads left {leaked}")
    reports = []
    for f in sorted(os.listdir(report_dir)):
        if f.startswith("hook-"):
            with open(os.path.join(report_dir, f)) as fh:
                reports.append(json.load(fh))
    log(f"[fleet] (d) shutdown() with Q1 in flight: new work 503 "
        f"FLEET_DRAINING, the in-flight Q1 equal to its single-thread run, "
        f"the workers exit {codes}, drained in "
        f"{time.perf_counter() - t0:.1f} s; no orphan pid, no "
        f"{sup.thread_prefix}* thread left")
    return reports


def phase_fleet(D, S, G, path, tmp, sql_results, launches, current,
                captured, served, device="cuda:0"):
    """Phase 20: the crash-only serving fleet on the card, (a)-(d).
    `served` is phase 19's (refs, served p50 ms by query), or None."""
    import os
    import sys as _sys
    import torch
    from spark_tpu_torch.io.device_cache import CACHE
    t0 = time.perf_counter()
    if served is None:
        refs = serve_references(D, S, G, path, serve_init(
            path, serve_range_source()), sql_results, launches, current,
            device)
        served_p50 = {}
    else:
        refs, served_p50 = served
    CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info(torch.device(device))
    dirs = {"init": os.path.join(tmp, "fleet-init"),
            "report": os.path.join(tmp, "fleet-report"),
            "fleet": os.path.join(tmp, "fleet")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(dirs["init"], "chip_fleet_init.py"), "w") as f:
        f.write(FLEET_INIT_SRC.format(path=path, report=dirs["report"],
                                      table=SERVE_RANGE_TABLE,
                                      rows=RANGE_ROWS))
    with open(os.path.join(dirs["init"], "chip_fleet_bad.py"), "w") as f:
        f.write(FLEET_BAD_INIT_SRC)
    prev = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = dirs["init"] + (
        os.pathsep + prev if prev else "")
    # the workers' caching allocators map device memory page by page, so
    # that returning cached blocks is not held up by fragmentation and
    # (b)'s readings count what the workers use
    prev_alloc = os.environ.get(FLEET_ALLOC_KEY)
    os.environ[FLEET_ALLOC_KEY] = ",".join(
        x for x in (prev_alloc, FLEET_ALLOC) if x)
    sup = fleet_supervisor(dirs, "chip_fleet_init:init", FLEET_WORKERS,
                           device=device)
    try:
        ready = fleet_start(sup)
        idle_start = fleet_idle(sup, dirs["report"], 1, device)
        log(f"[fleet] references in {time.perf_counter() - t0:.1f} s; card "
            f"free {free0:,} of {total:,} bytes at start; {FLEET_WORKERS} "
            f"workers on {device}, hbmBudget {sup._hbm_share} bytes each; "
            f"spawn to ready (s) "
            + ", ".join(f"worker {i} {s:.3f}" for i, s in sorted(
                ready.items())) + f"; router on 127.0.0.1:{sup.port}")
        t1 = time.perf_counter()
        raw = fleet_routing(sup, refs, served_p50)
        log(f"[fleet] (a) in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        flap_dirs = dict(dirs, fleet=os.path.join(tmp, "fleet-flap"))
        flap = fleet_flap_start(flap_dirs, device)
        try:
            fleet_kill(sup, refs, raw, device, dirs["report"], idle_start)
            log(f"[fleet] (b) in {time.perf_counter() - t1:.1f} s (the "
                f"fleet of (c) crashing beside it)")
            t1 = time.perf_counter()
            fleet_flap(flap_dirs, *flap)
        finally:
            flap[0].stop()
        log(f"[fleet] (c) in {time.perf_counter() - t1:.1f} s after (b)")
        reports = fleet_drain(sup, refs, dirs["report"])
    finally:
        sup.stop()
        for key, value in (("PYTHONPATH", prev),
                           (FLEET_ALLOC_KEY, prev_alloc)):
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    total_launches = {}
    for r in reports:
        if r["bad_modules"] or r["device"] != device:
            raise AssertionError(f"fleet worker report {r}")
        for k, v in r["launches"].items():
            total_launches[k] = total_launches.get(k, 0) + v
        log(f"[fleet] worker {r['worker']} ({r['conf']['spark_tpu.service.'
            'idPrefix']}, pid {r['pid']}) on {r['device']}: launches "
            f"{r['launches']}, max_memory_allocated "
            f"{r['max_memory_allocated']:,} bytes, no JAX module")
    require_kernels("the fleet's workers", ("dense_sums_smem",
                                            "dense_sums_global"),
                    total_launches)
    if len(reports) != FLEET_WORKERS:
        raise AssertionError(f"fleet: {len(reports)} worker reports")
    if any(m == "jax" or m.startswith(("jax.", "spark_tpu."))
           or m == "spark_tpu" for m in _sys.modules):
        raise AssertionError("fleet: the parent imported JAX or the JAX "
                             "package")
    # the workers' kernel inputs are the single-thread runs' (same data,
    # same plans): the report times them under the workers' launches
    launches["fleet"] = total_launches
    captured[("fleet", "dense_sums_smem")] = captured[
        ("serve q1", "dense_sums_smem")]
    captured[("fleet", "dense_sums_global")] = captured[
        ("serve range", "dense_sums_global")]
    log(f"[fleet] the surviving workers launched {total_launches} "
        f"(the killed worker's launches died with it)")


# ---------------------------------------------------------------------------
# Phase 21: the ML and graph libraries
# ---------------------------------------------------------------------------

LIBS_FEATURES = ("l_quantity", "l_discount", "l_tax")
LIBS_KMEANS_K = 8
LIBS_KMEANS_ITERS = 10
LIBS_KMEANS_SEED = 42
LIBS_LOGREG_ITERS = 25
LIBS_LOGREG_STEP = 0.005
LIBS_PAGERANK_ITERS = 20
LIBS_SUPPLIER_BASE = 1_000_000


class CudaTimer:
    """CUDA events around a block: `ms` once the block has ended."""

    def __enter__(self):
        import torch
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        import torch
        self.end.record()
        torch.cuda.synchronize()
        self.ms = self.start.elapsed_time(self.end)


def libs_line(name, wall, collect, device_ms, extra=""):
    import torch
    log(f"[libs] {name}: wall {wall:.3f} s, collect {collect:.3f} s, "
        f"device {device_ms:.2f} ms (CUDA events){extra}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated():,} bytes")


def libs_close(what, got, want, rtol):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    if not np.allclose(got, want, rtol=rtol, atol=0.0):
        raise AssertionError(f"{what}: {got} against {want} "
                             f"(max relative error {err:.3g})")
    return err


def libs_ml(session, n_rows):
    """Phase 21, ML: LinearRegression, LogisticRegression and KMeans over
    all of lineitem, each against a float64 numpy run."""
    import numpy as np
    import torch
    from spark_tpu_torch import functions as F
    from spark_tpu_torch import types as T
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.ml import (KMeans, LinearRegression,
                                    LogisticRegression, VectorAssembler)
    from spark_tpu_torch.ml import classification as MC
    from spark_tpu_torch.ml import clustering as MK
    from spark_tpu_torch.ml import regression as MR
    from spark_tpu_torch.ml.util import collect_xy, to_device
    li = session.table("lineitem").select(
        *[col(c).cast(T.DOUBLE).alias(c) for c in LIBS_FEATURES],
        col("l_extendedprice").cast(T.DOUBLE).alias("price"),
        F.when(col("l_returnflag") == "R", 1.0).otherwise(0.0)
        .alias("returned"))
    df = VectorAssembler(list(LIBS_FEATURES), "features").transform(li)
    t0 = time.perf_counter()
    table, X, y = collect_xy(df, "features", "price")
    collect_s = time.perf_counter() - t0
    ret = np.asarray(table.column("returned").to_numpy(), np.float64)
    if X.shape != (n_rows, 3):
        raise AssertionError(f"libs: feature matrix {X.shape}")
    Xt, yt, rt = to_device(df, X), to_device(df, y), to_device(df, ret)
    # linear regression: the normal equations against lstsq
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lr = LinearRegression(labelCol="price").fit(df)
    wall = time.perf_counter() - t0
    with CudaTimer() as ct:
        MR._gram_moments(Xt, yt, 0.0)
    A = np.column_stack([X, np.ones(len(X))])
    want, *_ = np.linalg.lstsq(A, y, rcond=None)
    err = libs_close("LinearRegression against lstsq",
                     np.append(lr.coefficients, lr.intercept), want, 1e-8)
    libs_line("LinearRegression (price ~ quantity, discount, tax; "
              f"{len(X):,} rows)", wall, collect_s, ct.ms,
              f"; coefficients {np.append(lr.coefficients, lr.intercept)} "
              f"within {err:.3g} of lstsq")
    # logistic regression: the same gradient steps in numpy
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logit = LogisticRegression(labelCol="returned",
                               maxIter=LIBS_LOGREG_ITERS,
                               stepSize=LIBS_LOGREG_STEP).fit(df)
    wall = time.perf_counter() - t0
    with CudaTimer() as ct:
        MC._logreg_fit(Xt, rt, LIBS_LOGREG_ITERS, LIBS_LOGREG_STEP, 0.0)
    n = len(X)
    w = np.zeros(4)
    for _ in range(LIBS_LOGREG_ITERS):
        p = 1.0 / (1.0 + np.exp(-(A @ w)))
        w = w - LIBS_LOGREG_STEP * (A.T @ (p - ret) / n)
    err = libs_close("LogisticRegression against numpy",
                     np.append(logit.coefficients, logit.intercept), w, 1e-9)
    libs_line(f"LogisticRegression (l_returnflag = 'R', "
              f"{int(ret.sum()):,} of {n:,}; {LIBS_LOGREG_ITERS} steps of "
              f"{LIBS_LOGREG_STEP})", wall, collect_s, ct.ms,
              f"; weights within {err:.3g} of numpy")
    # k-means: Lloyd from the same farthest-point start
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    km = KMeans(k=LIBS_KMEANS_K, maxIter=LIBS_KMEANS_ITERS,
                seed=LIBS_KMEANS_SEED).fit(df)
    wall = time.perf_counter() - t0
    # the estimator's farthest-point start, each point's distance to the
    # nearest chosen centre kept as centres are added (the same floats
    # as its min over all chosen centres, in k passes instead of k^2/2)
    rs = np.random.RandomState(LIBS_KMEANS_SEED)
    centers = [X[rs.randint(len(X))]]
    d = np.sum((X - centers[0]) ** 2, axis=1)
    for _ in range(1, LIBS_KMEANS_K):
        centers.append(X[int(np.argmax(d))])
        d = np.minimum(d, np.sum((X - centers[-1]) ** 2, axis=1))
    init = np.stack(centers)
    with CudaTimer() as ct:
        _, assign = MK._lloyd(Xt, to_device(df, init), LIBS_KMEANS_K,
                              LIBS_KMEANS_ITERS)
    x2 = np.sum(X * X, axis=1, keepdims=True)

    def dist(C):
        return x2 - 2.0 * (X @ C.T) + np.sum(C * C, axis=1)[None, :]

    C = init
    for _ in range(LIBS_KMEANS_ITERS):
        a = np.argmin(dist(C), axis=1)
        cnt = np.bincount(a, minlength=LIBS_KMEANS_K).astype(np.float64)
        tot = np.stack([np.bincount(a, weights=X[:, j],
                                    minlength=LIBS_KMEANS_K)
                        for j in range(X.shape[1])], axis=1)
        C = np.where((cnt > 0)[:, None], tot / np.maximum(cnt, 1.0)[:, None],
                     C)
    err = libs_close("KMeans centres against numpy", km.cluster_centers, C,
                     1e-9)
    dd = np.sort(dist(C), axis=1)
    clear = (dd[:, 1] - dd[:, 0]) > 1e-9
    got_a = assign.cpu().numpy()
    want_a = np.argmin(dist(C), axis=1)
    if not np.array_equal(got_a[clear], want_a[clear]):
        raise AssertionError("KMeans assignments differ from numpy")
    libs_line(f"KMeans (k={LIBS_KMEANS_K}, {LIBS_KMEANS_ITERS} iterations)",
              wall, collect_s, ct.ms,
              f"; centres within {err:.3g} of numpy; assignments equal on "
              f"{int(clear.sum()):,} rows ({int((~clear).sum()):,} within "
              f"1e-9 of a tie); cluster sizes "
              f"{np.bincount(got_a, minlength=LIBS_KMEANS_K).tolist()}")


def libs_graph(session, n_rows, n_vertices):
    """Phase 21, graph: customers and suppliers, one edge per lineitem row
    from its order's customer to its supplier; PageRank against numpy,
    connected components against scipy."""
    import numpy as np
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as sp_cc
    from spark_tpu_torch.graph import Graph, connected_components, page_rank
    t0 = time.perf_counter()
    edges = session.sql(
        f"SELECT o_custkey AS src, l_suppkey + {LIBS_SUPPLIER_BASE} AS dst "
        f"FROM lineitem JOIN orders ON l_orderkey = o_orderkey").to_pandas()
    verts = session.sql(
        f"SELECT c_custkey AS id FROM customer UNION ALL "
        f"SELECT s_suppkey + {LIBS_SUPPLIER_BASE} AS id FROM supplier"
    ).to_pandas()
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = Graph(verts, edges, device=session.device)
    build_s = time.perf_counter() - t0
    n, m = g.num_vertices, g.num_edges
    if (n, m) != (n_vertices, n_rows):
        raise AssertionError(f"libs graph: {n} vertices, {m} edges")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CudaTimer() as ct:
        pr = page_rank(g, num_iter=LIBS_PAGERANK_ITERS)
    wall = time.perf_counter() - t0
    src, dst = g.src.cpu().numpy(), g.dst.cpu().numpy()
    deg = np.bincount(src, minlength=n).astype(np.float64)
    safe = np.where(deg == 0, 1.0, deg)
    r = np.full(n, 1.0 / n)
    for _ in range(LIBS_PAGERANK_ITERS):
        inflow = np.bincount(dst, weights=(r / safe)[src], minlength=n)
        r = 0.15 / n + 0.85 * (inflow + r[deg == 0].sum() / n)
    err = libs_close("PageRank against numpy", pr["pagerank"].to_numpy(),
                     r * n, 1e-10)
    total = float(pr["pagerank"].sum())
    if not np.isclose(total, n, rtol=1e-10):
        raise AssertionError(f"PageRank sums to {total}, not {n}")
    libs_line(f"page_rank ({n:,} vertices, {m:,} edges, "
              f"{LIBS_PAGERANK_ITERS} iterations)", wall, collect_s, ct.ms,
              f"; graph built in {build_s:.3f} s; ranks within {err:.3g} of "
              f"numpy, sum {total:.6f}; no host read in the loop")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CudaTimer() as ct:
        cc = connected_components(g)
    wall = time.perf_counter() - t0
    ncomp, lab = sp_cc(coo_matrix((np.ones(m), (src, dst)), shape=(n, n)),
                       directed=False)
    first = {}
    for i, c in enumerate(lab):
        first.setdefault(c, g.vertex_ids[i])
    want = np.array([first[c] for c in lab])
    if not np.array_equal(cc["component"].to_numpy(), want) or \
            cc["component"].nunique() != ncomp:
        raise AssertionError("connected_components differ from scipy")
    stats = g.pregel_stats
    libs_line(f"connected_components ({ncomp:,} components)", wall,
              collect_s, ct.ms,
              f"; labels equal scipy's; {stats['supersteps']} supersteps, "
              f"{stats['host_reads']} host reads")


def phase_libs(S, path, device="cuda:0") -> None:
    """Phase 21: the ML and graph libraries on a CUDA session over the
    TPC-H SF1 tables (6,001,215 lineitem rows, 150,000 customers and
    10,000 suppliers, read from the Parquet metadata)."""
    import pyarrow.parquet as pq
    from spark_tpu_torch.tpch.queries import register_tables
    session = S.SparkTpuSession.builder().device(device).get_or_create()
    register_tables(session, path)

    def rows(table):
        import os
        return pq.ParquetFile(os.path.join(path, f"{table}.parquet")) \
            .metadata.num_rows

    n_rows = rows("lineitem")
    t0 = time.perf_counter()
    libs_ml(session, n_rows)
    log(f"[libs] ml in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    libs_graph(session, n_rows, rows("customer") + rows("supplier"))
    log(f"[libs] graph in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 22: the mesh across engine processes
# ---------------------------------------------------------------------------

#: phase 22: the engine processes (each drives MESH_SHARDS / 2 shards),
#: the one-card run's SQL queries (the range group-by besides), the bound
#: within which every process must leave a failed run, the delay of the
#: kill after rank 1's mark, and the four-card run's cards a process
CLUSTER_PROCESSES = 2
CLUSTER_QUERIES = ("q1", "q3", "q5", "q6")
CLUSTER_BOUND_S = 30.0
CLUSTER_KILL_DELAY_S = 2.0
CLUSTER_CARDS = ("0,1", "2,3")
RESTART_KEY = "spark_tpu.execution.meshRestart.enabled"
FALLBACK_KEY = "spark_tpu.execution.meshFallback.enabled"
#: phase 22's SF10 stream cases: the position rank 1 drains, the one it
#: slows at the `shard_chunk` seam (its own; the straggler's chunks are
#: phase 16's, 2^22 rows), and the label of the one-process pinned stream
#: whose kernel inputs stand for a shard's chunk in the two processes
CLUSTER_DRAIN_POSITION = 3
CLUSTER_SLOW_POSITION = 3
CLUSTER_STREAM_LABEL = "cluster stream"


def cluster_stats_snapshot() -> dict:
    from spark_tpu_torch.parallel.cluster import CLUSTER_STATS
    return {k: list(v) for k, v in CLUSTER_STATS.items()}


def cluster_crossed(before, after) -> dict:
    """Per collective tag, the bytes this process received from its peer
    and the seconds its process-group calls took, between two
    snapshots."""
    out = {}
    for k, v in after.items():
        b = before.get(k, [0, 0, 0, 0.0, 0])
        if v[1] - b[1] > 0:
            out[k] = [v[1] - b[1], v[3] - b[3]]
    return out


def cluster_cases(session, queries, with_range, sf10_session=None):
    """(name, make) of each case phase 22 runs on `session`."""
    from spark_tpu_torch import functions as F
    from spark_tpu_torch.functions import col
    from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
    cases = [(q, lambda q=q: session.sql(SQL_QUERIES[q])) for q in queries]
    if with_range:
        cases.append(("range", lambda: session.range(RANGE_ROWS).group_by(
            col("id") % RANGE_MOD).agg(F.count(), F.sum(col("id")),
                                       F.avg(col("id")))))
    if sf10_session is not None:
        cases += [(f"sf{OOC_SF} {q}",
                   lambda q=q: sf10_session.sql(SQL_QUERIES[q]))
                  for q in ("q1", "q6")]
    return cases


def cluster_child(session, proc):
    """Phase 22's program in each engine process (started by
    `spark_tpu_torch.parallel.launch.run_cluster`): args["queries"] (SQL)
    over the TPC-H tables at args["path"], the range group-by with
    args["range"], and SF10 Q1/Q6 resident with args["sf10"], each at
    mesh.size MESH_SHARDS a first run (device cache and kept capacities
    emptied) and a warm run, which must give the first run's bytes and
    take no recovery action. With
    args["faults"], then `mesh:fatal:1` in rank 1 alone on Q1: with the
    gang restart on, and with both rungs off. With args["stream"] (the
    SF10 lineitem path), then `cluster_stream_cases`. Returns each first
    run's result; the report holds each run's wall, the bytes that
    crossed processes in the warm run, the launches. With
    args["kill"], last, rank 1 saves its report and sleeps at the `mesh`
    seam of SQL Q6, where the parent kills it; rank 0 waits at the
    query's first collective and must raise the named mesh failure."""
    import gc
    import torch
    from spark_tpu_torch.execution import dense_groupby as D
    from spark_tpu_torch.io.device_cache import CACHE
    from spark_tpu_torch.tpch.queries import register_tables
    args = proc.args
    register_tables(session, args["path"])
    sf10_session = None
    if args.get("sf10"):
        sf10_session = cluster_sf10_session(session, args["sf10"])
    for s in (session, sf10_session):
        if s is not None:
            s.conf.set(MESH_KEY, MESH_SHARDS)
            if args.get("cache_bytes"):
                s.conf.set(CACHE_KEY, args["cache_bytes"])
    results, runs = {}, {}
    for name, make in cluster_cases(session, args["queries"],
                                    args.get("range"), sf10_session):
        for s in (session, sf10_session):
            if s is not None:
                reset_state(s)
        gc.collect()
        torch.cuda.empty_cache()
        rec = {}
        for run in ("first", "warm"):
            before, l0 = cluster_stats_snapshot(), dict(D.LAUNCHES)
            t0 = time.perf_counter()
            qe = make()._qe()
            got = qe.collect()
            torch.cuda.synchronize()
            rec[run] = time.perf_counter() - t0
            if qe.fault_summary:
                raise AssertionError(f"{name} {run}: {qe.fault_summary}")
            if run == "first":
                results[name] = got
                rec["launches"] = {k: v - l0.get(k, 0)
                                   for k, v in D.LAUNCHES.items()}
                rec["attempts"] = qe.attempts
            else:
                rec["crossed"] = cluster_crossed(before,
                                                 cluster_stats_snapshot())
                if not got.equals(results[name]):
                    raise AssertionError(f"{name}: the warm run's bytes "
                                         f"differ from the first run's")
        runs[name] = rec
    CACHE.clear()
    if args.get("faults"):
        from spark_tpu_torch.testing import faults
        from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
        spec = "mesh:fatal:1" if proc.rank == 1 else ""
        for label, confs in (("restart", ((RESTART_KEY, True),)),
                             ("raise", ((RESTART_KEY, False),
                                        (FALLBACK_KEY, False)))):
            for k, v in confs:
                session.conf.set(k, v)
            rec = {}
            t0 = time.perf_counter()
            with faults.inject(session.conf, spec):
                qe = session.sql(SQL_QUERIES["q1"])._qe()
                try:
                    results[f"fault {label}"] = qe.collect()
                    rec["faults"] = qe.fault_summary
                except Exception as e:  # noqa: BLE001 — the parent checks
                    rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
            rec["wall_s"] = time.perf_counter() - t0
            runs[f"fault {label}"] = rec
            for k, _v in confs:
                session.conf.unset(k)
    proc.report["runs"] = runs
    if args.get("stream"):
        results.update(cluster_stream_cases(D, session, proc,
                                            args["stream"]))
    proc.report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if args.get("kill"):
        from spark_tpu_torch.testing import faults
        from spark_tpu_torch.tpch.sql_queries import SQL_QUERIES
        if proc.rank == 1:
            proc.save(results)
        spec = "mesh:slow:1:120000" if proc.rank == 1 else ""
        kill = {}
        with faults.inject(session.conf, spec):
            proc.mark("kill")
            try:
                session.sql(SQL_QUERIES["q6"]).collect()
                kill["outcome"] = "finished"
            except Exception as e:  # noqa: BLE001 — the parent checks
                kill["outcome"] = type(e).__name__
                kill["message"] = str(e)[:200]
        kill["raised_at"] = time.time()
        proc.report["kill"] = kill
    return results


def cluster_sf10_session(session, path, confs=()):
    """A session of this engine process, joined to its cluster (pinned
    where `session` is), over SF10 lineitem at mesh.size MESH_SHARDS."""
    from spark_tpu_torch.io.sources import ParquetSource
    builder = type(session).builder()
    if session.device_pinned:
        builder = builder.device(session.device)
    for key in ("coordinator", "numProcesses", "processId"):
        key = f"spark_tpu.sql.cluster.{key}"
        builder = builder.config(key, session.conf.get(key))
    s = builder.get_or_create()
    s.conf.set(MESH_KEY, MESH_SHARDS)
    for key, value in confs:
        s.conf.set(key, value)
    s.register_table("lineitem", ParquetSource(path, "lineitem"))
    return s


def cluster_stream_cases(D, session, proc, path) -> dict:
    """Phase 22's mesh stream in each engine process, SQL Q1 over SF10
    lineitem at mesh.size MESH_SHARDS (the device cache at its default,
    below the scan, so Q1 streams per shard; the per-shard telemetry on),
    each case on a fresh session: the stream; then, in 2^22-row chunks
    (a replay or a resume's skip covers less), a drain of
    CLUSTER_DRAIN_POSITION requested from a listener in rank 1 alone
    once chunk 1's records are posted; CLUSTER_SLOW_POSITION slowed
    ELASTIC_SLOW_MS at the `shard_chunk` seam every chunk in rank 1
    alone; and `mesh_checkpoint:fatal:2` in rank 1 alone with a
    checkpoint every chunk. Returns each case's result;
    `proc.report["stream"]` holds what the parent checks."""
    from spark_tpu_torch.observability import QueryListener
    counters = ("rec_chunks_replayed", "rebalance_rows",
                "mesh_restart_attempts")
    watched = {"chunk": None, "flags": []}

    class Watcher(QueryListener):
        drain = False

        def on_shard_records(self, event):
            watched["chunk"] = event.chunk
            if self.drain and proc.rank == 1 and event.chunk >= 1:
                self.drain = False
                self.session.decommission_shards([CLUSTER_DRAIN_POSITION])

        def on_straggler(self, event):
            watched["flags"].append([event.shard, watched["chunk"]])

    slow = ",".join(
        f"shard_chunk:slow:{c * MESH_SHARDS + CLUSTER_SLOW_POSITION + 1}:"
        f"{ELASTIC_SLOW_MS}" for c in range(64))
    small = ((CHUNK_KEY, ELASTIC_SLOW_CHUNK_ROWS),)
    cases = (("stream", (), ""),
             ("drain", small, ""),
             ("straggler", small, slow),
             ("fault", small + ((CKPT_KEY, 1),), "mesh_checkpoint:fatal:2"))
    results, report = {}, {}
    for label, confs, spec in cases:
        s = cluster_sf10_session(session, path,
                                 ((SPANS_KEY, "on"),) + confs)
        watcher = Watcher()
        watcher.session = s
        watcher.drain = label == "drain"
        watched["flags"] = []
        s.add_listener(watcher)
        before = {k: s.metrics.counter(k).value for k in counters}
        l0 = dict(D.LAUNCHES)
        got, qe, seconds, fired = run_q1(s, spec if proc.rank == 1 else "")
        results[f"stream {label}"] = got
        report[label] = {
            "wall_s": seconds, "fired": [list(f) for f in fired],
            "faults": qe.fault_summary,
            # each process jitters its own backoff
            "events": [{k: v for k, v in ev.items()
                        if k not in ("error", "backoff_ms")}
                       for ev in qe.fault_events],
            "delta": {k: s.metrics.counter(k).value - before[k]
                      for k in counters},
            "launches": {k: v - l0.get(k, 0) for k, v in D.LAUNCHES.items()},
            # the last stream's chunks: a failed attempt's count depends on
            # when each process saw the abort
            "chunks": len(qe.stream_stats[-1]["chunks"]),
            "folded": n_chunks(qe),
            "spliced": qe.spliced_plan.tree_string(),
            "flags": list(watched["flags"]),
            "after": [int(s.conf.get(MESH_KEY)),
                      str(s.conf.get("spark_tpu.sql.mesh.excludeDevices"))],
            "chunk_records": mesh_chunk_records(qe)}
        s.remove_listener(watcher)
        del s, qe
    proc.report["stream"] = report
    return results


def cluster_launch(program, out, args, timeout_s, **kw):
    from spark_tpu_torch.parallel.launch import run_cluster
    t0 = time.perf_counter()
    res = run_cluster(f"chip_smoke:{program}", CLUSTER_PROCESSES, out,
                      args=args, timeout_s=timeout_s, **kw)
    return res, time.perf_counter() - t0


def cluster_require(res, backend, killed=None) -> None:
    """Every rank exited 0 (the `killed` rank by SIGKILL) with no error,
    no JAX module, and its tensors over `backend`."""
    for r in res:
        err = r.report.get("error")
        if r.returncode != (-9 if r.rank == killed else 0) or err:
            raise AssertionError(
                f"cluster rank {r.rank} exited {r.returncode}: "
                f"{(err or {}).get('traceback', '')}\n{r.log[-4000:]}")
        if r.report["bad_modules"]:
            raise AssertionError(f"rank {r.rank} loaded "
                                 f"{r.report['bad_modules']}")
        if r.report["backends"] != [backend]:
            raise AssertionError(f"rank {r.rank} moved tensors over "
                                 f"{r.report['backends']}, not {backend}")


def cluster_lines(tag, res, kernels) -> dict:
    """Print each rank's start, walls, crossed bytes and launches; check
    each case's kernel launched once per local shard at least in every
    rank. Returns the launches summed over the ranks."""
    total = {}
    for r in res:
        rep = r.report
        log(f"[cluster] {tag} rank {r.rank} (pid {rep['pid']}, "
            f"{rep['device']}): backend {rep['backends'][0]}, "
            f"init_process_group {rep['init_s']:.3f} s, spawn to ready "
            f"{rep['ready_s']:.3f} s, ended after {r.wall_s:.1f} s; "
            f"max_memory_allocated {rep['max_memory_allocated']:,} bytes; "
            f"launches {rep['launches']}; peer-copy bytes in the process "
            f"{ {k: v[0] for k, v in rep['copy_stats'].items()} }; no JAX "
            f"module")
        for k, v in rep["launches"].items():
            total[k] = total.get(k, 0) + v
        for name, rec in rep["runs"].items():
            if name.startswith("fault "):
                continue
            crossed = sum(b for b, _s in rec["crossed"].values())
            rates = "; ".join(
                f"{k} {b:,} B at {b / s / 1e9:.2f} GB/s" if s > 0
                else f"{k} {b:,} B" for k, (b, s) in sorted(
                    rec["crossed"].items(), key=lambda kv: -kv[1][0])[:4])
            log(f"[cluster] {tag} rank {r.rank} {name}: first run "
                f"{rec['first']:.3f} s (attempts {rec['attempts']}), warm "
                f"run {rec['warm']:.3f} s; warm run received {crossed:,} "
                f"bytes from the peer process ({rates}); launches "
                f"{rec['launches']}")
            for kernel in kernels.get(name) or ():
                if rec["launches"].get(kernel, 0) < MESH_SHARDS // \
                        CLUSTER_PROCESSES:
                    raise AssertionError(
                        f"{tag} rank {r.rank} {name}: {kernel} launched "
                        f"{rec['launches']}, fewer than its shards")
    return total


def cluster_check_results(tag, res, G, path, refs, sf10_ans=None) -> None:
    """Every rank's result of every case against its golden, and equal in
    bytes to the one-process result `refs` holds, where it holds one."""
    for r in res:
        for name, got in r.results.items():
            if name.startswith("stream "):
                continue  # cluster_stream_check's
            if name.startswith("fault "):
                mesh_golden(G, path, "q1", got)
            elif name == "range":
                mesh_range_check(got)
            elif name.startswith("sf"):
                check_q1_q6(name.split()[-1], got, sf10_ans)
            else:
                mesh_golden(G, path, name, got)
            if name in refs and not got.equals(refs[name]):
                raise AssertionError(f"{tag} rank {r.rank} {name}: not the "
                                     f"one-process mesh's bytes")


def cluster_stream_check(tag, res, ans, ref) -> None:
    """Phase 22's SF10 stream cases in both ranks: each result at the
    exact golden (and in bytes the one-process pinned stream's `ref`,
    where given), the same outcome in both ranks (fault summary, events,
    chunks, counter deltas, straggler flags, mesh.size and exclusions
    after), dense_sums_smem launched in both for every local shard and
    chunk of the stream. Prints per rank and chunk of the stream its
    decode, stripe copy, update and agreement ms."""
    reps = [r.report["stream"] for r in res]
    local = MESH_SHARDS // CLUSTER_PROCESSES
    for label in reps[0]:
        a, b = (rep[label] for rep in reps)
        for key in ("faults", "events", "chunks", "delta", "flags",
                    "after"):
            if a[key] != b[key]:
                raise AssertionError(f"{tag} stream {label}: the ranks "
                                     f"differ in {key}: {a[key]} / {b[key]}")
        for r, rep in zip(res, reps):
            got = r.results[f"stream {label}"]
            check_q1_q6("q1", got, ans)
            if ref is not None and not got.equals(ref):
                raise AssertionError(f"{tag} rank {r.rank} stream {label}: "
                                     f"not the one-process stream's bytes")
            if "InputExec(streamed_partial_agg," not in \
                    rep[label]["spliced"]:
                raise AssertionError(f"{tag} stream {label} did not stream "
                                     f"per shard: {rep[label]['spliced']}")
            want = local * (rep[label]["chunks"] if label == "stream" else 1)
            if rep[label]["launches"].get("dense_sums_smem", 0) < want:
                raise AssertionError(
                    f"{tag} rank {r.rank} stream {label}: dense_sums_smem "
                    f"launched {rep[label]['launches']}, fewer than {want}")
    st, dr, sg, ft = (reps[0][k] for k in ("stream", "drain", "straggler",
                                           "fault"))
    drained = [e for e in dr["events"] if e["action"] == "checkpoint_restore"]
    restore = [e for e in ft["events"] if e["action"] == "checkpoint_restore"]
    if st["faults"] or st["chunks"] < 2:
        raise AssertionError(f"{tag} stream: {st['faults']}, "
                             f"{st['chunks']} chunks")
    if dr["faults"] != {"decommission": 1, "checkpoint_restore": 1} or \
            dr["after"] != [MESH_SHARDS - 1, str(CLUSTER_DRAIN_POSITION)]:
        raise AssertionError(f"{tag} drain: {dr['faults']}, mesh.size and "
                             f"exclusions after {dr['after']}")
    if sg["faults"] != {"shard_rebalance": 1} or \
            sg["delta"]["rebalance_rows"] <= 0 or not sg["flags"] or \
            any(f[0] != CLUSTER_SLOW_POSITION for f in sg["flags"]):
        raise AssertionError(f"{tag} straggler: {sg['faults']}, "
                             f"{sg['delta']}, flags {sg['flags']}")
    if ft["faults"] != {"mesh_restart": 1, "checkpoint_restore": 1} or \
            len(restore) != 1 or restore[0].get("driver") != "mesh" or \
            restore[0]["chunks_replayed"] > 1:
        raise AssertionError(f"{tag} fault: {ft['faults']}, {restore}")
    for r, rep in zip(res, reps):
        walls = ", ".join(f"{k} {v['wall_s']:.3f} s ({v['folded']} chunks, "
                          f"dense_sums_smem "
                          f"{v['launches'].get('dense_sums_smem', 0)})"
                          for k, v in rep.items())
        log(f"[cluster] {tag} rank {r.rank} SF{OOC_SF} q1 mesh-streamed: "
            f"{walls}")
        lines = "; ".join(
            f"chunk {i}: decode {c['decode']:.1f}, stripe copy "
            f"{c['stripe']:.1f}, update {c['update']:.1f} (device "
            f"{'/'.join(f'{x:.2f}' for x in c['device'])}), agreement "
            f"{c['agree']:.1f}"
            for i, c in enumerate(rep["stream"]["chunk_records"]))
        log(f"[cluster] {tag} rank {r.rank} stream chunks, ms: {lines}")
    log(f"[cluster] {tag} SF{OOC_SF} q1 stream in both ranks at the exact "
        f"golden{'' if ref is None else ' and the one-process bytes'}; "
        f"drain of position {CLUSTER_DRAIN_POSITION} from rank 1 alone: "
        f"both drained at chunk {drained[0]['cursor']}, mesh.size "
        f"{dr['after'][0]}; straggler (position {CLUSTER_SLOW_POSITION} "
        f"slowed {ELASTIC_SLOW_MS} ms a chunk in rank 1 alone): both flagged "
        f"{sg['flags']} ([position, chunk]), rebalance_rows "
        f"{sg['delta']['rebalance_rows']:,} in each; mesh_checkpoint:fatal:2 "
        f"in rank 1 alone: both restarted at cursor {restore[0]['cursor']}, "
        f"replaying {restore[0]['chunks_replayed']} chunk(s)")


def cluster_faults(res) -> None:
    """The same outcome in both ranks: a gang restart to the golden, then
    the fault raised in both within CLUSTER_BOUND_S."""
    runs = [r.report["runs"] for r in res]
    for rr in runs:
        if rr["fault restart"].get("faults") != {"mesh_restart": 1}:
            raise AssertionError(f"mesh:fatal:1 in rank 1 with the restart "
                                 f"on: {[x['fault restart'] for x in runs]}")
        if not rr["fault raise"].get("error", "").startswith(
                "FaultInjected") or \
                rr["fault raise"]["wall_s"] > CLUSTER_BOUND_S:
            raise AssertionError(f"mesh:fatal:1 in rank 1 with both rungs "
                                 f"off: {[x['fault raise'] for x in runs]}")
    if runs[0]["fault raise"]["error"] != runs[1]["fault raise"]["error"]:
        raise AssertionError("the ranks raised different errors")
    log(f"[cluster] mesh:fatal:1 in rank 1 alone on q1: both ranks "
        f"gang-restarted (fault_summary {runs[0]['fault restart']['faults']}"
        f", {runs[0]['fault restart']['wall_s']:.3f} and "
        f"{runs[1]['fault restart']['wall_s']:.3f} s) to the golden; with "
        f"both rungs off both raised {runs[0]['fault raise']['error'][:60]}"
        f" after {runs[0]['fault raise']['wall_s']:.3f} and "
        f"{runs[1]['fault raise']['wall_s']:.3f} s (bound "
        f"{CLUSTER_BOUND_S:.0f} s)")


def cluster_kill(res) -> None:
    """Rank 1 killed with SIGKILL mid-query: rank 0 raised the named mesh
    failure within CLUSTER_BOUND_S."""
    survivor, killed = res
    rep = survivor.report["kill"]
    after = rep["raised_at"] - killed.report["killed_at"]
    if rep["outcome"] != "ClusterPeerLostError" or \
            not 0 <= after < CLUSTER_BOUND_S:
        raise AssertionError(f"kill -9 of rank 1: rank 0 {rep}, "
                             f"{after:.3f} s after the kill")
    log(f"[cluster] kill -9 of rank 1 mid-query ({CLUSTER_KILL_DELAY_S} s "
        f"after its mark, asleep at q6's mesh seam): rank 0 raised "
        f"ClusterPeerLostError {after:.3f} s after the kill (bound "
        f"{CLUSTER_BOUND_S:.0f} s): {rep['message'][:120]}")


def phase_cluster(D, S, G, path, launches, current, captured, sf10,
                  mesh_refs, cluster_stream, own_stream_ref) -> None:
    """Phase 22: the mesh across engine processes. On every run, two
    processes each pinned to cuda:0 with two shards (mesh.size 4, over
    gloo): SQL Q1, Q3, Q5, Q6 and the range group-by at SF1 against the
    goldens and the one-process pinned mesh-4 run's bytes (phase 14's
    first runs, `mesh_refs`, or this phase's own when phase 14 did not
    run), a fault in one process, SF10 Q1 mesh-streamed with a drain, a
    straggler and a checkpointed restart (`cluster_stream_cases`), and a
    killed process. With 4 cards, two processes with two cards each
    (over NCCL): the 22 SQL queries and SF10 Q1/Q6 resident, the fault,
    the stream cases and the kill over NCCL. The stream's results go to
    `cluster_stream` for phase 16, which holds them to its one-process
    pinned stream's bytes and lends its kernel inputs to the
    CLUSTER_STREAM_LABEL row; with `own_stream_ref` (phase 16 does not
    run) this phase runs that one-process stream itself."""
    import gc
    import os
    import torch
    from spark_tpu_torch.io.device_cache import CACHE
    t0 = time.perf_counter()
    sf10_path, ans = sf10.get("cluster")
    stream_ref = None
    if own_stream_ref:
        t1 = time.perf_counter()
        session = elastic_session(S, sf10_path, pinned=True)
        current[0] = CLUSTER_STREAM_LABEL
        zero_launches(D)
        stream_ref, _qe, seconds, _ = run_q1(session)
        current[0] = None
        check_q1_q6("q1", stream_ref, ans)
        del session, _qe
        log(f"[cluster] the one-process pinned mesh-{MESH_SHARDS} SF{OOC_SF} "
            f"q1 stream: {seconds:.3f} s, launches {dict(D.LAUNCHES)}; "
            f"{time.perf_counter() - t1:.1f} s")
    if not mesh_refs:
        session = mesh_session(S, path, pinned=True)
        for name, make in cluster_cases(session, CLUSTER_QUERIES, True):
            label = f"phase22 {name}"
            reset_state(session)
            current[0] = label
            zero_launches(D)
            mesh_refs[name] = (make().collect(), label)
            torch.cuda.synchronize()
            current[0] = None
            launches[label] = dict(D.LAUNCHES)
        del session
        log(f"[cluster] the one-process pinned mesh-{MESH_SHARDS} "
            f"references in {time.perf_counter() - t0:.1f} s")
    refs = {name: table for name, (table, _label) in mesh_refs.items()}
    CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    kernels = {q: (MESH_KERNELS[q],) if MESH_KERNELS[q] else ()
               for q in CLUSTER_QUERIES}
    kernels["range"] = ("dense_sums_global",)
    with tempfile.TemporaryDirectory() as tmp:
        res, wall = cluster_launch(
            "cluster_child", os.path.join(tmp, "one"),
            {"path": path, "queries": list(CLUSTER_QUERIES), "range": True,
             "faults": True, "stream": sf10_path, "kill": True}, 900,
            device="cuda:0", kill_at=(1, "kill", CLUSTER_KILL_DELAY_S))
        cluster_require(res, "gloo", killed=1)
        total = cluster_lines("one card", res, kernels)
        cluster_check_results("one card", res, G, path, refs)
        cluster_faults(res)
        cluster_stream_check("one card", res, ans, stream_ref)
        cluster_stream["results"] = [r.results["stream stream"] for r in res]
        launches[CLUSTER_STREAM_LABEL] = {"dense_sums_smem": sum(
            r.report["stream"]["stream"]["launches"]["dense_sums_smem"]
            for r in res)}
        cluster_kill(res)
        log(f"[cluster] one card: {CLUSTER_PROCESSES} processes x "
            f"{MESH_SHARDS // CLUSTER_PROCESSES} shards on cuda:0 match the "
            f"goldens and the one-process mesh's bytes; {wall:.1f} s with "
            f"the starts")
        require_kernels("phase 22's processes", ("dense_sums_smem",
                                                  "dense_sums_global"),
                        total)
        for r in res:
            require_kernels(f"phase 22 rank {r.rank}", (
                "dense_sums_smem", "dense_sums_global"), r.report["launches"])
        launches["cluster"] = total
        captured[("cluster", "dense_sums_smem")] = captured[
            (mesh_refs["q1"][1], "dense_sums_smem")]
        captured[("cluster", "dense_sums_global")] = captured[
            (mesh_refs["range"][1], "dense_sums_global")]
        log(f"[cluster] one card: {time.perf_counter() - t0:.1f} s")
        if torch.cuda.device_count() < 2 * CLUSTER_PROCESSES:
            log(f"[cluster] {torch.cuda.device_count()} card(s): the "
                f"two-cards-a-process cases run on a host with "
                f"{2 * CLUSTER_PROCESSES} cards (--phases cluster)")
            return
        t1 = time.perf_counter()
        res, wall = cluster_launch(
            "cluster_child", os.path.join(tmp, "cards"),
            {"path": path, "queries": list(SQL_KERNELS), "range": False,
             "sf10": sf10_path, "cache_bytes": MESH_CACHE_BYTES,
             "faults": True, "stream": sf10_path, "kill": True}, 1500,
            visible_devices=CLUSTER_CARDS,
            kill_at=(1, "kill", CLUSTER_KILL_DELAY_S))
        cluster_require(res, "nccl", killed=1)
        kernels = {q: (k,) if k else () for q, k in SQL_KERNELS.items()}
        kernels.update({f"sf{OOC_SF} q1": ("dense_sums_smem",),
                        f"sf{OOC_SF} q6": ("dense_sums_smem",)})
        cluster_lines("4 cards", res, kernels)
        cluster_check_results("4 cards", res, G, path, {}, ans)
        cluster_faults(res)
        cluster_stream_check("4 cards", res, ans, stream_ref)
        cluster_stream["results"] += [r.results["stream stream"]
                                      for r in res]
        cluster_kill(res)
        log(f"[cluster] 4 cards: {CLUSTER_PROCESSES} processes x 2 cards "
            f"(CUDA_VISIBLE_DEVICES {', '.join(CLUSTER_CARDS)}) over NCCL: "
            f"the 22 SQL queries and SF{OOC_SF} Q1/Q6 resident match the "
            f"goldens, the fault, the SF{OOC_SF} stream with its drain, "
            f"straggler and restart, and the kill end both alike; "
            f"{wall:.1f} s with the starts; {time.perf_counter() - t1:.1f} "
            f"s in all")


def run_phases(D, phases):
    """The main-path phases chosen (5-12); returns the per-kernel launch
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
            # gives dense_sums_global two domains), the last call's data;
            # on a mesh each card's, the shard with the most kept rows
            # (a shard of padding rows alone is not the main path's input)
            shape = (idx.shape[0], domain, len(int_rows), len(float_rows))
            if current[0].startswith(("mesh ", "elastic ")):
                shape += (str(idx.device),)
            kept = int(((idx >= 0) & (idx < domain)).sum())
            inputs = captured.setdefault((current[0], kernel), {})
            if shape not in inputs or inputs[shape][4] <= kept:
                inputs[shape] = (idx, list(int_rows), list(float_rows),
                                 domain, kept)
        return original(idx, int_rows, float_rows, domain, int_widths)

    D.dense_groupby_sums = recording
    launches = {}
    #: phase 22's SF10 stream results, phase 16 holds them to its own
    cluster_stream = {}
    sf10_dir = tempfile.TemporaryDirectory()
    sf10 = Sf10(sf10_dir.name)
    if {"ooc", "mesh", "elastic", "cluster"} & phases:
        sf10.start()
    try:
        if {"main", "sql", "functions", "etl", "ooc", "udf", "mesh",
                "obs", "stream", "analysis", "serve", "fleet",
                "libs", "cluster"} & phases:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                path = write_parquet(tmp + "/tpch", SF)
                log(f"[main] TPC-H SF{SF} generated in "
                    f"{time.perf_counter() - t0:.1f} s")
                df_results = None
                #: phase 6's first-run result of each SQL query
                sql_results = {}
                if "main" in phases:
                    t0 = time.perf_counter()
                    df_results = phase_dataframes(D, S, Q, path, launches,
                                                  current)
                    log(f"[main] phase in {time.perf_counter() - t0:.1f} s")
                if "sql" in phases:
                    t0 = time.perf_counter()
                    phase_sql(D, S, G, path, df_results, launches, current,
                              sql_results)
                    log(f"[sql] phase in {time.perf_counter() - t0:.1f} s")
                if "functions" in phases:
                    t0 = time.perf_counter()
                    phase_functions(D, S, ["f1", "f2"], path, launches,
                                    current)
                    log(f"[functions] f1, f2 in "
                        f"{time.perf_counter() - t0:.1f} s")
                if "etl" in phases:
                    t0 = time.perf_counter()
                    phase_etl(D, S, path, launches, current)
                    log(f"[etl] phase in {time.perf_counter() - t0:.1f} s")
                if "ooc" in phases:
                    t0 = time.perf_counter()
                    phase_ooc(D, S, path, launches, current, captured,
                              sf10)
                    log(f"[ooc] phase in {time.perf_counter() - t0:.1f} s")
                if "udf" in phases:
                    t0 = time.perf_counter()
                    phase_udf(D, S, path, launches, current, captured)
                    log(f"[udf] phase in {time.perf_counter() - t0:.1f} s")
                #: phase 14's pinned first runs, phase 22's references
                mesh_refs = {}
                if "mesh" in phases:
                    t0 = time.perf_counter()
                    phase_mesh(D, S, G, path, df_results, launches, current,
                               sf10, mesh_refs)
                    log(f"[mesh] phase in {time.perf_counter() - t0:.1f} s")
                if "obs" in phases:
                    # its kernel inputs are main's and sql's when those ran
                    phase_obs(D, S, G, path, launches, current,
                              capture=not {"main", "sql"} & phases)
                if "stream" in phases:
                    t0 = time.perf_counter()
                    phase_stream(D, S, path, tmp, launches, current)
                    log(f"[stream] phase in "
                        f"{time.perf_counter() - t0:.1f} s")
                if "analysis" in phases:
                    t0 = time.perf_counter()
                    phase_analysis(D, S, G, path, tmp, sql_results,
                                   launches)
                    log(f"[analysis] phase in "
                        f"{time.perf_counter() - t0:.1f} s")
                #: phase 19's references and served p50s, for phase 20
                served = None
                if "serve" in phases:
                    t0 = time.perf_counter()
                    served = phase_serve(D, S, G, path, tmp, sql_results,
                                         launches, current)
                    log(f"[serve] phase in {time.perf_counter() - t0:.1f} s")
                if "fleet" in phases:
                    t0 = time.perf_counter()
                    phase_fleet(D, S, G, path, tmp, sql_results, launches,
                                current, captured, served)
                    log(f"[fleet] phase in {time.perf_counter() - t0:.1f} s")
                if "libs" in phases:
                    t0 = time.perf_counter()
                    phase_libs(S, path)
                    log(f"[libs] phase in {time.perf_counter() - t0:.1f} s")
                if "cluster" in phases:
                    t0 = time.perf_counter()
                    phase_cluster(D, S, G, path, launches, current,
                                  captured, sf10, mesh_refs, cluster_stream,
                                  own_stream_ref="elastic" not in phases)
                    log(f"[cluster] phase in "
                        f"{time.perf_counter() - t0:.1f} s")
        if "elastic" in phases:
            t0 = time.perf_counter()
            phase_elastic(D, S, launches, current, sf10, captured,
                          cluster_stream)
            log(f"[elastic] phase in {time.perf_counter() - t0:.1f} s")
        if "main" in phases:
            phase_range(D, S, launches, current)
        if {"tpcds", "window", "functions"} & phases:
            from spark_tpu_torch.tpcds.datagen import write_parquet as ds
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                path = ds(tmp + "/tpcds", TPCDS_SF)
                log(f"[tpcds] SF{TPCDS_SF} generated in "
                    f"{time.perf_counter() - t0:.1f} s")
                if "tpcds" in phases:
                    t0 = time.perf_counter()
                    phase_tpcds(D, S, path, launches, current)
                    log(f"[tpcds] phase in {time.perf_counter() - t0:.1f} s")
                if "window" in phases:
                    t0 = time.perf_counter()
                    phase_window(D, S, path)
                    log(f"[window] phase in "
                        f"{time.perf_counter() - t0:.1f} s")
                if "functions" in phases:
                    phase_functions(D, S, ["f3"], path, launches, current)
        if "fuzz" in phases:
            t0 = time.perf_counter()
            phase_fuzz(D, S)
            log(f"[fuzz] phase in {time.perf_counter() - t0:.1f} s")
    finally:
        D.dense_groupby_sums = original
        sf10.stop()
        sf10_dir.cleanup()
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


def breakdown(df, qe=None) -> str:
    """Where one run of `df` spends its time. The query runs once to let
    the re-plan loop converge (or `qe`, an execution of the same query
    that already ran, gives its converged plan; a plan with UDF stages
    runs from that execution's splice, whose InputExec holds the UDF
    stage's result); then the converged plan runs twice with
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
    if qe is None:
        qe = df._qe()
        qe.execute_batch()
    plan = qe.spliced_plan if qe.udf_summary else qe.executed_plan

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

        batch = run_plan(plan, ctx, visit)
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
    busy_s, events = device_busy(prof)
    by_name = collections.defaultdict(float)
    for e in events:
        by_name[e.name[:48]] += (e.time_range.end - e.time_range.start) / 1e3
    top = ", ".join(f"{n} {ms:.2f} ms" for n, ms in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    device = busy_text(busy_s, events, wall) + (
        f"; most device time: {top}" if events else "")
    return f"total {total * 1e3:.1f} ms: {parts}; {device}"


def kernel_report(D, launches, captured, phases):
    """One entry per kernel and main-path input shape, measured on the
    inputs that query gave it: the DataFrame programs' of KERNEL_INPUTS
    (each must have been captured when phase 5 ran), then each TPC-H and
    TPC-DS SQL query's, function-library program's and phase-11
    aggregate's that launched a kernel. `launches` counts all of the
    query's launches of that kernel."""
    import torch
    entries = []
    programs = KERNEL_INPUTS if "main" in phases else []
    missing = [pair for pair in programs if (pair[1], pair[0]) not in captured]
    if missing:
        raise AssertionError(f"no kernel input captured for {missing}")
    sql = [(name, label) for label, name in captured
           if label.startswith(("sql ", "tpcds ", "functions ", "etl ",
                                "ooc ", "udf ", "mesh ", "obs ",
                                "elastic ", "stream ", "serve ", "fleet",
                                "cluster"))]
    inputs = [(name, q, x) for name, q in programs + sql
              for x in captured[(q, name)].values()]
    for name, q, (idx, ir, fr, domain, _kept) in inputs:
        # a mesh shard's input lies on its own card: time it there
        with torch.cuda.device(idx.device):
            got = D.dense_groupby_sums(idx, ir, fr, domain)
            torch.cuda.synchronize()
            want = reference_sums(D, idx, ir, fr, domain)
            err = compare_sums(f"{name} on {q} inputs", got, want)
            t = measure(D, idx, ir, fr, domain)
        b, by = bound_ms(idx, len(ir) + len(fr), domain)
        log(f"[report] {name} on {q}'s inputs: n={idx.shape[0]} "
            f"domain={domain} int_rows={len(ir)} float_rows={len(fr)} "
            f"ms={t['ms']:.4f} kernel_ms={t['kernel_ms']:.4f} "
            f"bound_ms={b:.4f} share={b / t['kernel_ms']:.3f} "
            f"plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} "
            f"launches={launches[q][name]} device={idx.device}"
            + (f"; float sums within {err:.3g} of the tree sums, the "
               f"plain version's within {plain_float_error(want):.3g} "
               "relative" if fr else ""))
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[q][name],
            "max_abs_err": err, "ms": t["ms"], "kernel_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b, "bound_by": by,
            "share": b / t["kernel_ms"], "library_ms": t["library_ms"],
            "shape": {"query": q, "n": int(idx.shape[0]), "domain": domain,
                      "int_rows": len(ir), "float_rows": len(fr),
                      "device": str(idx.device)}})
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
    if argv[:1] == [WRITE_LINEITEM_FLAG]:
        write_lineitem(argv[1], float(argv[2]))
        return 0
    t_start = time.perf_counter()
    phases = parse_phases(argv)
    #: only phases 3-4: the kernel shapes line, floats that differ between
    #: two runs reported, not fatal (for timing another checkout's kernels)
    shapes_only = not phases & set(MAIN_PHASES)
    try:
        import torch
        smi_line, name = phase_device()
        D = phase_build()
        t0 = time.perf_counter()
        if "kernels" in phases:
            shapes = phase_kernels(D, strict=not shapes_only)
        if "variants" in phases:
            phase_variants(D)
        log(f"[kernels] phases 3-4 in {time.perf_counter() - t0:.1f} s")
        if not shapes_only:
            launches, captured = run_phases(D, phases)
            t0 = time.perf_counter()
            entries = kernel_report(D, launches, captured, phases)
            log(f"[report] {len(entries)} inputs in "
                f"{time.perf_counter() - t0:.1f} s")
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
