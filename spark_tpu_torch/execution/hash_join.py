"""Hash build/probe equi-join kernel: open-addressing table over the
sorted build side (the port of `spark_tpu/execution/hash_join.py`;
reference: `BytesToBytesMap.java`).

The sort kernel (`execution/join.py`) binary-searches every probe key in
the sorted build. This kernel builds a power-of-two open-addressing
table (linear probing, splitmix-mixed int64 keys) over the build side's
DISTINCT keys and probes it with a bounded vectorized loop: O(expected
cluster length) small-table gathers per probe row instead of a search.

- The build side is still sorted once (`join.build_sorted`). The table
  stores, per distinct key, the POSITION of its run start in the sorted
  array, and run lengths come from a per-run count. The probe therefore
  returns the exact ``(lo, cnt)`` pair the sort kernel's `match_ranges`
  returns, so the expansion, the unique-build fast path and every
  gather are shared between kernels, and the two produce byte-identical
  output (same rows, same order).
- Table capacity is a power of two derived from the (bucketed) build
  capacity and `join.hashLoadFactor`, clamped by
  `join.hashMaxTableSlots`. A clamp that pushes the load factor past
  `_FALLBACK_LOAD_FACTOR` falls back to the sort kernel.
- Inserts claim vacant slots with a scatter-min among the step's
  contenders (occupied slots are never stolen, so the probe may stop at
  the first vacancy). Both loops are Python loops of whole-column steps
  bounded by `join.hashMaxProbe`, each ending with a host check of its
  all-done condition. A build whose longest cluster exceeds the bound
  raises the ``join_hashsat_<tag>`` flag and the executor runs that join
  again on the sort kernel — correctness never depends on the bound.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..expr import Vec
from ..sketch import _mix64
from .join import _keys_equal, canon_key_data

KERNEL_MODE_KEY = "spark_tpu.sql.join.kernelMode"
LOAD_FACTOR_KEY = "spark_tpu.sql.join.hashLoadFactor"
MAX_PROBE_KEY = "spark_tpu.sql.join.hashMaxProbe"
MAX_SLOTS_KEY = "spark_tpu.sql.join.hashMaxTableSlots"
MIN_PROBE_ROWS_KEY = "spark_tpu.sql.join.hashMinProbeRows"
PROBE_BUILD_RATIO_KEY = "spark_tpu.sql.join.hashProbeBuildRatio"

#: effective load factor past which a (maxTableSlots-clamped) table
#: degrades to long clusters: fall back to the sort kernel instead
_FALLBACK_LOAD_FACTOR = 0.7

#: device bytes per table slot while a table builds: the slot's int64
#: run position (`t_pos`) and the int64 scratch word each insert step
#: reduces into (the JAX package's table also takes 16)
SLOT_BYTES = 16


def _want_slots(build_cap: int, conf) -> int:
    """Unclamped table capacity: smallest power of two holding
    `build_cap` distinct keys at `hashLoadFactor`."""
    load = float(conf.get(LOAD_FACTOR_KEY))
    want = max(int(np.ceil(max(int(build_cap), 1) / load)), 16)
    return 1 << int(np.ceil(np.log2(want)))


def table_slots(build_cap: int, conf) -> int:
    """Table capacity: `_want_slots` clamped by `hashMaxTableSlots`,
    floored to a power of two (slot indexing masks with `& (slots - 1)`)."""
    max_slots = int(conf.get(MAX_SLOTS_KEY))
    return min(_want_slots(build_cap, conf),
               1 << (max_slots.bit_length() - 1))


def kernel_choice(conf, probe_cap: int, build_cap: int,
                  hash_fallback=None) -> Tuple[str, str]:
    """('hash'|'sort', reason) for one join, decided from capacities.
    `hash_fallback` is the per-join re-plan state: False means a
    previous attempt saturated the table — stay on sort.

    Reasons: 'pinned' (saturation pin), 'forced' (kernelMode said so),
    'small-probe'/'ratio' (auto heuristics keep sort), 'clamp' (the
    maxTableSlots clamp pushes the load factor past the fallback bound),
    'auto' (auto picked hash)."""
    if hash_fallback is False:
        return "sort", "pinned"
    mode = str(conf.get(KERNEL_MODE_KEY))
    if mode == "sort":
        return "sort", "forced"
    if mode == "auto":
        # the table build amortizes only over large, probe-heavy joins
        if int(probe_cap) < int(conf.get(MIN_PROBE_ROWS_KEY)):
            return "sort", "small-probe"
        if int(probe_cap) < float(conf.get(PROBE_BUILD_RATIO_KEY)) \
                * int(build_cap):
            return "sort", "ratio"
    slots = table_slots(build_cap, conf)
    # the fallback bound applies only when the clamp actually reduced
    # the table: an unclamped table honors hashLoadFactor by construction
    if slots < _want_slots(build_cap, conf) \
            and int(build_cap) > _FALLBACK_LOAD_FACTOR * slots:
        return "sort", "clamp"
    return "hash", ("forced" if mode == "hash" else "auto")


def resolve_kernel(conf, probe_cap: int, build_cap: int,
                   hash_fallback=None) -> str:
    """The kernel `kernel_choice` picks, without its reason."""
    return kernel_choice(conf, probe_cap, build_cap, hash_fallback)[0]


#: splitmix64-style finalizer seed (shared by build and probe — the
#: one requirement; the value mirrors murmur3's c1)
_HASH_SEED = 0xCC9E2D51


def _hash_keys(keys, hash_dtype=None):
    """Mixed int64 hash of a key column. Floats hash by BIT PATTERN,
    with +-0.0 and NaN payloads canonicalized so keys the join treats as
    equal hash equal; collisions only cost probe steps — the table
    compares true key values.

    `hash_dtype` is the promoted common dtype of the two key sides:
    build and probe must hash under one dtype, or numerically equal
    mixed-precision keys hash different bit patterns."""
    if hash_dtype is not None and keys.dtype != hash_dtype:
        keys = keys.to(hash_dtype)
    if keys.is_floating_point():
        keys = canon_key_data(keys)
        keys = keys.view({2: torch.int16, 4: torch.int32,
                          8: torch.int64}[keys.element_size()])
    return _mix64(keys.to(torch.int64), _HASH_SEED)


def build_table(keys_s, valid_s, slots: int, max_probe: int,
                hash_dtype=None) -> Tuple:
    """Insert each distinct valid build key into the open table.

    `keys_s`/`valid_s` come from `join.build_sorted`. Returns
    ``(t_pos, cnt_all, saturated, steps)``:

      t_pos[s]    sorted-array position of the run START of the key
                  stored in slot s, or `cap` (empty)
      cnt_all[p]  number of VALID rows in position p's key run
      saturated   0-d bool tensor: some key failed to claim a slot
                  within `max_probe` steps
      steps       insert steps taken
    """
    cap = keys_s.shape[0]
    dev = keys_s.device
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    prev_same = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                           _keys_equal(keys_s[1:], keys_s[:-1])])
    is_start = (~prev_same) & valid_s
    # per-run valid-row counts: one scatter-add over the (small) build
    run_id = torch.cumsum(is_start.to(torch.int64), 0) - 1
    counts = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    counts.index_add_(0, torch.where(valid_s, run_id,
                                     torch.full_like(run_id, cap)),
                      torch.ones_like(run_id))
    cnt_all = counts[run_id.clamp(0, cap - 1)]

    h = _hash_keys(keys_s, hash_dtype) & (slots - 1)
    t_pos = torch.full((slots,), cap, dtype=torch.int64, device=dev)
    claimed = torch.zeros((cap,), dtype=torch.bool, device=dev)
    steps = 0
    while steps < max_probe and not bool((claimed | ~is_start).all()):
        want = is_start & ~claimed
        s = (h + steps) & (slots - 1)
        # min contender per slot this step, merged only into VACANT
        # slots: an occupied slot is never stolen, so no vacancy lies
        # between a key's home slot and its slot
        scratch = torch.full((slots + 1,), cap, dtype=torch.int64,
                             device=dev)
        scratch.scatter_reduce_(0, torch.where(want, s,
                                               torch.full_like(s, slots)),
                                pos, reduce="amin")
        scratch = scratch[:slots]
        t_pos = torch.where((t_pos == cap) & (scratch < cap), scratch, t_pos)
        claimed = claimed | (want & (t_pos[s] == pos))
        steps += 1
    saturated = (is_start & ~claimed).any()
    return t_pos, cnt_all, saturated, steps


def probe_table(t_pos, cnt_all, keys_s, probe_key: Vec, probe_sel,
                slots: int, max_probe: int, hash_dtype=None) -> Tuple:
    """Vectorized bounded probe: returns the sort kernel's ``(lo, cnt)``
    contract (`join.match_ranges`) and the probe steps taken — build
    rows [lo, lo+cnt) in sorted order match; cnt is 0 for unmatched,
    NULL-key or unselected probe rows.

    Every inserted key sits within `max_probe` steps of its home slot
    with no vacancy before it, so a probe that hits a vacant slot (or
    exhausts the bound against a table built without saturation) has
    PROVEN a miss."""
    cap = keys_s.shape[0]
    pk = probe_key.data  # raw values: IEEE == already treats +-0 equal
    ph = _hash_keys(pk, hash_dtype) & (slots - 1)
    n = pk.shape[0]
    dev = pk.device
    lo = torch.zeros((n,), dtype=torch.int64, device=dev)
    cnt = torch.zeros((n,), dtype=torch.int64, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    steps = 0
    while steps < max_probe and not bool(done.all()):
        s = (ph + steps) & (slots - 1)
        tp = t_pos[s]
        occupied = tp < cap
        tpc = tp.clamp(max=cap - 1)
        hit = occupied & _keys_equal(keys_s[tpc], pk) & ~done
        lo = torch.where(hit, tp, lo)
        cnt = torch.where(hit, cnt_all[tpc], cnt)
        done = done | hit | ~occupied
        steps += 1
    found = cnt > 0
    if probe_key.validity is not None:
        found = found & probe_key.validity
    if probe_sel is not None:
        found = found & probe_sel
    cnt = torch.where(found, cnt, torch.zeros_like(cnt))
    return lo, cnt, steps
