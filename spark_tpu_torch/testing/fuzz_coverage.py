"""What a set of differential-fuzzer campaigns reaches: the plan shapes
and the kernels of each seed, and what one set of campaigns reaches that
another does not.

    python -m spark_tpu_torch.testing.fuzz_coverage \\
        --kept 0-199:40:auto 0-24:4096:auto 0-199:40:matmul \\
        --dropped 25-49:4096:auto 200-999:40:matmul

A campaign is `first-last:maxRows:kernelMode`. Each seed's case is made
as `chip_smoke.py`'s phase 9 makes it (`gen_tables`, then SQL text for a
quarter of the seeds, else a DataFrame program) and runs on a CPU
session under that `spark_tpu.sql.aggregate.kernelMode`. A seed's shapes
are its executed plan's operators, each with its `strategy=` and `mode=`
where it prints them and a join with its type, plus `kernel:<name>` for
each hand kernel its run calls (on the CPU the wrapper's plain version
runs; the plan and the kernel chosen are the card's: phase 9 holds the
plans equal).
Prints each shape only the dropped campaigns reach, with its seeds.
"""

from __future__ import annotations

import argparse
import json
import random
import re
import sys
from typing import Dict, List, Set, Tuple

AGG_MODE = "spark_tpu.sql.aggregate.kernelMode"
_OP = re.compile(r"^\s*(\w+)")
_ATTR = re.compile(r"\b(strategy|mode)=([\w']+)")
_JOIN_TYPE = re.compile(r"^\s*JoinExec\((\w+),")


def parse_campaign(text: str) -> Tuple[range, int, str]:
    seeds, max_rows, mode = text.split(":")
    first, last = (int(x) for x in seeds.split("-"))
    return range(first, last + 1), int(max_rows), mode


def plan_shapes(tree: str) -> Set[str]:
    """One shape per plan line: its operator and the attributes above."""
    out = set()
    for line in tree.splitlines():
        m = _OP.match(line)
        if not m:
            continue
        pairs = [(k, v.strip("'")) for k, v in _ATTR.findall(line)]
        how = _JOIN_TYPE.match(line)
        if how:
            pairs.insert(0, ("how", how.group(1)))
        attrs = ",".join(f"{k}={v}" for k, v in pairs)
        out.add(f"{m.group(1)}({attrs})" if attrs else m.group(1))
    return out


def seed_shapes(session, seed: int, max_rows: int) -> Set[str]:
    """The shapes and kernels of one seed's case (phase 9's generation)."""
    from ..execution import dense_groupby as D
    from ..io.sources import ArrowTableSource
    from . import plan_fuzz as PF
    rng = random.Random(seed)
    tables = PF.gen_tables(rng, max_rows)
    for name, tbl in tables.items():
        session.register_table(name, ArrowTableSource(name, tbl))
    sql = PF.gen_sql(rng, tables) if rng.random() < 0.25 else None
    df = session.sql(sql) if sql else PF.gen_query(rng, session, tables)
    qe = df._qe()
    shapes = plan_shapes(qe.executed_plan.tree_string())
    kernels: Set[str] = set()
    original = D.dense_groupby_sums

    def recording(idx, int_rows, float_rows, domain, int_widths=None):
        kernels.add("kernel:dense_sums_smem" if domain <= D.SMEM_DOMAIN
                    else "kernel:dense_sums_global")
        return original(idx, int_rows, float_rows, domain, int_widths)

    D.dense_groupby_sums = recording
    try:
        qe.collect()
    finally:
        D.dense_groupby_sums = original
    return shapes | kernels


def reach(campaigns: List[Tuple[range, int, str]]) -> Dict[str, List[str]]:
    """shape -> the seeds (`seed@maxRows:mode`) that reach it."""
    from .. import SparkTpuSession
    session = SparkTpuSession.builder().device("cpu").get_or_create()
    out: Dict[str, List[str]] = {}
    for seeds, max_rows, mode in campaigns:
        session.conf.set(AGG_MODE, mode)
        for seed in seeds:
            try:
                shapes = seed_shapes(session, seed, max_rows)
            except Exception as e:  # noqa: BLE001 — a shape of its own
                shapes = {f"error:{type(e).__name__}"}
            for s in shapes:
                out.setdefault(s, []).append(f"{seed}@{max_rows}:{mode}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kept", nargs="+", required=True)
    ap.add_argument("--dropped", nargs="+", required=True)
    ap.add_argument("--out", help="write both maps here as JSON")
    ns = ap.parse_args(argv)
    kept = reach([parse_campaign(c) for c in ns.kept])
    dropped = reach([parse_campaign(c) for c in ns.dropped])
    only = sorted(set(dropped) - set(kept))
    print(f"kept campaigns {ns.kept}: {len(kept)} shapes; dropped "
          f"campaigns {ns.dropped}: {len(dropped)} shapes, {len(only)} "
          f"of them not reached by the kept ones")
    for s in only:
        print(f"  only dropped: {s}: {len(dropped[s])} seeds, "
              f"{', '.join(dropped[s][:5])}")
    for s in sorted(kept):
        print(f"  kept: {s}: {len(kept[s])} seeds"
              + (f" (dropped: {len(dropped[s])})" if s in dropped else ""))
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump({"kept": kept, "dropped": dropped}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
