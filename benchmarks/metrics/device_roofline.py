"""Kernels: the byte bound of the window's queries over the device's busy
time inside them, in %. A query's bound is the bytes its plain reference
counts (`bytes_moved`: each column the query uses outside its tables'
own predicates, read once at its fewest whole bytes, for the rows that
survive those predicates, and the result written once) at the HBM peak
(`yardstick.PEAK_BYTES_PER_S`)."""

from yardstick import PEAK_BYTES_PER_S


def read(ctx):
    busy = ctx.get("busy_by_query") or []
    per_query = ctx.get("bytes_by_query") or {}
    bound = busy_total = 0.0
    for r, b in zip(ctx["records"], busy):
        if r["ok"] and r["q"] in per_query:
            bound += per_query[r["q"]] / PEAK_BYTES_PER_S
            busy_total += b
    if busy_total <= 0:
        return None
    return 100.0 * bound / busy_total
