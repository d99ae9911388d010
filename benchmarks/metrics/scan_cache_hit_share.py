"""Scan and device cache: hits over lookups of the program's device table
cache (`CACHE.stats()`) across the window, in %."""


def read(ctx):
    before, after = ctx["cache"]
    hits = after["hits"] - before["hits"]
    lookups = hits + after["misses"] - before["misses"]
    if lookups <= 0:
        return None
    return 100.0 * hits / lookups
