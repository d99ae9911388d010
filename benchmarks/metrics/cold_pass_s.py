"""Scan and ingest: wall seconds of the set-up's first pass over the mix,
each query's first run (Arrow to the card, planning from nothing)."""


def read(ctx):
    return ctx.get("cold_pass_s")
