"""Operators, joins: device busy time of the kernels launched inside the
program's `op:JoinExec` and `op:RuntimeFilterExec` ranges (the union of
their intervals), mean ms over the window's completed queries
(`program_ranges.reduce_events`); nothing where no such range launched
device work."""


def read(ctx):
    return (ctx.get("ranges") or {}).get("join_device_ms")
