"""Execution driver: the device's idle time in gaps whose midpoint lies
inside one of the program's `spark_tpu/dispatch` ranges, over the
window's completed queries, in ms (`program_ranges.reduce_events`);
nothing from a trace without the program's ranges or without device
work."""


def read(ctx):
    return (ctx.get("ranges") or {}).get("dispatch_idle_ms")
