"""Device: the share of the traced window in which no kernel or copy ran
on the card (the union of the profiler's device intervals), in %."""


def read(ctx):
    window = ctx.get("traced_window_s") or 0.0
    if window <= 0 or not ctx.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / window)
