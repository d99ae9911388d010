"""Egress (`Batch.to_arrow`): the program's `egress` phase time on each
window query's end event, mean ms a query."""


def read(ctx):
    timeline = ctx["timeline"]
    events = [e for e in timeline.events[:len(ctx["records"])]
              if e["status"] == "ok" and "egress" in e["phase_times_s"]] \
        if timeline else []
    if not events:
        return None
    return sum(e["phase_times_s"]["egress"] for e in events) \
        / len(events) * 1e3
