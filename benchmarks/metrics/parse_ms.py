"""SQL front end: the program's `parse` phase time (`session.sql`'s parse
and lowering, before any phase `plan_ms` counts) on each window query's
end event, mean ms a query; nothing from a program that keeps no such
phase."""


def read(ctx):
    timeline = ctx["timeline"]
    events = [e for e in timeline.events[:len(ctx["records"])]
              if e["status"] == "ok" and "parse" in e["phase_times_s"]] \
        if timeline else []
    if not events:
        return None
    return sum(e["phase_times_s"]["parse"] for e in events) \
        / len(events) * 1e3
