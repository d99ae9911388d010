"""SQL front end and planner: analysis + optimization + planning, from the
program's phase times on each window query's end event, mean ms a
query."""

PHASES = ("analysis", "optimization", "planning")


def read(ctx):
    timeline = ctx["timeline"]
    events = [e for e in timeline.events[:len(ctx["records"])]
              if e["status"] == "ok"] if timeline else []
    if not events:
        return None
    total = sum(e["phase_times_s"].get(p, 0.0) for e in events
                for p in PHASES)
    return total / len(events) * 1e3
