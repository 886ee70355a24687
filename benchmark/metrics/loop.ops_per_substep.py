"""Device operations launched a control substep inside the program's
planner tick (every ``loop.*`` span), the gait engine's shared over the
tick's substeps."""


def read(run):
    spans, n = run.counts.get("spans"), run.counts.get("substeps")
    if not spans or not n:
        return None
    ops = sum(r["ops"] for name, r in spans.items()
              if name.startswith("loop."))
    return ops / n if ops else None
