"""Share of the traced window of the closed loop in which no operation ran
on the device."""


def read(run):
    if not run.counts.get("ticks") or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
