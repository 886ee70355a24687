"""Share of the traced window in which no operation ran on the device
(rank 0's card on several cards)."""


def read(run):
    if not run.counts.get("calls"):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
