"""Device operations (kernels, copies, sets, collectives) per call of the
QP entry in the traced window, the caller's read of the result included."""


def read(run):
    calls = run.counts.get("calls")
    return run.trace.count() / calls if calls else None
