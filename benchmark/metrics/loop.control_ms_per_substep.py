"""Device time a control substep of the controller around the QP, in ms:
the program's ``loop.contact_fsm`` (contact sensor, FSM, reflexes),
``loop.prepare`` (VMC, QP rows, formation, swing torques) and
``loop.finish`` (stance torques, freeze reflex) spans, and the gait
engine's ``loop.gait_advance`` (once a tick) shared over the tick's four
substeps."""

SPANS = ("loop.gait_advance", "loop.contact_fsm", "loop.prepare",
         "loop.finish")


def read(run):
    spans, n = run.counts.get("spans"), run.counts.get("substeps")
    if not spans or not n or not all(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["device_s"] for s in SPANS) / n
