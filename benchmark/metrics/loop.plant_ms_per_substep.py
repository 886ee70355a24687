"""Device time a control substep under the program's ``loop.plant`` span
(the articulated plant's step), in ms."""


def read(run):
    spans, n = run.counts.get("spans"), run.counts.get("substeps")
    if not spans or not n or "loop.plant" not in spans:
        return None
    return 1e3 * spans["loop.plant"]["device_s"] / n
