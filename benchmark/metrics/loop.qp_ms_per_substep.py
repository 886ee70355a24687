"""Device time a control substep under the program's ``loop.qp`` span (the
batched QP solve of every scenario: the kernel and its entry, whose own
``qp.*`` spans count as ``loop.qp``'s), in ms."""


def read(run):
    spans, n = run.counts.get("spans"), run.counts.get("substeps")
    if not spans or not n or "loop.qp" not in spans:
        return None
    return 1e3 * spans["loop.qp"]["device_s"] / n
