"""Device time of the collective kernels (NCCL) per sharded call, on rank
0's card."""

from benchmark.harness.trace import is_collective


def read(run):
    calls = run.counts.get("calls")
    if not calls or not run.trace.count(is_collective):
        return None
    return 1e3 * run.trace.seconds(is_collective) / calls
