"""The batched QP solve's share of its roofline: the least time the card
could take for the work of solving one call's batch (formation of G, g
and the interior-point solve, counted by ``harness.roofline``) over the
device time of every operation but the collectives that one call issues."""

from benchmark.harness import roofline
from benchmark.harness.trace import is_collective


def read(run):
    calls, batch = run.counts.get("calls"), run.counts.get("batch")
    if not calls or not batch:
        return None
    least = roofline.least_seconds(
        run.device_name,
        roofline.weighted_ls_fd_qp_flops(run.config["qp_iters"]) * batch,
        roofline.weighted_ls_fd_qp_bytes(batch))
    spent = run.trace.seconds(lambda name: not is_collective(name)) / calls
    if least is None or spent <= 0:
        return None
    return 100.0 * least / spent
