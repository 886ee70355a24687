"""Faults planted underneath the timed path, for the test that sees
``correct`` come out false. Each ``plant_*`` replaces one function of the
program in this process and returns a callable that puts it back."""

from __future__ import annotations

import os

import torch

QP_FAULTS = ("unchanged", "half", "altered")
DP_FAULTS = ("no_exchange", "half", "altered")


def _faulty_solution(sol, fault):
    x = sol.x.clone()
    if fault == "unchanged":
        x.zero_()
    elif fault == "half":
        x[x.shape[0] // 2:] = 0.0
    else:
        x[0] = -x[0]
    return sol._replace(x=x)


def plant_qp(fault: str):
    """A batched solve that returns its starting point (zeros), solves
    only the first half of the batch, or flips one instance's answer."""
    from quadruped_locomotion_tpu_torch.control import force_distribution as fd

    original = fd.solve_fd_qp_batched

    def faulty(*args, **kw):
        return _faulty_solution(original(*args, **kw), fault)

    fd.solve_fd_qp_batched = faulty
    return lambda: setattr(fd, "solve_fd_qp_batched", original)


def plant_dp(fault: str):
    """On several ranks: the all-reduce left out (each rank keeps its own
    value), half of each shard left out with the mean wrench error taken
    over the rest, or one instance's answer flipped."""
    from quadruped_locomotion_tpu_torch.control import force_distribution as fd
    from quadruped_locomotion_tpu_torch.parallel import mesh

    if fault == "no_exchange":
        original = mesh._all_reduce
        mesh._all_reduce = lambda m, value, op: value.detach().clone()
        return lambda: setattr(mesh, "_all_reduce", original)
    original = fd.solve_fd_qp_batched

    def faulty(A, b, S, W, D, d, **kw):
        if fault == "half":
            h = A.shape[0] // 2
            sol = original(*(t[:h] for t in (A, b, S, W, D, d)), **kw)
            pad = lambda t: torch.cat([t, torch.zeros_like(t)])  # noqa: E731
            return sol._replace(x=pad(sol.x), kkt_error=pad(sol.kkt_error))
        return _faulty_solution(original(A, b, S, W, D, d, **kw), fault)

    fd.solve_fd_qp_batched = faulty
    return lambda: setattr(fd, "solve_fd_qp_batched", original)


def rank_main(rank, world, port, fault, batch, seed, results):
    """One gloo rank of a run of the balance QP sharded over ``world``
    ranks on the CPU (the ``qp.balance.dp4`` traffic), with ``fault`` (or
    None) planted; rank 0 puts the result's line on ``results``."""
    import json
    import time

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import benchmark.run as run
    from benchmark.harness import spec

    cell = spec.load_cell("qp.balance")
    cell.traffic = json.loads(
        (spec.BENCH_DIR / "workloads" / "qp.balance.dp4.json").read_text())
    cell.chips = world
    cell.config["batch_per_chip"] = batch
    try:
        if fault is not None:
            plant_dp(fault)
        line = run.measure(cell, seed, 0.5, False, "cpu", time.time(),
                           rank, world)
        if rank == 0:
            results.put(("ok", line))
    except BaseException as e:  # the parent reports it
        results.put(("error", repr(e)))
        raise
