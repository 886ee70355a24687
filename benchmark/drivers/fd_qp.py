"""Driver of the batched force-distribution QP: a closed-loop caller that
solves one batch of standing-balance QPs per call, reads the batch's
largest KKT residual on the host, then makes the next call.

Set-up draws a pool of base displacements (``harness.traffic``), builds
the pool's QPs through the program's VMC and ``build_qp``, and makes one
call per pool batch. On one card each call is
``control.force_distribution.solve_fd_qp_batched(..., backend="auto")``;
on several, one process per card, each call is
``parallel.distributed.make_sharded_qp_sweep(make_pod_mesh())`` on the
rank's contiguous block, whose global KKT maximum and mean wrench error
ride two all-reduces. A call's latency runs on the host's clock from just
before the call to just after its result has been read on the host; on
several cards it is the slowest rank's, call by call.

``correct``: once the window has closed, the reference works out the QPs
of a sample of the window's calls (drawn from the seed) from the same
draws and the configuration alone (``reference/stance.py``, float64),
solves them to the optimum (``reference/qp.py``), and judges the
program's answers by their objective gap; on several cards it also redoes
the two reductions from every rank's answers.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ..harness import traffic as traffic_mod
from ..harness.outcome import (
    Context, Outcome, no_larger_than, note, peak_bytes, sync,
)
from ..harness.trace import traced
from ..reference import qp as ref_qp
from ..reference import stance

SAMPLED_CALLS = 8  # answers checked, drawn over the window's calls
TRACED_CALLS = 300
STOP_EVERY = 16  # calls between the ranks' agreements to stop
CALIBRATION_CALLS = 200
# The float64 reference's scaled KKT residual on every instance (most
# reach 1e-16, a few stall near 1e-8): far below the objective gaps judged.
REFERENCE_KKT = 1e-6
# The control's precision: the nearest below the one the configuration states.
CONTROL = {"float64": "float32", "float32": "tf32"}


def build(cfg: dict, displacement: np.ndarray, device) -> list:
    """[(A, b, S, W, D, d)] of each pool batch of standing-balance QPs (the
    default stance at the configured height, the base displaced), built by
    the program: VMC wrench, then ``build_qp``."""
    from quadruped_locomotion_tpu_torch import types
    from quadruped_locomotion_tpu_torch.control import force_distribution as fd
    from quadruped_locomotion_tpu_torch.control import vmc
    from quadruped_locomotion_tpu_torch.rollout import simulator as simlib

    pool, batch, _ = displacement.shape
    model = types.RobotModel.simpledog(device)
    gains = types.VmcGains.gazebo_defaults(device)
    cfd = types.CfdParams.defaults(device)
    sim = simlib.default_stance_state(model, height=cfg["stance_height_m"],
                                      batch=(batch,))
    target = types.BaseTarget.from_base(sim.robot.base)
    base = sim.robot.base
    out = []
    for k in range(pool):
        noise = torch.as_tensor(displacement[k], dtype=torch.float32,
                                device=device)
        state = sim.robot.replace(base=base.replace(position=base.position
                                                    + noise))
        vf, vt = vmc.compute_virtual_wrench(model, gains, state, target)
        qp = fd.build_qp(model, cfd, state, vf, vt)
        out.append(tuple(t.contiguous() for t in qp))
    return out


def _block(ctx: Context, draws: np.ndarray) -> np.ndarray:
    """This rank's contiguous block of every pool batch."""
    per = draws.shape[1] // ctx.world
    return draws[:, ctx.rank * per:(ctx.rank + 1) * per]


class Reservoir:
    """A uniform sample of ``k`` of a stream's items, drawn from ``rng``;
    every rank of a run draws alike."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, make):
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = make()


def setup(ctx: Context):
    """Draws, this rank's block of them, the program's QPs and entry, and
    one warm-up call per pool batch."""
    cfg = ctx.cell.config
    per_rank = cfg["batch_per_chip"]
    draws = traffic_mod.generate(ctx.cell.traffic, per_rank * ctx.world,
                                 ctx.seed)
    mine = _block(ctx, draws)
    note(ctx, "inputs drawn")
    iters = cfg["qp_iters"]
    if ctx.world > 1:
        from quadruped_locomotion_tpu_torch.parallel import distributed

        distributed.initialize_multihost(device=ctx.device)
        mesh = distributed.make_pod_mesh(ctx.device)
        note(ctx, "process group joined")
        sweep = distributed.make_sharded_qp_sweep(mesh, iters=iters)

        def call(qp):
            sol, kkt, err = sweep(*qp)
            return sol.x, sol.kkt_error, kkt, err
    else:
        from quadruped_locomotion_tpu_torch.control.force_distribution import (
            solve_fd_qp_batched,
        )

        def call(qp):
            sol = solve_fd_qp_batched(*qp, iters=iters, backend="auto")
            return sol.x, sol.kkt_error, sol.kkt_error.amax(), None

    pool = build(cfg, mine, ctx.device)
    sync(ctx.device)
    note(ctx, "program's QPs built")
    for qp in pool:  # the cell's shapes: first-use costs land here
        call(qp)
    sync(ctx.device)
    note(ctx, "warm-up calls made")
    return SimpleNamespace(draws=draws, pool=pool, call=call,
                           batch=per_rank)


def _stop_agreed(ctx: Context, mine: bool) -> bool:
    import torch.distributed as dist

    flag = torch.tensor([1.0 if mine else 0.0], device=ctx.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item() > 0)


def window(ctx: Context, s, max_calls: int | None = None):
    """The measured (or traced) window. Returns (calls, this rank's wall
    seconds, per-call latencies in ms on the host's clock, calls whose
    read was not finite, the sampled answers)."""
    sample = Reservoir(SAMPLED_CALLS, traffic_mod.rng(ctx.seed, 2))
    lat, bad, calls, n_pool = [], 0, 0, len(s.pool)
    sync(ctx.device)
    t0 = time.perf_counter()
    while True:
        k = calls % n_pool
        t_call = time.perf_counter()
        x, kkt, kkt_read, err = s.call(s.pool[k])
        read = float(kkt_read)
        lat.append(1e3 * (time.perf_counter() - t_call))
        bad += read != read or read in (float("inf"), float("-inf"))
        sample.offer(lambda: (k, x.clone(), kkt.clone(), read,
                              None if err is None else err.clone()))
        calls += 1
        if max_calls is not None:
            if calls >= max_calls:
                break
        elif ctx.world == 1:
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        elif calls % STOP_EVERY == 0 and _stop_agreed(
                ctx, time.perf_counter() - t0 >= ctx.seconds):
            break
    wall = time.perf_counter() - t0
    return calls, wall, lat, bad, sample.items


def _all(ctx: Context, value: float, op: str) -> float:
    """``value`` reduced over the ranks (itself on one card)."""
    if ctx.world == 1:
        return value
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64, device=ctx.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else
                    dist.ReduceOp.SUM)
    return float(t.item())


def _slowest_latencies(ctx: Context, lat: list) -> np.ndarray:
    """Per call, the largest latency over the ranks."""
    t = torch.tensor(lat, dtype=torch.float64, device=ctx.device)
    if ctx.world > 1:
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(ctx.world)]
        dist.all_gather(parts, t)
        t = torch.stack(parts).amax(0)
    return t.cpu().numpy()


def reference_answers(ctx: Context, s, samples, precision: str = "float64"):
    """The reference's problem and answer of each sampled call's pool
    batch: {pool index: (A, b, S, W, D, d, x)}, the problem in float64;
    ``precision`` other than float64 is the control's."""
    mine = _block(ctx, s.draws)
    ar = ref_qp.Arith(precision)
    out = {}
    for k in sorted({item[0] for item in samples}):
        A, b, S, W, D, d = stance.qps(ctx.cell.config, mine[k], ctx.device)
        G, g = ref_qp.form(*ar.cast(A, S, W, b), ar)
        x, _, kkt = ref_qp.solve(G, g, *ar.cast(D, d), ar)
        if precision == "float64" and float(kkt.max()) > REFERENCE_KKT:
            raise RuntimeError(f"the float64 reference did not reach the "
                               f"optimum (KKT {float(kkt.max()):.3g})")
        out[k] = (A, b, S, W, D, d, x)
    return out


def judge(ctx: Context, s, samples, answers=None) -> dict:
    """The compared numbers of the sampled calls: the largest objective gap
    over their instances (and ranks) and, on several cards, how far the
    read global KKT maximum and mean wrench error stand from the same
    reductions redone over every rank's answers. ``answers`` {pool index:
    x} judges those in place of the program's (the control)."""
    ref = reference_answers(ctx, s, samples)
    gap, kkt_gap, err_gap = 0.0, 0.0, 0.0
    for k, x, kkt, read, err in samples:
        A, b, S, W, D, d, x_ref = ref[k]
        x = x if answers is None else answers[k]
        gap = max(gap, no_larger_than(
            ref_qp.judge(A, b, S, W, D, d, x, x_ref)["gap"].max()))
        if ctx.world > 1:
            top = _all(ctx, float(kkt.amax()), "max")
            kkt_gap = max(kkt_gap, no_larger_than(abs(read - top)))
            r = (A.double() @ x.double().unsqueeze(-1)).squeeze(-1) - b.double()
            mean = _all(ctx, float(r.abs().amax(-1).sum()), "sum") / (
                s.batch * ctx.world)
            err_gap = max(err_gap, no_larger_than(
                abs(float(err) - mean) / mean))
    out = {"obj_gap": _all(ctx, gap, "max")}
    if ctx.world > 1:
        out["kkt_reduce"] = kkt_gap
        out["wrench_mean_rel"] = err_gap
    return out


def run(ctx: Context) -> Outcome:
    s = setup(ctx)
    window_start = time.time()
    note(ctx, "window opened")
    if ctx.trace:
        (calls, wall, lat, bad, samples), trace = traced(
            lambda: window(ctx, s, TRACED_CALLS), ctx.device)
        busy = _all(ctx, trace.busy_s(), "sum") / ctx.world
    else:
        calls, wall, lat, bad, samples = window(ctx, s)
        trace, busy = None, None
    wall = _all(ctx, wall, "max")
    slowest = _slowest_latencies(ctx, lat)
    peak = int(_all(ctx, float(peak_bytes(ctx.device)), "max"))
    bad = int(_all(ctx, float(bad), "sum"))
    s.pool = s.call = None
    got = judge(ctx, s, samples)
    limits = ctx.cell.traffic["limits"]
    counts = {"calls": calls, "batch": s.batch}
    if busy is not None:
        counts["busy_s"] = busy
    return Outcome(
        metrics={"qp_solves_per_s": calls * s.batch * ctx.world / wall,
                 "qp_call_p95_ms": float(np.percentile(slowest, 95))
                 if len(slowest) else float("nan"),
                 "setup_s": window_start - ctx.t0},
        attempted=calls, failed=bad, memory_peak_bytes=peak,
        checks={k: (v, limits[k]) for k, v in got.items()},
        trace=trace, counts=counts)


def calibration(ctx: Context, control: bool) -> dict:
    """Readings for setting the limits: the program's numbers over a short
    window at the cell's load and, with ``control``, those of the
    reference put in the program's place, in the precision below the
    configuration's, on the same sampled calls."""
    s = setup(ctx)
    _, _, _, _, samples = window(ctx, s, CALIBRATION_CALLS)
    s.pool = s.call = None
    out = {"program": judge(ctx, s, samples)}
    if control:
        ctl = reference_answers(ctx, s, samples,
                                precision=CONTROL[ctx.cell.config["precision"]])
        out["control"] = judge(ctx, s, samples,
                               answers={k: v[-1] for k, v in ctl.items()})
    return out
