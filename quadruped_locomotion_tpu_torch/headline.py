"""The QP headline of the port on the GPU (≙ ``bench.py``'s default run):
batched 4-contact force-distribution QP solves per second at B = 4096,
with the quality checks that make the number mean something.

* :func:`build_batch` — the headline's problem data: standing-balance
  QPs of ``B`` scenarios whose base is displaced by ±3 cm (numpy seed 0),
  height 0.4 m, through the port's VMC and ``build_qp``.
* :func:`measure` — the headline on the card: a chain of ``CHAIN``
  dependent solves captured in one CUDA graph (each step nudges b by
  1e-6·tanh(x[:, :1]), so no solve can be hoisted), replayed and timed
  with CUDA events; the single-dispatch time of one eager
  ``solve_weighted_ls_fd_qp`` call; KKT and wrench-error percentiles;
  :func:`tail_proof`; and the kernel-vs-generic-QP objective gap on the
  first 512 instances.

    python3 -c "from quadruped_locomotion_tpu_torch import headline; \\
        print(headline.measure())"

The figures are the port's own and say nothing about the JAX package's
TPU numbers.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .control.force_distribution import build_qp
from .control.vmc import compute_virtual_wrench
from .model.kinematics import mv
from .ops import fd_qp_kernel as fk
from .ops import qp
from .rollout import simulator as simlib
from .types import (
    BaseTarget, CfdParams, RobotModel, VmcGains, full_f32_matmuls,
    resolve_device,
)
from .utils.cuda_graphs import Capture

CHAIN = 10  # dependent solves per graph replay
CROSS_CHECK = 512  # instances held against the generic QP
REPS = 20  # timed single dispatches (and REPS // 2 graph replays)


def build_batch(batch: int, device=None):
    """(A, b, S, W, D, d) of ``batch`` standing-balance QPs on ``device``
    (default CUDA): the default stance at height 0.4 m with the base
    displaced by uniform ±3 cm noise from numpy seed 0."""
    dev = resolve_device(device)
    model = RobotModel.simpledog(dev)
    sim = simlib.default_stance_state(model, height=0.4, batch=(batch,))
    target = BaseTarget.from_base(sim.robot.base)
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.uniform(-0.03, 0.03, size=(batch, 3)),
                            dtype=torch.float32, device=dev)
    base = sim.robot.base.replace(position=sim.robot.base.position + noise)
    state = sim.robot.replace(base=base)
    vf, vt = compute_virtual_wrench(model, VmcGains.gazebo_defaults(dev),
                                    state, target)
    A, b, S, W, D, d = build_qp(model, CfdParams.defaults(dev), state, vf, vt)
    return tuple(t.contiguous() for t in (A, b, S, W, D, d))


def objective(x, A, S, b, W):
    """(Ax − b)ᵀ diag(S) (Ax − b) + xᵀ diag(W) x per instance."""
    r = mv(A, x) - b
    return (r * S * r).sum(-1) + (x * W * x).sum(-1)


def wrench_error(A, x, b):
    """max_i |(Ax)_i − b_i| per instance: how far the realised wrench is
    from the requested one."""
    return (mv(A, x) - b).abs().amax(-1)


def tail_proof(A, b, S, W, D, d, x, wrench_err, max_oracle: int = 64):
    """Prove the wrench-error tail is constraint-bound, not solver failure
    (a copy of ``bench.py::tail_proof``; numpy and scipy only).

    1. Tail instances (wrench error > 1 N) with an active inequality
       (slack < 1e-3) are constraint-bound by direct slack evidence.
    2. Tail instances without one are each re-solved with a float64
       scipy SLSQP oracle: the solution must match the oracle's
       objective (gap ≤ 5e-3) and the oracle's wrench error must be as
       large (ratio in (0.9, 1.1)).
    3. The ``max_oracle`` worst instances by wrench error get the same
       oracle check.

    Returns (tail_frac, active_frac, oracle_rel_gap_max | None, proven).
    """
    An, bn, Sn, Wn = (np.asarray(v, np.float64) for v in (A, b, S, W))
    Dn, dn, xn = (np.asarray(v, np.float64) for v in (D, d, x))
    tail = wrench_err > 1.0
    tail_frac = float(tail.mean())
    if not tail.any():
        return tail_frac, 1.0, None, True
    slack = np.einsum("bij,bj->bi", Dn, xn) - dn
    min_slack = slack.min(axis=-1)
    active_frac = float((min_slack[tail] < 1e-3).mean())
    suspects = np.flatnonzero(tail & (min_slack >= 1e-3))

    try:
        from scipy import optimize
    except ImportError:  # pragma: no cover - scipy is installed
        return tail_frac, active_frac, None, False

    def oracle_check(i):
        """float64 re-solve of instance i -> (objective gap, err ratio)."""
        G = 2.0 * An[i].T @ (Sn[i][:, None] * An[i]) + np.diag(Wn[i])
        g = -2.0 * An[i].T @ (Sn[i] * bn[i])
        scale = max(1.0, np.abs(g).max())
        res = optimize.minimize(
            lambda v: (0.5 * v @ G @ v + g @ v) / scale,
            xn[i],
            jac=lambda v: (G @ v + g) / scale,
            constraints=[{
                "type": "ineq",
                "fun": lambda v, i=i: Dn[i] @ v - dn[i],
                "jac": lambda v, i=i: Dn[i],
            }],
            method="SLSQP",
            options={"maxiter": 500, "ftol": 1e-14},
        )
        obj = lambda v: v @ G @ v * 0.5 + g @ v  # noqa: E731
        denom = 1.0 + abs(obj(res.x))
        gap = abs(obj(xn[i]) - obj(res.x)) / denom
        ratio = np.abs(An[i] @ res.x - bn[i]).max() / max(wrench_err[i], 1e-9)
        return gap, ratio

    suspects_ok = True
    if suspects.size > max_oracle:  # pragma: no cover - pathological batch
        suspects_ok = False
        suspects = suspects[:max_oracle]
    sus_gaps = []
    for i in suspects:
        gap, ratio = oracle_check(i)
        sus_gaps.append(gap)
        if gap > 5e-3 or not 0.9 < ratio < 1.1:
            suspects_ok = False

    worst = np.argsort(wrench_err)[::-1][:max_oracle]
    gaps, oracle_errs = [], []
    for i in worst:
        gap, ratio = oracle_check(i)
        gaps.append(gap)
        oracle_errs.append(ratio)
    gap_max = float(np.max(gaps))
    err_ratio_med = float(np.median(oracle_errs))
    proven = bool(suspects_ok and gap_max <= 5e-3 and 0.9 < err_ratio_med < 1.1)
    print(
        f"tail proof: {tail.sum()}/{tail.size} instances >1N "
        f"({tail_frac:.1%}); active-constraint frac={active_frac:.3f}; "
        f"{suspects.size} inactive-slack suspects oracle-checked "
        f"(max gap {max(sus_gaps, default=0.0):.2e}); "
        f"oracle objective gap max={gap_max:.2e} over {len(worst)} worst; "
        f"oracle/kernel wrench-err ratio med={err_ratio_med:.3f}; "
        f"proven={proven}",
        file=sys.stderr,
    )
    return tail_frac, active_frac, gap_max, proven


def quality(A, b, S, W, D, d, x, kkt) -> dict:
    """KKT and wrench-error percentiles of a solved batch and its tail
    proof (bench.py's health block; host arrays, any device)."""
    kkt_np = kkt.cpu().numpy()  # float32, as bench.py takes its percentiles
    werr = wrench_error(A, x, b).double().cpu().numpy()
    tail_frac, active_frac, oracle_gap, proven = tail_proof(
        *(t.cpu().numpy() for t in (A, b, S, W, D, d, x)), werr)
    return {
        "kkt_p50": float(np.percentile(kkt_np, 50)),
        "kkt_p99": float(np.percentile(kkt_np, 99)),
        "kkt_max": float(kkt_np.max()),
        "kkt_finite": bool(np.isfinite(kkt_np).all()),
        "wrench_err_p50": float(np.median(werr)),
        "wrench_err_p99": float(np.percentile(werr, 99)),
        "tail_frac_gt_1N": tail_frac,
        "tail_active_constraint_frac": active_frac,
        "tail_oracle_gap_max": oracle_gap,
        "tail_proven": proven,
    }


def generic_gap(A, b, S, W, D, d, x, iters: int = 15,
                sub: int = CROSS_CHECK) -> dict:
    """Relative objective gap |f(x) − f(x_generic)| / (1 + |f(x_generic)|)
    between ``x`` and the generic QP's solution on the first ``sub``
    instances: median and p99 (bench.py's backend agreement check)."""
    sl = slice(0, min(sub, A.shape[0]))
    args = tuple(t[sl] for t in (A, S, b, W, D, d))
    xg = qp.solve_weighted_ls_qp(*args, iters=iters).x
    ox = objective(xg, A[sl], S[sl], b[sl], W[sl])
    op = objective(x[sl], A[sl], S[sl], b[sl], W[sl])
    gap = ((op - ox).abs() / (1.0 + ox.abs())).double().cpu().numpy()
    return {"generic_gap_median": float(np.median(gap)),
            "generic_gap_p99": float(np.percentile(gap, 99)),
            "generic_instances": int(gap.size)}


class ChainGraph(Capture):
    """``CHAIN`` dependent ``solve_weighted_ls_fd_qp`` calls captured in
    one CUDA graph (``utils/cuda_graphs.Capture``, after one warm-up):
    each :meth:`replay` runs, and counts, ``CHAIN`` kernel launches.
    Raises unless the capture holds ``CHAIN`` of them."""

    def __init__(self, A, b, S, W, D, d, iters: int = 15):
        self.args = (A, b, S, W, D, d)
        self.iters = iters
        super().__init__(self._chain, A.device, warmups=1)
        self.x, self.kkt = self.out
        if not (self.counted["qp.kernel_launches"]
                == self.counted["qp.wls_launches"] == CHAIN):
            raise RuntimeError(
                f"captured {self.counted['qp.kernel_launches']} launches, "
                f"want {CHAIN}")

    def _chain(self):
        A, b, S, W, D, d = self.args
        b_i = b
        for _ in range(CHAIN):
            x_i, _, _, kkt_i = fk.solve_weighted_ls_fd_qp(
                A, S, b_i, W, D, d, iters=self.iters)
            b_i = b + 1e-6 * torch.tanh(x_i[:, :1])
        return x_i, kkt_i


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(batch: int = 4096, iters: int = 15, device=None) -> dict:
    """The headline on the card (bench.py's default run, kernel part):
    returns bench.py's JSON keys plus the cross-check against the generic
    QP. Raises unless ``device`` (default CUDA) is a CUDA device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure times the card; got device {dev}")
    full_f32_matmuls()
    A, b, S, W, D, d = build_batch(batch, dev)

    # single dispatch: one eager wrapper call (formation + kernel)
    x, _, _, kkt = fk.solve_weighted_ls_fd_qp(A, S, b, W, D, d, iters=iters)
    single_ms = cuda_ms(lambda: fk.solve_weighted_ls_fd_qp(
        A, S, b, W, D, d, iters=iters), REPS)

    # chained: CHAIN dependent solves per graph replay
    chain = ChainGraph(A, b, S, W, D, d, iters=iters)
    chain_ms = cuda_ms(chain.replay, REPS // 2, warmup=1)
    batch_ms = chain_ms / CHAIN

    out = {
        "device": torch.cuda.get_device_name(dev),
        "batch": batch,
        "iters": iters,
        "chain_per_dispatch": CHAIN,
        "solves_per_s": batch * 1e3 / batch_ms,
        "batch_time_ms": batch_ms,
        "single_dispatch_solves_per_s": batch * 1e3 / single_ms,
        "single_dispatch_ms": single_ms,
        "chain_x_finite": bool(torch.isfinite(chain.x).all()),
    }
    out.update(quality(A, b, S, W, D, d, x, kkt))
    out.update(generic_gap(A, b, S, W, D, d, x, iters=iters))
    return out
