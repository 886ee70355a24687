"""GPU smoke run of the PyTorch port: builds the CUDA kernel, holds it
against its plain PyTorch version, and drives every ported path through
it: the massless and articulated closed loops, the QP headline, the
load-factor double solve and the config-5 scenario sweep; then the
EKF-estimated closed loop, scripted motion (the preview of every bundled
motion script and its closed loop) and the 400 Hz runtime (the controller
manager in process and the two-process realtime loop), whose generic QPs
do not use the kernel; then the operator API (the action server and the
console's trot, which runs the kernel); last, the bench entry's headline.

    python3 chip_smoke.py            # needs one CUDA card; exits 1 without

Phases, each of which raises (exit code 1) when a gate fails:

1. The card line (``nvidia-smi``), torch / CUDA / nvcc versions.
2. Build ``quadruped_locomotion_tpu_torch/csrc/fd_qp_ipm.cu`` with nvcc
   (``-Xptxas -v``): prints registers, shared memory, stack frame and
   spill bytes, and fails unless the spill stores and loads are 0 bytes.
3. Kernel vs ``solve_fd_qp_plain`` on the card at B = 4096: seeded
   stance QPs from the port's own ``build_qp`` (±3 cm base noise) and
   seeded random positive-definite QPs. Gates: relative objective gap
   median <= 1e-4 and p99 <= 1e-3, kernel KKT p99 <= 1e-3, finite
   outputs, Dx - d >= -1e-3 on 99 % of the instances and nowhere more
   than 1e-3 below the plain version's worst (the instances outside are
   printed); instance 0 solved alone gives its in-batch answer bit for
   bit. Prints the launch geometry (blocks, warps per instance) and times
   the kernel through ``solve_fd_qp`` at B = 4096 and at B = 1 (the
   400 Hz controller's batch) with CUDA events, and the plain version.
4. The massless main path: ``rollout(plant="massless")`` over B = 4096
   trot scenarios for ``--ticks`` planner ticks (default 25, cut from 100
   to make room for phases 9 and 10 in the time limit). Gates:
   exactly 4 kernel launches per tick, finite telemetry, upright fraction
   >= 0.99, QP KKT p99 <= 1e-2 and p99.9 <= 1e-3; the rollout's worst-KKT
   QP, re-solved alone, gives the kernel's in-rollout answer again; a
   5-tick run through the plain QP agrees on base positions within
   1e-3 m. Then ``plant="none"`` for 25 ticks.
5. The QP headline (``headline.measure``, bench.py's default run) at
   B = 4096 through ``solve_weighted_ls_fd_qp``: 10 dependent solves per
   CUDA-graph replay and the single eager dispatch. Gates (bench.py's):
   KKT finite and p99 <= 1e-4, median wrench error <= 0.1, objective gap
   against the generic QP median <= 1e-4 and p99 <= 1e-3 on 512
   instances, the wrench-error tail proven constraint-bound. Also times
   the wrapper's plain version and the generic QP on the same batch.
6. The load-factor double solve (``solve_fd_qp_batched(load_factors=)``)
   at B = 4096 with seeded factors in [0.3, 1.2] over 3- and 4-leg
   supports. Gates: exactly 2 launches, pinned legs equal factor x the
   first solution bit for bit, each dispatch against the plain version
   on identical inputs (the first on the original problems, the second
   on the problems eliminated with the kernel's first solution):
   objective gap median <= 1e-4 and p99 <= 1e-3; KKT p99 <= 1e-3. The
   end-to-end gap against the "plain" backend is printed.
7. The articulated main path: ``rollout(plant="articulated")`` (the
   default plant) over B = 4096 trot scenarios for ``--art-ticks``
   planner ticks (default 25, cut from 50 to make room for phase 15).
   Gates: 4 launches per tick, finite telemetry, upright fraction
   >= 0.99 at the end, a 5-tick run through
   the plain QP within 1e-3 m of the kernel run; the rollout's worst-KKT
   QP, re-solved alone, gives the kernel's in-rollout answer again.
8. Latency at B = 1 (bench.py's ``_latency_measure``, through the bench
   entry's ``latency_measure``): ``--latency-chunks`` 25-tick chunks
   (default 1, cut from 3 for phase 15) through the kernel with plant
   "none" and "articulated", and 5 one-tick dispatches; per-control-tick
   p50 / p99 ms, recorded, not gated (4 launches per planner tick).
9. The config-5 sweep (``sweep.measure``, bench.py's ``--sweep``) at
   B = 4096: per-scenario 48×48 heightfields, the 3:1 trot/pace mix and
   per-scenario velocity commands, articulated plant, ``--sweep-ticks``
   planner ticks (default 50, cut from 100 for phase 15; the dump recipe
   passes --sweep-ticks 100) after a one-tick warm-up, with the
   worst-QP and foothold taps inside the timed window. Gates: exactly 4
   kernel launches per tick (the warm-up's included), finite telemetry,
   upright fraction (base over the local ground > 0.25 m) >= 0.9
   (bench.py's health check), QP KKT p99 <= 1e-2, the sweep's worst-KKT
   QP re-solved alone gives its in-loop answer bit for bit, and a 5-tick
   rerun through the plain QP agrees with a 5-tick kernel run on base
   positions within 1e-3 m. Prints the scenario-seconds per wall-second,
   the KKT tail and the share of scenarios whose foothold search picked a
   cell other than the nominal foothold's own.
10. The EKF-estimated closed loop (``rollout_estimated``) at B = 1024 for
   ``--est-ticks`` ticks (default 100; at least 51), trot at 0.2 m/s,
   realistic sensors from a seeded generator on the card. Gates (the bounds of
   tests/test_estimated_loop.py): finite telemetry, base height in
   (0.3, 0.5) m throughout, median velocity error from tick 50 on
   < 0.12 m/s, every scenario's final position error < 0.25 m, and no
   kernel launch (its QP is the generic IPM, as in the JAX package).
11. The kinematic preview of the 13 bundled motion scripts, each
   compiled by the port's registry against the default 0.4 m stance and
   previewed up to the committed JAX preview's end (its done tick + 10;
   ``tests/data/torch_port_preview_golden.npz``). Gates: finite; step
   index, support set and done flag equal to JAX's tick for tick; the
   end reached; stance feet pinned exactly; base, feet and quaternion
   within 1e-5 of JAX; no kernel launch. Prints seconds per script and
   the device ops of a tick without a step entry and of a base_auto
   entry (torch.profiler).
12. The closed loop of scripted motion at B = 1 (``run_schedule``, the
   generic QP): standup from tick 0 for ``--script-ticks`` ticks
   (default 40) through the registry and ``init_script_state``, then
   20 ticks of each JAX golden window from its committed ScriptState
   (``tests/data/torch_port_script_golden.npz``): trot_test across a
   touchdown and a lift-off, change_to_spot with RH under the joint
   PID. Gates: finite; step index and desired support equal to JAX's
   tick for tick; base positions within 1e-4 m of the goldens (standup
   starts, as its golden does, with LF's hip abduction moved by 1e-5
   rad: its roll rate grows ~10x per tick from any asymmetry in the
   reference itself, and from the exact stance each run would grow it
   from its own rounding); the JAX tests' bounds (standup done at 0.45
   ± 0.02 m with the feet down, trot_test above 0.3 m, change_to_spot
   above 0.15 m); no kernel launch. Prints seconds per tick and the
   device ops of one tick.
13. The controller manager in process on the card (``runtime/``):
   ``SimHardware`` + ``ControllerManager`` + ``BalanceStandController``
   from the 0.4 m stance for 400 ticks (the balance tick's cold and warm
   variants and the bus tick each captured as a CUDA graph), then the
   freeze controller, the single-leg controller on LF, an e-stop. Gates:
   base height within 0.02 m of 0.4 and speed < 0.2 m/s after 400 ticks
   (tests/test_runtime.py's bounds), finite torques, no tick kept the
   previous torques, the replayed ticks' torques equal the eager tick's
   on the same samples bit for bit (the cold tick and the first 40 warm
   ticks), zero torque from the e-stop on, no kernel launch. Prints ms
   per manager tick (replayed), per eager and replayed balance tick and
   per bus step, the device ops of a cold tick, a warm tick and a bus
   step, and the busy share, beside the 2.5 ms budget.
14. The two-process realtime loop (``realtime_bench.measure``), controller
   and bus on the card, twice: at 400 Hz for ``--rt-seconds`` nominal
   seconds (default 2), and paced at 40 Hz with the plant still stepping
   2.5 ms per bus tick (400 ticks). Gates, both runs: the bus ran and
   reported, the controller ticked, the e-stop round trip was observed,
   the rings are gone; the paced run: no tick kept the previous torques,
   every sample read was finite and the last one before the e-stop
   within phase 13's standing bounds. Prints the rates, jitter and e-stop
   latency beside tests/test_realtime_bench.py's bounds, the ticks that
   kept the previous torques and the robot's state (at 400 Hz each
   torque reaches the plant a bus tick late, and the balance controller
   does not stand with that delay: recorded, not gated).
15. The operator API on the card. (a) The action server
   (``runtime/action_server.py``) from two committed JAX server
   snapshots (``tests/data/torch_port_server_golden.npz``), 15 ticks
   each through ``make_torch_port_golden.run_window``: a footstep goal
   whose first feedback appends a second goal, three paused ticks, then
   the first goal's completion; and a stop() with PREEMPT_STEP mid-swing.
   Gates: every feedback field, step index, done flag and live row count
   equal to JAX's tick for tick (duration, phase and time in step within
   1e-6), results on the same ticks with the same status, base positions
   within 1e-4 m, paused ticks leave the executor's clock where it was,
   one device-to-host copy per tick, no kernel launch (the generic QP, as
   in the JAX server). (b) ``trot --seconds 0.5`` through the console in
   process (``cli.main``): the batched rollout at B = 1 through the
   kernel. Gates: exit 0, the JAX console's keys, no NaN, distance and
   final height within 1e-3 m of the committed JAX console's
   (``tests/data/torch_port_console_golden.npz``), exactly 4 kernel
   launches per planner tick. (c) Its ``--plot`` PNG exists and is not
   empty. Prints ms per server tick and per trot tick.

16. Data parallelism over the scenario batch (``parallel/``). (a) A
   world of one in this process (NCCL): ``make_sharded_qp_sweep`` at
   B = 4096 equal bit for bit to one whole-batch
   ``solve_weighted_ls_fd_qp``, its KKT equal to the instances' maximum,
   its wrench error to the local mean (rtol 1e-6), one kernel launch per
   call; ``make_sharded_locomotion_rollout`` at B = 4096 for 5 ticks
   (articulated plant, the commands of ``__graft_entry__.py``) equal bit for bit to ``closed_loop.rollout`` on
   the same inputs, 4 launches per tick, upright >= 0.99, KKT finite;
   ``make_sharded_rollout`` at B = 1024 for 3 steps finite and equal bit
   for bit to ``balance_update`` + ``simulator.step`` on the whole batch.
   (b) Two ranks on the card (gloo, spawned; NCCL refuses two ranks on one
   GPU): the sweep's gathered solutions and the pod mesh's (shape (1, 2))
   equal to (a)'s whole-batch solve bit for bit, one launch per rank; the
   closed loop within ``__graft_entry__.py``'s sharded-vs-single gates of
   (a)'s (base position 1e-4 m, joints 1e-3 rad, upright equal), 4
   launches per tick per rank; ``measure_sharding_overhead`` recorded,
   not gated (two ranks on one card are no scaling figure). (c)
   ``python -m quadruped_locomotion_tpu_torch.bench --scaling`` as a
   subprocess: exit 0, bench.py's scaling keys, efficiency 1.0 at one
   device. (b) and (c) start once (a)'s sweep has been timed on the card
   and run beside (a)'s rollouts. Prints ms per sharded sweep and tick
   against the unsharded ones and the time of one world-1 NCCL
   ``all_reduce``.

Then ``python -m quadruped_locomotion_tpu_torch.bench --kernel-only`` runs
as a subprocess: its last line must carry bench.py's headline keys and
this card's name and power limit.

``--dump PATH`` writes the QPs that the gates single out (the phase-3
Dx >= d violators, the rollouts' and the sweep's worst-KKT QPs, the
headline's worst-KKT instances), with the kernel's answers, to an .npz
(``tests/test_torch_fd_qp.py`` holds the committed one against the JAX
solvers).

The line before the last is the ``{"kernels": [...]}`` record, whose
launch counts sum every main-path phase (graph replays included, the
kernel-vs-plain comparisons excluded); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCH = 4096  # scenarios and QP instances: the batch of bench.py's headline
EST_BATCH = 1024  # scenarios of the estimated loop
LATENCY_DISPATCHES = 5  # one-planner-tick dispatches timed in phase 8
F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12  # H100 SXM bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def versions() -> str:
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel

    nvcc = subprocess.run([fd_qp_kernel._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    return (f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"torch CUDA {torch.version.cuda}, nvcc: "
            f"{release[0].strip() if release else nvcc.stdout.strip()}")


def trot_commands(batch: int, seed: int):
    """Per-scenario trot commands over bench.py's trot ranges: vx in
    [-0.1, 0.4], vy in ±0.1, yaw rate in ±0.3 rad/s."""
    rng = np.random.default_rng(seed)
    vx = rng.uniform(-0.1, 0.4, batch)
    vy = rng.uniform(-0.1, 0.1, batch)
    wz = rng.uniform(-0.3, 0.3, batch)
    lin = np.stack([vx, vy, np.zeros(batch)], axis=1).astype(np.float32)
    return lin, wz.astype(np.float32)


# --------------------------------------------------------------------------
# phase 3: kernel vs plain
# --------------------------------------------------------------------------

SUPPORTS = np.array([[1, 1, 1, 1], [1, 1, 1, 0], [0, 1, 1, 1],
                     [1, 0, 0, 1], [0, 1, 1, 0]], bool)


def stance_qps(n: int, supports: np.ndarray, rng, device):
    """(A, b, S, W, D, d, support) of ``n`` standing-balance QPs from the
    port's build_qp: the default stance with the base displaced by
    uniform ±3 cm and a support drawn from the rows of ``supports``."""
    from quadruped_locomotion_tpu_torch.control.force_distribution import build_qp
    from quadruped_locomotion_tpu_torch.control.vmc import compute_virtual_wrench
    from quadruped_locomotion_tpu_torch.rollout import simulator as simlib
    from quadruped_locomotion_tpu_torch.types import (
        BaseTarget, CfdParams, RobotModel, VmcGains,
    )

    model = RobotModel.simpledog(device)
    sim = simlib.default_stance_state(model, height=0.4, batch=(n,))
    target = BaseTarget.from_base(sim.robot.base)
    noise = torch.as_tensor(rng.uniform(-0.03, 0.03, (n, 3)),
                            dtype=torch.float32, device=device)
    sup = torch.as_tensor(supports[rng.integers(0, len(supports), n)],
                          device=device)
    base = sim.robot.base.replace(position=sim.robot.base.position + noise)
    state = sim.robot.replace(base=base, support=sup)
    vf, vt = compute_virtual_wrench(model, VmcGains.gazebo_defaults(device),
                                    state, target)
    qp_data = build_qp(model, CfdParams.defaults(device), state, vf, vt)
    return (*(t.contiguous() for t in qp_data), sup)


def qp_batch(batch: int, n_random: int, device):
    """(G, g, D, d, A, S, b, W, n_stance): ``batch - n_random`` stance QPs
    (supports drawn from full, 3-leg and diagonal stances) then
    ``n_random`` random PD QPs. A/S/b/W cover the stance rows only."""
    from quadruped_locomotion_tpu_torch.ops.fd_qp_kernel import form_quadratic

    rng = np.random.default_rng(SEED)
    n_stance = batch - n_random
    A, b, S, W, D, d, _ = stance_qps(n_stance, SUPPORTS, rng, device)
    G, g = form_quadratic(A, S, W, b)

    # Random PD QPs with a strictly feasible point x0 (Dx0 - d >= 0.1), so
    # that the Dx >= d gate holds a solver to a problem that has an answer:
    # with tests/test_qp_pallas.py's d ~ N(0,1) - 1, a thousand draws
    # include near-infeasible ones on which every float32 IPM violates.
    M = rng.normal(size=(n_random, 12, 12))
    Dr = rng.normal(size=(n_random, 20, 12))
    x0 = rng.normal(size=(n_random, 12))
    rand = dict(
        G=np.einsum("bij,bik->bjk", M, M) + 3 * np.eye(12),
        g=rng.normal(size=(n_random, 12)),
        D=Dr,
        d=np.einsum("bij,bj->bi", Dr, x0) - rng.uniform(0.1, 1.0, (n_random, 20)),
    )
    cat = lambda a, k: torch.cat([a, torch.as_tensor(  # noqa: E731
        rand[k], dtype=torch.float32, device=device)]).contiguous()
    return (cat(G, "G"), cat(g, "g"), cat(D, "D"), cat(d, "d"),
            A, S, b, W, n_stance)


def objectives(x, G, g, A, S, b, W, n_stance):
    """Stance rows: the weighted least-squares objective (as bench.py);
    random rows: ½xᵀGx + gᵀx. float64."""
    x, G, g = x.double(), G.double(), g.double()
    xs = x[:n_stance]
    r = torch.einsum("bij,bj->bi", A.double(), xs) - b.double()
    stance = (r * S.double() * r).sum(-1) + (xs * W.double() * xs).sum(-1)
    xr = x[n_stance:]
    rand = (0.5 * torch.einsum("bi,bij,bj->b", xr, G[n_stance:], xr)
            + (g[n_stance:] * xr).sum(-1))
    return torch.cat([stance, rand])


def check_kernel(batch: int, device, dump: dict | None = None) -> dict:
    from quadruped_locomotion_tpu_torch.headline import cuda_ms
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    G, g, D, d, A, S, b, W, n_stance = qp_batch(batch, batch // 4, device)
    xk, sk, zk, kk = fk.solve_fd_qp(G, g, D, d)
    xp, _, _, kp = fk.solve_fd_qp_plain(G, g, D, d)
    torch.cuda.synchronize()

    for name, t in (("x", xk), ("s", sk), ("z", zk), ("kkt", kk)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"kernel output {name} is not finite")
    ok = objectives(xk, G, g, A, S, b, W, n_stance)
    op = objectives(xp, G, g, A, S, b, W, n_stance)
    gap = ((ok - op).abs() / (1.0 + op.abs())).cpu().numpy()
    kkt = kk.cpu().numpy()
    slack_k = (torch.einsum("bij,bj->bi", D, xk) - d).amin(-1).cpu().numpy()
    slack_p = (torch.einsum("bij,bj->bi", D, xp) - d).amin(-1).cpu().numpy()
    res = dict(gap_median=float(np.median(gap)),
               gap_p99=float(np.percentile(gap, 99)),
               gap_max=float(gap.max()),
               kkt_p99=float(np.percentile(kkt, 99)),
               kkt_plain_p99=float(np.percentile(kp.cpu().numpy(), 99)),
               slack_p1=float(np.percentile(slack_k, 1)),
               slack_min=float(slack_k.min()),
               slack_min_plain=float(slack_p.min()),
               max_abs_err_x=(xk - xp).abs().max().item(),
               median_abs_err_x=(xk - xp).abs().amax(-1).median().item(),
               max_abs_err_kkt=(kk - kp).abs().max().item())
    viol = np.flatnonzero((slack_k < -1e-3) | (slack_p < -1e-3))
    res.update(violators=viol.tolist(),
               violators_slack_kernel=slack_k[viol].tolist(),
               violators_slack_plain=slack_p[viol].tolist())
    log(f"kernel vs plain at B={batch} ({n_stance} stance + "
        f"{batch - n_stance} random QPs): " + json.dumps(res))
    if dump is not None:
        dump.update({f"violators_{k}": t[viol].cpu().numpy() for k, t in
                     dict(G=G, g=g, D=D, d=d, x_kernel=xk, x_plain=xp,
                          kkt_kernel=kk, kkt_plain=kp).items()},
                    violators=viol)
    if not (res["gap_median"] <= 1e-4 and res["gap_p99"] <= 1e-3):
        raise AssertionError(f"objective gap too large: {res}")
    if not res["kkt_p99"] <= 1e-3:
        raise AssertionError(f"kernel KKT p99 too large: {res}")
    # Dx - d >= -1e-3 on 99 % of the instances, and no violation beyond the
    # plain version's worst one by more than 1e-3. A few instances of this
    # seeded batch end up to ~2e-2 outside the cone under the reference
    # solvers themselves (the JAX kernel trace and the XLA IPM), and the
    # plain version stays inside their envelope on those instances:
    # tests/test_torch_fd_qp.py::test_violation_within_reference_envelope.
    if not (res["slack_p1"] >= -1e-3
            and res["slack_min"] >= min(res["slack_min_plain"], 0.0) - 1e-3):
        raise AssertionError(f"kernel violates Dx >= d: {res}")

    # an instance's arithmetic does not depend on B or on its position
    one = [t[:1].contiguous() for t in (G, g, D, d)]
    x1, _, _, k1 = fk.solve_fd_qp(*one)
    if not (torch.equal(x1[0], xk[0]) and torch.equal(k1[0], kk[0])):
        raise AssertionError("instance 0 solved alone differs from its "
                             "in-batch answer")

    # timing through solve_fd_qp at B and at B = 1, in turns, and the plain
    # version (CUDA events, warm)
    B = batch
    build = fk.build_kernel()
    per_block = build.threads_per_block // 32  # one warp per instance
    geometry = dict(threads_per_block=build.threads_per_block,
                    warps_per_instance=1, instances_per_block=per_block,
                    blocks=-(-B // per_block))
    full = lambda: cuda_ms(lambda: fk.solve_fd_qp(G, g, D, d), 50)  # noqa: E731
    single = lambda: cuda_ms(lambda: fk.solve_fd_qp(*one), 50)  # noqa: E731
    runs = [full(), single(), single(), full()]
    ms_kernel = (runs[0] + runs[3]) / 2
    ms_b1 = (runs[1] + runs[2]) / 2
    ms_plain = cuda_ms(lambda: fk.solve_fd_qp_plain(G, g, D, d), 5, warmup=1)
    flops = fk.fd_qp_flops() * B
    nbytes = fk.fd_qp_bytes(B)
    t_ops, t_bytes = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    res.update(ms_kernel=ms_kernel, ms_b1=ms_b1, ms_plain=ms_plain,
               flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               geometry=geometry)
    log(f"fd_qp_ipm launch at B={B}: {geometry['blocks']} blocks of "
        f"{build.threads_per_block} threads, {geometry['warps_per_instance']:g} "
        f"warp per instance, {per_block} instances per block; at B=1: 1 block")
    log(f"fd_qp_ipm through solve_fd_qp: B={B} {ms_kernel:.4f} ms, B=1 "
        f"{ms_b1:.4f} ms; plain {ms_plain:.3f} ms at B={B}; bound "
        f"{res['bound_ms'] * 1e3:.2f} us ({flops:.3e} flop / 67 TFLOP/s = "
        f"{t_ops * 1e3:.2f} us, {nbytes} B / 3.35 TB/s = "
        f"{t_bytes * 1e3:.2f} us); no single PyTorch call solves this QP, so "
        f"there is no library time; runs B={B}, 1, 1, {B}: "
        + ", ".join(f"{r:.4f}" for r in runs) + " ms")
    return res


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def setup_rollout(batch: int, device):
    from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.types import RobotModel

    model = RobotModel.simpledog(device)
    params = ControllerParams.defaults(device)
    gp = GaitParams.trot_defaults(device)
    ls0 = cl.init_locomotion(model, gp, batch, device=device)
    lin, wz = trot_commands(batch, SEED)
    cmd = cl.Command(linear_velocity=torch.as_tensor(lin, device=device),
                     yaw_rate=torch.as_tensor(wz, device=device))
    return model, params, gp, ls0, cmd


def run_rollout(args, ticks: int, device, **kw):
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tel = cl.rollout(*args, ticks, device=device, **kw)
    torch.cuda.synchronize()
    return tel, time.perf_counter() - t0


class WorstQp:
    """Context manager that wraps ``fd_qp_kernel.solve_fd_qp`` for one run
    and keeps, on the card and without a host sync, the QP instance with
    the largest KKT residual the kernel returned: its G, g, D, d, the
    kernel's x and KKT, the control substep and the scenario. A few small
    device ops per launch; the launch count is the wrapped function's."""

    def __init__(self, fk):
        self.fk, self.solve = fk, fk.solve_fd_qp
        self.worst: dict | None = None
        self.substep = 0

    def __enter__(self):
        self.fk.solve_fd_qp = self
        return self

    def __exit__(self, *exc):
        self.fk.solve_fd_qp = self.solve

    def __call__(self, G, g, D, d, iters: int = 15):
        x, s, z, kkt = self.solve(G, g, D, d, iters=iters)
        i = torch.argmax(kkt)
        cand = dict(kkt=kkt[i], G=G[i], g=g[i], D=D[i], d=d[i], x=x[i],
                    scenario=i, substep=torch.full_like(i, self.substep))
        if self.worst is None:
            self.worst = cand
        else:
            take = cand["kkt"] > self.worst["kkt"]
            self.worst = {k: torch.where(take, v, self.worst[k])
                          for k, v in cand.items()}
        self.substep += 1
        return x, s, z, kkt


def check_worst_qp(worst: dict, substeps_per_tick: int, dump,
                   key: str = "worst") -> dict:
    """Re-solve the rollout's worst QP alone through the kernel and the
    plain version on the card; the kernel must reproduce its in-rollout
    result. ``--dump`` keys start with ``key``."""
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    G, g, D, d = (worst[k][None].contiguous() for k in ("G", "g", "D", "d"))
    xk, _, _, kk = fk.solve_fd_qp(G, g, D, d)
    xp, _, _, kp = fk.solve_fd_qp_plain(G, g, D, d)
    obj = lambda x: (0.5 * x.double() @ G[0].double() @ x.double()  # noqa: E731
                     + g[0].double() @ x.double()).item()
    slack = lambda x: (D[0] @ x - d[0]).min().item()  # noqa: E731
    substep = int(worst["substep"])
    res = dict(tick=substep // substeps_per_tick,
               substep=substep, scenario=int(worst["scenario"]),
               kkt_rollout=float(worst["kkt"]), kkt_kernel=kk.item(),
               kkt_plain=kp.item(), obj_kernel=obj(xk[0]),
               obj_plain=obj(xp[0]), slack_kernel=slack(xk[0]),
               slack_plain=slack(xp[0]),
               max_abs_dx_rollout=(xk[0] - worst["x"]).abs().max().item(),
               g_absmax=g.abs().max().item(), d_absmax=d.abs().max().item())
    log(f"rollout's worst QP ({key}) re-solved alone: " + json.dumps(res))
    if dump is not None:
        dump.update({f"{key}_{k}": v.cpu().numpy() for k, v in worst.items()})
        dump.update({f"{key}_x_plain": xp[0].cpu().numpy(),
                     f"{key}_kkt_plain": kp.cpu().numpy()})
    if not res["max_abs_dx_rollout"] == 0.0:
        raise AssertionError(f"kernel does not reproduce its rollout solve: {res}")
    return res


def check_main_path(batch: int, ticks: int, device, ms_kernel: float,
                    dump: dict | None = None):
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl

    args = setup_rollout(batch, device)
    with WorstQp(fk) as tap:
        fk.launches = 0
        tel, wall = run_rollout(args, ticks, device, plant="massless")
        launches = fk.launches
    want = ticks * cl.CONTROL_SUBSTEPS
    for k, v in tel.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"telemetry {k} is not finite")
    upright = (tel["base_position"][-1, :, 2] > 0.25).float().mean().item()
    kkt = tel["qp_kkt"].cpu().numpy()
    kkt_p99 = float(np.percentile(kkt, 99))
    sim_s = ticks * cl.PLANNER_DT
    res = dict(launches=launches, wall_s=wall, upright=upright,
               kkt_p99=kkt_p99, kkt_p999=float(np.percentile(kkt, 99.9)),
               kkt_max=float(kkt.max()),
               kkt_over_1e_2=int((kkt > 1e-2).sum()),
               scenarios_over_1e_2=int((kkt > 1e-2).any(0).sum()),
               sim_s_per_wall_s=sim_s / wall,
               scenario_sim_s_per_wall_s=batch * sim_s / wall,
               kernel_share=launches * ms_kernel * 1e-3 / wall)
    log(f"rollout massless B={batch} ticks={ticks}: " + json.dumps(res))
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times, want {want}")
    if upright < 0.99:
        raise AssertionError(f"upright fraction {upright} < 0.99")
    if not (kkt_p99 <= 1e-2 and res["kkt_p999"] <= 1e-3):
        raise AssertionError(f"rollout QP KKT tail too large: {res}")
    worst = check_worst_qp(tap.worst, cl.CONTROL_SUBSTEPS, dump)
    if worst["kkt_rollout"] != res["kkt_max"]:
        raise AssertionError(f"worst QP tap missed the max KKT: {worst}")

    short = min(5, ticks)
    tel_p, wall_p = run_rollout(args, short, device, plant="massless",
                                qp_backend="plain")
    dpos = (tel_p["base_position"] - tel["base_position"][:short]).abs().max().item()
    log(f"rollout massless B={batch} ticks={short} plain QP: {wall_p:.2f} s, "
        f"max |base position - kernel run| = {dpos:.3e} m")
    if not dpos <= 1e-3:
        raise AssertionError(f"plain and kernel rollouts differ by {dpos} m")

    fk.launches = 0
    tel_n, wall_n = run_rollout(args, 25, device, plant="none")
    launches_none = fk.launches
    if launches_none != 25 * cl.CONTROL_SUBSTEPS:
        raise AssertionError(f"plant='none' launched {launches_none} times")
    if not all(torch.isfinite(v).all() for v in tel_n.values()
               if v.is_floating_point()):
        raise AssertionError("plant='none' telemetry is not finite")
    log(f"rollout none B={batch} ticks=25: {wall_n:.2f} s, "
        f"{25 * cl.PLANNER_DT / wall_n:.4f} sim s per wall s")
    res.update(max_dpos_plain=dpos, worst_qp=worst,
               launches_none=launches_none)
    return res


# --------------------------------------------------------------------------
# phase 5: the QP headline
# --------------------------------------------------------------------------


def wls_bound(batch: int) -> tuple[float, str]:
    """(bound ms, "operations" | "bytes") of solve_weighted_ls_fd_qp."""
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    t_ops = fk.weighted_ls_fd_qp_flops() * batch / F32_PEAK * 1e3
    t_bytes = fk.weighted_ls_fd_qp_bytes(batch) / HBM_RATE * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_headline(batch: int, device, dump: dict | None) -> dict:
    from quadruped_locomotion_tpu_torch.headline import cuda_ms
    from quadruped_locomotion_tpu_torch import headline
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.ops import qp

    fk.launches = fk.wls_launches = 0
    t0 = time.perf_counter()
    res = headline.measure(batch, device=device)
    res.update(wall_s=time.perf_counter() - t0, launches=fk.launches,
               wls_launches=fk.wls_launches)
    log(f"headline B={batch}: " + json.dumps(res))
    if fk.launches != fk.wls_launches or fk.launches < headline.CHAIN:
        raise AssertionError(f"headline launch counts {res}")
    if not (res["kkt_finite"] and res["chain_x_finite"]
            and res["kkt_p99"] <= 1e-4 and res["wrench_err_p50"] <= 0.1):
        raise AssertionError(f"headline QP quality gate failed: {res}")
    if not (res["generic_gap_median"] <= 1e-4 and res["generic_gap_p99"] <= 1e-3):
        raise AssertionError(f"kernel vs generic QP objective gap: {res}")
    if not res["tail_proven"]:
        raise AssertionError(f"wrench-error tail not proven: {res}")

    # the wrapper against its plain version, and the generic QP, on the card
    A, b, S, W, D, d = headline.build_batch(batch, device)
    xk, _, _, kk = fk.solve_weighted_ls_fd_qp(A, S, b, W, D, d)
    xp, _, _, kp = fk.solve_weighted_ls_fd_qp_plain(A, S, b, W, D, d)
    torch.cuda.synchronize()
    ok = headline.objective(xk.double(), A.double(), S.double(), b.double(),
                            W.double())
    op = headline.objective(xp.double(), A.double(), S.double(), b.double(),
                            W.double())
    gap = ((ok - op).abs() / (1.0 + op.abs())).cpu().numpy()
    ms_plain = cuda_ms(lambda: fk.solve_weighted_ls_fd_qp_plain(
        A, S, b, W, D, d), 5, warmup=1)
    ms_generic = cuda_ms(lambda: qp.solve_weighted_ls_qp(
        A, S, b, W, D, d, iters=15), 2, warmup=1)
    bound_ms, bound_by = wls_bound(batch)
    cmp = dict(max_abs_err_x=(xk - xp).abs().max().item(),
               median_abs_err_x=(xk - xp).abs().amax(-1).median().item(),
               plain_gap_median=float(np.median(gap)),
               plain_gap_p99=float(np.percentile(gap, 99)),
               kkt_plain_p99=float(np.percentile(kp.cpu().numpy(), 99)),
               ms_plain=ms_plain, ms_generic=ms_generic, bound_ms=bound_ms,
               bound_by=bound_by)
    log(f"solve_weighted_ls_fd_qp at B={batch}: wrapper "
        f"{res['single_dispatch_ms']:.4f} ms, chained {res['batch_time_ms']:.4f} "
        f"ms per solve, plain {ms_plain:.3f} ms, generic QP {ms_generic:.1f} ms, "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}); vs plain: "
        + json.dumps(cmp))
    if dump is not None:
        worst = torch.topk(kk, 16).indices
        dump.update({f"headline_{k}": t[worst].cpu().numpy() for k, t in
                     dict(A=A, b=b, S=S, W=W, D=D, d=d, x_kernel=xk,
                          kkt_kernel=kk, x_plain=xp, kkt_plain=kp).items()})
    res.update(cmp)
    return res


# --------------------------------------------------------------------------
# phase 6: the load-factor double solve
# --------------------------------------------------------------------------

LF_SUPPORTS = np.array([[1, 1, 1, 1], [1, 1, 1, 0], [0, 1, 1, 1],
                        [1, 0, 1, 1], [1, 1, 0, 1]], bool)


def lf_batch(batch: int, device):
    """(A, b, S, W, D, d, support, factors): stance QPs on 4- and 3-leg
    supports (numpy seed 1), factors in [0.3, 1.2]."""
    rng = np.random.default_rng(SEED + 1)
    *qp_data, sup = stance_qps(batch, LF_SUPPORTS, rng, device)
    lf = torch.as_tensor(rng.uniform(0.3, 1.2, (batch, 4)), dtype=torch.float32,
                         device=device)
    return (*qp_data, sup, lf)


def check_load_factors(batch: int, device) -> dict:
    """The double solve through the kernel (2 launches), and each of its
    two dispatches against the plain version on identical inputs: the
    first on the original problems, the second on the problems
    eliminated with the kernel's first solution. (Compared end to end,
    kernel and plain pin different first solutions, which sit up to ~1 N
    apart in the W = 1e-4 flat valley, so their second problems differ;
    that gap is printed, not gated.)"""
    from quadruped_locomotion_tpu_torch.headline import cuda_ms
    from quadruped_locomotion_tpu_torch import headline
    from quadruped_locomotion_tpu_torch.control import force_distribution as fd
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    A, b, S, W, D, d, sup, lf = lf_batch(batch, device)
    solve = lambda backend, A, b, D, d, **kw: fd.solve_fd_qp_batched(  # noqa: E731
        A, b, S, W, D, d, backend=backend, **kw)
    fk.launches = fk.wls_launches = 0
    sol = solve("kernel", A, b, D, d, load_factors=lf, support=sup)
    launches, wls = fk.launches, fk.wls_launches
    first = solve("kernel", A, b, D, d)
    first_plain = solve("plain", A, b, D, d)
    A2, b2, D2, d2, pinned, x_pin = fd.eliminate_pinned(
        A, b, D, d, first.x, lf, sup)
    second_plain = fd.combine_pinned(solve("plain", A2, b2, D2, d2).x, x_pin,
                                     pinned, sup)
    end_to_end_plain = solve("plain", A, b, D, d, load_factors=lf, support=sup)
    torch.cuda.synchronize()
    pin12 = pinned.repeat_interleave(3, dim=-1)
    want = first.x * lf.repeat_interleave(3, dim=-1)
    pinned_exact = bool(torch.equal(sol.x[pin12], want[pin12]))

    def gap(x, xp, A, b):
        o = lambda x: headline.objective(  # noqa: E731
            x.double(), A.double(), S.double(), b.double(), W.double())
        ok, op = o(x), o(xp)
        g = ((ok - op).abs() / (1.0 + op.abs())).cpu().numpy()
        return float(np.median(g)), float(np.percentile(g, 99)), float(g.max())

    free = lambda x: torch.where(pin12, torch.zeros_like(x), x)  # noqa: E731
    g1 = gap(first.x, first_plain.x, A, b)
    g2 = gap(free(sol.x), free(second_plain), A2, b2)
    ge = gap(sol.x, end_to_end_plain.x, A, b)
    kkt = sol.kkt_error.cpu().numpy()
    ms = cuda_ms(lambda: solve("kernel", A, b, D, d, load_factors=lf,
                               support=sup), 10)
    ms_plain = cuda_ms(lambda: solve("plain", A, b, D, d, load_factors=lf,
                                     support=sup), 2, warmup=1)
    res = dict(launches=launches, wls_launches=wls, pinned_exact=pinned_exact,
               pinned_legs=int(pinned.sum().item()),
               first_gap_median=g1[0], first_gap_p99=g1[1], first_gap_max=g1[2],
               second_gap_median=g2[0], second_gap_p99=g2[1],
               second_gap_max=g2[2], end_to_end_gap_median=ge[0],
               end_to_end_gap_p99=ge[1], end_to_end_gap_max=ge[2],
               kkt_p99=float(np.percentile(kkt, 99)), kkt_max=float(kkt.max()),
               kkt_plain_p99=float(np.percentile(
                   end_to_end_plain.kkt_error.cpu().numpy(), 99)),
               finite=bool(torch.isfinite(sol.x).all()), ms_kernel=ms,
               ms_plain=ms_plain)
    log(f"load factors B={batch}: " + json.dumps(res))
    if launches != 2 or wls != 2:
        raise AssertionError(f"load-factor solve launched {launches} times")
    if not (pinned_exact and res["finite"]):
        raise AssertionError(f"pinned legs differ from factor x first solve: {res}")
    for k in ("first", "second"):
        if not (res[f"{k}_gap_median"] <= 1e-4 and res[f"{k}_gap_p99"] <= 1e-3):
            raise AssertionError(f"load-factor {k} solve vs plain: {res}")
    if not res["kkt_p99"] <= 1e-3:
        raise AssertionError(f"load-factor KKT p99: {res}")
    return res


# --------------------------------------------------------------------------
# phase 7: the articulated main path
# --------------------------------------------------------------------------


def check_articulated(batch: int, ticks: int, device,
                      dump: dict | None = None) -> dict:
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl

    args = setup_rollout(batch, device)
    with WorstQp(fk) as tap:
        fk.launches = 0
        tel, wall = run_rollout(args, ticks, device, plant="articulated")
        launches = fk.launches
    for k, v in tel.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"articulated telemetry {k} is not finite")
    upright = (tel["base_position"][-1, :, 2] > 0.25).float().mean().item()
    kkt = tel["qp_kkt"].cpu().numpy()
    sim_s = ticks * cl.PLANNER_DT
    res = dict(launches=launches, ticks=ticks, wall_s=wall, upright=upright,
               height_min=tel["base_position"][..., 2].min().item(),
               kkt_p99=float(np.percentile(kkt, 99)), kkt_max=float(kkt.max()),
               s_per_tick=wall / ticks,
               scenario_sim_s_per_wall_s=batch * sim_s / wall)
    log(f"rollout articulated B={batch} ticks={ticks}: " + json.dumps(res))
    if launches != ticks * cl.CONTROL_SUBSTEPS:
        raise AssertionError(f"kernel launched {launches} times, want "
                             f"{ticks * cl.CONTROL_SUBSTEPS}")
    if upright < 0.99:
        raise AssertionError(f"articulated upright fraction {upright} < 0.99")
    worst = check_worst_qp(tap.worst, cl.CONTROL_SUBSTEPS, dump, "art_worst")
    if worst["kkt_rollout"] != res["kkt_max"]:
        raise AssertionError(f"worst QP tap missed the max KKT: {worst}")

    short = min(5, ticks)
    tel_p, wall_p = run_rollout(args, short, device, plant="articulated",
                                qp_backend="plain")
    dpos = (tel_p["base_position"]
            - tel["base_position"][:short]).abs().max().item()
    log(f"rollout articulated B={batch} ticks={short} plain QP: {wall_p:.2f} s, "
        f"max |base position - kernel run| = {dpos:.3e} m")
    if not dpos <= 1e-3:
        raise AssertionError(f"plain and kernel articulated rollouts differ "
                             f"by {dpos} m")
    res.update(max_dpos_plain=dpos, worst_qp=worst)
    return res


# --------------------------------------------------------------------------
# phase 8: latency at B = 1
# --------------------------------------------------------------------------


def check_latency(chunks: int, device) -> dict:
    """Per-control-tick ms of 25-tick chunks at B = 1 (bench.py's
    _latency_measure: vx = 0.2 m/s), after a 5-tick warm-up chunk, and of
    LATENCY_DISPATCHES one-tick dispatches, through the bench entry's
    ``latency_measure`` (which raises unless the kernel ran 4 times per
    planner tick)."""
    from quadruped_locomotion_tpu_torch import bench

    out = bench.latency_measure(chunks, device, dispatches=LATENCY_DISPATCHES)
    log("latency B=1 per 400 Hz control tick (25-tick chunks): "
        + json.dumps(out))
    return out


# --------------------------------------------------------------------------
# phase 9: the config-5 sweep
# --------------------------------------------------------------------------


class FootholdTap:
    """Context manager that wraps ``heightfield.optimize_footholds`` for
    one run and marks, on the card, the scenarios in which the search
    picked a cell other than the nominal foothold's own (any leg, any
    tick)."""

    def __init__(self, hfm):
        self.hfm, self.search = hfm, hfm.optimize_footholds
        self.moved: torch.Tensor | None = None

    def __enter__(self):
        self.hfm.optimize_footholds = self
        return self

    def __exit__(self, *exc):
        self.hfm.optimize_footholds = self.search

    def __call__(self, hf, nominal, hips_world=None, **kw):
        out = self.search(hf, nominal, hips_world, **kw)
        a, b = hf.cell_index(nominal[..., :2]), hf.cell_index(out[0][..., :2])
        moved = ((a[0] != b[0]) | (a[1] != b[1])).flatten(1).any(-1)
        self.moved = moved if self.moved is None else self.moved | moved
        return out


def check_sweep(batch: int, ticks: int, device, dump: dict | None) -> dict:
    from quadruped_locomotion_tpu_torch import sweep
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.terrain import heightfield as hfm

    torch.cuda.reset_peak_memory_stats()
    with WorstQp(fk) as tap, FootholdTap(hfm) as feet:
        fk.launches = 0
        res = sweep.measure(batch, ticks, device=device)
        launches = fk.launches
    want = (ticks + 1) * cl.CONTROL_SUBSTEPS  # the warm-up tick included
    res.update(launches=launches,
               moved_share=feet.moved.float().mean().item(),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"sweep B={batch} ticks={ticks}: " + json.dumps(res))
    if launches != want:
        raise AssertionError(f"sweep launched the kernel {launches} times, "
                             f"want {want}")
    if not res["finite"]:
        raise AssertionError("sweep telemetry is not finite")
    if res["upright_frac"] < 0.9:
        raise AssertionError(f"sweep upright fraction {res['upright_frac']}")
    if not res["p99_kkt"] <= 1e-2:
        raise AssertionError(f"sweep QP KKT p99 {res['p99_kkt']} > 1e-2")
    worst = check_worst_qp(tap.worst, cl.CONTROL_SUBSTEPS, dump,
                           "sweep_worst")
    if worst["kkt_rollout"] < res["max_kkt"]:
        raise AssertionError(f"worst QP tap missed the max KKT: {worst}")

    sc = sweep.build_scenarios(batch, 0, device)  # measure's scenarios
    short = min(5, ticks)
    _, tel_k = sweep.run(sc, short)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tel_p = sweep.run(sc, short, qp_backend="plain")
    torch.cuda.synchronize()
    dpos = (tel_p["base_position"] - tel_k["base_position"]).abs().max().item()
    log(f"sweep B={batch} ticks={short} plain QP: "
        f"{time.perf_counter() - t0:.2f} s, max |base position - kernel run| "
        f"= {dpos:.3e} m")
    if not dpos <= 1e-3:
        raise AssertionError(f"plain and kernel sweeps differ by {dpos} m")
    res.update(max_dpos_plain=dpos, worst_qp=worst)
    return res


# --------------------------------------------------------------------------
# phase 10: the EKF-estimated closed loop
# --------------------------------------------------------------------------


def check_estimated(batch: int, ticks: int, device) -> dict:
    from quadruped_locomotion_tpu_torch.control import state_estimator as se
    from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.rollout import estimated_loop as el
    from quadruped_locomotion_tpu_torch.types import RobotModel

    model = RobotModel.simpledog(device)
    gp = GaitParams.trot_defaults(device)
    els = el.init_estimated(model, gp, batch, seed=SEED, device=device)
    cmd = cl.Command(
        linear_velocity=torch.tensor([0.2, 0.0, 0.0],
                                     device=device).expand(batch, 3),
        yaw_rate=torch.zeros(batch, device=device))
    fk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tel = el.rollout_estimated(
        model, ControllerParams.defaults(device), gp,
        se.EstimatorParams.defaults(device), el.SensorParams.realistic(device),
        els, cmd, ticks, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    z = tel["base_position"][..., 2]
    vel_err, pos_err = tel["vel_err"], tel["pos_err"]
    late = vel_err[min(50, ticks - 1):]
    res = dict(batch=batch, ticks=ticks, wall_s=wall,
               s_per_tick=wall / ticks,
               scenario_sim_s_per_wall_s=batch * ticks * cl.PLANNER_DT / wall,
               finite=all(bool(torch.isfinite(v).all()) for v in tel.values()
                          if v.is_floating_point()),
               height_min=z.min().item(), height_max=z.max().item(),
               vel_err_median_late=late.median().item(),
               pos_err_final_max=pos_err[-1].max().item(),
               pos_err_final_median=pos_err[-1].median().item(),
               kkt_p99=float(np.percentile(tel["qp_kkt"].cpu().numpy(), 99)),
               kernel_launches=fk.launches)
    log(f"estimated loop B={batch} ticks={ticks}: " + json.dumps(res))
    if not res["finite"]:
        raise AssertionError("estimated-loop telemetry is not finite")
    if not (0.3 < res["height_min"] and res["height_max"] < 0.5):
        raise AssertionError(f"estimated loop left (0.3, 0.5) m: {res}")
    if not res["vel_err_median_late"] < 0.12:
        raise AssertionError(f"estimated velocity error: {res}")
    if not res["pos_err_final_max"] < 0.25:
        raise AssertionError(f"estimated position error: {res}")
    if fk.launches:
        raise AssertionError("the estimated loop reached the kernel")
    return res


# --------------------------------------------------------------------------
# phases 11-12: scripted motion (no kernel: its QPs are the generic IPM's)
# --------------------------------------------------------------------------

DATA = Path(__file__).resolve().parent / "tests" / "data"
PREVIEW_GOLDEN = DATA / "torch_port_preview_golden.npz"
SCRIPT_GOLDEN = DATA / "torch_port_script_golden.npz"
PREVIEW_TOL = 1e-5  # m (base, feet) and quaternion units, against JAX
SCRIPT_TOL = 1e-4  # m, base positions against the JAX goldens
WINDOW_TICKS = 20  # ticks of each closed-loop golden window


def device_ops(fn):
    """Run ``fn`` under torch.profiler: (its result, the CUDA device ops
    it issued (kernels and copies), their summed device seconds, the
    window's wall seconds). Only the card's activity is recorded: parsing
    the host's op events of one scripted tick took over a minute of
    phase 12, and nothing reads them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (out, len(ops),
            sum(e.self_device_time_total for e in ops) * 1e-6, wall)


def check_preview(device) -> dict:
    """Phase 11: every bundled motion script, compiled by the registry
    against the default stance, previewed up to the committed JAX
    preview's end (its done tick + 10)."""
    from quadruped_locomotion_tpu_torch.api.action_loader import default_registry
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.rollout import preview as pv
    from quadruped_locomotion_tpu_torch.rollout import simulator as simlib
    from quadruped_locomotion_tpu_torch.planning import steps
    from quadruped_locomotion_tpu_torch.types import RobotModel

    golden = dict(np.load(PREVIEW_GOLDEN))
    height = float(golden["meta/height"])
    model = RobotModel.simpledog(device)
    sim = simlib.default_stance_state(model, height=height)
    reg = default_registry()
    names = sorted(a.id for a in reg.list_actions() if a.type == "yaml")
    if len(names) != 13:
        raise AssertionError(f"expected the 13 bundled scripts: {names}")
    compile_ = lambda n: reg.compile(  # noqa: E731
        n, sim.robot.base.position, sim.robot.base.quaternion, sim.feet_world,
        device=device)
    fk.launches = 0
    per, worst = {}, dict(base=0.0, feet=0.0, quat=0.0, joints=0.0)
    for name in names:
        sched = compile_(name)
        ref = {k: golden[f"{name}/{k}"] for k in pv.StateBatch.__dataclass_fields__}
        ticks, done_tick = len(ref["times"]), int(golden[f"{name}/done_tick"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = pv.preview_schedule(model, sched, height=height,
                                    planner_ticks=ticks, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: getattr(batch, k).cpu().numpy() for k in ref}
        if not all(np.isfinite(v).all() for v in got.values()
                   if v.dtype.kind == "f"):
            raise AssertionError(f"{name}: preview not finite")
        for k in ("step_index", "support", "done"):
            if not np.array_equal(got[k], ref[k]):
                bad = np.flatnonzero((got[k] != ref[k]).reshape(ticks, -1).any(1))
                raise AssertionError(f"{name}: {k} differs from JAX at ticks "
                                     f"{bad[:10].tolist()}")
        if not got["done"][done_tick - 1:].all():
            raise AssertionError(f"{name}: the preview did not end")
        sup = ref["support"][1:]
        pinned = sup & (ref["feet_world"][1:] == ref["feet_world"][:-1]).all(-1)
        feet = got["feet_world"]
        if not np.array_equal(feet[1:][pinned], feet[:-1][pinned]):
            raise AssertionError(f"{name}: a stance foot moved")
        err = dict(
            base=float(np.abs(got["base_position"] - ref["base_position"]).max()),
            feet=float(np.abs(feet - ref["feet_world"]).max()),
            quat=float(np.abs(got["base_quaternion"]
                              - ref["base_quaternion"]).max()),
            joints=float(np.abs(got["joint_positions"]
                                - ref["joint_positions"]).max()))
        worst = {k: max(worst[k], v) for k, v in err.items()}
        per[name] = dict(ticks=ticks, done_tick=done_tick, s=wall,
                         ms_per_tick=1e3 * wall / ticks,
                         steps=sched.num_steps, **err)
        log(f"preview {name}: " + json.dumps(per[name]))
        if max(err["base"], err["feet"], err["quat"]) > PREVIEW_TOL:
            raise AssertionError(f"{name}: preview off the JAX preview by "
                                 f"more than {PREVIEW_TOL}: {err}")
    kernel_launches = fk.launches
    # device ops of one tick without a step entry (trot_test mid-swing)
    # and of a base_auto entry (standup's first tick: the pose QP)
    def ticks_of(name, n):
        sched = compile_(name)
        es = steps.init_exec_state(sim.feet_world, sim.robot.base.position,
                                   sim.robot.base.quaternion)
        state = (es, sim.feet_world, sim.robot.base.position,
                 sim.robot.base.quaternion)
        run = lambda st: pv.preview_step(model, sched, *st)[:4]  # noqa: E731
        for _ in range(n):
            state = run(state)
        return lambda: run(state)

    _, plain_ops, plain_busy, plain_wall = device_ops(ticks_of("trot_test", 5))
    _, entry_ops, entry_busy, entry_wall = device_ops(ticks_of("standup", 0))
    total_s = sum(p["s"] for p in per.values())
    total_ticks = sum(p["ticks"] for p in per.values())
    res = dict(scripts=len(per), ticks=total_ticks, wall_s=total_s,
               ms_per_tick=1e3 * total_s / total_ticks,
               ops_per_plain_tick=plain_ops, plain_tick_ms=1e3 * plain_wall,
               plain_tick_busy=plain_busy / plain_wall,
               ops_per_auto_entry_tick=entry_ops,
               auto_entry_tick_ms=1e3 * entry_wall,
               auto_entry_tick_busy=entry_busy / entry_wall,
               max_err=worst, kernel_launches=kernel_launches)
    log("preview of the 13 bundled scripts: " + json.dumps(res))
    if kernel_launches:
        raise AssertionError("the preview reached the QP kernel")
    return res


def check_scripted(standup_ticks: int, device) -> dict:
    """Phase 12: the closed loop of scripted motion at B = 1: standup from
    tick 0 through the registry and init_script_state, then the two JAX
    golden windows from their committed ScriptState."""
    from quadruped_locomotion_tpu_torch import convert
    from quadruped_locomotion_tpu_torch.api.action_loader import default_registry
    from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.planning import steps
    from quadruped_locomotion_tpu_torch.rollout import script_loop as sl
    from quadruped_locomotion_tpu_torch.types import RobotModel

    golden = dict(np.load(SCRIPT_GOLDEN))
    if not 40 <= standup_ticks <= len(golden["standup/tel/done"]):
        raise ValueError("--script-ticks must lie in [40, "
                         f"{len(golden['standup/tel/done'])}]")
    model, params = RobotModel.simpledog(device), ControllerParams.defaults(device)
    runs, res = {}, {}
    fk.launches = 0
    for name, ticks in (("standup", standup_ticks),
                        ("trot_test", WINDOW_TICKS),
                        ("change_to_spot", WINDOW_TICKS)):
        if name == "standup":
            # the golden's start: the stance with LF's hip abduction moved
            # by a seed that the reference's roll instability grows from
            ss0 = sl.init_script_state(
                model, height=float(golden["standup/meta/height"]),
                device=device)
            q = ss0.sim.robot.q.clone()
            q[0, 0] += float(golden["standup/meta/seed_lf_haa"])
            ss0 = ss0.replace(sim=ss0.sim.replace(
                robot=ss0.sim.robot.replace(q=q)))
            sim = ss0.sim
            sched = default_registry().compile(
                name, sim.robot.base.position, sim.robot.base.quaternion,
                sim.feet_world, device=device)
        else:
            get = lambda cls, p: convert.from_numpy(  # noqa: E731
                cls, convert.unflatten(golden, f"{name}/{p}"), device)
            ss0, sched = get(sl.ScriptState, "ss0/"), get(steps.StepSchedule,
                                                          "sched/")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ssf, tel = sl.run_schedule(model, params, sched, ss0, ticks,
                                   device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = (ssf, sched)
        got = {k: v.cpu().numpy() for k, v in tel.items()}
        ref = {k: golden[f"{name}/tel/{k}"][:ticks] for k in got}
        z = got["base_position"][:, 2]
        dpos = np.abs(got["base_position"] - ref["base_position"]).max(-1)
        r = dict(ticks=ticks, wall_s=wall, s_per_tick=wall / ticks,
                 finite=all(np.isfinite(v).all() for v in got.values()
                            if v.dtype.kind == "f"),
                 z_min=float(z.min()), z_final=float(z[-1]),
                 max_dpos=float(dpos.max()), dpos_by_tick=dpos[::5].tolist(),
                 kkt_max=float(got["qp_kkt"].max()),
                 done=bool(got["done"][-1]))
        res[name] = r
        log(f"scripted {name}: " + json.dumps(r))
        if not r["finite"]:
            raise AssertionError(f"{name}: telemetry not finite")
        for k in ("step_index", "support"):
            if not np.array_equal(got[k], ref[k]):
                raise AssertionError(f"{name}: {k} differs from JAX")
        if not r["max_dpos"] <= SCRIPT_TOL:
            raise AssertionError(f"{name}: base {r['max_dpos']} m off JAX "
                                 f"(> {SCRIPT_TOL})")
        # the JAX package's tests/test_actions.py bounds
        if name == "standup":
            feet_z = float(np.abs(got["feet_world"][-1, :, 2]).max())
            if not (r["done"] and abs(r["z_final"] - 0.45) < 0.02
                    and feet_z < 2e-3):
                raise AssertionError(f"standup did not stand up: {r}")
        elif not r["z_min"] > {"trot_test": 0.3, "change_to_spot": 0.15}[name]:
            raise AssertionError(f"{name}: the base sank: {r}")
    kernel_launches = fk.launches
    # device ops of one tick of the trot window (no step entry)
    ssf, sched = runs["trot_test"]
    _, ops, busy, wall = device_ops(lambda: sl.planner_tick(
        model, params, sched, ssf))
    res.update(ops_per_tick=ops, profiled_tick_s=wall,
               profiled_tick_busy=busy / wall, kernel_launches=kernel_launches)
    log("scripted motion: " + json.dumps({k: v for k, v in res.items()
                                          if not isinstance(v, dict)}))
    if kernel_launches:
        raise AssertionError("scripted motion reached the QP kernel")
    return res


# --------------------------------------------------------------------------
# phases 13-14: the runtime (no kernel: the balance tick's QP is the generic
# IPM, as in the JAX manager)
# --------------------------------------------------------------------------

MANAGER_TICKS = 400  # 1 s at 400 Hz (tests/test_runtime.py's standing run)
EAGER_TICKS = 41  # the cold tick and 40 warm ones, rerun eagerly
BUSY_TICKS = 5  # replayed manager ticks under the profiler
BUDGET_MS = 2.5  # the 400 Hz reference loop
RT_BOUNDS = dict(bus_rate_hz=300.0, bus_jitter_p99=0.006,
                 controller_rate_hz=120.0, estop_latency_s=0.05)
RT_PACED_HZ = 40.0  # a bus period the card's controller answers within
RT_PACED_TICKS = 400  # nominal ticks of the paced run (e-stop after 320)


def _ms_stats(ms) -> dict:
    return dict(p50_ms=float(np.percentile(ms, 50)),
                p99_ms=float(np.percentile(ms, 99)))


def check_manager(device) -> dict:
    """Phase 13: SimHardware + ControllerManager + BalanceStandController
    on the card from the 0.4 m stance for MANAGER_TICKS ticks, then a
    switch to the freeze controller, then the single-leg controller on LF,
    then an e-stop."""
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.runtime import hal, manager as mgr
    from quadruped_locomotion_tpu_torch.types import RobotModel

    model = RobotModel.simpledog(device)
    hw = hal.SimHardware(model, height=0.4, device=device)
    m = mgr.ControllerManager(hw, model)
    bal = mgr.BalanceStandController(model, device=device)
    frz = mgr.FreezeController(model, device=device)
    leg = mgr.SingleLegController(model, legs=(0,), device=device)
    for c in (bal, frz, leg):
        m.register(c)
    fk.launches = 0
    t0 = time.perf_counter()
    m.switch(bal.name)  # builds and captures both balance variants
    bal.warmup(hw.read())
    capture_s = time.perf_counter() - t0
    samples, taus, tick_ms = [], [], []
    for _ in range(MANAGER_TICKS):
        t0 = time.perf_counter()
        sample = m.tick()  # the copies out of the card synchronise
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        samples.append(sample.pack())
        taus.append(m._last_tau.copy())
    end = hw.read()
    taus = np.stack(taus)
    res = dict(capture_s=capture_s, ticks=MANAGER_TICKS,
               height=float(end.base_position[2]),
               speed=float(np.linalg.norm(end.base_linear_velocity)),
               finite=bool(np.isfinite(taus).all()),
               kept_previous=m.kept_previous,
               replays=dict(cold=bal._cold.replays,
                            warm=bal._warm_tick.replays,
                            bus=hw._tick.replays),
               manager_tick=_ms_stats(tick_ms))

    # the first EAGER_TICKS samples through the eager tick (the captured
    # function): the cold tick and the warm chain it seeds
    vecs = torch.as_tensor(np.stack(samples[:EAGER_TICKS]), device=device)
    eager, eager_ms, warm = [], [], None
    for v in vecs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tau, warm = mgr._balance_vec_update(
            bal.model, bal.gains, bal.cfd, v, bal._target, warm,
            mgr.COLD_ITERS if warm is None else bal._qp_iters,
            mgr.COLD_POLISH if warm is None else mgr.WARM_POLISH)
        eager.append(tau.cpu().numpy())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    eager = np.stack(eager)
    res.update(eager_ticks=EAGER_TICKS,
               eager_equal=bool(np.array_equal(eager, taus[:EAGER_TICKS])),
               eager_max_abs_diff=float(
                   np.abs(eager - taus[:EAGER_TICKS]).max()),
               eager_tick=_ms_stats(eager_ms[1:]))

    # replayed controller and bus ticks alone, and device ops of the eager
    # cold tick, warm tick and bus step
    last = hal.RobotSample.unpack(samples[-1])
    ctrl_ms, bus_ms = [], []
    for _ in range(50):
        t0 = time.perf_counter()
        bal.update(last)
        ctrl_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        hw.write(taus[-1])
        bus_ms.append((time.perf_counter() - t0) * 1e3)
    v = vecs[-1]
    _, cold_ops, cold_busy, cold_wall = device_ops(lambda: mgr._balance_vec_update(
        bal.model, bal.gains, bal.cfd, v, bal._target, None, mgr.COLD_ITERS,
        mgr.COLD_POLISH))
    _, warm_ops, warm_busy, warm_wall = device_ops(lambda: mgr._balance_vec_update(
        bal.model, bal.gains, bal.cfd, v, bal._target, warm, bal._qp_iters,
        mgr.WARM_POLISH))
    _, bus_ops, _, _ = device_ops(hw._step_pack)
    _, _, rep_busy, rep_wall = device_ops(
        lambda: [m.tick() for _ in range(BUSY_TICKS)])
    res.update(controller_replay=_ms_stats(ctrl_ms), bus_replay=_ms_stats(bus_ms),
               ops_cold_tick=cold_ops, ops_warm_tick=warm_ops,
               ops_bus_step=bus_ops, eager_cold_busy=cold_busy / cold_wall,
               eager_warm_busy=warm_busy / warm_wall,
               replayed_manager_busy=rep_busy / rep_wall,
               budget_ms=BUDGET_MS)

    # switch to freeze, then the single-leg controller on LF, then e-stop
    m.switch(frz.name)
    m.run(40)
    m.switch(leg.name)
    m.run(40)
    switched = dict(finite=bool(np.isfinite(m._last_tau).all()),
                    kept_previous=m.kept_previous)
    m.estop()
    after = []
    for _ in range(10):
        m.tick()
        after.append(hw._tau.cpu().numpy())
    final = hw.read()
    res.update(switched=switched, estop_flag=final.estop,
               estop_max_abs_tau=float(np.abs(np.stack(after)).max()),
               estop_sample_tau=float(np.abs(final.tau).max()),
               kernel_launches=fk.launches)
    log("manager on the card: " + json.dumps(res))
    if not (abs(res["height"] - 0.4) < 0.02 and res["speed"] < 0.2):
        raise AssertionError(f"standing balance drifted: {res}")
    if not (res["finite"] and switched["finite"]):
        raise AssertionError(f"non-finite manager torques: {res}")
    if res["kept_previous"] or switched["kept_previous"]:
        raise AssertionError(f"a tick kept the previous torques: {res}")
    if not res["eager_equal"]:
        raise AssertionError(f"replayed ticks differ from the eager tick: {res}")
    if not (res["estop_flag"] and res["estop_max_abs_tau"] == 0.0
            and res["estop_sample_tau"] == 0.0):
        raise AssertionError(f"e-stop did not zero the torques: {res}")
    if fk.launches:
        raise AssertionError("the manager reached the QP kernel")
    return res


def _run_loop(name: str, **kw) -> dict:
    """One ``realtime_bench.measure`` run with the controller and the bus
    on the card; fails unless the bus ran and reported, the controller
    ticked, the e-stop round trip was observed and the rings are gone."""
    from quadruped_locomotion_tpu_torch.runtime import realtime_bench as rb

    t0 = time.perf_counter()
    rep = rb.measure(prefix=f"/qlt_torch_smoke_{os.getpid()}", device="cuda",
                     bus_device="cuda", **kw)
    rep["wall_s"] = time.perf_counter() - t0
    leftover = [p.name for p in Path("/dev/shm").glob(
        rep["prefix"].strip("/") + "_*")]
    rep["bounds"] = {k: dict(measured=rep.get(k), bound=b)
                     for k, b in RT_BOUNDS.items()}
    log(f"realtime two-process loop on the card, {name}: " + json.dumps(rep))
    if not rep.get("bus_ticks") or "bus_error" in rep:
        raise AssertionError(f"the bus did not run: {rep}")
    if rep["controller_ticks"] < 10:
        raise AssertionError(f"the controller did not tick: {rep}")
    if rep["estop_latency_s"] is None:
        raise AssertionError(f"the e-stop round trip was not observed: {rep}")
    if leftover:
        raise AssertionError(f"rings left behind: {leftover}")
    return rep


def check_realtime(duration_s: float) -> dict:
    """Phase 14: the two-process loop with the controller and the bus on
    the card, twice.

    In real time (400 Hz, ``duration_s`` nominal seconds) the JAX test's
    rate bounds are printed beside the figures, not gated, and so are the
    robot's state and the ticks that kept the previous torques: a bus
    step there takes longer than the controller's answer, so each torque
    reaches the plant one bus tick late, and the reference's balance
    controller does not stand with that delay (PERF.md §7).

    With the robot's clock slowed (the bus paced at ``RT_PACED_HZ``, the
    plant still stepping 2.5 ms per tick) the controller answers each
    sample before the next bus tick. Gates there, besides the first run's:
    no tick kept the previous torques, every sample was finite, and the
    last one before the e-stop is within phase 13's standing bounds."""
    real = _run_loop("400 Hz", duration_s=duration_s, rate_hz=400.0)
    paced = _run_loop(f"paced at {RT_PACED_HZ:g} Hz",
                      duration_s=RT_PACED_TICKS / RT_PACED_HZ,
                      rate_hz=RT_PACED_HZ, plant_dt=1.0 / 400.0)
    if paced["kept_previous"]:
        raise AssertionError(f"ticks kept the previous torques: {paced}")
    if not (paced["samples_finite"]
            and abs(paced["height_before_estop"] - 0.4) < 0.02
            and paced["speed_before_estop"] < 0.2):
        raise AssertionError(f"the robot did not stand: {paced}")
    return dict(real=real, paced=paced)


# --------------------------------------------------------------------------
# phase 15: the operator API on the card
# --------------------------------------------------------------------------

SERVER_GOLDEN = DATA / "torch_port_server_golden.npz"
CONSOLE_GOLDEN = DATA / "torch_port_console_golden.npz"
OPERATOR_WINDOWS = {"append_pause": 15, "stop_step": 15}  # window -> ticks
OPERATOR_FLOAT_TOL = 1e-6  # feedback duration and phase, time in step
CONSOLE_TOL = 1e-3  # m, the console trot against the JAX console's
TROT_SECONDS = 0.5  # 50 planner ticks


def check_operator_api(device) -> dict:
    """Phase 15: (a) the action server from two committed JAX snapshots,
    15 ticks each (a goal's first feedback appends a second goal, three
    paused ticks, the first goal's completion; a stop() with
    PREEMPT_STEP); (b) ``trot`` through the console in process at
    B = 1; (c) its telemetry plotted through ``--plot``."""
    import contextlib
    import io
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    from make_torch_port_golden import FEEDBACK_INTS, run_window
    from make_torch_port_references import slice7_goals

    from quadruped_locomotion_tpu_torch import convert
    from quadruped_locomotion_tpu_torch.api import cli
    from quadruped_locomotion_tpu_torch.api import messages as msgs
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.rollout.closed_loop import (
        CONTROL_SUBSTEPS,
    )
    from quadruped_locomotion_tpu_torch.runtime.action_server import (
        FreeGaitActionServer,
    )
    from quadruped_locomotion_tpu_torch.types import RobotModel

    golden = dict(np.load(SERVER_GOLDEN))
    model = RobotModel.simpledog(device)
    goals = slice7_goals(msgs)
    res = {}
    fk.launches = 0
    for name, ticks in OPERATOR_WINDOWS.items():
        snap = convert.unflatten(golden, f"{name}/snap/")
        srv = FreeGaitActionServer.from_snapshot(model, snap, device=device)
        c0 = srv.host_copies
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_window(srv, name, ticks, msgs, goals,
                         lambda t: t.detach().cpu().numpy())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ref = {k: golden[f"{name}/tel/{k}"] for k in got}
        dpos = np.abs(got["base_position"] - ref["base_position"][:ticks])
        # the copies: one per tick, one for the pose the appended goal is
        # resolved against, one for the executor state stop() reads
        r = dict(ticks=ticks, wall_s=wall, ms_per_tick=wall / ticks * 1e3,
                 host_copies_per_tick=(srv.host_copies - c0 - 1) / ticks,
                 max_dpos=float(dpos.max()),
                 results=got["results"].tolist(),
                 max_dphase=float(np.abs(got["phase"]
                                         - ref["phase"][:ticks]).max()),
                 finite=bool(np.isfinite(got["base_position"]).all()))
        res[name] = r
        log(f"operator server {name}: " + json.dumps(r))
        for k in (*FEEDBACK_INTS, "has_feedback", "step_id", "branches",
                  "step_index", "done", "active"):
            if not np.array_equal(got[k], ref[k][:ticks]):
                raise AssertionError(f"{name}: feedback {k} differs from "
                                     f"JAX: {got[k]} vs {ref[k][:ticks]}")
        want = ref["results"][ref["results"][:, 0] < ticks]
        if not np.array_equal(got["results"], want):
            raise AssertionError(f"{name}: results {got['results']} vs JAX "
                                 f"{want}")
        for k in ("duration", "phase", "time_in_step"):
            if not np.allclose(got[k], ref[k][:ticks], atol=OPERATOR_FLOAT_TOL,
                               rtol=0):
                raise AssertionError(f"{name}: {k} differs from JAX")
        if not (r["finite"] and r["max_dpos"] <= SCRIPT_TOL):
            raise AssertionError(f"{name}: base {r['max_dpos']} m off JAX "
                                 f"(> {SCRIPT_TOL})")
        if r["host_copies_per_tick"] != 1.0:
            raise AssertionError(f"{name}: {r['host_copies_per_tick']} "
                                 "host copies per tick")
        if name == "append_pause":
            t = got["time_in_step"]
            paused = got["status"] == msgs.PROGRESS_PAUSED
            if not (paused.sum() == 3 and np.all(t[paused] == t[0])):
                raise AssertionError(f"paused ticks moved the clock: {t}")
    res["server_kernel_launches"] = fk.launches
    if fk.launches:
        raise AssertionError("the action server reached the QP kernel")

    console = dict(np.load(CONSOLE_GOLDEN))
    want = json.loads(str(console["trot/json"]))
    fk.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "trot.png"
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["trot", "--seconds", str(TROT_SECONDS), "--plot",
                           str(png), "--device", device.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        png_bytes = png.stat().st_size if png.exists() else 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    ticks = int(TROT_SECONDS / 0.01)
    trot = dict(rc=rc, wall_s=wall, ms_per_tick=wall / ticks * 1e3,
                launches=fk.launches, line=line, jax_line=want,
                d_distance=abs(line["distance"] - want["distance"]),
                d_final_height=abs(line["final_height"] - want["final_height"]),
                plot_bytes=png_bytes)
    res["trot"] = trot
    log("operator console trot: " + json.dumps(trot))
    if rc != 0 or list(line) != list(want) or line["nan"]:
        raise AssertionError(f"console trot: rc {rc}, line {line}")
    if not (trot["d_distance"] <= CONSOLE_TOL
            and trot["d_final_height"] <= CONSOLE_TOL):
        raise AssertionError(f"console trot off the JAX console: {trot}")
    per_tick = CONTROL_SUBSTEPS if device.type == "cuda" else 0
    if fk.launches != per_tick * ticks:
        raise AssertionError(f"console trot: {fk.launches} kernel launches, "
                             f"want {per_tick * ticks}")
    if not png_bytes:
        raise AssertionError("console trot: --plot wrote no PNG")
    res["launches"] = fk.launches
    return res


# --------------------------------------------------------------------------
# phase 16: data parallelism over the scenario batch
# --------------------------------------------------------------------------

PAR_RANKS = 2  # ranks sharing the card in phase 16b
PAR_TICKS = 5  # planner ticks of the sharded closed loop
PAR_RANK_TIMEOUT_S = 400.0
PAR_BALANCE_BATCH = 1024
PAR_BALANCE_STEPS = 3
PAR_TARGET_NOISE = 0.02  # m, the balance rollout's target displacement
PAR_POS_GATE = 1e-4  # m, __graft_entry__.py's sharded-vs-single gates
PAR_Q_GATE = 1e-3  # rad
PAR_REPS = 20  # timed sweeps
SCALING_KEYS = ("metric", "value", "unit", "vs_baseline", "by_devices",
                "device")


def graft_commands(batch: int, seed: int = SEED):
    """``__graft_entry__.py``'s sharded closed-loop commands: vx in
    [-0.1, 0.3], vy in ±0.1, yaw rate in ±0.2 rad/s."""
    rng = np.random.default_rng(seed)
    lin = np.stack([rng.uniform(-0.1, 0.3, batch),
                    rng.uniform(-0.1, 0.1, batch), np.zeros(batch)], axis=1)
    return lin.astype(np.float32), rng.uniform(-0.2, 0.2, batch).astype(
        np.float32)


def parallel_inputs(device, batch: int) -> dict:
    """Phase 16's inputs, made the same way in every process: the headline
    QPs (B = 4096), the closed loop's standing start and commands
    (B = 4096), the balance rollout's stance and displaced targets."""
    from quadruped_locomotion_tpu_torch import headline
    from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.rollout import simulator as simlib
    from quadruped_locomotion_tpu_torch.types import BaseTarget, RobotModel

    model = RobotModel.simpledog(device)
    lin, wz = graft_commands(batch)
    cmd = cl.Command(linear_velocity=torch.as_tensor(lin, device=device),
                     yaw_rate=torch.as_tensor(wz, device=device))
    ls0 = cl.init_locomotion(model, GaitParams.trot_defaults(device), batch,
                             device=device)
    sims = simlib.default_stance_state(model, height=0.4,
                                       batch=(PAR_BALANCE_BATCH,))
    noise = np.random.default_rng(SEED).uniform(
        -PAR_TARGET_NOISE, PAR_TARGET_NOISE, (PAR_BALANCE_BATCH, 3))
    target = BaseTarget.from_base(sims.robot.base)
    target = target.replace(position=target.position + torch.as_tensor(
        noise, dtype=torch.float32, device=device))
    return dict(problem=headline.build_batch(batch, device), ls0=ls0, cmd=cmd,
                sims=sims, targets=target)


def _leaves(tree) -> list:
    from quadruped_locomotion_tpu_torch.types import map_tensors

    out = []
    map_tensors(tree, out.append)
    return out


def trees_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, fn, *a):
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*a)
    _sync(device)
    return out, time.perf_counter() - t0


def world1_mesh(device):
    """Phase 16a's mesh: a world of one in this process (NCCL on the card)."""
    from quadruped_locomotion_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(device=device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if (mesh.backend, mesh.shape) != (backend, (1,)):
        raise AssertionError(f"world-1 mesh: {mesh.backend} {mesh.shape}")
    return mesh


def check_world1_sweep(mesh, device, inp: dict) -> dict:
    """Phase 16a's sweep against one whole-batch solve, and the card's
    times of the sweep and of one ``all_reduce``."""
    import torch.distributed as dist

    from quadruped_locomotion_tpu_torch.model.kinematics import mv
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.parallel import distributed as pdist

    per_call = 1 if device.type == "cuda" else 0  # kernel launches
    A, b, S, W, D, d = prob = inp["problem"]
    x_ref, _, _, kkt_ref = fk.solve_weighted_ls_fd_qp(A, S, b, W, D, d)
    sweep = pdist.make_sharded_qp_sweep(mesh)
    shard = pdist.shard_problem(mesh, prob)
    n0 = fk.launches
    sol, gkkt, gerr = sweep(*shard)
    sweep_launches = fk.launches - n0
    local_err = (mv(A, x_ref) - b).abs().amax(-1).mean()
    res = {"sweep": dict(
        launches=sweep_launches, x_equal=torch.equal(sol.x, x_ref),
        kkt=float(gkkt), kkt_equal=bool(gkkt == kkt_ref.max()),
        err=float(gerr), err_local=float(local_err),
        ms_sharded=headline_ms(lambda: sweep(*shard)),
        ms_unsharded=headline_ms(lambda: fk.solve_weighted_ls_fd_qp(
            A, S, b, W, D, d)))}
    one = torch.zeros(2, device=device)
    res["all_reduce_ms"] = headline_ms(
        lambda: dist.all_reduce(one, group=mesh.group), reps=100)
    log(f"parallel world 1 sweep B={A.shape[0]}: " + json.dumps(res))
    if not (res["sweep"]["x_equal"] and res["sweep"]["kkt_equal"]
            and sweep_launches == per_call):
        raise AssertionError(f"world-1 sharded sweep: {res['sweep']}")
    if not abs(res["sweep"]["err"] - res["sweep"]["err_local"]) <= (
            1e-6 * abs(res["sweep"]["err_local"])):
        raise AssertionError(f"world-1 sweep error: {res['sweep']}")
    res["x_ref"] = x_ref.cpu().numpy()
    return res


def check_world1_rollouts(mesh, device, inp: dict) -> dict:
    """Phase 16a's closed loop and balance rollout against their unsharded
    runs, both timed warm on the host clock."""
    from quadruped_locomotion_tpu_torch.control.balance_controller import balance_update
    from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.parallel import mesh as pmesh
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.rollout import simulator as simlib
    from quadruped_locomotion_tpu_torch.types import CfdParams, RobotModel, VmcGains

    per_call = 1 if device.type == "cuda" else 0
    ticks = PAR_TICKS
    model = RobotModel.simpledog(device)
    params = ControllerParams.defaults(device)
    gp = GaitParams.trot_defaults(device)
    cl.rollout(model, params, gp, inp["ls0"], inp["cmd"], 1, device=device)
    loco = pmesh.make_sharded_locomotion_rollout(mesh, ticks)
    n0 = fk.launches
    (fin, kkt, up), wall = _timed(
        device, loco, pmesh.shard_batch(mesh, inp["ls0"]),
        pmesh.shard_batch(mesh, inp["cmd"]))
    loco_launches = fk.launches - n0
    (ref, tel), wall_ref = _timed(device, lambda: cl.rollout(
        model, params, gp, inp["ls0"], inp["cmd"], ticks, device=device))
    res = {"loco": dict(
        ticks=ticks, launches=loco_launches, upright=float(up),
        kkt=float(kkt), equal=trees_equal(fin, ref),
        kkt_equal=bool(kkt == tel["qp_kkt"].amax()),
        ms_per_tick_sharded=wall / ticks * 1e3,
        ms_per_tick_unsharded=wall_ref / ticks * 1e3)}
    log(f"parallel world 1 closed loop B={BATCH} (beside 16b and 16c): "
        + json.dumps(res["loco"]))
    if not (res["loco"]["equal"] and res["loco"]["kkt_equal"]
            and loco_launches == ticks * cl.CONTROL_SUBSTEPS * per_call
            and res["loco"]["upright"] >= 0.99
            and np.isfinite(res["loco"]["kkt"])):
        raise AssertionError(f"world-1 sharded closed loop: {res['loco']}")

    gains, cfd = VmcGains.gazebo_defaults(device), CfdParams.defaults(device)
    balance_update(model, gains, cfd, inp["sims"].robot, inp["targets"],
                   qp_iters=15)  # warm
    roll = pmesh.make_sharded_rollout(mesh, PAR_BALANCE_STEPS)
    (fin_b, err_b, kkt_b), wall_b = _timed(
        device, roll, pmesh.shard_batch(mesh, inp["sims"]),
        pmesh.shard_batch(mesh, inp["targets"]))
    s = inp["sims"]
    t0 = time.perf_counter()
    for _ in range(PAR_BALANCE_STEPS):
        tau, _ = balance_update(model, gains, cfd, s.robot, inp["targets"],
                                qp_iters=15)
        s = simlib.step(model, s, tau, 0.0025)
    _sync(device)
    res["balance"] = dict(
        batch=PAR_BALANCE_BATCH, steps=PAR_BALANCE_STEPS,
        err=float(err_b), kkt=float(kkt_b), equal=trees_equal(fin_b, s),
        ms_per_step_sharded=wall_b / PAR_BALANCE_STEPS * 1e3,
        ms_per_step_unsharded=(time.perf_counter() - t0)
        / PAR_BALANCE_STEPS * 1e3)
    log("parallel world 1 balance rollout (beside 16b and 16c): "
        + json.dumps(res["balance"]))
    if not (res["balance"]["equal"] and np.isfinite(res["balance"]["err"])
            and np.isfinite(res["balance"]["kkt"])):
        raise AssertionError(f"world-1 sharded balance rollout: "
                             f"{res['balance']}")
    res.update(pos_ref=ref.sim.robot.base.position.cpu().numpy(),
               q_ref=ref.sim.robot.q.cpu().numpy(), upright_ref=float(up))
    return res


def headline_ms(fn, reps: int = PAR_REPS) -> float:
    """Mean ms of ``fn`` on the card (CUDA events, after a warm call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def parallel_rank(rank: int, batch: int, ticks: int, device: str) -> dict:
    """Phase 16b, one of two ranks on ``device`` (gloo). Its closed loop is
    timed cold: the first tick is in its ms per tick."""
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.parallel import distributed as pdist
    from quadruped_locomotion_tpu_torch.parallel import mesh as pmesh
    from quadruped_locomotion_tpu_torch.types import full_f32_matmuls

    full_f32_matmuls()
    device = torch.device(device)
    inp = parallel_inputs(device, batch)
    prob = inp["problem"]
    fk.launches = fk.wls_launches = 0
    mesh = pmesh.make_mesh(device=device)
    pod = pdist.make_pod_mesh(device=device)
    sol, gkkt, gerr = pdist.make_sharded_qp_sweep(mesh)(
        *pdist.shard_problem(mesh, prob))
    out = {"sweep_launches": fk.launches, "mesh": mesh.shape,
           "pod": pod.shape, "backend": mesh.backend}
    x = pmesh.gather_batch(mesh, sol.x)
    sol_p, _, _ = pdist.make_sharded_qp_sweep(pod)(
        *pdist.shard_problem(pod, prob))
    xp = pmesh.gather_batch(pod, sol_p.x)
    ls0, cmd = (pmesh.shard_batch(mesh, inp[k]) for k in ("ls0", "cmd"))
    loco = pmesh.make_sharded_locomotion_rollout(mesh, ticks)
    n0 = fk.launches
    (fin, kkt, up), wall = _timed(device, loco, ls0, cmd)
    out.update(loco_launches=fk.launches - n0, kkt=float(kkt), upright=float(up))
    fin = pmesh.gather_batch(mesh, fin)
    ms = pmesh.gather_batch(mesh, torch.tensor([wall / ticks * 1e3],
                                               device=device))
    half = tuple(t[:batch // PAR_RANKS] for t in prob)
    out["overhead"] = pdist.measure_sharding_overhead(half, mesh=mesh)
    out.update(launches=fk.launches, wls_launches=fk.wls_launches,
               ms_per_tick_ranks=ms.cpu().tolist())
    if rank == 0:  # numpy: the results travel to the parent pickled
        out.update(x=x.cpu().numpy(), x_pod=xp.cpu().numpy(),
                   pos=fin.sim.robot.base.position.cpu().numpy(),
                   q=fin.sim.robot.q.cpu().numpy(), kkt_global=float(gkkt),
                   err_global=float(gerr))
    return out


def run_parallel_ranks(device, batch: int) -> tuple[list, float]:
    """Phase 16b's two ranks, spawned on the card; their results and the
    wall seconds they took."""
    from quadruped_locomotion_tpu_torch.parallel import distributed as pdist

    t0 = time.perf_counter()
    dev = str(device) if device.type == "cpu" else "cuda:0"
    ranks = pdist.run_local_ranks(parallel_rank, PAR_RANKS,
                                  (batch, PAR_TICKS, dev), device=dev,
                                  timeout=PAR_RANK_TIMEOUT_S)
    return ranks, time.perf_counter() - t0


def check_parallel_ranks(device, ranks: list, wall_s: float, ref: dict) -> dict:
    """Phase 16b's gates: the two ranks against phase 16a."""
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl

    per_call = 1 if device.type == "cuda" else 0
    r0 = ranks[0]
    res = dict(
        wall_s=wall_s, backend=r0["backend"], mesh=r0["mesh"], pod=r0["pod"],
        sweep_launches=[r["sweep_launches"] for r in ranks],
        loco_launches=[r["loco_launches"] for r in ranks],
        x_equal=bool(np.array_equal(r0["x"], ref["x_ref"])),
        x_pod_equal=bool(np.array_equal(r0["x_pod"], ref["x_ref"])),
        dpos=float(np.abs(r0["pos"] - ref["pos_ref"]).max()),
        dq=float(np.abs(r0["q"] - ref["q_ref"]).max()),
        upright=r0["upright"], upright_ref=ref["upright_ref"],
        kkt=r0["kkt"], ms_per_tick_ranks_cold=r0["ms_per_tick_ranks"],
        overhead=r0["overhead"],
        launches=sum(r["launches"] for r in ranks),
        wls_launches=sum(r["wls_launches"] for r in ranks))
    log("parallel two ranks on the card: " + json.dumps(res))
    if not (res["x_equal"] and res["x_pod_equal"]
            and res["sweep_launches"] == [per_call] * PAR_RANKS):
        raise AssertionError(f"two-rank sweep: {res}")
    if not (res["dpos"] < PAR_POS_GATE and res["dq"] < PAR_Q_GATE
            and res["upright"] == res["upright_ref"]
            and np.isfinite(res["kkt"])
            and res["loco_launches"]
            == [PAR_TICKS * cl.CONTROL_SUBSTEPS * per_call] * PAR_RANKS):
        raise AssertionError(f"two-rank closed loop: {res}")
    return res


def run_scaling_entry() -> tuple[subprocess.CompletedProcess, float]:
    """Phase 16c: ``python -m quadruped_locomotion_tpu_torch.bench
    --scaling`` as a subprocess on the one card, and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "quadruped_locomotion_tpu_torch.bench",
         "--scaling"], capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent)
    return proc, time.perf_counter() - t0


def check_scaling_entry(card: str, proc, wall_s: float) -> dict:
    """Phase 16c's gates: exit 0, bench.py's scaling keys, efficiency 1.0."""
    if proc.returncode != 0:
        raise AssertionError(f"bench --scaling exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"bench --scaling ({wall_s:.1f} s, beside 16a and 16b): "
        + json.dumps(line))
    if set(line) != set(SCALING_KEYS) or line["value"] != 1.0 or (
            line["device"] != card) or [r["devices"] for r in
                                        line["by_devices"]] != [1]:
        raise AssertionError(f"bench --scaling line: {line}")
    return line


def check_parallel(device, card: str) -> dict:
    """Phase 16: (a) a world of one in this process; (b) two ranks and (c)
    the bench entry, started in threads once (a)'s sweep has been timed on
    the card, run beside the rest of (a), whose rollouts are host-bound:
    (b) and (c) spend most of their time starting their processes."""
    import torch.distributed as dist

    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    inp = parallel_inputs(device, BATCH)
    fk.launches = fk.wls_launches = 0
    with ThreadPoolExecutor(2) as pool:
        mesh = world1_mesh(device)
        try:
            w1 = check_world1_sweep(mesh, device, inp)
            ranks = pool.submit(run_parallel_ranks, device, BATCH)
            entry = pool.submit(run_scaling_entry)
            w1.update(check_world1_rollouts(mesh, device, inp))
        finally:
            dist.destroy_process_group()
        w1_launches, w1_wls = fk.launches, fk.wls_launches
        two = check_parallel_ranks(device, *ranks.result(), w1)
        line = check_scaling_entry(card, *entry.result())
    return dict(launches=w1_launches + two["launches"],
                wls_launches=w1_wls + two["wls_launches"], scaling=line)


BENCH_HEADLINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "chain_per_dispatch",
    "batch_time_ms", "single_dispatch_solves_per_s", "single_dispatch_ms",
    "kkt_p50", "kkt_p99", "wrench_err_p50", "wrench_err_p99",
    "tail_frac_gt_1N", "tail_active_constraint_frac", "tail_oracle_gap_max",
    "tail_proven", "device")


def check_bench_entry(card: str) -> dict:
    """``python -m quadruped_locomotion_tpu_torch.bench --kernel-only`` (the
    headline) as a subprocess: its last line carries bench.py's headline
    keys and the card's name."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "quadruped_locomotion_tpu_torch.bench",
         "--kernel-only"], capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    if proc.returncode != 0:
        raise AssertionError(f"bench entry exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"bench entry ({time.perf_counter() - t0:.1f} s): " + json.dumps(line))
    missing = [k for k in BENCH_HEADLINE_KEYS if k not in line]
    if missing or line["device"] != card:
        raise AssertionError(f"bench entry line: missing {missing}, "
                             f"device {line.get('device')!r}")
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=25,
                    help="planner ticks of the massless rollout (a quick "
                         "check after a kernel change uses fewer)")
    ap.add_argument("--art-ticks", type=int, default=25,
                    help="planner ticks of the articulated rollout")
    ap.add_argument("--latency-chunks", type=int, default=1,
                    help="timed 25-tick chunks per plant at B = 1")
    ap.add_argument("--sweep-ticks", type=int, default=50,
                    help="planner ticks of the config-5 sweep")
    ap.add_argument("--est-ticks", type=int, default=100,
                    help="planner ticks of the estimated loop (>= 51)")
    ap.add_argument("--script-ticks", type=int, default=40,
                    help="closed-loop ticks of standup from tick 0 "
                         "(40-120: the JAX golden's length)")
    ap.add_argument("--rt-seconds", type=float, default=2.0,
                    help="nominal seconds of the two-process loop at 400 Hz")
    ap.add_argument("--dump", type=Path, default=None,
                    help="write the QP instances the gates look at (the "
                         "kernel's and plain version's Dx >= d violators, "
                         "the massless and articulated rollouts' worst-KKT "
                         "QPs and the headline's worst-KKT instances) to "
                         "this .npz")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.types import full_f32_matmuls

    t_start = time.perf_counter()
    full_f32_matmuls()
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(versions())

    build = fk.build_kernel()
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"built {build.path.name} in {build.seconds:.1f} s; ptxas: "
        + " | ".join(ptxas))
    report = fk.ptxas_report(build.log)
    log("fd_qp_ipm ptxas report: " + json.dumps(report))
    if report["spill_store_bytes"] or report["spill_load_bytes"]:
        raise AssertionError(f"fd_qp_ipm spills registers: {report}")

    dump = None if args.dump is None else {}
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        return out

    k = timed("kernel_check", check_kernel, BATCH, device, dump)
    m = timed("massless", check_main_path, BATCH, args.ticks, device,
              k["ms_kernel"], dump)
    h = timed("headline", check_headline, BATCH, device, dump)
    lf = timed("load_factors", check_load_factors, BATCH, device)
    a = timed("articulated", check_articulated, BATCH, args.art_ticks, device,
              dump)
    lat = timed("latency", check_latency, args.latency_chunks, device)
    sw = timed("sweep", check_sweep, BATCH, args.sweep_ticks, device, dump)
    est = timed("estimated", check_estimated, EST_BATCH, args.est_ticks,
                device)
    pre = timed("preview", check_preview, device)
    scr = timed("scripted", check_scripted, args.script_ticks, device)
    man = timed("manager", check_manager, device)
    timed("realtime", check_realtime, args.rt_seconds)
    op = timed("operator_api", check_operator_api, device)
    par = timed("parallel", check_parallel, device, card)
    timed("bench_entry", check_bench_entry, card)
    if dump is not None:
        args.dump.parent.mkdir(parents=True, exist_ok=True)
        np.savez(args.dump, **dump)

    launches = (m["launches"] + m["launches_none"] + h["launches"]
                + lf["launches"] + a["launches"] + lat["launches"]
                + sw["launches"] + est["kernel_launches"]
                + pre["kernel_launches"] + scr["kernel_launches"]
                + man["kernel_launches"] + op["launches"] + par["launches"])
    log("phase wall seconds: " + json.dumps(phase_s)
        + f"; whole script {time.perf_counter() - t_start:.1f} s")
    record = {"kernels": [{
        "name": "fd_qp_ipm",
        "route": "cuda",
        "source": "quadruped_locomotion_tpu_torch/csrc/fd_qp_ipm.cu",
        "replaces": "quadruped_locomotion_tpu/ops/qp_pallas.py:199",
        "launches": launches,
        "max_abs_err": k["max_abs_err_x"],
        "ms": k["ms_kernel"],
        "plain_ms": k["ms_plain"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }, {
        "name": "solve_weighted_ls_fd_qp",
        "route": "cuda",
        "source": "quadruped_locomotion_tpu_torch/csrc/fd_qp_ipm.cu",
        "replaces": "quadruped_locomotion_tpu/ops/qp_pallas.py:651",
        "launches": h["wls_launches"] + lf["wls_launches"]
        + par["wls_launches"],
        "max_abs_err": h["max_abs_err_x"],
        "ms": h["single_dispatch_ms"],
        "plain_ms": h["ms_plain"],
        "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"],
        "library_ms": None,
    }]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
