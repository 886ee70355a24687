"""Where the time goes in the PyTorch port's main paths on a GPU.

``--path`` selects what is profiled at B = 4096:

* ``articulated`` (default; the JAX package's default plant),
  ``massless`` or ``none``: the batched closed loop over trot scenarios
  (commands from numpy seed 0, as in ``chip_smoke.py``). Warms up, times
  ``TICKS`` planner ticks with the host clock around a synchronised run
  (wall seconds per tick, scenario-seconds per wall-second), then
  profiles ``PROFILE_TICKS`` ticks.
* ``headline``: ``PROFILE_CALLS`` eager ``solve_weighted_ls_fd_qp`` calls
  and ``PROFILE_CALLS`` replays of the headline's 10-deep CUDA graph
  (``headline.ChainGraph``) on ``headline.build_batch``.
* ``load_factors``: ``PROFILE_CALLS`` load-factor double solves
  (``solve_fd_qp_batched(load_factors=...)``) on ``chip_smoke.lf_batch``.
* ``sweep``: the config-5 scenario sweep (``sweep.build_scenarios``:
  per-scenario heightfields, the trot/pace mix, articulated plant),
  timed and profiled as the rollouts are.
* ``estimated``: the EKF-estimated closed loop at ``chip_smoke.EST_BATCH``
  scenarios with realistic sensors, timed and profiled per tick.
* ``qp_balance``: the benchmark's ``qp.balance`` caller
  (``benchmark/drivers/fd_qp.py``: 16384 QPs a call from a pool of 8,
  the largest KKT residual read on the host after each call) for its
  traced window of 300 calls.

Each profile window (``torch.profiler``, CUDA activity alone, as the
benchmark traces: recording the host's operators would slow the host
the spans time) prints the device busy share (summed device time over
the window's wall time), the CUDA kernels launched per control substep
or per call, and the top CUDA kernels by device time. The program's
spans (``utils/logging.py``) are recorded over the window, and for each
span, by name and substep, a line gives how often it ran and, per run,
its host time and self time, the device time and operations launched
inside it (each device operation joined to its launching CUDA runtime
call by correlation id) and the device idle time while the host was in
it, on the host's clock (``utils/logging.idle_intervals``).
``(outside program spans)`` is the caller's share. The QP kernel's
own time per launch is ``chip_smoke.py``'s (phase 3).

    python3 scripts/profile_torch_rollout.py [--path articulated]

Needs a CUDA card; exits 1 without one. The full profiler tables go to
``chiprun_out/profile_torch_<path>.txt``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TICKS = 10  # timed warm planner ticks
PROFILE_TICKS = 2  # ticks under torch.profiler
PROFILE_CALLS = 5  # QP calls (or graph replays) under torch.profiler
PATHS = ("articulated", "massless", "none", "headline", "load_factors",
         "sweep", "estimated", "qp_balance")


def span_rows(prof, spans: list) -> list[dict]:
    """One row per span name and substep: how often it ran and, per run,
    its host time and self time, and the device time, operations and
    idle time put down to it (``utils/logging.attribute``); then the
    caller's ``(outside program spans)`` and any operation whose launch
    the profiler did not keep, as totals over the window; then how far
    the device's timestamps ran ahead of the host's clock."""
    from quadruped_locomotion_tpu_torch.utils import logging as qlog

    def key(s):
        return (s.name, s.attrs.get("substep"))

    ops = qlog.profiler_device_ops(prof)
    rows = qlog.attribute(ops, spans, key)
    own = qlog.self_ns(spans)
    runs, host, self_ = {}, {}, {}
    for s in spans:
        k = key(s)
        runs[k] = runs.get(k, 0) + 1
        host[k] = host.get(k, 0) + s.end_ns - s.start_ns
        self_[k] = self_.get(k, 0) + own[s.id]
    out = []
    for k in sorted(runs, key=lambda k: (k[0], -1 if k[1] is None else k[1])):
        n, got = runs[k], rows.get(k, {"ops": 0, "device_s": 0.0,
                                       "idle_s": 0.0})
        out.append({"span": k[0], "substep": k[1], "runs": n,
                    "host_us": host[k] / n / 1e3,
                    "host_self_us": self_[k] / n / 1e3,
                    "device_us": got["device_s"] / n * 1e6,
                    "device_ops": got["ops"] / n,
                    "idle_us": got["idle_s"] / n * 1e6})
    for k in (qlog.OUTSIDE, qlog.UNLINKED):
        if k in rows:
            out.append({"span": k, "window_device_us": rows[k]["device_s"]
                        * 1e6, "window_device_ops": rows[k]["ops"],
                        "window_idle_us": rows[k]["idle_s"] * 1e6})
    # how far the profiler's device clock ran ahead of the host's (an
    # operation cannot start before its launch); the split does not use it
    out.append({"device_clock_lead_us": max(
        (o.launch_ns - o.start_ns for o in ops if o.launch_ns is not None),
        default=0) / 1e3})
    return out


def profile_window(path: str, fn, per: int, unit: str):
    """Run ``fn`` under torch.profiler with span recording on; print the
    busy share, the CUDA kernels per ``unit`` (``per`` units in the
    window), the top kernels and the spans' rows, and write the full
    tables to the output directory."""
    from torch.profiler import ProfilerActivity, profile

    from quadruped_locomotion_tpu_torch.utils import logging as qlog

    torch.cuda.synchronize()
    qlog.enable_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    qlog.disable_spans()
    rows = span_rows(prof, qlog.collect_spans())
    events = prof.key_averages()
    # device-side rows only (kernels, copies): host operators carry the
    # same time again as the device time of what they launched
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    print(json.dumps({
        "path": path, "window_s": window,
        "device_busy_s": device_us * 1e-6,
        "device_busy_share": device_us * 1e-6 / window,
        "cuda_kernel_launches": n_kernels,
        f"launches_per_{unit}": n_kernels / per,
    }), flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=15),
          flush=True)
    for row in rows:
        print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_torch_{path}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=60) + "\n"
        + "".join(json.dumps(row) + "\n" for row in rows))


def profile_rollout(plant: str, dev) -> None:
    import chip_smoke
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl

    B = chip_smoke.BATCH
    terrain = None
    if plant == "sweep":
        from quadruped_locomotion_tpu_torch import sweep

        sc = sweep.build_scenarios(B, chip_smoke.SEED, dev)
        model, params, gp, ls, cmd = sc.rollout_args()
        terrain, plant = sc.terrain, sweep.PLANT
    else:
        model, params, gp, ls, cmd = chip_smoke.setup_rollout(B, dev)
    state = {"ls": ls}

    def ticks(n):
        for _ in range(n):
            state["ls"], _ = cl.planner_tick(model, params, gp, state["ls"],
                                             cmd, terrain=terrain, plant=plant)

    ticks(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks(TICKS)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TICKS
    path = "sweep" if terrain is not None else plant
    print(json.dumps({"path": path, "plant": plant, "batch": B,
                      "wall_s_per_tick": wall,
                      "scenario_sim_s_per_wall_s": B * cl.PLANNER_DT / wall}),
          flush=True)
    profile_window(path, lambda: ticks(PROFILE_TICKS),
                   PROFILE_TICKS * cl.CONTROL_SUBSTEPS, "substep")


def profile_estimated(dev) -> None:
    import chip_smoke
    from quadruped_locomotion_tpu_torch.control import state_estimator as se
    from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.rollout import estimated_loop as el
    from quadruped_locomotion_tpu_torch.types import RobotModel

    B = chip_smoke.EST_BATCH
    model, gp = RobotModel.simpledog(dev), GaitParams.trot_defaults(dev)
    args = (model, ControllerParams.defaults(dev), gp.per_scenario(B),
            se.EstimatorParams.defaults(dev), el.SensorParams.realistic(dev))
    cmd = cl.Command(
        linear_velocity=torch.tensor([0.2, 0.0, 0.0], device=dev).expand(B, 3),
        yaw_rate=torch.zeros(B, device=dev))
    state = {"els": el.init_estimated(model, gp, B, seed=chip_smoke.SEED,
                                      device=dev)}

    def ticks(n):
        for _ in range(n):
            state["els"], _ = el.planner_tick_estimated(*args, state["els"],
                                                        cmd)

    ticks(2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks(TICKS)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TICKS
    print(json.dumps({"path": "estimated", "batch": B, "wall_s_per_tick": wall,
                      "scenario_sim_s_per_wall_s": B * cl.PLANNER_DT / wall}),
          flush=True)
    profile_window("estimated", lambda: ticks(PROFILE_TICKS),
                   PROFILE_TICKS * cl.CONTROL_SUBSTEPS, "substep")


def profile_qp(path: str, dev) -> None:
    import chip_smoke
    from quadruped_locomotion_tpu_torch import headline
    from quadruped_locomotion_tpu_torch.control.force_distribution import (
        solve_fd_qp_batched,
    )
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    B = chip_smoke.BATCH
    if path == "headline":
        A, b, S, W, D, d = headline.build_batch(B, dev)
        chain = headline.ChainGraph(A, b, S, W, D, d)

        def run():
            for _ in range(PROFILE_CALLS):
                fk.solve_weighted_ls_fd_qp(A, S, b, W, D, d)
            for _ in range(PROFILE_CALLS):
                chain.replay()

        per = PROFILE_CALLS * (1 + headline.CHAIN)
    else:
        A, b, S, W, D, d, sup, lf = chip_smoke.lf_batch(B, dev)

        def run():
            for _ in range(PROFILE_CALLS):
                solve_fd_qp_batched(A, b, S, W, D, d, load_factors=lf,
                                    support=sup)

        per = PROFILE_CALLS
    run()  # warm-up
    profile_window(path, run, per, "solve" if path == "headline" else "call")


def profile_qp_balance(dev) -> None:
    import chip_smoke
    from benchmark.drivers import fd_qp
    from benchmark.harness import spec
    from benchmark.harness.outcome import Context

    ctx = Context(cell=spec.load_cell("qp.balance"), seed=chip_smoke.SEED,
                  seconds=0.0, trace=True, device=dev, t0=time.time())
    s = fd_qp.setup(ctx)
    profile_window("qp_balance", lambda: fd_qp.window(ctx, s,
                                                      fd_qp.TRACED_CALLS),
                   fd_qp.TRACED_CALLS, "call")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="articulated", choices=PATHS)
    path = ap.parse_args().path
    if not torch.cuda.is_available():
        print("profile_torch_rollout: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
    from quadruped_locomotion_tpu_torch.types import full_f32_matmuls

    full_f32_matmuls()
    dev = torch.device("cuda")
    print(f"card: {chip_smoke.card_line()}", flush=True)
    fk.KERNEL.build()
    if path in ("headline", "load_factors"):
        profile_qp(path, dev)
    elif path == "qp_balance":
        profile_qp_balance(dev)
    elif path == "estimated":
        profile_estimated(dev)
    else:
        profile_rollout(path, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
