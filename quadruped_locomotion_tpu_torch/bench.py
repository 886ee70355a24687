"""The port's benchmark entry (≙ the repository's ``bench.py``): one JSON
line per run, with bench.py's keys for each mode plus ``"device"``, the
card's name and power limit (``nvidia-smi``), or ``"cpu"``.

    python -m quadruped_locomotion_tpu_torch.bench [batch]      # headline
    python -m quadruped_locomotion_tpu_torch.bench --latency [ticks]
    python -m quadruped_locomotion_tpu_torch.bench --sweep [batch]
    python -m quadruped_locomotion_tpu_torch.bench --roofline [batch]
    python -m quadruped_locomotion_tpu_torch.bench --scaling [batch]
    torchrun --nproc_per_node=N -m quadruped_locomotion_tpu_torch.bench --scaling [batch]

* headline (default, batch 4096): batched force-distribution QP solves
  per second through the CUDA kernel (``headline.measure``: a CUDA-graph
  chain of 10 dependent solves, bench.py's quality gates' figures), plus
  bench.py's whole-system extras, the B = 1 latency and a 1024 x 20-tick
  sweep, unless ``--kernel-only``; ``--iters=N`` sets the IPM iterations.
* ``--latency [ticks]`` (400): per-400 Hz-control-tick latency at B = 1
  through the kernel, controller only (plant "none") and with the
  articulated plant, in 25-tick chunks (at least 8), and one planner tick
  per dispatch.
* ``--sweep [batch]`` (1024): the config-5 scenario sweep, 100 ticks.
* ``--roofline [batch]`` (4096): the kernel's achieved float32 rate
  against the H100's 67 TFLOP/s, from the algorithm's operation count
  (``fd_qp_kernel.weighted_ls_fd_qp_flops``) and the timed solves; the
  launch geometry (instances per block, resident blocks per SM, the share
  of half-warps that carry an instance) goes to stderr.
* ``--scaling [batch]`` (4096 per card): weak scaling of the sharded QP
  sweep (``parallel/distributed.py::measure_scaling``, the kernel inside
  every shard) over 1, 2 and all the ranks that torchrun started, one per
  card; alone it is one rank on one card and reports efficiency 1.0. Rank
  0 prints the line, with every device count's figures under
  ``"by_devices"``.

Every mode runs on the card and raises where CUDA is absent; the
functions below take ``device="cpu"`` for the latency, sweep and
scaling modes (host clock), while the headline and the roofline time the card and raise
off it. Nothing here catches a failure.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE_SOLVES_PER_S = 10_000.0  # bench.py's north-star bar
BUDGET_MS = 2.5  # the 400 Hz reference loop
SCALING_BAR = 0.85  # bench.py's weak-scaling efficiency bar
SCALING_REPS = 10  # timed sweeps per device count (bench.py's)
F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores
LATENCY_CHUNK = 25  # planner ticks per timed chunk (bench.py's)


def device_line(device) -> str:
    """``name, power limit`` of the card (``nvidia-smi``), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def latency_measure(chunks: int, device=None, dispatches: int = 50,
                    chunk: int = LATENCY_CHUNK, warmup: int = 5) -> dict:
    """Per-control-tick ms at B = 1, vx = 0.2 m/s (bench.py's
    ``_latency_measure``): after a ``warmup``-tick rollout, ``chunks``
    rollouts of ``chunk`` planner ticks each, with plant "none"
    (controller only) and "articulated"; then ``dispatches`` one-tick
    rollouts with plant "none" (one planner tick per dispatch). Raises
    unless the kernel ran exactly 4 times per planner tick on the card (0
    on the CPU), or if the telemetry is not finite."""
    from .rollout import closed_loop as cl
    from .control.locomotion import ControllerParams
    from .gait.phase import GaitParams
    from .types import RobotModel, full_f32_matmuls, resolve_device
    from .utils.logging import counters

    dev = resolve_device(device)
    full_f32_matmuls()
    model = RobotModel.simpledog(dev)
    params = ControllerParams.defaults(dev)
    gp = GaitParams.trot_defaults(dev)
    ls0 = cl.init_locomotion(model, gp, 1, device=dev)
    cmd = cl.Command(linear_velocity=torch.tensor([[0.2, 0.0, 0.0]], device=dev),
                     yaw_rate=torch.zeros(1, device=dev))
    per_tick = cl.CONTROL_SUBSTEPS if dev.type == "cuda" else 0
    out = {"launches": 0, "device": dev.type}

    def roll(ls, ticks, plant):
        return cl.rollout(model, params, gp, ls, cmd, ticks, plant=plant,
                          device=dev)

    for plant in ("none", "articulated"):
        counters["qp.kernel_launches"] = 0
        ls, _ = roll(ls0, warmup, plant)
        per_ctrl = []
        for _ in range(chunks):
            _sync(dev)
            t0 = time.perf_counter()
            ls, tel = roll(ls, chunk, plant)
            _sync(dev)
            per_ctrl.append((time.perf_counter() - t0) * 1e3
                            / (chunk * cl.CONTROL_SUBSTEPS))
        want = (warmup + chunks * chunk) * per_tick
        launches = counters["qp.kernel_launches"]
        if launches != want:
            raise AssertionError(f"latency {plant}: {launches} launches, "
                                 f"want {want}")
        if not torch.isfinite(tel["base_position"]).all():
            raise AssertionError(f"latency {plant}: telemetry not finite")
        out["launches"] += launches
        out[plant] = dict(p50_ms=float(np.percentile(per_ctrl, 50)),
                          p99_ms=float(np.percentile(per_ctrl, 99)),
                          chunks_ms=per_ctrl)
    counters["qp.kernel_launches"] = 0
    disp = []
    for _ in range(dispatches):
        _sync(dev)
        t0 = time.perf_counter()
        ls, _ = roll(ls, 1, "none")
        _sync(dev)
        disp.append((time.perf_counter() - t0) * 1e3 / cl.CONTROL_SUBSTEPS)
    launches = counters["qp.kernel_launches"]
    if launches != dispatches * per_tick:
        raise AssertionError(f"latency dispatches: {launches} launches")
    out["launches"] += launches
    out["per_dispatch_p50_ms"] = float(np.percentile(disp, 50))
    return out


def latency_record(lat: dict) -> dict:
    c99 = lat["none"]["p99_ms"]
    return {
        "metric": "closed-loop 400 Hz control-tick latency "
                  "(controller-only, B = 1 through the CUDA kernel, p99)",
        "value": c99,
        "unit": "ms",
        "vs_baseline": BUDGET_MS / c99,  # > 1 beats the 2.5 ms budget
        "p50_ms": lat["none"]["p50_ms"],
        "with_plant_p50_ms": lat["articulated"]["p50_ms"],
        "with_plant_p99_ms": lat["articulated"]["p99_ms"],
        "per_dispatch_p50_ms": lat["per_dispatch_p50_ms"],
    }


def sweep_record(res: dict) -> dict:
    return {
        "metric": "closed-loop scenario sweep "
                  "(robots simulated+controlled in real time per chip)",
        "value": res["rt_factor"],
        "unit": "robots (scenario.sim-s/wall-s)",
        "vs_baseline": res["rt_factor"] / 1.0,
        "upright_frac": res["upright_frac"],
        "qp_backend": res["qp_backend"],
        "sweep_batch": res["batch"],
        "sweep_ticks": res["ticks"],
        "scenario_axes": res["scenario_axes"],
        "pallas_vs_xla_speedup": None,  # no second backend to compare
    }


def sweep_run(batch: int, ticks: int, device=None) -> dict:
    from . import sweep
    from .types import resolve_device

    dev = resolve_device(device)
    res = sweep.measure(batch, ticks, device=dev)
    res["qp_backend"] = "kernel" if dev.type == "cuda" else "plain"
    return res


def headline_extras(batch: int, device) -> dict:
    """bench.py's whole-system extras of the headline run."""
    lat = latency_measure(max(100 // LATENCY_CHUNK, 8), device)
    sw = sweep_run(min(batch, 1024), 20, device)
    return {
        "latency_ctrl_p50_ms": lat["none"]["p50_ms"],
        "latency_ctrl_p99_ms": lat["none"]["p99_ms"],
        "latency_with_plant_p99_ms": lat["articulated"]["p99_ms"],
        "latency_per_dispatch_p50_ms": lat["per_dispatch_p50_ms"],
        "sweep_robots_realtime": sw["rt_factor"],
        "sweep_upright_frac": sw["upright_frac"],
        "sweep_qp_backend": sw["qp_backend"],
        "sweep_batch": sw["batch"],
        "sweep_ticks": sw["ticks"],
        "sweep_scenario_axes": sw["scenario_axes"],
    }


def headline_record(res: dict, extras: dict) -> dict:
    return {
        "metric": "4-contact force-distribution QP solves/s/chip",
        "value": res["solves_per_s"],
        "unit": "solves/s",
        "vs_baseline": res["solves_per_s"] / BASELINE_SOLVES_PER_S,
        "chain_per_dispatch": res["chain_per_dispatch"],
        "batch_time_ms": res["batch_time_ms"],
        "single_dispatch_solves_per_s": res["single_dispatch_solves_per_s"],
        "single_dispatch_ms": res["single_dispatch_ms"],
        "kkt_p50": res["kkt_p50"],
        "kkt_p99": res["kkt_p99"],
        "wrench_err_p50": res["wrench_err_p50"],
        "wrench_err_p99": res["wrench_err_p99"],
        "tail_frac_gt_1N": res["tail_frac_gt_1N"],
        "tail_active_constraint_frac": res["tail_active_constraint_frac"],
        "tail_oracle_gap_max": res["tail_oracle_gap_max"],
        "tail_proven": res["tail_proven"],
        **extras,
    }


def roofline_measure(batch: int, iters: int = 15, device=None) -> dict:
    """Solves per second of one eager ``solve_weighted_ls_fd_qp`` call at
    ``batch`` (CUDA events, 20 calls) and the achieved float32 rate from
    the algorithm's operation count. Raises off the card."""
    from . import headline
    from .ops import fd_qp_kernel as fk
    from .types import full_f32_matmuls, resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the roofline times the card; got device {dev}")
    full_f32_matmuls()
    A, b, S, W, D, d = headline.build_batch(batch, dev)
    ms = headline.cuda_ms(lambda: fk.solve_weighted_ls_fd_qp(
        A, S, b, W, D, d, iters=iters), 20)
    flops = float(fk.weighted_ls_fd_qp_flops(iters))
    solves_per_s = batch * 1e3 / ms
    return {"flops_per_solve": flops, "solves_per_s": solves_per_s,
            "ms": ms, "achieved_flop_s": flops * solves_per_s,
            "geometry": fk.KERNEL.geometry(batch)}


def roofline_record(res: dict) -> dict:
    return {
        "metric": "QP kernel roofline (fraction of H100 float32 peak)",
        "value": 100.0 * res["achieved_flop_s"] / F32_PEAK,
        "unit": "% of 67 TFLOP/s",
        "vs_baseline": res["solves_per_s"] / BASELINE_SOLVES_PER_S,
        "flops_per_solve": res["flops_per_solve"],
        "solves_per_s": res["solves_per_s"],
    }


def scaling_measure(batch: int, iters: int = 15, device=None) -> dict:
    """``measure_scaling`` of the sharded QP sweep with ``batch`` headline
    QPs per rank: joins torchrun's process group if there is one, else
    runs as a world of one in this process. ``device`` defaults to
    ``cuda:$LOCAL_RANK``."""
    from . import headline
    from .parallel import distributed as pdist
    from .parallel.mesh import rank_device
    from .types import full_f32_matmuls

    dev = rank_device(device)
    full_f32_matmuls()
    pdist.initialize_multihost(device=dev)
    problem = headline.build_batch(batch, dev)
    return pdist.measure_scaling(problem, iters=iters, reps=SCALING_REPS,
                                 backend="auto", device=dev)


def scaling_record(res: dict) -> dict:
    """bench.py's scaling keys for the largest device count, plus
    ``"by_devices"``: every count's figures, which bench.py prints only
    to stderr."""
    top = res[max(res)]
    return {
        "metric": f"QP sweep weak-scaling efficiency ({max(res)} devices)",
        "value": top["efficiency"],
        "unit": "fraction",
        "vs_baseline": top["efficiency"] / SCALING_BAR,
        "by_devices": [res[n] for n in sorted(res)],
    }


def scaling_main(batch: int, iters: int) -> int:
    """``--scaling``: every rank measures, rank 0 prints the line."""
    import torch.distributed as dist

    from .parallel.mesh import rank_device

    res = scaling_measure(batch, iters)
    rank = dist.get_rank()
    dist.destroy_process_group()
    if rank != 0:
        return 0
    for n, r in sorted(res.items()):
        print(f"devices={n} solves/s={r['solves_per_s']:.1f} "
              f"efficiency={r['efficiency']:.3f} max_kkt={r['max_kkt']:.2e}",
              file=sys.stderr)
    record = scaling_record(res)
    record["device"] = device_line(rank_device())
    print(json.dumps(record))
    return 0


def main(argv: list[str] | None = None) -> int:
    """bench.py's command line; prints one JSON line and returns 0."""
    from . import headline
    from .types import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    nums = [a for a in argv if not a.startswith("--")]
    iters = 15
    for a in argv:
        if a.startswith("--iters="):
            iters = int(a.split("=")[1])
    if "--scaling" in argv:
        return scaling_main(int(nums[0]) if nums else 4096, iters)
    dev = resolve_device(None)
    if "--latency" in argv:
        ticks = int(nums[0]) if nums else 400
        record = latency_record(latency_measure(
            max(ticks // LATENCY_CHUNK, 8), dev))
    elif "--sweep" in argv:
        record = sweep_record(sweep_run(int(nums[0]) if nums else 1024, 100,
                                        dev))
    elif "--roofline" in argv:
        res = roofline_measure(int(nums[0]) if nums else 4096, iters, dev)
        print(f"roofline launch: {json.dumps(res['geometry'])}",
              file=sys.stderr)
        record = roofline_record(res)
    else:
        batch = int(nums[0]) if nums else 4096
        res = headline.measure(batch, iters, device=dev)
        extras = {} if "--kernel-only" in argv else headline_extras(batch, dev)
        print(f"headline: {json.dumps(res)}", file=sys.stderr)
        record = headline_record(res, extras)
    record["device"] = device_line(dev)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
