"""The config-5 scenario sweep on the GPU: terrain × gait × velocity through
the batched closed loop (≙ ``bench.py``'s ``build_scenarios`` and
``_sweep_measure``, the workload the JAX package reports as its scenario
sweep).

Every 400 Hz control substep of every scenario runs through one batched
force-distribution QP launch (the CUDA kernel on the card), over
per-scenario heightfields, a per-scenario trot/pace mix and per-scenario
velocity commands, with the articulated plant.

    from quadruped_locomotion_tpu_torch import sweep
    res = sweep.measure(4096, ticks=100)   # needs CUDA unless device="cpu"
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .control.locomotion import ControllerParams
from .gait import phase as phase_mod
from .gait.phase import GaitParams
from .rollout import closed_loop as cl
from .terrain.heightfield import Heightfield
from .types import RobotModel, full_f32_matmuls, resolve_device, where_tree

SCENARIO_AXES = (
    "terrain(75% heightfields ±3cm, 25% flat) x "
    "gait(75% trot 0.45/0.45, 25% pace 0.5/1.5) x "
    "velocity(vx -0.1..0.4, vy ±0.1, yaw ±0.3)"
)
MAP_CELLS = 48  # per side
COARSE_CELLS = 8  # per side of the random grid that is upsampled
RESOLUTION = 0.1  # m per cell
EXTENT = 2.4  # the map spans [-EXTENT, EXTENT) in x and y
# half-widths (x, y) of the flat spawn box; bumps ramp in over 0.4 box units
FLAT_ZONE = (0.65, 0.45)
PLANT = "articulated"


def cubic_resize(a: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, n, n) -> (B, n_out, n_out) as ``jax.image.resize(a, (B, n_out,
    n_out), "cubic")``, applied separably: per axis, float32 weights of
    the Keys cubic kernel with a = -0.5 at half-pixel centres, columns
    renormalised to sum to 1 (which changes the border columns), in the
    reference's operation order. ``F.interpolate(mode="bicubic")``
    differs (a = -0.75, clamped borders)."""
    n_in, f32 = a.shape[-1], torch.float32
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * (n_in / n_out) - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=f32)[:, None])
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w)).to(a.device)
    return w.mT @ a @ w


def heightfields(coarse: np.ndarray, amp: np.ndarray, device) -> Heightfield:
    """Per-scenario maps: the (B, 8, 8) coarse grid upsampled to 48×48
    (cubic), scaled by ``amp`` (B,) and by a ramp that is 0 inside the
    flat spawn box (``FLAT_ZONE``, covering the stance feet at the start)
    and reaches 1 within 0.4 box units beyond it."""
    rough = cubic_resize(torch.as_tensor(coarse, dtype=torch.float32,
                                         device=device), MAP_CELLS)
    xs = -EXTENT + np.arange(MAP_CELLS) * RESOLUTION
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    box = np.maximum(np.abs(gx) / FLAT_ZONE[0], np.abs(gy) / FLAT_ZONE[1])
    ramp = torch.as_tensor(np.clip((box - 1.0) / 0.4, 0.0, 1.0),
                           dtype=torch.float32, device=device)
    amp = torch.as_tensor(amp, dtype=torch.float32, device=device)
    height = rough * amp[:, None, None] * ramp[None, :, :]
    return Heightfield.from_height_array(height, origin=(-EXTENT, -EXTENT),
                                         resolution=RESOLUTION)


@dataclass
class Scenarios:
    model: RobotModel
    params: ControllerParams
    gait_params: GaitParams  # per scenario
    ls0: cl.LocomotionState
    command: cl.Command
    terrain: Heightfield  # one map per scenario

    def rollout_args(self):
        return (self.model, self.params, self.gait_params, self.ls0,
                self.command)


def build_scenarios(batch: int, seed: int = 0, device=None) -> Scenarios:
    """The config-5 scenario batch on ``device`` (default CUDA; raises
    where it is absent), drawn as ``bench.build_scenarios`` draws it from
    ``numpy.random.default_rng(seed)``:

    * gait: a 3:1 trot/pace interleave (scenario i paces where
      i % 4 == 3), each with its defaults and its init table;
    * velocity: vx in [-0.1, 0.4] (trot) / [0, 0.15] (pace), vy ±0.1 /
      ±0.05, yaw rate ±0.3 / ±0.15 rad/s; both branches of each choice
      are drawn, in that order;
    * terrain: 48×48 maps at 0.1 m from an (8, 8) normal grid, cubic
      upsampling, amplitudes in [0.01, 0.03] m except for the flat
      scenarios (i % 4 == 2), ramped in beyond a flat spawn box.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = RobotModel.simpledog(dev)
    params = ControllerParams.defaults(dev)

    idx = np.arange(batch)
    is_pace = idx % 4 == 3
    pace = torch.as_tensor(is_pace, device=dev)
    gp = where_tree(pace, GaitParams.pace_defaults(dev).per_scenario(batch),
                    GaitParams.trot_defaults(dev).per_scenario(batch))
    gait_type = torch.where(pace, phase_mod.PACE, phase_mod.TROT)
    ls0 = cl.init_locomotion_mixed(model, gp, gait_type, device=dev)

    vx = np.where(is_pace, rng.uniform(0.0, 0.15, batch),
                  rng.uniform(-0.1, 0.4, batch))
    vy = np.where(is_pace, rng.uniform(-0.05, 0.05, batch),
                  rng.uniform(-0.1, 0.1, batch))
    wz = np.where(is_pace, rng.uniform(-0.15, 0.15, batch),
                  rng.uniform(-0.3, 0.3, batch))
    cmd = cl.Command(
        linear_velocity=torch.as_tensor(
            np.stack([vx, vy, np.zeros(batch)], axis=1), dtype=torch.float32,
            device=dev),
        yaw_rate=torch.as_tensor(wz, dtype=torch.float32, device=dev))

    coarse = rng.normal(size=(batch, COARSE_CELLS, COARSE_CELLS)).astype(
        np.float32)
    amp = np.where(idx % 4 == 2, 0.0,
                   rng.uniform(0.01, 0.03, batch)).astype(np.float32)
    terrain = heightfields(coarse, amp, dev)
    return Scenarios(model, params, gp, ls0, cmd, terrain)


def run(sc: Scenarios, ticks: int, qp_backend: str = "auto"):
    """``ticks`` planner ticks of the scenarios from their start on the
    scenarios' device. Returns (final state, telemetry of every tick:
    (T, B, ...))."""
    return cl.rollout(sc.model, sc.params, sc.gait_params, sc.ls0,
                      sc.command, ticks, terrain=sc.terrain, plant=PLANT,
                      qp_backend=qp_backend,
                      device=sc.ls0.sim.feet_world.device)


def _summarize(sc: Scenarios, tel: dict, wall_s: float) -> dict:
    """bench.py's sweep fields. ``upright_frac``: the share of scenarios
    whose final base height over the ground under it exceeds 0.25 m;
    ``p99_kkt`` over every tick and scenario (bench takes its last
    chunk's)."""
    base = tel["base_position"]
    T, B = base.shape[:2]
    gz = sc.terrain.height_at(base[-1, :, :2])
    kkt = tel["qp_kkt"].double().cpu().numpy()
    return {
        "rt_factor": B * T * cl.PLANNER_DT / wall_s,
        "wall_s": wall_s,
        "finite": all(bool(torch.isfinite(v).all()) for v in tel.values()
                      if v.is_floating_point()),
        "upright_frac": ((base[-1, :, 2] - gz) > 0.25).float().mean().item(),
        "p99_kkt": float(np.percentile(kkt, 99)),
        "max_kkt": float(kkt.max()),
        "batch": B,
        "ticks": T,
        "scenario_axes": SCENARIO_AXES,
    }


def measure(batch: int = 4096, ticks: int = 100, device=None) -> dict:
    """Time the whole closed loop (gait engine, contact FSM, controller,
    one batched QP launch per control substep, articulated plant) over
    ``batch`` config-5 scenarios for ``ticks`` planner ticks, after a
    one-tick warm-up, with the host clock around a synchronised run.
    Returns bench.py's fields: ``rt_factor`` (scenario-sim-seconds per
    wall-second), ``wall_s``, ``finite``, ``upright_frac``, ``p99_kkt``,
    ``batch``, ``ticks``, ``scenario_axes``."""
    dev = resolve_device(device)
    full_f32_matmuls()
    sc = build_scenarios(batch, 0, dev)
    run(sc, 1)  # warm-up: first-use costs of the kernels and libraries
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    _, tel = run(sc, ticks)
    sync()
    return _summarize(sc, tel, time.perf_counter() - t0)
