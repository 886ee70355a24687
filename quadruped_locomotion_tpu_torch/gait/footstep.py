"""Swing-foot trajectories: knot profile, timing, Hermite fit (≙
``quadruped_locomotion_tpu/gait/footstep.py``).

The four knot profiles are triangle (the gait engine's), square,
straight and trapezoid (scripted footsteps and end-effector targets).
``profile`` is one profile code for every leading index, or a tensor of
codes per leading index (e.g. per leg); all four profiles are built and
each index takes its own by gather, as the JAX package selects them.
"""

from __future__ import annotations

import torch

from .spline import MAX_KNOTS, HermiteSpline, fit

PROFILE_TRIANGLE = 0
PROFILE_SQUARE = 1
PROFILE_STRAIGHT = 2
PROFILE_TRAPEZOID = 3

DEFAULT_PROFILE_HEIGHT = 0.08
DEFAULT_AVERAGE_VELOCITY = 0.65
DEFAULT_LIFTOFF_SPEED = 0.2
DEFAULT_TOUCHDOWN_SPEED = 0.05
DEFAULT_MIN_DURATION = 0.3


def _with_z(p, z):
    return torch.cat([p[..., :2], z[..., None]], dim=-1)


def _triangle_knots(start, target, height):
    knot2 = start + 0.5 * (target - start)
    apex = torch.maximum(start[..., 2], target[..., 2]) + height
    knot2 = _with_z(knot2, apex)
    return torch.stack([start, knot2, target, target, target], dim=-2), 3


def _square_knots(start, target, height):
    basis = torch.maximum(start[..., 2], target[..., 2]) + height
    k2 = _with_z(start, basis)
    k3 = _with_z(target, basis)
    return torch.stack([start, k2, k3, target, target], dim=-2), 4


def _straight_knots(start, target, height):
    return torch.stack([start, target, target, target, target], dim=-2), 2


def _trapezoid_knots(start, target, height):
    k2 = _with_z(start + 0.1 * (target - start), start[..., 2] + height)
    k4 = _with_z(start + 0.9 * (target - start), target[..., 2] + height)
    k3 = _with_z(k2 + 0.5 * (k4 - k2), k4[..., 2])
    return torch.stack([start, k2, k3, k4, target], dim=-2), 5


KNOTS = (_triangle_knots, _square_knots, _straight_knots, _trapezoid_knots)


def fma_norm(v: torch.Tensor) -> torch.Tensor:
    """‖v‖ over a last axis of 3, rounded as PyTorch's and XLA's CPU
    norms round it (a fused multiply-add chain x², + y², + z², then the
    square root), on any device; the chain is evaluated in float64 with
    a float32 rounding per step. A swing stretched to the minimum
    duration ends within an ulp of a planner tick, so this rounding
    decides on which tick the window closes; CUDA's norm rounds
    otherwise."""
    x, y, z = v.double().unbind(-1)
    s = (x * x).to(v.dtype).double()
    s = (y * y + s).to(v.dtype).double()
    return torch.sqrt((z * z + s).to(v.dtype))


def _last(a, num_knots):
    """``a[..., num_knots - 1]`` for per-index knot counts."""
    return torch.gather(a, -1, (num_knots.long() - 1)[..., None])[..., 0]


def compute_timing(values, num_knots, average_velocity, min_duration):
    """Knot times from inter-knot distance / average velocity, stretched
    to the minimum duration when too fast. ``num_knots`` is a tensor of
    the leading shape, ``average_velocity`` a number or one."""
    deltas = fma_norm(values[..., 1:, :] - values[..., :-1, :])
    idx = torch.arange(MAX_KNOTS - 1, device=values.device)
    deltas = torch.where(idx < (num_knots - 1)[..., None], deltas,
                         torch.zeros_like(deltas))
    if isinstance(average_velocity, torch.Tensor):
        average_velocity = average_velocity[..., None]
    # a running sum in knot order (a device's scan may associate otherwise)
    dt = deltas / average_velocity
    times = [torch.zeros_like(dt[..., 0])]
    for k in range(MAX_KNOTS - 1):
        times.append(times[-1] + dt[..., k])
    times = torch.stack(times, dim=-1)
    total = _last(times, num_knots)
    scale = torch.where(total < min_duration,
                        min_duration / torch.clamp(total, min=1e-9),
                        torch.ones_like(total))
    return times * scale[..., None]


def swing_trajectory(
    start: torch.Tensor,  # (...,3)
    target: torch.Tensor,  # (...,3)
    surface_normal: torch.Tensor | None = None,
    profile: int | torch.Tensor = PROFILE_TRIANGLE,  # int or (...) codes
    profile_height: float | torch.Tensor = DEFAULT_PROFILE_HEIGHT,  # or (...)
    average_velocity: float | torch.Tensor = DEFAULT_AVERAGE_VELOCITY,  # or (...)
    liftoff_speed: float = DEFAULT_LIFTOFF_SPEED,
    touchdown_speed: float = DEFAULT_TOUCHDOWN_SPEED,
    min_duration: float = DEFAULT_MIN_DURATION,
) -> HermiteSpline:
    """One swing-foot spline per leading index."""
    if surface_normal is None:
        surface_normal = start.new_tensor([0.0, 0.0, 1.0])
    if not isinstance(profile, torch.Tensor):
        profile = torch.full(start.shape[:-1], profile, device=start.device)
    built = [k(start, target, profile_height) for k in KNOTS]
    p = profile.long()
    values = torch.gather(
        torch.stack([v for v, _ in built]), 0,
        p[None, ..., None, None].expand((1,) + built[0][0].shape))[0]
    n = torch.tensor([k for _, k in built], dtype=torch.int32,
                     device=start.device)[p]
    times = compute_timing(values, n, average_velocity, min_duration)
    # pad times beyond the real knots with the end time
    idx = torch.arange(MAX_KNOTS, device=start.device)
    times = torch.where(idx < n[..., None], times, _last(times, n)[..., None])
    lift_vel = start.new_tensor([0.0, 0.0, 1.0]) * liftoff_speed
    touch_vel = -touchdown_speed * surface_normal
    batch = start.shape[:-1]
    return fit(times, values, lift_vel.expand(batch + (3,)),
               touch_vel.expand(batch + (3,)), n)
