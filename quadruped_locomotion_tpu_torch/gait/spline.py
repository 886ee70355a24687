"""Fixed-knot cubic Hermite splines (≙ ``quadruped_locomotion_tpu/gait/
spline.py``). Every trajectory is padded to MAX_KNOTS knots by repeating
the last one; interior tangents are Catmull-Rom, endpoint tangents are
given. Leading dims are a batch of splines (e.g. scenarios × legs)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..types import TensorStruct

MAX_KNOTS = 5


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (..., K) or (..., K, 3) gathered at knot indices idx (..., J)."""
    if a.dim() == idx.dim():
        return torch.gather(a, -1, idx)
    return torch.gather(a, -2, idx[..., None].expand(idx.shape + a.shape[-1:]))


@dataclass
class HermiteSpline(TensorStruct):
    times: torch.Tensor  # (...,K) non-decreasing, padded with t_end
    values: torch.Tensor  # (...,K,3)
    tangents: torch.Tensor  # (...,K,3) derivative at each knot
    num_knots: torch.Tensor  # (...) int
    duration: torch.Tensor  # (...)

    def evaluate(self, t: torch.Tensor) -> torch.Tensor:
        return _eval(self, t, 0)

    def velocity(self, t: torch.Tensor) -> torch.Tensor:
        return _eval(self, t, 1)

    def acceleration(self, t: torch.Tensor) -> torch.Tensor:
        return _eval(self, t, 2)

    def derivatives(self, t: torch.Tensor, n: int = 3):
        """(value, velocity, acceleration)[:n] at t, one segment lookup."""
        seg = _segment(self, t)
        return tuple(_basis(d, *seg) for d in range(n))


def fit(times, values, start_velocity, end_velocity, num_knots) -> HermiteSpline:
    """Fit with given endpoint derivatives and Catmull-Rom interior
    tangents. ``times``/``values`` are padded to MAX_KNOTS by repeating
    the final knot; ``num_knots`` is (...) int."""
    k = num_knots.long()
    idx = torch.arange(MAX_KNOTS, device=times.device)
    last = k[..., None] - 1
    prev_i = torch.clamp(idx - 1, 0, MAX_KNOTS - 1).expand(times.shape)
    next_i = torch.minimum(torch.clamp(idx + 1, min=0), last)
    dt = _take(times, next_i) - _take(times, prev_i)
    safe_dt = torch.where(dt > 1e-9, dt, torch.ones_like(dt))
    catmull = (_take(values, next_i) - _take(values, prev_i)) / safe_dt[..., None]

    is_start = (idx == 0)[:, None]
    is_end = (idx >= last)[..., None]
    tangents = torch.where(
        is_start, start_velocity[..., None, :],
        torch.where(is_end, end_velocity[..., None, :], catmull),
    )
    duration = _take(times, last)[..., 0] - times[..., 0]
    return HermiteSpline(times=times, values=values, tangents=tangents,
                         num_knots=num_knots, duration=duration)


def _segment(sp: HermiteSpline, t: torch.Tensor):
    """The knot segment at t: (s, h, ok, p0, p1, m0, m1), shared by the
    value and its derivatives."""
    last = (sp.num_knots.long() - 1)[..., None]
    t = torch.minimum(torch.maximum(t, sp.times[..., 0]),
                      _take(sp.times, last)[..., 0])
    # segment: last real knot with time <= t, one lookup per spline
    idx = torch.arange(MAX_KNOTS, device=t.device)
    valid = idx < last
    seg = (valid & (sp.times <= t[..., None])).sum(-1, keepdim=True) - 1
    seg = torch.clamp(seg, 0, MAX_KNOTS - 2)

    t0 = _take(sp.times, seg)[..., 0]
    t1 = _take(sp.times, seg + 1)[..., 0]
    # Degenerate (zero-length / padded) segments short-circuit: the Hermite
    # basis cancels only up to rounding, and that residue divided by h²
    # is garbage.
    h_raw = t1 - t0
    ok = h_raw > 1e-6
    h = torch.where(ok, h_raw, torch.ones_like(h_raw))
    s = ((t - t0) / h)[..., None]
    hh = h[..., None]
    p0 = _take(sp.values, seg)[..., 0, :]
    p1 = _take(sp.values, seg + 1)[..., 0, :]
    m0 = _take(sp.tangents, seg)[..., 0, :] * hh
    m1 = _take(sp.tangents, seg + 1)[..., 0, :] * hh
    return s, hh, ok[..., None], p0, p1, m0, m1


def _basis(deriv: int, s, hh, okv, p0, p1, m0, m1) -> torch.Tensor:
    if deriv == 0:
        h00 = 2 * s**3 - 3 * s**2 + 1
        h10 = s**3 - 2 * s**2 + s
        h01 = -2 * s**3 + 3 * s**2
        h11 = s**3 - s**2
        val = h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1
        return torch.where(okv, val, p0)
    if deriv == 1:
        h00 = 6 * s**2 - 6 * s
        h10 = 3 * s**2 - 4 * s + 1
        h01 = -6 * s**2 + 6 * s
        h11 = 3 * s**2 - 2 * s
        val = (h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1) / hh
        return torch.where(okv, val, torch.zeros_like(val))
    h00 = 12 * s - 6
    h10 = 6 * s - 4
    h01 = -12 * s + 6
    h11 = 6 * s - 2
    val = (h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1) / (hh * hh)
    return torch.where(okv, val, torch.zeros_like(val))


def _eval(sp: HermiteSpline, t: torch.Tensor, deriv: int) -> torch.Tensor:
    return _basis(deriv, *_segment(sp, t))
