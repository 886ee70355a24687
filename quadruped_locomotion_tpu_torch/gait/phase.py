"""Per-leg swing/stance phase machine for trot and pace (≙
``quadruped_locomotion_tpu/gait/phase.py``). Everything is
``torch.where``-masked over (..., 4) leg arrays.

``GaitParams`` is either one set shared by every scenario (scalar and
(2,) leaves) or one set per scenario ((B,) and (B,2) leaves, e.g. a
trot/pace mix); the functions here index a leaf's own axes from the end
(``t_swing[..., None]`` against the leg axis,
``sigma_st[..., None, :]``), so both forms take the same code path and a
(B,) leaf never broadcasts along the legs."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..types import TensorStruct, resolve_device

TROT = 0
PACE = 1


@dataclass
class GaitParams(TensorStruct):
    # shapes shared / per scenario:
    t_swing: torch.Tensor  # () / (B,)
    t_stance: torch.Tensor  # () / (B,)
    height: torch.Tensor  # () / (B,) nominal base height over the footprint
    sigma_st: torch.Tensor  # (2,) / (B,2) erf widths, stance
    sigma_sw: torch.Tensor  # (2,) / (B,2) erf widths, swing
    base_avg_velocity: torch.Tensor  # () / (B,) base reference tracking speed
    capture_gain: torch.Tensor  # (2,) / (B,2) Raibert capture gain per axis
    vel_cmd_blend: torch.Tensor  # () / (B,) 0 = spline velocity, 1 = command

    @classmethod
    def trot_defaults(cls, device=None, dtype=torch.float32) -> "GaitParams":
        """The reference trot timing, 0.45 s swing / 0.45 s stance."""
        return cls._make(device, dtype, 0.45, 0.45, [1.0, 1.0])

    @classmethod
    def pace_defaults(cls, device=None, dtype=torch.float32) -> "GaitParams":
        return cls._make(device, dtype, 0.5, 1.5, [1.0, 2.2])

    def per_scenario(self, batch: int) -> "GaitParams":
        """Leaves with a leading scenario axis (B,): shared parameters are
        expanded as views; per-scenario ones must already have B rows."""
        def one(t, tail):
            if t.dim() == tail:
                return t.expand((batch,) + t.shape)
            if t.shape[0] != batch:
                raise ValueError(f"GaitParams leaf of shape {tuple(t.shape)} "
                                 f"for {batch} scenarios")
            return t
        return GaitParams(**{
            f.name: one(getattr(self, f.name),
                        1 if f.name in ("sigma_st", "sigma_sw",
                                        "capture_gain") else 0)
            for f in dataclasses.fields(self)})

    @classmethod
    def _make(cls, device, dtype, t_swing, t_stance, capture_gain):
        dev = resolve_device(device)
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
        return cls(
            t_swing=f(t_swing), t_stance=f(t_stance), height=f(0.4),
            sigma_st=f([0.8, 0.8]), sigma_sw=f([1.0, 1.0]),
            base_avg_velocity=f(0.2), capture_gain=f(capture_gain),
            vel_cmd_blend=f(1.0),
        )


@dataclass
class PhaseState(TensorStruct):
    swing_phase: torch.Tensor  # (...,4) seconds into the swing
    stance_phase: torch.Tensor  # (...,4) seconds into the stance
    is_swing: torch.Tensor  # (...,4) bool
    ready_to_swing: torch.Tensor  # (...,4) bool, one-shot at lift-off

    @classmethod
    def init_trot(cls, params: GaitParams, batch=()) -> "PhaseState":
        """LF + RH lift off on the first tick: all legs start in stance
        with the lead pair's stance timer already expired."""
        t = params.t_stance
        return cls._make(batch, torch.stack([t, 0 * t, t, 0 * t], dim=-1))

    @classmethod
    def init_pace(cls, params: GaitParams, batch=()) -> "PhaseState":
        """LF first; RH at 2/3·t_st, LH at 1/3·t_st."""
        t = params.t_stance
        return cls._make(batch, torch.stack([t, 0 * t, 2 * t / 3, t / 3],
                                            dim=-1))

    @classmethod
    def _make(cls, batch, stance):
        stance = stance.expand(*batch, 4).clone()
        no = torch.zeros(*batch, 4, dtype=torch.bool, device=stance.device)
        return cls(swing_phase=torch.zeros_like(stance), stance_phase=stance,
                   is_swing=no, ready_to_swing=no.clone())

    @property
    def support(self) -> torch.Tensor:
        return ~self.is_swing


def advance(state: PhaseState, params: GaitParams, dt: float) -> PhaseState:
    """One timer tick."""
    zero = torch.zeros_like(state.swing_phase)
    sw = state.swing_phase + torch.where(state.is_swing, dt, zero)
    st = state.stance_phase + torch.where(state.is_swing, zero, dt)
    # Half-tick tolerance so swing_done and the partner legs' stance_done
    # fire on the SAME tick despite float accumulation error.
    eps = 0.5 * dt
    t_sw, t_st = params.t_swing[..., None], params.t_stance[..., None]
    swing_done = state.is_swing & (sw > t_sw - eps)
    stance_done = ~state.is_swing & (st > t_st - eps)
    # carry the overshoot into the new phase timer
    sw_res = torch.clamp(st - t_st, min=0.0)
    st_res = torch.clamp(sw - t_sw, min=0.0)
    return PhaseState(
        swing_phase=torch.where(stance_done, sw_res,
                                torch.where(swing_done, zero, sw)),
        stance_phase=torch.where(swing_done, st_res,
                                 torch.where(stance_done, zero, st)),
        is_swing=torch.where(swing_done, False,
                             torch.where(stance_done, True, state.is_swing)),
        ready_to_swing=stance_done,
    )


def total_phase(state: PhaseState, params: GaitParams) -> torch.Tensor:
    """Normalized gait-cycle phase per leg ∈ [0,1], swing first."""
    cycle = (params.t_stance + params.t_swing)[..., None]
    return torch.where(state.is_swing, state.swing_phase / cycle,
                       (state.stance_phase + params.t_swing[..., None]) / cycle)


def com_weights(state: PhaseState, params: GaitParams) -> torch.Tensor:
    """erf-based per-leg CoM weights."""
    p = total_phase(state, params)
    sq2 = math.sqrt(2.0)
    erf = torch.special.erf
    st, sw = params.sigma_st[..., None, :], params.sigma_sw[..., None, :]
    k_st = 0.5 * (erf(p / (st[..., 0] * sq2))
                  + erf((1 - p) / (st[..., 1] * sq2)))
    k_sw = 0.5 * (2.0 + erf(-p / (sw[..., 0] * sq2))
                  + erf((p - 1) / (sw[..., 1] * sq2)))
    return torch.where(state.is_swing, k_sw, k_st)
