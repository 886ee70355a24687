"""Per-leg contact-event state machine with memory + reflexes (≙
``quadruped_locomotion_tpu/control/contact_fsm.py``).

The gait's desired per-leg mode is reconciled with measured foot contact
every control tick into the nine StateSwitcher states; the effective
support set goes to the force-distribution QP and the swing references
get late-touchdown / bump reflexes. All arrays carry leading batch dims
before the leg axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..types import TensorStruct, resolve_device

# State codes ≙ StateSwitcher::States, same order.
INIT = 0
STANCE_NORMAL = 1
STANCE_SLIPPING = 2
STANCE_LOST = 3
SWING_NORMAL = 4
SWING_LATE_LIFTOFF = 5
SWING_EARLY_TD = 6
SWING_BUMPED = 7
SWING_LATE_TD = 8

EARLY_TD_PHASE = 0.5  # contact past this swing phase = touchdown
BUMP_PHASE = 0.2  # contact past this (but before EARLY_TD) = obstacle
LATE_TD_PHASE = 0.1  # no contact before this stance phase = late TD
LOST_CONTACT_PHASE = 0.5  # no contact past this stance phase = lost

DEFAULT_SLIP_SPEED = 0.15  # m/s tangential foot speed ⇒ slipping


@dataclass
class FsmState(TensorStruct):
    """Per-leg FSM memory carried through the control loop."""

    leg_state: torch.Tensor  # (...,4) int32 state code
    stored_q: torch.Tensor  # (...,4,3) joint positions stored at freeze entry
    store_flag: torch.Tensor  # (...,4) bool


def init_fsm_state(batch=(), device=None, dtype=torch.float32) -> FsmState:
    """All legs in ``INIT`` (support until reconciled)."""
    dev = resolve_device(device)
    return FsmState(
        leg_state=torch.full((*batch, 4), INIT, dtype=torch.int32, device=dev),
        stored_q=torch.zeros((*batch, 4, 3), dtype=dtype, device=dev),
        store_flag=torch.zeros((*batch, 4), dtype=torch.bool, device=dev),
    )


class FsmOutput(NamedTuple):
    support: torch.Tensor  # (...,4) bool — legs the QP should load
    leg_state: torch.Tensor  # (...,4) int32
    late_touchdown: torch.Tensor  # (...,4) bool — drive-foot-down reflex
    bumped: torch.Tensor  # (...,4) bool — retract reflex
    freeze: torch.Tensor  # (...,4) bool — joint-freeze reflex
    q_freeze: torch.Tensor  # (...,4,3) joint positions held when frozen


def fsm_step(
    fsm: FsmState,
    desired_support: torch.Tensor,  # (...,4) bool from the gait
    contact: torch.Tensor,  # (...,4) bool measured contact
    swing_phase: torch.Tensor,  # (...,4) normalized ∈ [0,1]
    stance_phase: torch.Tensor,  # (...,4) normalized ∈ [0,1]
    q: torch.Tensor,  # (...,4,3) measured joint positions
    is_footstep: torch.Tensor | None = None,  # (...,4) bool reflexes enabled
    foot_speed_tangential: torch.Tensor | None = None,  # (...,4) m/s
    slip_speed_threshold: float = DEFAULT_SLIP_SPEED,
) -> tuple[FsmState, FsmOutput]:
    """One reconciliation tick: transition + reaction."""
    if is_footstep is None:
        is_footstep = torch.ones_like(contact)
    prev = fsm.leg_state

    # desired swing
    early_td = contact & (swing_phase > EARLY_TD_PHASE)
    bumped_now = contact & (swing_phase > BUMP_PHASE) & ~early_td
    late_liftoff = contact & (swing_phase <= BUMP_PHASE)
    swing_state = torch.where(
        is_footstep & early_td, SWING_EARLY_TD,
        torch.where(
            is_footstep & bumped_now, SWING_BUMPED,
            torch.where(is_footstep & late_liftoff, SWING_LATE_LIFTOFF,
                        SWING_NORMAL),
        ),
    )

    # desired stance: late TD before 0.1, lost past 0.5, previous state
    # held in between (a held INIT resolves to LATE_TD)
    if foot_speed_tangential is None:
        slipping = torch.zeros_like(contact)
    else:
        slipping = foot_speed_tangential > slip_speed_threshold
    stance_contact = torch.where(slipping, STANCE_SLIPPING, STANCE_NORMAL)
    held = torch.where(prev == INIT, SWING_LATE_TD, prev)
    stance_nocontact = torch.where(
        stance_phase < LATE_TD_PHASE, SWING_LATE_TD,
        torch.where(stance_phase > LOST_CONTACT_PHASE, STANCE_LOST, held),
    )
    stance_state = torch.where(~is_footstep | contact, stance_contact,
                               stance_nocontact)
    leg_state = torch.where(desired_support, stance_state, swing_state).to(
        torch.int32)

    # reactions
    support = (
        (leg_state == STANCE_NORMAL) | (leg_state == STANCE_SLIPPING)
        | (leg_state == SWING_EARLY_TD) | (leg_state == INIT)
    )
    late_td = leg_state == SWING_LATE_TD
    bumped = leg_state == SWING_BUMPED
    freeze = leg_state == STANCE_LOST

    # freeze-posture store-once: capture q on entry into a freezing state,
    # clear the flag back in a normal state
    entering = (freeze | late_td) & ~fsm.store_flag
    stored_q = torch.where(entering[..., None], q, fsm.stored_q)
    normal = (leg_state == STANCE_NORMAL) | (leg_state == SWING_NORMAL)
    store_flag = (fsm.store_flag | entering) & ~normal

    out = FsmOutput(support=support, leg_state=leg_state,
                    late_touchdown=late_td, bumped=bumped, freeze=freeze,
                    q_freeze=stored_q)
    return FsmState(leg_state=leg_state, stored_q=stored_q,
                    store_flag=store_flag), out


def contact_fsm(desired_support: torch.Tensor, contact: torch.Tensor,
                swing_phase: torch.Tensor, t_swing) -> FsmOutput:
    """Stateless single-tick reconciliation (no memory, no lost-contact
    detection): :func:`fsm_step` from a fresh mid-stance state, with the
    stance phase pinned to 0. ``swing_phase`` (..., 4) is in seconds."""
    t = torch.clamp(torch.as_tensor(t_swing, dtype=swing_phase.dtype,
                                    device=swing_phase.device), min=1e-6)
    batch = swing_phase.shape[:-1]
    fsm0 = FsmState(
        leg_state=torch.full((*batch, 4), STANCE_NORMAL, dtype=torch.int32,
                             device=swing_phase.device),
        stored_q=torch.zeros((*batch, 4, 3), dtype=swing_phase.dtype,
                             device=swing_phase.device),
        store_flag=torch.zeros((*batch, 4), dtype=torch.bool,
                               device=swing_phase.device),
    )
    _, out = fsm_step(fsm0, desired_support, contact, swing_phase / t,
                      torch.zeros_like(swing_phase), fsm0.stored_q)
    return out


def apply_swing_reflexes(
    pos_ref: torch.Tensor,  # (...,4,3) world swing references
    vel_ref: torch.Tensor,
    acc_ref: torch.Tensor,
    feet_world: torch.Tensor,  # (...,4,3) measured foot positions
    fsm: FsmOutput,
    ground_height: torch.Tensor | float = 0.0,
    touchdown_speed: float = 0.10,
    retract_height: float = 0.05,
    retract_back: float = 0.0125,
):
    """Late TD: hold the horizontal target, drive z down at the touchdown
    speed from the measured foot height. Bump: move the foot up and back
    from its measured position."""
    gz = torch.as_tensor(ground_height, dtype=pos_ref.dtype,
                         device=pos_ref.device)
    zero_leg = torch.zeros_like(pos_ref[..., 0])

    down = fsm.late_touchdown[..., None]
    pos_down = torch.stack(
        [pos_ref[..., 0], pos_ref[..., 1],
         torch.minimum(feet_world[..., 2] - 0.01, gz)], dim=-1)
    vel_down = torch.stack(
        [zero_leg, zero_leg, torch.full_like(zero_leg, -touchdown_speed)],
        dim=-1)

    up = fsm.bumped[..., None]
    pos_up = torch.stack(
        [feet_world[..., 0] - retract_back, feet_world[..., 1],
         feet_world[..., 2] + retract_height], dim=-1)

    zero = torch.zeros_like(pos_ref)
    pos = torch.where(down, pos_down, torch.where(up, pos_up, pos_ref))
    vel = torch.where(down, vel_down, torch.where(up, zero, vel_ref))
    acc = torch.where(down | up, zero, acc_ref)
    return pos, vel, acc
