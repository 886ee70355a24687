"""Whole-body balance-control tick, stance path (≙ ``quadruped_locomotion_tpu/
control/balance_controller.py``): measured state and desired base motion
→ VMC wrench → force-distribution QP (the generic IPM of ``ops/qp.py``,
as in the JAX package) → stance torques clamped to ±``torque_limit``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import BaseTarget, CfdParams, RobotModel, RobotState, VmcGains
from .force_distribution import ForceDistributionResult, distribute, stance_torques
from .vmc import compute_virtual_wrench


class BalanceDiagnostics(NamedTuple):
    virtual_force: torch.Tensor  # (...,3)
    virtual_torque: torch.Tensor  # (...,3)
    distribution: ForceDistributionResult


def balance_update(
    model: RobotModel,
    vmc_gains: VmcGains,
    cfd_params: CfdParams,
    state: RobotState,
    target: BaseTarget,
    qp_iters: int = 20,
    warm: tuple[torch.Tensor, torch.Tensor] | None = None,
    polish: str = "full",
):
    """One balance-controller tick → (stance torques (...,4,3),
    diagnostics). ``warm`` is the previous tick's (x, z) QP iterates; with
    ``polish="light"`` it is the 400 Hz loop's warm configuration."""
    vf, vt = compute_virtual_wrench(model, vmc_gains, state, target)
    dist = distribute(model, cfd_params, state, vf, vt, iters=qp_iters,
                      warm=warm, polish=polish)
    tau = stance_torques(model, state, dist.contact_forces)
    tau = torch.clamp(tau, -model.torque_limit, model.torque_limit)
    return tau, BalanceDiagnostics(virtual_force=vf, virtual_torque=vt,
                                   distribution=dist)
