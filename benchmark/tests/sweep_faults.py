"""Faults planted underneath the closed-loop cell's timed path, for the
test that sees ``correct`` come out false. Each ``plant(fault)`` replaces
one function of the program in this process and returns a callable that
puts it back."""

from __future__ import annotations

import torch

FAULTS = ("tick0_skipped", "qp_start", "leg_torques_zeroed",
          "plant_low_precision")


def _swap(module, name, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement)
    return lambda: setattr(module, name, original)


def plant(fault: str):
    """``tick0_skipped``: the scenarios handed over one tick past the
    standing start; ``qp_start``: every substep's QP answered by its
    starting point (zeros); ``leg_torques_zeroed``: the torques of each
    scenario's first stance leg left out; ``plant_low_precision``: the
    plant's state kept in bfloat16."""
    from quadruped_locomotion_tpu_torch import sweep
    from quadruped_locomotion_tpu_torch.control import locomotion
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.types import map_tensors

    if fault == "tick0_skipped":
        original = sweep.scenarios_from_draws

        def advanced(draws, device=None):
            sc = original(draws, device)
            B = len(draws["pace"])
            sc.ls0, _ = cl.planner_tick(
                sc.model, sc.params, sc.gait_params.per_scenario(B), sc.ls0,
                sc.command, terrain=sc.terrain)
            return sc

        return _swap(sweep, "scenarios_from_draws", advanced)
    if fault == "qp_start":
        original = cl.solve_formed_qp_batched

        def at_start(*args, **kw):
            sol = original(*args, **kw)
            return sol._replace(x=torch.zeros_like(sol.x))

        return _swap(cl, "solve_formed_qp_batched", at_start)
    if fault == "leg_torques_zeroed":
        original = locomotion.stance_torques

        def one_leg_out(model, state, forces):
            tau = original(model, state, forces).clone()
            first = state.support.to(torch.int8).argmax(-1)  # a stance leg
            tau[torch.arange(tau.shape[0]), first] = 0.0
            return tau

        return _swap(locomotion, "stance_torques", one_leg_out)
    if fault == "plant_low_precision":
        original = cl.PLANTS["articulated"]

        def rounded(*args, **kw):
            sim = original(*args, **kw)
            return map_tensors(sim, lambda t: t.to(torch.bfloat16).to(t.dtype)
                               if t.is_floating_point() else t)

        cl.PLANTS["articulated"] = rounded
        return lambda: cl.PLANTS.__setitem__("articulated", original)
    raise ValueError(f"unknown fault {fault!r}")
