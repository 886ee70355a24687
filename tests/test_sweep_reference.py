"""The config-5 sweep cell (``benchmark/drivers/sweep.py``) on the CPU:
its plain float64 reference of one control substep
(``benchmark/reference/loop.py``, ``robot.py``) against the port, and the
port's normal path taking the cell's QP iteration count.

One planner tick of 8 scenarios from the standing start runs through
``closed_loop.planner_tick`` as the cell's caller runs it (the plain QP on
the CPU, the configuration's ``qp_iters``), its four substeps recorded by
the cell's ``telemetry_fn``; each substep's controller QP, stance torques
and plant step must fall within the cell's limits
(``benchmark/workloads/sweep.config5.json``) against the reference.
"""

import inspect
import time

import numpy as np
import pytest
import torch

from benchmark.drivers import sweep as drv
from benchmark.harness import spec, traffic
from benchmark.harness.outcome import Context
from benchmark.reference import qp as ref_qp
from benchmark.reference.robot import Robot
from quadruped_locomotion_tpu_torch import sweep
from quadruped_locomotion_tpu_torch.rollout import articulated as art
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.utils import logging as qlog

CELL = spec.load_cell("sweep.config5")
CPU = torch.device("cpu")
B, SEED = 8, 2**31 + 21
PARTS = {"qp": ("obj_gap", "cone_violation_n"),
         "stance_torques": ("stance_torque_rel",),
         "plant": ("plant_state_rel",)}


@pytest.fixture(scope="module")
def tick0():
    """(the cell's configuration at B = 8, tick 0's records, the spans of
    the tick)."""
    cfg = dict(CELL.config, batch_per_chip=B)
    draws = traffic.generate(CELL.traffic, B, SEED)
    sc = sweep.scenarios_from_draws(draws, CPU)
    rec = drv.Recorder([(0, s) for s in range(drv.SUBSTEPS)])
    qlog.enable_spans()
    try:
        ls, _ = cl.planner_tick(
            sc.model, sc.params, sc.gait_params.per_scenario(B), sc.ls0,
            sc.command, qp_iters=cfg["qp_iters"], terrain=sc.terrain,
            plant=cfg["plant"], qp_backend="plain", telemetry_fn=rec,
            telemetry_inputs=True)
    finally:
        qlog.disable_spans()
    rec.end_tick(ls)
    return cfg, rec.records, qlog.collect_spans()


@pytest.fixture(scope="module")
def judged(tick0):
    cfg, records, _ = tick0
    return {key: drv.judge_substep(cfg, r, drv._outputs(r), CPU)
            for key, r in records.items()}


@pytest.mark.parametrize("part", sorted(PARTS))
@pytest.mark.parametrize("substep", range(drv.SUBSTEPS))
def test_tick0_substep_within_the_cells_limits(judged, substep, part):
    got = judged[(0, substep)]
    assert got["scenarios"] == B
    for name in PARTS[part]:
        assert got[name] <= CELL.traffic["limits"][name], (name, got[name])
    if part == "plant":
        assert got["mismatched_feet"] == 0


def test_the_whole_judge_passes_tick0(tick0):
    cfg, records, _ = tick0
    cell = spec.load_cell("sweep.config5")
    cell.config["batch_per_chip"] = B
    ctx = Context(cell=cell, seed=SEED, seconds=0.0, trace=False, device=CPU,
                  t0=time.time())
    got = drv.judge(ctx, records)
    assert got["tick0_unjudged"] == 0
    assert all(v <= CELL.traffic["limits"][k] for k, v in got.items()), got


def test_the_telemetry_hands_out_the_plants_input_under_loop_record(tick0):
    _, records, spans = tick0
    first = records[(0, 0)]
    assert first["pinned"].all() and (first["v"] == 0).all()
    assert (first["qd"] == 0).all() and first["gz"].shape == (B, 4)
    # the plant's output of one substep is the next one's input
    assert torch.equal(records[(0, 0)]["next_q"], records[(0, 1)]["q"])
    assert torch.equal(records[(0, 2)]["next_pinned"],
                       records[(0, 3)]["pinned"])
    rec_spans = sorted(s.attrs["substep"] for s in spans
                       if s.name == "loop.record")
    assert rec_spans == [0, 1, 2, 3]


def test_the_configuration_states_the_programs_robot_controller_and_plant():
    from quadruped_locomotion_tpu_torch import types
    from quadruped_locomotion_tpu_torch.control.locomotion import (
        ControllerParams,
    )
    from quadruped_locomotion_tpu_torch.rollout import simulator

    r, c, pm = (CELL.config[k] for k in ("robot", "controller", "plant_model"))
    m = types.RobotModel.simpledog(CPU, torch.float64)
    p = ControllerParams.defaults(CPU).to(CPU)
    eq = lambda got, want: np.testing.assert_allclose(  # noqa: E731
        np.asarray(got, np.float64), want.double().numpy(), rtol=0, atol=1e-9)
    for key, want in (("hip_pos_m", m.hip_pos), ("hip_rot", m.hip_rot),
                      ("hip_offset_m", m.hip_offset),
                      ("leg_mass_kg", m.leg_mass),
                      ("com_in_base_m", m.com_in_base),
                      ("link_mass_kg", m.link_mass),
                      ("link_com_m", m.link_com),
                      ("abduction_offset_m", m.d), ("thigh_m", m.l1),
                      ("shank_m", m.l2), ("base_mass_kg", m.base_mass),
                      ("joint_damping_n_m_s", m.joint_damping),
                      ("torque_limit_n_m", m.torque_limit)):
        eq(r[key], want)
    eq(r["link_inertia_diag_kg_m2"], torch.diagonal(m.link_inertia, dim1=-2,
                                                    dim2=-1))
    assert r["gravity_m_s2"] == types.GRAVITY
    # the trunk's inertia: the lumped one less the legs' parallel-axis
    # terms, which the program adds up in float32 (within 6e-7 kg m^2)
    np.testing.assert_allclose(
        r["base_link_inertia_diag_kg_m2"],
        torch.diagonal(art.base_dynamic_params(m)[1]).numpy(), rtol=1e-6)
    gains = {f"vmc_{k}": getattr(p.vmc, k) for k in (
        "kp_lin", "kd_lin", "kff_lin", "kp_ang", "kd_ang", "kff_ang")}
    for key, want in (*gains.items(),
                      ("gravity_percentage", p.vmc.gravity_percentage),
                      ("s_weights", p.cfd.s_weights),
                      ("w_regularizer", p.cfd.w_regularizer),
                      ("friction_coeff", p.cfd.friction_coeff),
                      ("min_normal_force_n", p.cfd.min_normal_force)):
        np.testing.assert_allclose(c[key], want.numpy(), rtol=1e-7)
    assert pm == {"control_dt_s": cl.CONTROL_DT, "substeps": art.SUBSTEPS,
                  "baumgarte_tau_s": art.BAUMGARTE_TAU,
                  "contact_compliance": art.CONTACT_COMPLIANCE,
                  "contact_tol_m": simulator.CONTACT_TOL,
                  "reach_share": 0.995, "release_force_n": art.RELEASE_FORCE}
    assert CELL.config["plant"] == sweep.PLANT


@pytest.mark.parametrize("batch,seed", [(8, 0), (37, 2**31 + 7)])
def test_the_generator_draws_the_programs_scenarios(batch, seed):
    got = traffic.generate(CELL.traffic, batch, seed)
    want = sweep.draw_scenarios(batch, seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [3, 4])
def test_the_reference_dynamics_are_the_programs_in_float64(seed):
    """M(q) and h(q, v) of the reference's closed-form Kane equations
    against the program's plant (autodiff through a chart) at random
    states, both in float64."""
    from quadruped_locomotion_tpu_torch import types

    g = torch.Generator().manual_seed(seed)
    n = 6
    quat = torch.randn(n, 4, generator=g, dtype=torch.float64)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    base = types.BaseState(
        position=torch.randn(n, 3, generator=g, dtype=torch.float64),
        quaternion=quat,
        linear_velocity=torch.randn(n, 3, generator=g, dtype=torch.float64),
        angular_velocity=torch.randn(n, 3, generator=g, dtype=torch.float64))
    q = torch.randn(n, 4, 3, generator=g, dtype=torch.float64)
    qd = torch.randn(n, 4, 3, generator=g, dtype=torch.float64)
    m = types.RobotModel.simpledog(CPU, torch.float64)
    robot = Robot(CELL.config, ref_qp.Arith("float64"), CPU)
    # the program's trunk inertia, summed in float32 (6e-7 kg m^2 off the
    # configuration's), so that only the equations are compared
    robot.trunk_inertia = art.base_dynamic_params(m)[1]
    M, h, feet, *_ = robot.dynamics(base.position, quat, base.linear_velocity,
                                    base.angular_velocity, q, qd)
    want_m = art.mass_matrix(m, base, q)
    want_h = art.bias_forces(m, base, q, qd)
    assert torch.allclose(M, want_m, rtol=0, atol=1e-10 * want_m.abs().max())
    assert torch.allclose(h, want_h, rtol=0, atol=1e-10 * want_h.abs().max())


def test_sweep_takes_its_qp_iterations_to_the_loop():
    before = qlog.counters["qp.instance_iterations"]
    res = sweep.measure(2, ticks=1, device="cpu", qp_iters=7)
    # the warm-up tick and the measured one, four substeps each
    assert qlog.counters["qp.instance_iterations"] - before == 2 * 4 * 2 * 7
    assert res["qp_iters"] == 7 and res["finite"]


def test_the_default_is_still_15_iterations():
    for fn in (sweep.run, sweep.measure, cl.planner_tick, cl.rollout):
        assert inspect.signature(fn).parameters["qp_iters"].default == 15
    assert sweep.QP_ITERS == 15
