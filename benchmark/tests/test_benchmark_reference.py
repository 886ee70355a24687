"""The plain reference: the configuration states the program's robot and
controller, the stance QPs worked out from it agree with the program's
formation, and the reference's QP solver reaches the optimum."""

import numpy as np
import pytest
import torch

from benchmark.drivers import fd_qp
from benchmark.harness import spec, traffic
from benchmark.reference import qp as ref_qp
from benchmark.reference import stance

CPU = torch.device("cpu")
QP = spec.load_cell("qp.balance")


def _equal(got, want):
    assert np.allclose(np.asarray(got, dtype=np.float64),
                       want.double().numpy(), rtol=0, atol=0), (got, want)


def test_the_configuration_states_the_programs_robot_and_controller():
    from quadruped_locomotion_tpu_torch import types

    robot, ctl = QP.config["robot"], QP.config["controller"]
    model = types.RobotModel.simpledog(CPU, torch.float64)
    gains = types.VmcGains.gazebo_defaults(CPU, torch.float64)
    cfd = types.CfdParams.defaults(CPU, torch.float64)
    assert robot["gravity_m_s2"] == types.GRAVITY
    _equal(robot["base_mass_kg"], model.base_mass)
    _equal(robot["leg_mass_kg"], model.leg_mass)
    _equal(robot["com_in_base_m"], model.com_in_base)
    _equal(robot["hip_pos_m"], model.hip_pos)
    _equal(robot["hip_offset_m"], model.hip_offset)
    _equal(ctl["vmc_kp_lin"], gains.kp_lin)
    _equal(ctl["gravity_percentage"], gains.gravity_percentage)
    _equal(ctl["s_weights"], cfd.s_weights)
    _equal(ctl["w_regularizer"], cfd.w_regularizer)
    _equal(ctl["friction_coeff"], cfd.friction_coeff)
    _equal(ctl["min_normal_force_n"], cfd.min_normal_force)
    neutral = types.RobotState.neutral((1,), CPU, torch.float64)
    _equal(robot["ground_normal"], neutral.surface_normal[0, 0])


def test_the_stance_qps_agree_with_the_programs_formation():
    draws = traffic.generate(QP.traffic, 256, 2**31 + 5)
    prog = fd_qp.build(QP.config, draws[:1], CPU)[0]
    ref = stance.qps(QP.config, draws[0], CPU)
    # the program forms in float32: a few of its ulps of the largest
    # entry (the IK/FK round trip of the feet included), and nothing more
    for name, p, r in zip("AbSWDd", prog, ref):
        assert p.shape == r.shape, name
        gap = float((p.double() - r).abs().max())
        assert gap <= 1e-6 * float(r.abs().max()), (name, gap)


def _stance_qps(batch, seed):
    draws = traffic.generate(QP.traffic, batch, seed)
    return stance.qps(QP.config, draws[0], CPU)


def test_reference_qp_reaches_the_optimum():
    from scipy import optimize

    A, b, S, W, D, d = _stance_qps(64, 4)
    ar = ref_qp.Arith("float64")
    G, g = ref_qp.form(*ar.cast(A, S, W, b), ar)
    x, _, kkt = ref_qp.solve(G, g, D, d, ar)
    assert float(kkt.max()) < 1e-8
    Gn, gn, Dn, dn = (t.numpy() for t in (G, g, D.double(), d.double()))
    for i in range(0, 64, 16):
        f = lambda v, i=i: 0.5 * v @ Gn[i] @ v + gn[i] @ v  # noqa: E731
        res = optimize.minimize(
            f, np.zeros(12), jac=lambda v, i=i: Gn[i] @ v + gn[i],
            constraints=[{"type": "ineq", "fun": lambda v, i=i: Dn[i] @ v - dn[i],
                          "jac": lambda v, i=i: Dn[i]}],
            method="SLSQP", options={"maxiter": 500, "ftol": 1e-15})
        # SLSQP may stand a hair outside the cone; 1e-7 of the objective is
        # far below the gaps the cells judge
        assert f(x[i].numpy()) <= res.fun + 1e-7 * (1 + abs(res.fun))


def test_programs_plain_qp_is_within_the_limit_of_the_reference():
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    A, b, S, W, D, d = _stance_qps(256, 6)
    ar = ref_qp.Arith("float64")
    G, g = ref_qp.form(*ar.cast(A, S, W, b), ar)
    x_ref, _, _ = ref_qp.solve(G, g, D, d, ar)
    x, _, _, _ = fk.solve_weighted_ls_fd_qp_plain(
        *(t.float() for t in (A, S, b, W, D, d)))
    gap = ref_qp.judge(A, b, S, W, D, d, x, x_ref)["gap"]
    assert float(gap.max()) <= QP.traffic["limits"]["obj_gap"]


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10
    t = torch.tensor([one + ulp / 4, one + 3 * ulp / 4, one + ulp / 2,
                      one + 3 * ulp / 2, -(one + 3 * ulp / 4)])
    want = torch.tensor([one, one + ulp, one, one + 2 * ulp, -(one + ulp)])
    assert torch.equal(ref_qp.to_tf32(t), want)


@pytest.mark.cuda
def test_control_fails_where_the_program_passes_on_the_card(cuda_device):
    """The QP cell's control at a size a test run holds: the program's
    answers pass the limit and the TF32 reference's fail it."""
    import time

    from benchmark.harness.outcome import Context

    cell = spec.load_cell("qp.balance")
    cell.config["batch_per_chip"] = 4096
    ctx = Context(cell=cell, seed=31, seconds=0.0, trace=False,
                  device=cuda_device, t0=time.time())
    got = fd_qp.calibration(ctx, control=True)
    limit = cell.traffic["limits"]["obj_gap"]
    assert got["program"]["obj_gap"] <= limit < got["control"]["obj_gap"]
