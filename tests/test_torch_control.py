"""PyTorch port vs JAX reference: one seeded batch of near-stance states
through the control tick's modules — VMC wrench, QP assembly, the G/g
formation, swing and stance torques, the contact FSM and its reflexes,
and locomotion_prepare / locomotion_finish (both fed the same formed G/g
and the same QP solution).

Tolerances: rtol 1e-5 with an absolute floor scaled to each quantity.
Wrenches and g reach 1e2-1e4 (gains of 5e3-1e4 N/m on centimetre
errors), so their floor is 1e-3; torques and matrices are O(1-100), floor
1e-4; the FSM's codes and masks must agree exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu.control import contact_fsm as jfsm
from quadruped_locomotion_tpu.control import force_distribution as jfd
from quadruped_locomotion_tpu.control import locomotion as jloco
from quadruped_locomotion_tpu.control import swing as jswing
from quadruped_locomotion_tpu.control.vmc import compute_virtual_wrench as jvmc
from quadruped_locomotion_tpu.ops import qp as jqp
from quadruped_locomotion_tpu.rollout import simulator as jsim
from quadruped_locomotion_tpu import types as jtypes
from quadruped_locomotion_tpu_torch import types as ttypes
from quadruped_locomotion_tpu_torch.control import contact_fsm as tfsm
from quadruped_locomotion_tpu_torch.control import force_distribution as tfd
from quadruped_locomotion_tpu_torch.control import locomotion as tloco
from quadruped_locomotion_tpu_torch.control import swing as tswing
from quadruped_locomotion_tpu_torch.control.vmc import compute_virtual_wrench as tvmc
from quadruped_locomotion_tpu_torch.ops.qp import QpSolution

torch.set_num_threads(1)

B = 6
WRENCH = dict(rtol=1e-5, atol=1e-3)
TORQUE = dict(rtol=1e-5, atol=1e-4)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def batch():
    """Seeded numpy inputs: a perturbed standing robot, its target, swing
    references and random supports."""
    rng = np.random.default_rng(3)
    jm = jtypes.RobotModel.simpledog()
    sim = jsim.default_stance_state(jm)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    quat = _unit(np.concatenate([np.ones((B, 1)),
                                 rng.normal(0, 0.05, (B, 3))], -1))
    normal = _unit(np.concatenate([rng.normal(0, 0.05, (B, 4, 2)),
                                   np.ones((B, 4, 1))], -1))
    feet_world = np.asarray(sim.feet_world)[None] + rng.normal(0, 0.01, (B, 4, 3))
    support = rng.random((B, 4)) < 0.7
    support[0] = True
    support[1] = [True, False, True, False]
    return dict(
        position=f32([0, 0, 0.4] + rng.uniform(-0.03, 0.03, (B, 3))),
        quaternion=f32(quat),
        linear_velocity=f32(rng.normal(0, 0.1, (B, 3))),
        angular_velocity=f32(rng.normal(0, 0.2, (B, 3))),
        q=f32(np.asarray(sim.robot.q)[None] + rng.normal(0, 0.05, (B, 4, 3))),
        qd=f32(rng.normal(0, 0.5, (B, 4, 3))),
        tau=f32(np.zeros((B, 4, 3))),
        support=support,
        surface_normal=f32(normal),
        t_position=f32([0, 0, 0.4] + rng.uniform(-0.02, 0.02, (B, 3))),
        t_quaternion=f32(_unit(np.concatenate(
            [np.ones((B, 1)), np.zeros((B, 2)), rng.normal(0, 0.1, (B, 1))], -1))),
        t_linear_velocity=f32(rng.normal(0, 0.1, (B, 3))),
        t_angular_velocity=f32(np.concatenate(
            [np.zeros((B, 2)), rng.normal(0, 0.2, (B, 1))], -1)),
        feet_world=f32(feet_world),
        swing_pos=f32(feet_world + rng.normal(0, 0.03, (B, 4, 3))),
        swing_vel=f32(rng.normal(0, 0.3, (B, 4, 3))),
        swing_acc=f32(rng.normal(0, 3.0, (B, 4, 3))),
        forces=f32(rng.normal(0, 50.0, (B, 4, 3))),
    )


def _state(mod, a, t):
    """RobotState and BaseTarget of module ``mod`` (JAX types or port
    types) from the numpy batch, with array constructor ``t``."""
    base = mod.BaseState(position=t(a["position"]), quaternion=t(a["quaternion"]),
                         linear_velocity=t(a["linear_velocity"]),
                         angular_velocity=t(a["angular_velocity"]))
    state = mod.RobotState(base=base, q=t(a["q"]), qd=t(a["qd"]), tau=t(a["tau"]),
                           support=t(a["support"]),
                           surface_normal=t(a["surface_normal"]))
    target = mod.BaseTarget(position=t(a["t_position"]),
                            quaternion=t(a["t_quaternion"]),
                            linear_velocity=t(a["t_linear_velocity"]),
                            angular_velocity=t(a["t_angular_velocity"]))
    return state, target


def _tt(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def sides(batch):
    jm = jtypes.RobotModel.simpledog()
    tm = ttypes.RobotModel.simpledog(device="cpu")
    jp = jloco.ControllerParams.defaults()
    tp = tloco.ControllerParams.defaults(device="cpu")
    js, jt = _state(jtypes, batch, jnp.asarray)
    ts, tt = _state(ttypes, batch, _tt)
    return dict(jm=jm, tm=tm, jp=jp, tp=tp, js=js, jt=jt, ts=ts, tt=tt)


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def test_virtual_wrench(sides):
    s = sides
    jf, jtq = jax.vmap(lambda st, tg: jvmc(s["jm"], s["jp"].vmc, st, tg))(
        s["js"], s["jt"])
    tf, ttq = tvmc(s["tm"], s["tp"].vmc, s["ts"], s["tt"])
    _close(tf, jf, WRENCH)
    _close(ttq, jtq, WRENCH)


@pytest.mark.parametrize("field", ["A", "b", "S", "W", "D", "d"])
def test_build_qp(sides, field):
    s = sides
    jvf, jvt = jax.vmap(lambda st, tg: jvmc(s["jm"], s["jp"].vmc, st, tg))(
        s["js"], s["jt"])
    ref = jax.vmap(lambda st, f, t: jfd.build_qp(s["jm"], s["jp"].cfd, st, f, t))(
        s["js"], jvf, jvt)
    # same virtual wrench on both sides, so the assembly alone is compared
    port = tfd.build_qp(s["tm"], s["tp"].cfd, s["ts"], _tt(jvf), _tt(jvt))
    i = "A b S W D d".split().index(field)
    _close(port[i], ref[i], WRENCH if field == "b" else TORQUE)


def test_g_formation(sides):
    """G = 2AᵀSA + diag(W), g = -2AᵀSb at full float32, from the same A,
    S, W, b on both sides."""
    s = sides
    jvf, jvt = jax.vmap(lambda st, tg: jvmc(s["jm"], s["jp"].vmc, st, tg))(
        s["js"], s["jt"])
    A, b, S, W, _, _ = (np.asarray(x) for x in jax.vmap(
        lambda st, f, t: jfd.build_qp(s["jm"], s["jp"].cfd, st, f, t))(
            s["js"], jvf, jvt))

    def form(A, S, W, b):
        with jax.default_matmul_precision("highest"):
            SA = A * S[:, None]
            return 2.0 * A.T @ SA + jnp.diag(W), -2.0 * SA.T @ b

    jG, jg = jax.vmap(form)(A, S, W, b)
    tG, tg = tloco.form_quadratic(*map(_tt, (A, S, W, b)))
    _close(tG, jG, TORQUE)
    _close(tg, jg, WRENCH)


def test_swing_torques(sides, batch):
    s = sides
    p, v, a = (batch[k] for k in ("swing_pos", "swing_vel", "swing_acc"))
    ref = jax.vmap(lambda st, p, v, a: jswing.swing_torques(
        s["jm"], s["jp"].swing, st, p, v, a))(s["js"], p, v, a)
    port = tswing.swing_torques_plain(s["tm"], s["tp"].swing, s["ts"],
                                      _tt(p), _tt(v), _tt(a))
    _close(port, ref, TORQUE)


def test_stance_torques(sides, batch):
    s = sides
    f = batch["forces"]
    ref = jax.vmap(lambda st, f: jfd.stance_torques(s["jm"], st, f))(s["js"], f)
    _close(tfd.stance_torques(s["tm"], s["ts"], _tt(f)), ref, TORQUE)


@pytest.fixture(scope="module")
def fsm_inputs():
    rng = np.random.default_rng(4)
    n = 64  # enough rows to visit every transition
    return dict(
        leg_state=rng.integers(0, 9, (n, 4)).astype(np.int32),
        stored_q=rng.normal(size=(n, 4, 3)).astype(np.float32),
        store_flag=rng.random((n, 4)) < 0.5,
        desired=rng.random((n, 4)) < 0.5,
        contact=rng.random((n, 4)) < 0.5,
        sw=rng.uniform(0, 1, (n, 4)).astype(np.float32),
        st=rng.uniform(0, 1, (n, 4)).astype(np.float32),
        q=rng.normal(size=(n, 4, 3)).astype(np.float32),
        speed=rng.uniform(0, 0.3, (n, 4)).astype(np.float32),
    )


def _fsm_both(a):
    jst = jfsm.FsmState(leg_state=a["leg_state"], stored_q=a["stored_q"],
                        store_flag=a["store_flag"])
    tst = tfsm.FsmState(leg_state=_tt(a["leg_state"]), stored_q=_tt(a["stored_q"]),
                        store_flag=_tt(a["store_flag"]))
    keys = ("desired", "contact", "sw", "st", "q")
    jref = jax.vmap(lambda f, *x, sp: jfsm.fsm_step(
        f, *x, foot_speed_tangential=sp))(jst, *(a[k] for k in keys),
                                          sp=a["speed"])
    port = tfsm.fsm_step(tst, *(_tt(a[k]) for k in keys),
                         foot_speed_tangential=_tt(a["speed"]))
    return jref, port


@pytest.mark.parametrize("field", ["support", "leg_state", "late_touchdown",
                                   "bumped", "freeze", "q_freeze"])
def test_fsm_step_output(fsm_inputs, field):
    (_, jout), (_, tout) = _fsm_both(fsm_inputs)
    np.testing.assert_array_equal(getattr(tout, field).numpy(),
                                  np.asarray(getattr(jout, field)))


def test_fsm_step_memory(fsm_inputs):
    (jst, _), (tst, _) = _fsm_both(fsm_inputs)
    for name in ("leg_state", "stored_q", "store_flag"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)))


def test_apply_swing_reflexes(fsm_inputs, batch):
    (_, jout), (_, tout) = _fsm_both(fsm_inputs)
    n = fsm_inputs["q"].shape[0]
    rng = np.random.default_rng(5)
    p, v, a, feet = (rng.normal(size=(n, 4, 3)).astype(np.float32)
                     for _ in range(4))
    ref = jax.vmap(lambda p, v, a, f, o: jfsm.apply_swing_reflexes(
        p, v, a, f, o, ground_height=jnp.zeros(4)))(p, v, a, feet, jout)
    port = tfsm.apply_swing_reflexes(_tt(p), _tt(v), _tt(a), _tt(feet), tout,
                                     ground_height=torch.zeros(n, 4))
    for r, t in zip(ref, port):
        _close(t, r, dict(rtol=0, atol=1e-7))


@pytest.fixture(scope="module")
def prepared(sides, batch):
    s = sides
    refs = tuple(batch[k] for k in ("swing_pos", "swing_vel", "swing_acc"))
    jctx = jax.vmap(lambda st, tg, p, v, a: jloco.locomotion_prepare(
        s["jm"], s["jp"], st, tg, p, v, a))(s["js"], s["jt"], *refs)
    tctx = tloco.locomotion_prepare(s["tm"], s["tp"], s["ts"], s["tt"],
                                    *map(_tt, refs))
    return jctx, tctx


@pytest.mark.parametrize("field", ["A", "b", "D", "d", "G", "g",
                                   "virtual_force", "virtual_torque",
                                   "tau_swing"])
def test_locomotion_prepare(prepared, field):
    jctx, tctx = prepared
    tol = WRENCH if field in ("b", "g", "virtual_force", "virtual_torque") \
        else TORQUE
    _close(getattr(tctx, field), getattr(jctx, field), tol)


def test_locomotion_finish_same_solution(sides, prepared):
    """Both finish stages consume the SAME QP solution of the SAME formed
    G/g (the port's), so torques agree to float32 rounding."""
    s = sides
    jctx, tctx = prepared
    sol = tfd.solve_formed_qp_batched(tctx.G, tctx.g, tctx.D, tctx.d,
                                      backend="plain")
    jsol = jqp.QpSolution(*(jnp.asarray(np.asarray(v)) for v in sol))
    jtau, jdiag = jax.vmap(lambda st, c, so: jloco.locomotion_finish(
        s["jm"], s["jp"], st, c, so))(s["js"], jctx, jsol)
    ttau, tdiag = tloco.locomotion_finish(s["tm"], s["tp"], s["ts"], tctx,
                                          QpSolution(*sol))
    _close(ttau, jtau, TORQUE)
    _close(tdiag.distribution.virtual_wrench_realized,
           jdiag.distribution.virtual_wrench_realized, WRENCH)
    _close(tdiag.distribution.contact_forces,
           jdiag.distribution.contact_forces, TORQUE)
