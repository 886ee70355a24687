"""PyTorch port vs JAX reference: robot model, kinematics, leg dynamics,
rotations and the 3×3 solve, on seeded joint states.

Tolerance: atol = rtol = 1e-5 throughout. Both sides compute the same
float32 formulas (closed forms and the same automatic derivatives); what
differs is operation order inside fused kernels, worth a few ulps on
values of order 1-10.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu.model import dynamics as jdyn
from quadruped_locomotion_tpu.model import kinematics as jkin
from quadruped_locomotion_tpu.ops import linalg3 as jlinalg3
from quadruped_locomotion_tpu.types import RobotModel as JRobotModel
from quadruped_locomotion_tpu.utils import rotations as jrot
from quadruped_locomotion_tpu_torch import types as ttypes
from quadruped_locomotion_tpu_torch.model import dynamics as tdyn
from quadruped_locomotion_tpu_torch.model import kinematics as tkin
from quadruped_locomotion_tpu_torch.ops import linalg3 as tlinalg3
from quadruped_locomotion_tpu_torch.utils import rotations as trot

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
B = 6


@pytest.fixture(scope="module")
def models():
    return JRobotModel.simpledog(), ttypes.RobotModel.simpledog(device="cpu")


@pytest.fixture(scope="module")
def joints():
    rng = np.random.default_rng(0)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        q=f32(rng.uniform(-1.2, 1.2, (B, 4, 3))),
        qd=f32(rng.normal(0.0, 2.0, (B, 4, 3))),
        qdd=f32(rng.normal(0.0, 5.0, (B, 4, 3))),
        g=f32(rng.normal(0.0, 1.0, (B, 3)) + [0.0, 0.0, -9.8]),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _legs(fn):
    """Per-leg JAX function fn(q_leg, ..., leg) -> stacked over legs and
    vmapped over the batch."""
    return jax.vmap(lambda *a: jnp.stack([fn(*(x[i] for x in a), i)
                                          for i in range(4)]))


def test_robot_model_fields_match(models):
    jm, tm = models
    for name in jm.__dataclass_fields__:
        _close(getattr(tm, name), getattr(jm, name), atol=0, rtol=1e-6)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttypes.RobotModel.simpledog()


@pytest.mark.parametrize("name", ["fk", "jacobians", "foot_velocities"])
def test_kinematics(models, joints, name):
    jm, tm = models
    q, qd = joints["q"], joints["qd"]
    if name == "fk":
        ref = jax.vmap(lambda q: jkin.forward_kinematics(jm, q))(q)
        port = tkin.forward_kinematics(tm, _t(q))
    elif name == "jacobians":
        ref = jax.vmap(lambda q: jkin.jacobians(jm, q))(q)
        port = tkin.jacobians(tm, _t(q))
    else:
        ref = jax.vmap(lambda q, qd: jkin.foot_velocities(jm, q, qd))(q, qd)
        port = tkin.foot_velocities(tm, _t(q), _t(qd))
    _close(port, ref)


@pytest.mark.parametrize("branch", [0, 1, 2, 3])
def test_inverse_kinematics_branch(models, joints, branch):
    jm, tm = models
    feet = np.asarray(jax.vmap(lambda q: jkin.forward_kinematics(jm, q))(
        joints["q"]))
    ref = _legs(lambda f, i: jkin.leg_inverse_kinematics(
        jm, f, i, branch=jnp.int32(branch)))(feet)
    port = tkin.inverse_kinematics(tm, _t(feet), torch.full((4,), branch))
    # compare angles modulo 2π (a branch may sit at the ±π seam)
    diff = np.angle(np.exp(1j * (port.numpy() - np.asarray(ref))))
    np.testing.assert_allclose(diff, 0.0, atol=1e-5)


def test_inverse_kinematics_default_branches_invert_fk(models, joints):
    jm, tm = models
    feet = tkin.forward_kinematics(tm, _t(joints["q"]))
    ref = jax.vmap(lambda f: jkin.inverse_kinematics(jm, f))(feet.numpy())
    _close(tkin.inverse_kinematics(tm, feet), ref)


@pytest.mark.parametrize("name", ["gravity", "mass_matrix", "inverse_dynamics"])
def test_dynamics(models, joints, name):
    jm, tm = models
    q, qd, qdd, g = (joints[k] for k in ("q", "qd", "qdd", "g"))
    if name == "gravity":
        ref = jax.vmap(lambda q, g: jdyn.gravity_torques(jm, q, g))(q, g)
        port = tdyn.gravity_torques(tm, _t(q), _t(g))
    elif name == "mass_matrix":
        ref = jax.vmap(jax.vmap(lambda q: jdyn.leg_mass_matrix(jm, q)))(q)
        port = tdyn.leg_mass_matrix(tm, _t(q))
    else:
        ref = jax.vmap(
            lambda q, qd, qdd, g: jnp.stack([
                jdyn.leg_inverse_dynamics(jm, q[i], qd[i], qdd[i], g, i)
                for i in range(4)])
        )(q, qd, qdd, g)
        port = tdyn.leg_inverse_dynamics(tm, _t(q), _t(qd), _t(qdd), _t(g))
    _close(port, ref)


def test_solve3(joints):
    rng = np.random.default_rng(1)
    A = (rng.normal(size=(B, 4, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    b = rng.normal(size=(B, 4, 3)).astype(np.float32)
    _close(tlinalg3.solve3(_t(A), _t(b)), jlinalg3.solve3(A, b))


@pytest.mark.parametrize("name", ["rotate", "inv_rotate", "mul", "log", "exp",
                                  "rpy", "from_rpy", "skew", "wrap"])
def test_rotations(name):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = np.roll(q, 1, axis=0)
    v = rng.normal(size=(B, 3)).astype(np.float32)
    a = rng.uniform(-7, 7, size=(B,)).astype(np.float32)
    cases = {
        "rotate": (lambda m: m.quat_rotate, (q, v)),
        "inv_rotate": (lambda m: m.quat_inv_rotate, (q, v)),
        "mul": (lambda m: m.quat_mul, (q, q2)),
        "log": (lambda m: m.quat_log, (q,)),
        "exp": (lambda m: m.quat_exp, (v,)),
        "rpy": (lambda m: m.rpy_from_quat, (q,)),
        "from_rpy": (lambda m: m.quat_from_rpy, (v[:, 0], v[:, 1], v[:, 2])),
        "skew": (lambda m: m.skew, (v,)),
        "wrap": (lambda m: m.wrap_angle, (a,)),
    }
    fn, args = cases[name]
    port, ref = fn(trot)(*map(_t, args)), fn(jrot)(*args)
    if name == "rpy":  # angles compared modulo 2π
        diff = np.angle(np.exp(1j * (torch.stack(port).numpy()
                                     - np.stack(ref))))
        np.testing.assert_allclose(diff, 0.0, atol=1e-5)
    else:
        _close(port, ref)


def test_constants_first_made_inside_a_transform():
    """``types.const`` caches the tick paths' constants (so that a tick can
    be captured as a CUDA graph). A constant first made inside a torch.func
    transform (the leg dynamics' jacfwd under vmap) must come out as a plain
    tensor that later calls, inside or outside transforms, can use: the
    same values as a fresh cache."""
    model = ttypes.RobotModel.simpledog("cpu")
    q = torch.tensor([[0.1, 0.7, -1.3], [-0.2, -0.6, 1.2],
                      [0.05, 0.8, -1.4], [0.0, -0.5, 1.1]])
    qd = torch.linspace(-1.0, 1.0, 12).reshape(4, 3)
    g = torch.tensor([0.0, 0.0, -9.8])
    ttypes._const.cache_clear()
    first = tdyn.leg_inverse_dynamics(model, q, qd, torch.zeros_like(qd), g)
    again = tdyn.leg_inverse_dynamics(model, q, qd, torch.zeros_like(qd), g)
    jac = tkin.jacobians(model, q)
    ttypes._const.cache_clear()
    np.testing.assert_array_equal(first.numpy(), again.numpy())
    np.testing.assert_array_equal(jac.numpy(), tkin.jacobians(model, q).numpy())
