"""The port's state estimator (``control/state_estimator.py``) and the
estimated closed loop (``rollout/estimated_loop.py``) against the JAX
package.

* The EKF's ``predict``, ``update`` and ``synthesize_imu`` on seeded
  states (the ``ekf/`` section of ``tests/data/torch_port_slice4_refs.npz``,
  ``-m slow`` recomputes it): the same float32 algebra, within 1e-5
  (absolute and relative; the covariance's entries span 1e-10..1e6).
* The estimated loop with ideal sensors (every noise and bias zero, so
  the two sides' different random streams do not matter), B = 3 trot
  scenarios, 10 ticks, articulated plant, against the JAX golden
  ``tests/data/torch_port_estimated_golden.npz``
  (``scripts/make_torch_port_golden.py --path estimated``). Both run the
  generic IPM per scenario: base positions within 1e-4 m over all ticks,
  leg states exactly, the estimator's errors within 1e-5 and its
  velocity within 1e-4 m/s (observed: ≤ 3.4e-7).
* Realistic sensors, which cannot match JAX's key streams, are checked
  statistically: the noise is present and seeded, and the estimate stays
  within the JAX package's own test bounds of the truth.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.control import state_estimator as se
from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.rollout import estimated_loop as el
from quadruped_locomotion_tpu_torch.types import RobotModel
from quadruped_locomotion_tpu_torch.utils.logging import counters

ROOT = Path(__file__).resolve().parent.parent
REFS = ROOT / "tests" / "data" / "torch_port_slice4_refs.npz"
GOLDEN = ROOT / "tests" / "data" / "torch_port_estimated_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402
from make_torch_port_golden import flatten  # noqa: E402

torch.set_num_threads(1)

EKF_TOL = dict(atol=1e-5, rtol=1e-5)
STATE_FIELDS = ("position", "velocity", "quaternion", "foot_positions",
                "covariance")


@pytest.fixture(scope="module")
def ekf_refs():
    with np.load(REFS) as f:
        return {k[len("ekf/"):]: f[k] for k in f.files if k.startswith("ekf/")}


def _est(refs):
    return se.EstimatorState(**{k: torch.from_numpy(refs[f"in/{k}"])
                                for k in STATE_FIELDS})


def _t(refs, k):
    return torch.from_numpy(refs[f"in/{k}"])


def check_ekf(refs, part, field):
    params = se.EstimatorParams.defaults("cpu")
    est = _est(refs)
    if part == "predict":
        out = se.predict(params, est, _t(refs, "gyro"), _t(refs, "accel"),
                         _t(refs, "contact"), make_refs.EKF_DT)
    elif part == "update":
        out = se.update(RobotModel.simpledog("cpu"), params, est,
                        _t(refs, "q"), _t(refs, "contact"))
    else:
        gyro, accel = se.synthesize_imu(_t(refs, "traj_quat"),
                                        _t(refs, "traj_pos"), make_refs.EKF_DT)
        out = {"gyro": gyro, "accel": accel}
        np.testing.assert_allclose(out[field].numpy(), refs[f"imu/{field}"],
                                   **EKF_TOL)
        return
    np.testing.assert_allclose(getattr(out, field).numpy(),
                               refs[f"{part}/{field}"], **EKF_TOL)


@pytest.mark.parametrize("part, field", [
    *(("predict", f) for f in STATE_FIELDS),
    *(("update", f) for f in STATE_FIELDS),
    ("imu", "gyro"), ("imu", "accel")])
def test_ekf_matches_jax(ekf_refs, part, field):
    check_ekf(ekf_refs, part, field)


def test_update_pulls_toward_the_kinematics(ekf_refs):
    """One update with every leg in stance shrinks the position variance
    and keeps the covariance symmetric positive definite."""
    est = _est(ekf_refs)
    out = se.update(RobotModel.simpledog("cpu"),
                    se.EstimatorParams.defaults("cpu"), est,
                    _t(ekf_refs, "q"), torch.ones(make_refs.B_EKF, 4,
                                                  dtype=torch.bool))
    P = out.covariance
    torch.testing.assert_close(P, P.mT, atol=0, rtol=0)
    assert (torch.linalg.eigvalsh(P.double()) > 0).all()
    var0 = est.covariance.diagonal(dim1=-2, dim2=-1)[:, :3]
    assert (P.diagonal(dim1=-2, dim2=-1)[:, :3] < var0).all()


def test_failed_factor_gives_nan_without_raising(ekf_refs):
    est = _est(ekf_refs)
    est = est.replace(covariance=est.covariance.clone())
    est.covariance[0] = float("nan")
    out = se.update(RobotModel.simpledog("cpu"),
                    se.EstimatorParams.defaults("cpu"), est, _t(ekf_refs, "q"),
                    _t(ekf_refs, "contact"))
    assert torch.isnan(out.position[0]).all()
    assert torch.isfinite(out.position[1:]).all()


@pytest.mark.slow
def test_ekf_references_match_live_jax():
    live = {k: np.asarray(v) for k, v in make_refs.ekf_references().items()}
    for part in ("predict", "update"):
        for f in STATE_FIELDS:
            check_ekf(live, part, f)
    for f in ("gyro", "accel"):
        check_ekf(live, "imu", f)


# ---------------------------------------------------------------- the loop


def _golden_inputs(golden):
    get = lambda cls, p: convert.from_numpy(  # noqa: E731
        cls, convert.unflatten(golden, p), "cpu")
    model, params = get(RobotModel, "model/"), get(ControllerParams, "params/")
    gp, ep = get(GaitParams, "gait_params/"), get(se.EstimatorParams,
                                                   "est_params/")
    loop = get(cl.LocomotionState, "loop0/")
    est = get(se.EstimatorState, "est0/")
    B = est.position.shape[0]
    els = el.EstimatedLoopState(loop=loop, est=est, gyro=torch.zeros(B, 3),
                                generator=torch.Generator())
    return model, params, gp, ep, els, get(cl.Command, "cmd/")


def _run_port(golden):
    model, params, gp, ep, els, cmd = _golden_inputs(golden)
    counters["qp.kernel_launches"] = 0
    _, tel = el.rollout_estimated(model, params, gp, ep,
                                  el.SensorParams.ideal("cpu"), els, cmd,
                                  int(golden["meta/ticks"]), device="cpu")
    # the generic QP, never the kernel
    assert counters["qp.kernel_launches"] == 0
    return {k: v.numpy() for k, v in tel.items()}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def port_telemetry(golden):
    return _run_port(golden)


def _compare(golden, port):
    ref = {k[len("tel/"):]: v for k, v in golden.items()
           if k.startswith("tel/")}
    assert set(port) == set(ref)
    for k, v in port.items():
        assert v.shape == ref[k].shape, k
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k
    np.testing.assert_allclose(port["base_position"][0],
                               ref["base_position"][0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(port["est_position"][0],
                               ref["est_position"][0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(port["base_position"], ref["base_position"],
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(port["leg_state"], ref["leg_state"])


def test_estimated_loop_matches_jax_golden(golden, port_telemetry):
    _compare(golden, port_telemetry)


@pytest.mark.parametrize("field", ["pos_err", "vel_err", "est_velocity",
                                   "feet_world", "qp_kkt"])
def test_estimated_fields_track_golden(golden, port_telemetry, field):
    """The estimator's errors within 1e-5, its velocity within 1e-4 m/s,
    feet within 1e-4 m; both sides' QP KKT below 1e-2. Observed on a CPU:
    |Δ| ≤ 5.9e-8 m (pos_err, against values up to 2.8e-4 m), 3.4e-7 m/s
    (vel_err, up to 1.1e-3 m/s), 1.8e-7 m/s (est_velocity), 9e-8 m
    (feet_world) and 3e-8 m (base_position, held within 1e-4 m above)."""
    got, want = port_telemetry[field], golden[f"tel/{field}"]
    if field == "qp_kkt":
        assert got.max() < 1e-2 and want.max() < 1e-2
        return
    tol = {"pos_err": 1e-5, "vel_err": 1e-5, "est_velocity": 1e-4,
           "feet_world": 1e-4}[field]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("gait_type", [0, 1], ids=["trot", "pace"])
def test_init_estimated_starts_in_its_gait(golden, gait_type):
    """``init_estimated(gait_type=)`` starts the loop from
    ``init_locomotion`` in that gait, as the JAX package's does; the trot
    start (loop and EKF) is the golden's JAX ``init_estimated`` within
    1e-6 (the inverse kinematics differs by an ulp)."""
    B = int(golden["meta/batch"])
    model, gp = RobotModel.simpledog("cpu"), GaitParams.trot_defaults("cpu")
    els = el.init_estimated(model, gp, B, gait_type=gait_type, device="cpu")
    want = cl.init_locomotion(model, gp, B, gait_type=gait_type, device="cpu")
    got = flatten(convert.to_numpy(els.loop))
    ref = flatten(convert.to_numpy(want))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    trot = flatten(convert.to_numpy(
        cl.init_locomotion(model, gp, B, device="cpu").gait))
    gait = flatten(convert.to_numpy(els.loop.gait))
    assert (gait_type == 0) == all(np.array_equal(gait[k], trot[k])
                                   for k in trot)
    if gait_type == 0:
        for part, obj in (("loop0/", els.loop), ("est0/", els.est)):
            for k, v in flatten(convert.to_numpy(obj), part).items():
                np.testing.assert_allclose(v, golden[k], atol=1e-6, rtol=0,
                                           err_msg=k)


@pytest.mark.slow
def test_estimated_matches_live_jax():
    from make_torch_port_golden import make_estimated_golden

    golden = make_estimated_golden(batch=3, ticks=10, seed=0)
    _compare(golden, _run_port(golden))


def test_realistic_sensors_are_seeded_and_bounded():
    """One tick at B = 16 with realistic sensors: the same seed gives the
    same run, another seed another one; the noisy estimate stays within
    the JAX package's own bounds (tests/test_estimated_loop.py) of the
    truth and differs from the ideal-sensor estimate by the noise's
    order, not more."""
    B, ticks = 16, 1
    model, gp = RobotModel.simpledog("cpu"), GaitParams.trot_defaults("cpu")
    cmd = cl.Command(linear_velocity=torch.tensor([[0.2, 0.0, 0.0]] * B),
                     yaw_rate=torch.zeros(B))
    args = (model, ControllerParams.defaults("cpu"), gp,
            se.EstimatorParams.defaults("cpu"))

    def run(sensors, seed):
        els = el.init_estimated(model, gp, B, seed=seed, device="cpu")
        return el.rollout_estimated(*args, sensors, els, cmd, ticks,
                                    device="cpu")[1]

    a = run(el.SensorParams.realistic("cpu"), 0)
    b = run(el.SensorParams.realistic("cpu"), 0)
    c = run(el.SensorParams.realistic("cpu"), 1)
    ideal = run(el.SensorParams.ideal("cpu"), 0)
    torch.testing.assert_close(a["est_position"], b["est_position"], atol=0,
                               rtol=0)
    assert not torch.equal(a["est_velocity"], c["est_velocity"])
    assert torch.isfinite(a["est_position"]).all()
    assert (a["base_position"][..., 2] > 0.3).all()
    assert a["pos_err"].max() < 0.25 and a["vel_err"].median() < 0.12
    dv = (a["est_velocity"] - ideal["est_velocity"]).abs().max()
    assert 1e-4 < dv < 0.5
    # scenarios draw independent noise
    assert len(torch.unique(a["est_velocity"][-1, :, 0])) == B
