"""The port's counterparts of the JAX package's remaining reference
functions and tools, against the JAX outputs in ``item6/`` and
``logging/`` of ``tests/data/torch_port_slice7_refs.npz``
(``scripts/make_torch_port_references.py --file slice7``), on seeded
inputs:

* ``utils/rotations.py``: ``quat_identity`` exactly; ``quat_from_matrix``
  (every Shepperd branch), ``quat_from_axis_angle`` and ``quat_boxminus``
  within 1e-6;
* ``model/dynamics.py``: ``inverse_dynamics`` and ``leg_forward_dynamics``
  (each leg) within 1e-6 relative to the largest entry;
  ``model/kinematics.py::joint_velocities_from_foot_velocities`` likewise;
* ``terrain/heightfield.py::optimize_foothold`` (single foot, with and
  without the reach check): found flags exactly, footholds and normals
  within 1e-6; ``rollout/simulator.py::foot_heights`` within 1e-6 m;
* ``control/contact_fsm.py::contact_fsm`` (stateless) exactly;
* ``ops/linalgn.py::spd_solve`` at n = 6, 12, 18 within 1e-6 relative;
* ``rollout/closed_loop.py::rollout(telemetry_fn=)``: the extras of a
  B = 2, 2-tick massless rollout through the plain QP (JAX: the batched
  XLA IPM) — support exactly, the formed QP within 1e-4 of each array's
  largest entry, the first tick's torques and forces within 1e-3, the
  second's torques within 1 N·m (the W = 1e-4 flat valley moves the
  optimum by tenths of a newton between two float32 formations; observed
  0.31 N·m and 0.81 N), base positions within 1e-6 m;
* ``utils/logging.py``: the ring log's capture order, cursor and count
  exactly, before and after it wraps; ``Timer``; a profiler session's
  Chrome trace;
* ``viz/plot.py``: PNGs of a preview and of closed-loop telemetry
  (rasterized with numpy: matplotlib need not be installed);
* ``model/urdf.py``: the bundled URDF round-trips to ``RobotModel.
  simpledog`` (tests/test_urdf.py's checks).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.control.contact_fsm import contact_fsm
from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
from quadruped_locomotion_tpu_torch.model import dynamics, kinematics
from quadruped_locomotion_tpu_torch.model import urdf
from quadruped_locomotion_tpu_torch.ops.linalgn import spd_solve
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.rollout import simulator as simlib
from quadruped_locomotion_tpu_torch.terrain.heightfield import (
    Heightfield, optimize_foothold,
)
from quadruped_locomotion_tpu_torch.types import RobotModel
from quadruped_locomotion_tpu_torch.utils import logging as qlog
from quadruped_locomotion_tpu_torch.utils import rotations as rot

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)
MODEL = RobotModel.simpledog("cpu")


@pytest.fixture(scope="module")
def refs():
    with np.load(make_refs.SLICE7_OUT) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def item6(refs):
    return {k[len("item6/"):]: v for k, v in refs.items()
            if k.startswith("item6/")}


def inputs(item6):
    return {k[len("inputs/"):]: torch.as_tensor(
        v.astype(np.float32) if v.dtype.kind == "f" else v)
        for k, v in item6.items() if k.startswith("inputs/")}


def close_rel(got, want, rtol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def test_quat_identity(item6):
    q = rot.quat_identity(device="cpu")
    assert q.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), item6["quat_identity"])


@pytest.mark.parametrize("name", ["quat_from_matrix", "quat_from_axis_angle",
                                  "quat_boxminus"])
def test_rotations_match_jax(item6, name):
    x = inputs(item6)
    got = {"quat_from_matrix": lambda: rot.quat_from_matrix(x["rot"]),
           "quat_from_axis_angle": lambda: rot.quat_from_axis_angle(
               x["axis"], x["angle"]),
           "quat_boxminus": lambda: rot.quat_boxminus(x["q1"], x["q2"]),
           }[name]()
    np.testing.assert_allclose(got.numpy(), item6[name], atol=1e-6, rtol=0)


def test_quat_from_matrix_takes_every_branch(item6):
    """Random rotations (trace > 0) and turns by ~π about x, y and z
    (trace < 0, each diagonal entry largest once)."""
    m = item6["inputs/rot"]
    tr = np.trace(m, axis1=-2, axis2=-1)
    assert (tr > 0).any() and (tr < 0).sum() >= 3
    diag = np.diagonal(m, axis1=-2, axis2=-1)[tr < 0]
    assert set(np.argmax(diag, -1)) == {0, 1, 2}


def test_inverse_dynamics_matches_jax(item6):
    x = inputs(item6)
    got = dynamics.inverse_dynamics(MODEL, x["q"], x["qd"], x["qdd"],
                                    x["gravity"])
    close_rel(got, item6["inverse_dynamics"])


@pytest.mark.parametrize("leg", range(4))
def test_leg_forward_dynamics_matches_jax(item6, leg):
    x = inputs(item6)
    got = dynamics.leg_forward_dynamics(
        MODEL, x["q"][:, leg], x["qd"][:, leg], x["tau"][:, leg],
        x["gravity"], leg)
    close_rel(got, item6["leg_forward_dynamics"][:, leg])


def test_joint_velocities_from_foot_velocities(item6):
    x = inputs(item6)
    got = kinematics.joint_velocities_from_foot_velocities(MODEL, x["q"],
                                                           x["v_feet"])
    close_rel(got, item6["joint_velocities_from_foot_velocities"])


def _map(item6) -> Heightfield:
    return Heightfield.from_height_array(
        torch.as_tensor(item6["map/height"])[None], origin=(-1.0, -1.0),
        resolution=0.04)


@pytest.mark.parametrize("reach", ["no_reach", "reach"])
def test_optimize_foothold_matches_jax(item6, reach):
    x = inputs(item6)
    n = x["nominal_xy"].shape[0]
    hf = _map(item6)
    hf = Heightfield(**{f: getattr(hf, f).expand(n, *getattr(hf, f).shape[1:])
                        for f in hf.__dataclass_fields__})
    fh, nrm, found = optimize_foothold(
        hf, x["nominal_xy"], x["hips"] if reach == "reach" else None)
    pre = f"optimize_foothold/{reach}/"
    np.testing.assert_array_equal(found.numpy(), item6[pre + "found"])
    np.testing.assert_allclose(fh.numpy(), item6[pre + "foothold"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(nrm.numpy(), item6[pre + "normal"], atol=1e-6,
                               rtol=0)
    if reach == "reach":  # the reach check decides somewhere
        assert not np.array_equal(item6[pre + "foothold"],
                                  item6["optimize_foothold/no_reach/foothold"])


def test_foot_heights_match_jax(item6):
    x = inputs(item6)
    hf = _map(item6)
    sim = simlib.default_stance_state(MODEL, height=0.4)
    got = []
    for feet in x["feet"]:
        s = sim.replace(feet_world=feet)
        got.append(torch.stack([
            simlib.foot_heights(s),
            simlib.foot_heights(s, lambda xy: hf.height_at(xy[None])[0])]))
    np.testing.assert_allclose(torch.stack(got).numpy(), item6["foot_heights"],
                               atol=1e-6, rtol=0)


def test_contact_fsm_matches_jax(item6):
    x = inputs(item6)
    out = contact_fsm(x["support"], x["contact"], x["swing_phase"],
                      float(item6["inputs/t_swing"]))
    for k, v in convert.to_numpy(out).items():
        np.testing.assert_array_equal(v, item6[f"contact_fsm/{k}"], err_msg=k)


@pytest.mark.parametrize("n", [6, 12, 18])
def test_spd_solve_matches_jax(item6, n):
    x = inputs(item6)
    got = spd_solve(x[f"A{n}"], x[f"b{n}"])
    close_rel(got, item6[f"spd_solve/{n}"])
    # and it solves the system
    res = (x[f"A{n}"].double() @ got.double()[..., None])[..., 0] - x[f"b{n}"]
    assert float(res.abs().max()) < 1e-4 * float(x[f"b{n}"].abs().max())


def _telemetry_fn(state, tau, diag, ctx):
    return {"tau": tau, "grf": diag.distribution.ground_reaction,
            "support": state.support, "G": ctx.G, "g": ctx.g, "D": ctx.D,
            "d": ctx.d}


def test_rollout_telemetry_fn_matches_jax(item6):
    r = {k[len("rollout_telemetry/"):]: v for k, v in item6.items()
         if k.startswith("rollout_telemetry/")}
    ls0 = convert.from_numpy(cl.LocomotionState, convert.unflatten(r, "ls0/"),
                             "cpu")
    cmd = cl.Command(linear_velocity=torch.as_tensor(r["cmd/linear_velocity"]),
                     yaw_rate=torch.as_tensor(r["cmd/yaw_rate"]))
    batch, ticks = make_refs.ROLLOUT_TEL
    _, tel = cl.rollout(MODEL, ControllerParams.defaults("cpu"),
                        GaitParams.trot_defaults("cpu"), ls0, cmd, ticks,
                        plant="massless", qp_backend="plain", device="cpu",
                        telemetry_fn=_telemetry_fn)
    ex = {k: v.numpy() for k, v in tel["extras"].items()}
    want = {k: r[f"extras/{k}"] for k in ex}
    for k in ex:  # (T, substeps, B, ...)
        assert ex[k].shape == want[k].shape == (
            ticks, cl.CONTROL_SUBSTEPS, batch) + want[k].shape[3:], k
    np.testing.assert_array_equal(ex["support"], want["support"])
    for k in ("G", "g", "D", "d"):
        close_rel(ex[k], want[k], 1e-4)
    for k in ("tau", "grf"):
        np.testing.assert_allclose(ex[k][0], want[k][0], atol=1e-3, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(ex["tau"], want["tau"], atol=1.0, rtol=0)
    np.testing.assert_allclose(tel["base_position"].numpy(),
                               r["base_position"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [3, make_refs.RING_SAMPLES])
def test_ring_log_order_matches_jax(refs, n):
    lg = {k[len("logging/"):]: v for k, v in refs.items()
          if k.startswith("logging/")}
    samples = {k[len("samples/"):]: torch.as_tensor(v)
               for k, v in lg.items() if k.startswith("samples/")}
    log = qlog.ring_log({k: v[0] for k, v in samples.items()},
                        capacity=make_refs.RING_CAPACITY)
    for i in range(n):
        log = qlog.record(log, {k: v[i] for k, v in samples.items()})
    assert int(log.cursor) == int(lg[f"capture_{n}/cursor"])
    assert int(log.total) == int(lg[f"capture_{n}/total"])
    out = qlog.capture(log)
    for k, v in out.items():
        assert v.dtype == lg[f"capture_{n}/{k}"].dtype, k
        np.testing.assert_array_equal(v, lg[f"capture_{n}/{k}"], err_msg=k)


def test_timer_and_profiler_session(tmp_path):
    t = qlog.Timer()
    with t.lap("a"):
        pass
    t.pin("b")
    t.split("b")
    assert len(t.laps["a"]) == 1 and t.mean("b") >= 0.0
    assert np.isnan(t.mean("none"))
    qlog.start_profiler(str(tmp_path))
    with qlog.trace_annotation("port_region"):
        torch.ones(3).sum()
    path = qlog.stop_profiler()
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "port_region"
               for e in trace["traceEvents"])


def test_plots_write_pngs(tmp_path):
    from quadruped_locomotion_tpu_torch.api.action_loader import default_registry
    from quadruped_locomotion_tpu_torch.rollout import preview as pv
    from quadruped_locomotion_tpu_torch.viz import plot_preview, plot_telemetry

    sim = simlib.default_stance_state(MODEL, height=0.4)
    sched = default_registry().compile(
        "trot_test", sim.robot.base.position, sim.robot.base.quaternion,
        sim.feet_world, device="cpu")
    batch = pv.batch_preview(MODEL, sched, sim.feet_world,
                             sim.robot.base.position,
                             sim.robot.base.quaternion, 60)
    p1 = plot_preview(batch, str(tmp_path / "preview.png"))
    T = 30
    tel = {"base_position": batch.base_position[:T],
           "feet_world": batch.feet_world[:T], "support": batch.support[:T],
           "qp_kkt": torch.full((T,), 1e-7), "extras": {"tau": None}}
    p2 = plot_telemetry(tel, str(tmp_path / "telemetry.png"), title="t")
    for p in (p1, p2):
        data = Path(p).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 10_000
        # IHDR: 1100 x 800, 8-bit RGB
        assert data[16:26] == bytes.fromhex("0000044c000003200802")


HIP_OFFSET = np.array([[0.42, 0.075, 0.0], [0.42, -0.075, 0.0],
                       [-0.42, -0.075, 0.0], [-0.42, 0.075, 0.0]])


def test_urdf_round_trips_to_simpledog():
    """tests/test_urdf.py's checks on the port's loader: structure, the
    round trip (1e-6) and FK/IK inverses."""
    robot = urdf.load_urdf(urdf.SIMPLEDOG_URDF)
    assert robot.name == "simpledog" and robot.root_link() == "base_link"
    assert len(robot.links) == 17
    rev = [j for j in robot.joints.values() if j.type == "revolute"]
    assert len(rev) == 12 and all(j.effort == 300.0 for j in rev)
    loaded = urdf.robot_model_from_urdf(
        urdf.SIMPLEDOG_URDF, vmc_base_mass=27.0, vmc_leg_mass=6.0,
        hip_offset=HIP_OFFSET, device="cpu")
    ref = RobotModel.simpledog("cpu")
    for name in ref.__dataclass_fields__:
        np.testing.assert_allclose(getattr(loaded, name).numpy(),
                                   getattr(ref, name).numpy(), atol=1e-6,
                                   err_msg=name)
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.uniform(-0.8, 0.8, (4, 3)) + [0.0, 0.7, -1.4],
                        dtype=torch.float32)
    feet = kinematics.forward_kinematics(loaded, q)
    feet2 = kinematics.forward_kinematics(
        loaded, kinematics.inverse_kinematics(loaded, feet))
    np.testing.assert_allclose(feet2.numpy(), feet.numpy(), atol=1e-5)
    plain = urdf.robot_model_from_urdf(device="cpu")
    np.testing.assert_allclose(plain.leg_mass.numpy(),
                               np.full(4, 1.1709 + 1.3902 + 1.3523), rtol=1e-6)


def test_entry_points_run_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        urdf.robot_model_from_urdf()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rot.quat_identity()
