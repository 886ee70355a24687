"""The port's batched closed loop as a whole, against the JAX reference.

``tests/data/torch_port_rollout_golden.npz`` holds the inputs and the
per-tick telemetry of the JAX package's ``rollout(batched=True,
plant="massless", qp_backend="xla", terrain=None)`` over 8 trot
scenarios with seeded commands for 25 planner ticks (written by
``scripts/make_torch_port_golden.py``). The port starts from the same
state, carried over by ``convert.py``, and runs on the CPU through the
plain QP.

Tolerances: after one tick (4 substeps) the two sides have solved the
same QPs from the same state, so base position and feet agree to
1e-4 m and both QP KKT residuals are < 1e-3. Over 25 ticks the two QP
solvers (the kernel's algorithm vs the generic XLA IPM) pick different
points along the W = 1e-4 flat valley, 0.1-0.5 N apart, and the
closed loop integrates that: base positions agree to 5e-3 m, the gait's
support sequence exactly, and every value stays finite.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.types import RobotModel

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_rollout_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))

torch.set_num_threads(1)


def _port_inputs(golden: dict):
    return tuple(
        convert.from_numpy(cls, convert.unflatten(golden, prefix), "cpu")
        for cls, prefix in (
            (RobotModel, "model/"),
            (ControllerParams, "params/"),
            (GaitParams, "gait_params/"),
            (cl.LocomotionState, "ls0/"),
            (cl.Command, "cmd/"),
        ))


def _run_port(golden: dict):
    fd_qp_kernel.launches = 0
    ticks = int(golden["meta/ticks"])
    _, tel = cl.rollout(*_port_inputs(golden), ticks, plant="massless",
                        qp_backend="plain", device="cpu")
    assert fd_qp_kernel.launches == 0  # the CPU never reaches the kernel
    return {k: v.numpy() for k, v in tel.items()}


def _compare(golden: dict, port: dict):
    ref = {k[len("tel/"):]: v for k, v in golden.items()
           if k.startswith("tel/")}
    assert set(port) == set(ref)
    for k, v in port.items():
        assert v.shape == ref[k].shape, k
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k
    # after tick 1
    np.testing.assert_allclose(port["base_position"][0],
                               ref["base_position"][0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(port["feet_world"][0], ref["feet_world"][0],
                               atol=1e-4, rtol=0)
    assert port["qp_kkt"][0].max() < 1e-3
    assert ref["qp_kkt"][0].max() < 1e-3
    # over all ticks
    np.testing.assert_allclose(port["base_position"], ref["base_position"],
                               atol=5e-3, rtol=0)
    np.testing.assert_array_equal(port["support"], ref["support"])


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def port_telemetry(golden):
    return _run_port(golden)


def test_rollout_matches_jax_golden(golden, port_telemetry):
    _compare(golden, port_telemetry)


@pytest.mark.parametrize("field", ["leg_state", "base_quaternion",
                                   "base_velocity", "feet_world"])
def test_rollout_fields_track_golden(golden, port_telemetry, field):
    """The rest of the telemetry over all 25 ticks: the FSM's leg states
    exactly; orientation to 1e-3, velocity to 5e-2 m/s and feet to 5e-3 m
    (the same flat-valley drift as the base position)."""
    got, want = port_telemetry[field], golden[f"tel/{field}"]
    if field == "leg_state":
        np.testing.assert_array_equal(got, want)
    else:
        tol = {"base_quaternion": 1e-3, "base_velocity": 5e-2,
               "feet_world": 5e-3}[field]
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.slow
def test_rollout_matches_live_jax():
    """Regenerates the golden from the JAX package (minutes of XLA:CPU
    compilation) and repeats the comparison."""
    from make_torch_port_golden import make_golden

    golden = make_golden(batch=8, ticks=25, seed=0)
    _compare(golden, _run_port(golden))


def test_convert_round_trip(golden):
    """numpy -> port -> numpy reproduces every array of the state and the
    parameters bit for bit."""
    ports = _port_inputs(golden)
    for obj, prefix in zip(ports, ("model/", "params/", "gait_params/",
                                   "ls0/", "cmd/")):
        back = convert.to_numpy(obj)
        for key in (k for k in golden if k.startswith(prefix)):
            node = back
            for part in key[len(prefix):].split("/"):
                node = node[part]
            np.testing.assert_array_equal(node, golden[key], err_msg=key)


def _small(batch=2):
    model = RobotModel.simpledog("cpu")
    gp = GaitParams.trot_defaults("cpu")
    ls0 = cl.init_locomotion(model, gp, batch, device="cpu")
    cmd = cl.Command(linear_velocity=torch.zeros(batch, 3),
                     yaw_rate=torch.zeros(batch))
    return model, ControllerParams.defaults("cpu"), gp, ls0, cmd


def test_controller_only_plant_holds_state():
    args = _small()
    _, tel = cl.rollout(*args, 2, plant="none", device="cpu")
    pos = tel["base_position"].numpy()
    assert all(np.isfinite(v.numpy()).all() for v in tel.values()
               if v.is_floating_point())
    start = args[3].sim.robot.base.position.numpy()
    np.testing.assert_allclose(pos, np.broadcast_to(start, pos.shape),
                               atol=1e-6)


@pytest.mark.parametrize("plant, err", [("rigid", ValueError)])
def test_unported_plants_raise(plant, err):
    with pytest.raises(err):
        cl.rollout(*_small(), 1, plant=plant, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means CUDA; without it the entry points raise instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RobotModel.simpledog()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cl.rollout(*_small(), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cl.init_locomotion(RobotModel.simpledog("cpu"),
                           GaitParams.trot_defaults("cpu"), 2)
