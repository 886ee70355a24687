"""The port's wire messages (``api/messages.py``) and limb configuration
(``types.limb_configure_branches``) against the JAX package's.

JAX outputs: ``messages/`` of ``tests/data/torch_port_slice7_refs.npz``
(``scripts/make_torch_port_references.py --file slice7``) for the goals of
``slice7_goals`` (tests/test_messages.py's, tests/test_action_server.py's
and tests/test_marker.py's) and a feedback, a result and two robot-state
messages. Gates: ``to_json`` byte for byte; ``from_json`` round trips;
the YAML-shaped document of each goal equal to the one JAX compiles;
``goal_to_schedule`` against the 0.38 m and 0.4 m stances with integer
and boolean fields equal and float fields within 1e-6.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.api import messages as msgs
from quadruped_locomotion_tpu_torch.rollout import simulator as simlib
from quadruped_locomotion_tpu_torch.types import (
    IK_BRANCH, LIMB_CONFIGURE, RobotModel, limb_configure_branches,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

MODEL = RobotModel.simpledog("cpu")
GOALS = make_refs.slice7_goals(msgs)
MESSAGES = {**GOALS, **make_refs.slice7_messages(msgs)}


@pytest.fixture(scope="module")
def refs():
    with np.load(make_refs.SLICE7_OUT) as f:
        return {k[len("messages/"):]: f[k] for k in f.files
                if k.startswith("messages/")}


@pytest.mark.parametrize("name", list(MESSAGES))
def test_json_is_byte_identical(refs, name):
    s = msgs.to_json(MESSAGES[name])
    assert s == str(refs[f"json/{name}"])
    assert msgs.from_json(s) == MESSAGES[name]


@pytest.mark.parametrize("height", make_refs.MESSAGE_HEIGHTS)
def test_robot_state_snapshot(refs, height):
    sim = simlib.default_stance_state(MODEL, height=height)
    m = msgs.robot_state_from_sim(sim, torch.as_tensor(make_refs.STATE_SUPPORT),
                                  make_refs.STATE_PHASES)
    want = str(refs[f"json/robot_state_{height}"])
    # joint angles come from each package's IK: compare numbers within an
    # ulp of the stance's, and the rest of the message exactly
    got_d, want_d = json.loads(msgs.to_json(m)), json.loads(want)
    np.testing.assert_allclose(np.asarray(got_d["joint_positions"]),
                               np.asarray(want_d["joint_positions"]),
                               atol=1e-6, rtol=0)
    got_d["joint_positions"] = want_d["joint_positions"]
    assert got_d == want_d
    assert msgs.from_json(msgs.to_json(m)) == m


@pytest.mark.parametrize("height", make_refs.MESSAGE_HEIGHTS)
@pytest.mark.parametrize("name", list(GOALS))
def test_goal_to_schedule_matches_jax(refs, name, height):
    want_doc = json.loads(str(refs[f"{height}/{name}/doc"]))
    assert json.loads(json.dumps(msgs.goal_to_doc(GOALS[name]))) == want_doc
    sim = simlib.default_stance_state(MODEL, height=height)
    sched = msgs.goal_to_schedule(GOALS[name], sim.robot.base.position,
                                  sim.robot.base.quaternion, sim.feet_world,
                                  device="cpu")
    got = convert.to_numpy(sched)
    prefix = f"{height}/{name}/"
    want = {k[len(prefix):]: v for k, v in refs.items()
            if k.startswith(prefix) and k != prefix + "doc"}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("configure", sorted(LIMB_CONFIGURE))
def test_limb_configure_branches(configure):
    b = limb_configure_branches(configure, "cpu")
    assert b.dtype == torch.int32 and b.shape == (4,)
    assert b.tolist() == [IK_BRANCH[n] for n in LIMB_CONFIGURE[configure]]


def test_limb_configure_rejects_unknown_strings():
    with pytest.raises(KeyError):
        limb_configure_branches("??", "cpu")


def test_goal_to_schedule_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    sim = simlib.default_stance_state(MODEL, height=0.4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        msgs.goal_to_schedule(GOALS["footstep2"], sim.robot.base.position,
                              sim.robot.base.quaternion, sim.feet_world)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        limb_configure_branches("><")
