"""The port's operator API against the JAX package's: the action classes
(``api/action.py``, ``api/continuous_actions.py``), the action loader
(``api/action_loader.py::ActionLoader``) and the marker session
(``api/marker.py``).

JAX outputs: ``loader/`` of ``tests/data/torch_port_server_golden.npz``
(``scripts/make_torch_port_golden.py --path server``): the JAX
``ActionLoader`` sending the bundled python action (the continuous trot),
combined-YAML action and launch action to fresh servers, through the
same function (``run_loader``) as here. Gates: the action's class and
state, its goal document, the server's live schedule rows (integers
equal, floats within 1e-6), three ticks of feedback equal to JAX's
(duration and phase within 1e-6, base within 1e-5 m) and the lifecycle
log equal; the launch action's log and exit code equal. The marker
session builds the goals of ``slice7_goals`` (held byte for byte against
JAX's JSON in tests/test_torch_messages.py).
"""

from __future__ import annotations

import json
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.api import action as A
from quadruped_locomotion_tpu_torch.api import messages as msgs
from quadruped_locomotion_tpu_torch.api.action_loader import (
    BUNDLED_LIBRARY, ActionLoader, default_registry,
)
from quadruped_locomotion_tpu_torch.api.marker import MarkerSession, repl
from quadruped_locomotion_tpu_torch.runtime.action_server import (
    FreeGaitActionServer,
)
from quadruped_locomotion_tpu_torch.types import RobotModel

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_server_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))
from make_torch_port_golden import (  # noqa: E402
    FEEDBACK_INTS, LOADER_TICKS, SERVER_CAPACITY, run_loader,
)
from make_torch_port_references import slice7_goals  # noqa: E402

torch.set_num_threads(1)
MODEL = RobotModel.simpledog("cpu")
GOALS = slice7_goals(msgs)
S = A.ActionState


def host(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def server():
    return FreeGaitActionServer(MODEL, capacity=SERVER_CAPACITY, device="cpu")


@pytest.mark.parametrize("action_id", ["velocity_trot", "standup_then_rotate"])
def test_loader_action_matches_jax(golden, action_id):
    got = run_loader(ActionLoader(server()), action_id, msgs, GOALS, host)
    pre = f"loader/{action_id}/"
    ref = {k[len(pre):]: v for k, v in golden.items() if k.startswith(pre)}
    assert got.keys() == ref.keys()
    for k in ("type", "state_after_send", "active", "state_log"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert json.loads(str(got["doc"])) == json.loads(str(ref["doc"]))
    for k, v in ref.items():
        if k.startswith("rows/"):
            if v.dtype.kind == "f":
                np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k in (*FEEDBACK_INTS, "has_feedback", "step_id", "branches",
              "step_index", "done", "active", "cycles_sent", "results"):
        np.testing.assert_array_equal(got[f"tel/{k}"], ref[f"tel/{k}"],
                                      err_msg=k)
    for k in ("duration", "phase", "time_in_step"):
        np.testing.assert_allclose(got[f"tel/{k}"], ref[f"tel/{k}"],
                                   atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["tel/base_position"],
                               ref["tel/base_position"], atol=1e-5, rtol=0)
    assert len(got["tel/step_index"]) == LOADER_TICKS


def test_loader_launch_action_matches_jax(golden):
    got = run_loader(ActionLoader(server()), "external_demo", msgs, GOALS,
                     host)
    ref = "loader/external_demo/"
    assert str(got["type"]) == str(golden[ref + "type"]) == "SubprocessAction"
    np.testing.assert_array_equal(got["state_log"], golden[ref + "state_log"])
    assert int(got["returncode"]) == int(golden[ref + "returncode"]) == 0


def test_python_actions_resolve_to_the_ports_copy():
    reg = default_registry()
    entry = reg.actions["velocity_trot"]
    assert entry.type == "python"
    path = Path(entry.file)
    assert path == BUNDLED_LIBRARY / "python_actions" / "velocity_trot.py"
    assert "quadruped_locomotion_tpu_torch" in path.parts
    assert "from quadruped_locomotion_tpu." not in path.read_text()


def test_sequence_chains_and_stops_on_an_unknown_id():
    """send_action_sequence starts the next action from the done callback;
    an unknown id ends the sequence in ERROR, as the reference's purge."""
    loader = ActionLoader(server())
    loader.send_action_sequence(["external_demo", "external_demo"])
    first = loader.action
    assert loader.pump_until(S.DONE, max_ticks=50)
    assert loader.action is not first and not loader.action_sequence_queue
    assert loader.pump_until(S.DONE, max_ticks=50)
    loader.send_action_sequence(["external_demo", "does_not_exist"])
    for _ in range(50):
        loader.pump()
        if loader.action is None:
            break
    assert loader.action is None and loader.state_log[-1] == S.ERROR
    with pytest.raises(KeyError):
        loader.send_action("does_not_exist")


def test_action_lifecycle_without_ticks(tmp_path):
    srv = server()
    act = A.SimpleAction(srv, None)
    act.start()
    assert act.state == S.DONE and act.result is not None
    assert S.to_text(S.IDLE) == "Idle"
    t = A.TriggerOnFeedback(1, 0.5)
    assert not t.check(msgs.ExecuteStepsFeedback(queue_size=2, phase=0.9))
    assert not t.check(msgs.ExecuteStepsFeedback(queue_size=1, phase=0.4))
    assert t.check(msgs.ExecuteStepsFeedback(queue_size=1, phase=0.6))
    assert not t.check(None)
    doc = {"a": "X", "b": [1, "X", {"c": "Y"}], "d": "Z"}
    assert A.replace_placeholders(doc, {"X": 0.3, "Y": [1]}) == {
        "a": 0.3, "b": [1, 0.3, {"c": [1]}], "d": "Z"}
    # a goal of each accepted form is queued
    A.SimpleAction(srv, GOALS["footstep2"]).start()
    A.SimpleAction(srv, {"steps": [{"step": [{"base_auto": {}}]}]}).start()
    assert srv._active == 3
    with pytest.raises(TypeError):
        A.SimpleAction(srv, 3).start()


def test_combined_yaml_placeholders(tmp_path):
    """tests/test_action_lifecycle.py's placeholder file: the value
    substitutes into the combined script's goal."""
    (tmp_path / "param_move.yaml").write_text(textwrap.dedent("""
        steps:
          - step:
              - base_target:
                  target: {position: [0.0, 0.0, TARGET_HEIGHT]}
        """))
    combined = tmp_path / "combined.yaml"
    combined.write_text(textwrap.dedent("""
        global_placeholders:
          TARGET_HEIGHT: 0.345
        yaml_actions:
          - action:
              file_path: param_move.yaml
        """))
    act = A.CombinedYamlAction(server())
    act.set_goal_from_file(str(combined))
    assert act.state == S.INITIALIZED
    pos = act.goal["steps"][0]["step"][0]["base_target"]["target"]["position"]
    assert pos[2] == 0.345
    missing = A.CombinedYamlAction(server())
    missing.set_goal_from_file(str(tmp_path / "nope.yaml"))
    assert missing.state == S.ERROR


def test_marker_session_builds_the_jax_goals():
    srv = server()
    sess = MarkerSession(srv, height=0.4)
    feet = srv.state.sim.feet_world.numpy()
    for i, name in enumerate(msgs.LEG_NAMES):
        np.testing.assert_array_equal(sess.footholds[name], feet[i])
    sess.set_foothold("LF", (0.50, 0.21, 0.0))
    assert sess.foothold_goal("LF") == GOALS["marker_foothold"]
    for k in GOALS["marker_trajectory"].steps[0].end_effector_trajectories[0].knots:
        sess.add_knot("LF", k.time, k.position)
    assert sess.trajectory_goal("LF") == GOALS["marker_trajectory"]
    gid = sess.send_foothold("LF")
    assert gid == 0 and sess.sent_goals == [0] and srv._active == 1
    sim = srv.state.sim
    want = msgs.goal_to_schedule(GOALS["marker_foothold"],
                                 sim.robot.base.position,
                                 sim.robot.base.quaternion, sim.feet_world,
                                 device="cpu")
    np.testing.assert_array_equal(srv._sched.leg_target[:1].numpy(),
                                  want.leg_target.numpy())
    out = []
    repl(sess, ["bogus", "foot XX 1 2", "setknot LF 9 0 0 0", "# comment", "",
                "nudge LF 0.01 0", "show", "quit", "show"], out=out.append)
    assert sum(o.startswith(("!", "?")) for o in out) == 3
    assert sum("marker (world)" in o for o in out) == 1  # quit stops
    np.testing.assert_allclose(sess.footholds["LF_LEG"], [0.51, 0.21, 0.0])


def test_operator_entry_points_run_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    for make in (ActionLoader, MarkerSession,
                 lambda: FreeGaitActionServer(MODEL)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert isinstance(ActionLoader(device="cpu").server, FreeGaitActionServer)
    sess = MarkerSession(device="cpu")
    assert sess.server.device == torch.device("cpu")
    assert convert.to_numpy(sess.server.state.sim.feet_world).shape == (4, 3)
