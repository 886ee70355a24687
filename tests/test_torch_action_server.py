"""The port's action server (``runtime/action_server.py``) against the JAX
package's ``FreeGaitActionServer``.

The JAX golden ``tests/data/torch_port_server_golden.npz``
(``scripts/make_torch_port_golden.py --path server``) holds, for each
window of ``SERVER_WINDOWS``, the JAX server's state just before an event
(``<name>/snap/``: the padded schedule, the live row count, the clock,
the goals, the scripted loop's state) and what its next 20 ticks showed.
A whole goal takes hundreds of ticks at ~1-2 s each on a CPU core, so the
port starts from each snapshot (``FreeGaitActionServer.from_snapshot``)
and runs the first WINDOW_TICKS[name] ticks of the window through
``run_window``, the same function the golden was recorded with:

* ``append_pause``: a goal's first feedback appends a second goal, then
  three paused ticks and a resumed one;
* ``complete``: the goal completes on the second tick and the executor
  goes idle;
* ``stop_step`` / ``stop_immediate`` / ``stop_no``: ``stop()`` under each
  preemption mode;
* ``limb``: ``set_limb_configure`` with an unknown string, then '>>';
* ``trot``: the continuous trot's trigger sends the next half-cycle.

Gates: every feedback field, the executor's step index and done flag,
the live rows, the results (tick, goal, status) and the trot's goal count
equal JAX's tick for tick; the feedback's duration and phase and the
executor's time in step within 1e-6; base positions within
``test_torch_script.POS_TOL`` (1e-5 m); one device-to-host copy per
tick; no kernel launch (the balance QP is the generic IPM).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.api import messages as msgs
from quadruped_locomotion_tpu_torch.api.continuous_actions import (
    VelocityTrotAction,
)
from quadruped_locomotion_tpu_torch.planning.steps import BASE_AUTO, LEG_NONE
from quadruped_locomotion_tpu_torch.runtime.action_server import (
    FreeGaitActionServer,
)
from quadruped_locomotion_tpu_torch.types import RobotModel
from quadruped_locomotion_tpu_torch.utils.logging import counters

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_server_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))
from make_torch_port_golden import (  # noqa: E402
    FEEDBACK_INTS, SERVER_CAPACITY, SERVER_WINDOWS, restore_trot, run_window,
)
from make_torch_port_references import slice7_goals  # noqa: E402

torch.set_num_threads(1)

POS_TOL = 1e-5  # m, as tests/test_torch_script.py
FLOAT_TOL = 1e-6
# ticks of each window run here (the golden has 20): each covers its event
WINDOW_TICKS = {"append_pause": 5, "complete": 3, "stop_step": 3,
                "stop_immediate": 2, "stop_no": 2, "limb": 2, "trot": 3}
MODEL = RobotModel.simpledog("cpu")
GOALS = slice7_goals(msgs)


def host(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def restore(golden, name):
    snap = convert.unflatten(golden, f"{name}/snap/")
    srv = FreeGaitActionServer.from_snapshot(MODEL, snap, device="cpu")
    action = None
    if name == "trot":
        action = VelocityTrotAction(srv, velocity=(0.12, 0.0))
        restore_trot(action, golden, f"{name}/snap/")
    return srv, action


def test_windows_cover_their_events(golden):
    assert set(WINDOW_TICKS) == set(SERVER_WINDOWS)
    assert golden["append_pause/tel/results"].tolist() == [[11, 0, 3]]
    assert golden["complete/tel/results"].tolist()[0] == [1, 0, 3]
    for mode in ("stop_step", "stop_immediate"):
        assert golden[f"{mode}/tel/results"].tolist()[0] == [-1, 0, 2]
    assert golden["stop_no/tel/results"].size == 0
    assert golden["trot/tel/cycles_sent"][:2].tolist() == [1, 2]
    assert golden["limb/tel/limb"].tolist() == [False, True]


@pytest.mark.parametrize("name", list(WINDOW_TICKS))
def test_window_matches_jax(golden, name):
    ticks = WINDOW_TICKS[name]
    srv, action = restore(golden, name)
    counters["qp.kernel_launches"] = 0
    copies0 = srv.host_copies
    got = run_window(srv, name, ticks, msgs, GOALS, host, action)
    assert counters["qp.kernel_launches"] == 0
    # one copy per tick, plus one for the pose each appended goal is
    # resolved against and one for the executor state stop() reads (a
    # PREEMPT_NO stop reads nothing)
    events = int(name in ("append_pause", "trot", "stop_step",
                          "stop_immediate"))
    assert srv.host_copies - copies0 == ticks + events
    ref = {k: golden[f"{name}/tel/{k}"] for k in got}
    for k in (*FEEDBACK_INTS, "has_feedback", "step_id", "branches",
              "step_index", "done", "active", "cycles_sent"):
        np.testing.assert_array_equal(got[k], ref[k][:ticks], err_msg=k)
    for k in ("limb", "ik_branch"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    want = ref["results"][ref["results"][:, 0] < ticks]
    np.testing.assert_array_equal(got["results"], want)
    for k in ("duration", "phase", "time_in_step"):
        np.testing.assert_allclose(got[k], ref[k][:ticks], atol=FLOAT_TOL,
                                   rtol=0, err_msg=k)
    assert np.isfinite(got["base_position"]).all()
    np.testing.assert_allclose(got["base_position"],
                               ref["base_position"][:ticks], atol=POS_TOL,
                               rtol=0)
    if name == "append_pause":
        # paused ticks leave the executor's clock where it was
        t = got["time_in_step"]
        assert t[1] == t[2] == t[3] and t[4] > t[3]


def test_snapshot_round_trips(golden):
    """JAX snapshot → port server → snapshot, bit for bit."""
    want = convert.unflatten(golden, "stop_step/snap/")
    srv, _ = restore(golden, "stop_step")
    back = srv.snapshot()
    flat = lambda t, p="": {  # noqa: E731
        f"{p}{k}": v for kk, vv in t.items()
        for k, v in (flat(vv, f"{kk}/").items() if isinstance(vv, dict)
                     else [(kk, vv)])}
    got, ref = flat(back), flat(want)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def _rows(srv):
    return srv._host_lm[:srv._active], srv._host_bm[:srv._active]


def test_trailing_base_auto_is_replaced():
    """A queued final pure-BaseAuto step gives way to the next goal, as in
    the JAX server (tests/test_action_server.py's check, before any
    tick); the device buffer's rows match the host mirrors."""
    srv = FreeGaitActionServer(MODEL, capacity=SERVER_CAPACITY, device="cpu")
    goal = slice7_goals(msgs)["footstep2"]
    goal.steps.append(msgs.StepMsg(base_auto=msgs.BaseAutoMsg(height=0.4)))
    srv.submit_goal(goal)
    assert srv._active == 3 and srv._row_is_pure_base_auto(2)
    srv.submit_goal(GOALS["footstep1_append"])
    assert srv._active == 3
    lm, bm = _rows(srv)
    assert (lm[2] != LEG_NONE).any() and bm[2] == BASE_AUTO
    assert srv._goals[0].n_steps == 2 and srv._goals[1].first_row == 2
    np.testing.assert_array_equal(srv._sched.leg_motion_type.numpy(),
                                  srv._host_lm)
    np.testing.assert_array_equal(srv._sched.base_mode.numpy(), srv._host_bm)


def test_compaction_keeps_live_rows():
    """Past the buffer, executed rows before the current one are dropped
    and the executor's index and the goals' rows move with them."""
    srv = FreeGaitActionServer(MODEL, capacity=4, device="cpu")
    srv.submit_goal(GOALS["footstep3"])
    row2 = srv._sched.leg_target[2].clone()
    es = srv.state.exec
    srv._set_exec(step_index=torch.full_like(es.step_index, 2))
    srv._snap = None
    srv.submit_goal(GOALS["footstep2"])
    assert srv._active == 3 and srv.current_row == 0
    assert torch.equal(srv._sched.leg_target[0], row2)
    assert [g.first_row for g in srv._goals] == [-2, 1]
    np.testing.assert_array_equal(srv._sched.leg_motion_type.numpy(),
                                  srv._host_lm)
    assert (srv._host_lm[3] == LEG_NONE).all()


def test_goal_rows_are_the_compiled_goal():
    """A submitted goal's rows are ``goal_to_schedule`` of it against the
    robot's state, written with one host-to-device copy."""
    srv = FreeGaitActionServer(MODEL, capacity=SERVER_CAPACITY, device="cpu")
    sim = srv.state.sim
    want = msgs.goal_to_schedule(GOALS["footstep3"], sim.robot.base.position,
                                 sim.robot.base.quaternion, sim.feet_world,
                                 device="cpu")
    srv.submit_goal(GOALS["footstep3"])
    for k, v in convert.to_numpy(want).items():
        got = convert.to_numpy(getattr(srv._sched, k))[:3]
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_server_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FreeGaitActionServer(MODEL)
