"""The port's closed-loop scripted motion (``rollout/script_loop.py``)
against the JAX package's, and the state conversion of the
scripted-motion structs (``convert.py``).

The JAX golden ``tests/data/torch_port_script_golden.npz``
(``scripts/make_torch_port_golden.py --path script``) holds three
windows of ``script_loop.planner_tick`` (massless plant, generic QP): a
``ScriptState`` at the window's start and per tick the run_schedule
telemetry, the executor's desired support and its joint mode. The port
starts from that state (through ``convert.py``) and runs WINDOW_TICKS of
each, as ``chip_smoke.py`` phase 12 runs 20 of the two windows:

* ``standup`` from tick 0 (the step entry's pose optimization, the base
  rising 0.38 → 0.45 m), LF's hip abduction moved by 1e-5 rad;
* ``trot_test`` from tick 24, across the first pair's touchdown and the
  second pair's lift-off (tick 30): the FSM reflexes and the triangle
  footstep;
* ``change_to_spot`` from tick 120: RH under the joint PID.

Gates: step index and desired support exactly, no kernel launch (the
generic QP, as in JAX), finite telemetry, base positions within 1e-5 m
(observed: ≤ 4e-9 m in the windows over 20 ticks, ≤ 1.1e-6 m in standup
over 60). Standup is chaotic in the reference itself: its base roll rate
grows ~10x per tick from any asymmetry (JAX from the exact stance: 0 at
tick 1, 1e-5 rad/s at tick 2, 0.16 rad/s at tick 6, from its own
rounding), so from the exact stance two float32 runs part by up to
~1e-3 m (two XLA compilations: 4.8e-4 m; the port: 9.4e-4 m on a CPU,
1.2e-3 m on the card). The golden therefore starts with LF's hip
abduction moved by 1e-5 rad, a seed both runs share.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.control.contact_fsm import FsmState
from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel
from quadruped_locomotion_tpu_torch.planning import steps
from quadruped_locomotion_tpu_torch.rollout import script_loop as sl
from quadruped_locomotion_tpu_torch.types import RobotModel

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_script_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))
from make_torch_port_golden import SCRIPT_WINDOWS, flatten  # noqa: E402

torch.set_num_threads(1)

WINDOW_TICKS = 8
POS_TOL = 1e-5  # m
MODEL = RobotModel.simpledog("cpu")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def window_inputs(golden, name):
    get = lambda cls, p: convert.from_numpy(  # noqa: E731
        cls, convert.unflatten(golden, f"{name}/{p}"), "cpu")
    return get(sl.ScriptState, "ss0/"), get(steps.StepSchedule, "sched/")


def check_window(golden, name, ticks):
    ss0, sched = window_inputs(golden, name)
    fd_qp_kernel.launches = 0
    ssf, tel = sl.run_schedule(MODEL, ControllerParams.defaults("cpu"), sched,
                               ss0, ticks, device="cpu")
    assert fd_qp_kernel.launches == 0
    ref = {k: golden[f"{name}/tel/{k}"][:ticks] for k in tel}
    for k, v in tel.items():
        assert v.shape == ref[k].shape, k
        if v.is_floating_point():
            assert torch.isfinite(v).all(), k
    for k in ("step_index", "support", "done"):
        np.testing.assert_array_equal(tel[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(tel["base_position"].numpy(),
                               ref["base_position"], atol=POS_TOL, rtol=0)
    assert tel["qp_kkt"].max() < 1e-2
    return ssf, tel


@pytest.mark.parametrize("name", list(SCRIPT_WINDOWS))
def test_run_schedule_matches_jax(golden, name):
    check_window(golden, name, WINDOW_TICKS)


def test_windows_exercise_their_paths(golden):
    """The trot window switches steps with footsteps in swing; the
    change_to_spot window has RH in joint mode; standup enters its step
    on the first tick."""
    sup = golden["trot_test/tel/support"][:WINDOW_TICKS]
    idx = golden["trot_test/tel/step_index"][:WINDOW_TICKS]
    assert len(set(idx)) == 2 and (~sup).any()
    jm = golden["change_to_spot/tel/joint_mode"][:WINDOW_TICKS]
    assert jm[:, 2].all() and not jm[:, [0, 1, 3]].any()
    assert golden["standup/ss0/exec/step_index"] == -1


def test_init_script_state_matches_jax(golden):
    """The port's standing start, seeded as the golden's, is the JAX
    init_script_state (IK within an ulp)."""
    ss = sl.init_script_state(MODEL, height=float(golden["standup/meta/height"]),
                              device="cpu")
    ss.sim.robot.q[0, 0] += float(golden["standup/meta/seed_lf_haa"])
    got = flatten(convert.to_numpy(ss))
    for k, v in got.items():
        want = golden[f"standup/ss0/{k}"]
        assert v.dtype == want.dtype and v.shape == want.shape, k
        np.testing.assert_allclose(v, want, atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("cls, prefix", [
    (sl.ScriptState, "change_to_spot/ss0/"),
    (steps.ExecState, "change_to_spot/ss0/exec/"),
    (FsmState, "trot_test/ss0/fsm/"),
    (steps.StepSchedule, "change_to_spot/sched/"),
], ids=["ScriptState", "ExecState", "FsmState", "StepSchedule"])
def test_state_round_trips(golden, cls, prefix):
    """JAX → port → numpy, bit for bit (dtypes and the executor's inf
    included)."""
    tree = convert.unflatten(golden, prefix)
    obj = convert.from_numpy(cls, tree, "cpu")
    back = flatten(convert.to_numpy(obj))
    want = flatten(tree)
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_pause_tick_holds_the_executor(golden):
    """dt = 0: no step switch and no time passes, while the controller
    runs on the held outputs."""
    ss0, sched = window_inputs(golden, "trot_test")
    ss1, kkt = sl.planner_tick(MODEL, ControllerParams.defaults("cpu"), sched,
                               ss0, dt=0.0)
    assert torch.equal(ss1.exec.time_in_step, ss0.exec.time_in_step)
    assert torch.equal(ss1.exec.step_index, ss0.exec.step_index)
    assert not torch.equal(ss1.sim.robot.q, ss0.sim.robot.q)
    assert kkt < 1e-2


def test_script_loop_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sl.init_script_state(MODEL)


@pytest.mark.slow
def test_script_windows_match_live_jax():
    from make_torch_port_golden import make_script_golden

    live = make_script_golden()
    for name in SCRIPT_WINDOWS:
        check_window(live, name, WINDOW_TICKS)
