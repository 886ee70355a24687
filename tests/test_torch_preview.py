"""The port's kinematic preview (``rollout/preview.py``) against the JAX
package's: every bundled motion script (13) and the three inline scripts
of ``scripts/make_torch_port_references.py``, compiled against the
default 0.4 m stance and previewed up to ten ticks past their end,
against the committed JAX previews
(``tests/data/torch_port_preview_golden.npz``, written by
``scripts/make_torch_port_golden.py --path preview``; ``-m slow``
recomputes two of them live).

Gates per script: the step index, support set and done flag exactly, the
end reached, stance feet pinned exactly (where the JAX preview pins
them), base and feet positions within 1e-6 m, quaternions within 1e-6,
joints within 1e-5 rad (observed on a CPU: ≤ 6e-8 m, 6e-8 and 9.5e-7
rad). Then the StateBatch scrubbing and post-processors of the JAX
package's tests/test_preview.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.api.actions import load_action
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel
from quadruped_locomotion_tpu_torch.rollout import preview as pv
from quadruped_locomotion_tpu_torch.rollout import simulator as simlib
from quadruped_locomotion_tpu_torch.types import RobotModel

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_preview_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)

MODEL = RobotModel.simpledog("cpu")
POS_TOL = dict(atol=1e-6, rtol=0)
FIELDS = [f for f in pv.StateBatch.__dataclass_fields__]
_PREVIEWS: dict = {}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def reference(golden, name):
    return {k: golden[f"{name}/{k}"] for k in FIELDS + ["done_tick"]}


def port_preview(name, ticks):
    """The port's preview of ``name`` for ``ticks`` ticks (cached)."""
    if (name, ticks) not in _PREVIEWS:
        sim = simlib.default_stance_state(MODEL, height=make_refs.STANCE_HEIGHT)
        sched = load_action(make_refs.script_source(name),
                            sim.robot.base.position,
                            sim.robot.base.quaternion, sim.feet_world,
                            device="cpu")
        _PREVIEWS[name, ticks] = pv.preview_schedule(
            MODEL, sched, height=make_refs.STANCE_HEIGHT,
            planner_ticks=ticks, device="cpu")
    return _PREVIEWS[name, ticks]


def check_preview(ref, batch):
    got = {k: getattr(batch, k).numpy() for k in FIELDS}
    for k in FIELDS:
        assert got[k].shape == ref[k].shape, k
        if got[k].dtype.kind == "f":
            assert np.isfinite(got[k]).all(), k
    for k in ("step_index", "support", "done"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    done_tick = int(ref["done_tick"])
    assert not got["done"][done_tick - 2] and got["done"][done_tick - 1:].all()
    # stance feet stay exactly where they were (joint-mode legs, which
    # follow their joint splines, are where the JAX preview moves them)
    sup = ref["support"][1:]
    pinned = sup & (ref["feet_world"][1:] == ref["feet_world"][:-1]).all(-1)
    assert pinned.sum() >= 0.5 * sup.sum()
    feet = got["feet_world"]
    np.testing.assert_array_equal(feet[1:][pinned], feet[:-1][pinned])
    for k in ("times", "base_position", "feet_world", "base_quaternion",
              "feet_velocity"):
        np.testing.assert_allclose(got[k], ref[k], **POS_TOL, err_msg=k)
    np.testing.assert_allclose(got["joint_positions"], ref["joint_positions"],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", make_refs.PREVIEW_SCRIPTS)
def test_preview_matches_jax(golden, name):
    ref = reference(golden, name)
    fd_qp_kernel.launches = 0
    check_preview(ref, port_preview(name, len(ref["times"])))
    assert fd_qp_kernel.launches == 0


def test_state_batch_round_trips(golden):
    """JAX StateBatch → port → numpy, bit for bit."""
    ref = reference(golden, "leg_move")
    batch = convert.from_numpy(pv.StateBatch, {k: ref[k] for k in FIELDS},
                               "cpu")
    for k, v in convert.to_numpy(batch).items():
        assert v.dtype == ref[k].dtype and np.array_equal(v, ref[k]), k


def _leg_move(golden):
    return port_preview("leg_move", len(golden["leg_move/times"]))


def test_state_batch_scrubbing(golden):
    batch = _leg_move(golden)
    mid = pv.state_at(batch, batch.times[-1] * 0.5)
    assert mid["base_position"].shape == (3,)
    assert mid["joint_positions"].shape == (4, 3)
    np.testing.assert_allclose(float(torch.linalg.norm(mid["base_quaternion"])),
                               1.0, atol=1e-5)
    at5 = pv.state_at(batch, batch.times[5])
    np.testing.assert_allclose(at5["feet_world"].numpy(),
                               batch.feet_world[5].numpy(), atol=1e-5)
    # between two ticks: the linear blend of the neighbours
    t = 0.25 * batch.times[7] + 0.75 * batch.times[8]
    np.testing.assert_allclose(
        pv.state_at(batch, t)["base_position"].numpy(),
        (0.25 * batch.base_position[7] + 0.75 * batch.base_position[8]).numpy(),
        atol=1e-6)


def test_state_batch_computers(golden):
    batch = _leg_move(golden)
    times, swing = pv.compute_end_effector_trajectories(batch)
    support = batch.support.numpy()
    swing = swing.numpy()
    assert np.isnan(swing[support]).all()
    assert np.isfinite(swing[~support]).all()
    assert (~support).any()

    stances = pv.compute_stances(batch).numpy()
    assert stances.shape == batch.feet_world.shape
    changes = np.any(stances[1:] != stances[:-1], axis=(1, 2))
    switches = np.any(support[1:] != support[:-1], axis=1)
    assert (~changes | switches).all()
    first = np.flatnonzero(switches)[0] + 1
    np.testing.assert_array_equal(stances[first], batch.feet_world[first])
    _, pos, quat = pv.compute_base_trajectory(batch)
    assert pos is batch.base_position and quat is batch.base_quaternion


def test_preview_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    sched = load_action(make_refs.script_source("standup"),
                        torch.zeros(3), torch.tensor([1.0, 0, 0, 0]),
                        torch.zeros(4, 3), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pv.preview_schedule(MODEL, sched, planner_ticks=1)


@pytest.mark.slow
def test_preview_matches_live_jax():
    import jax

    from quadruped_locomotion_tpu.rollout import preview as jpv

    _, sim = make_refs._stance()
    for name in ("trot_test", "inline_profiles"):
        sched = make_refs.compile_script(name, sim)
        ticks = 80 if name == "trot_test" else 140
        b = jax.jit(lambda: jpv.preview_schedule(
            make_refs._stance()[0], sched, height=make_refs.STANCE_HEIGHT,
            planner_ticks=ticks))()
        ref = {k: np.asarray(getattr(b, k)) for k in FIELDS}
        ref["done_tick"] = int(np.argmax(ref["done"])) + 1
        check_preview(ref, port_preview(name, ticks))
