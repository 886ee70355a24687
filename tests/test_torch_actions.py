"""The port's motion-script front end against the JAX package: YAML →
``StepSchedule`` (``api/actions.py``), the action registry over the
bundled library (``api/action_loader.py``), and the console
(``api/cli.py``, ``python -m quadruped_locomotion_tpu_torch``).

* Every bundled motion script (13) and the three inline scripts of
  ``scripts/make_torch_port_references.py`` compile to the JAX
  schedule field for field, exactly (the ``schedule/`` section of
  ``tests/data/torch_port_slice5_refs.npz``; both sides build it in
  float64 numpy and round to float32 once).
* The registry lists what the JAX registry lists; python, launch and
  combined-YAML actions are listed and refuse to compile to a schedule
  (the action loader runs them).
* ``list-actions`` / ``list-collections`` print the JAX console's lines;
  ``preview --device cpu`` prints its JSON line, whose final pose is the
  committed JAX preview's (``tests/data/torch_port_preview_golden.npz``)
  within 1e-6 m; ``run --device cpu`` for two ticks ends where the JAX
  closed loop does (``tests/data/torch_port_script_golden.npz``) within
  1e-6 m.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch.api import action_loader, actions, cli
from quadruped_locomotion_tpu_torch.planning import steps
from quadruped_locomotion_tpu_torch.rollout import simulator as simlib
from quadruped_locomotion_tpu_torch.types import RobotModel

ROOT = Path(__file__).resolve().parent.parent
REFS = ROOT / "tests" / "data" / "torch_port_slice5_refs.npz"
PREVIEW = ROOT / "tests" / "data" / "torch_port_preview_golden.npz"
SCRIPT = ROOT / "tests" / "data" / "torch_port_script_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402
from make_torch_port_golden import flatten  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def schedules():
    with np.load(REFS) as f:
        return {k[len("schedule/"):]: f[k] for k in f.files
                if k.startswith("schedule/")}


def _stance():
    model = RobotModel.simpledog("cpu")
    return simlib.default_stance_state(model, height=make_refs.STANCE_HEIGHT)


@pytest.mark.parametrize("name", make_refs.PREVIEW_SCRIPTS)
def test_schedule_matches_jax(schedules, name):
    sim = _stance()
    for k in ("base_position", "base_quaternion"):
        np.testing.assert_array_equal(
            getattr(sim.robot.base, k[5:]).numpy(), schedules[f"stance/{k}"])
    np.testing.assert_array_equal(sim.feet_world.numpy(),
                                  schedules["stance/feet_world"])
    sched = actions.load_action(make_refs.script_source(name),
                                sim.robot.base.position,
                                sim.robot.base.quaternion, sim.feet_world,
                                device="cpu")
    got = flatten({f.name: getattr(sched, f.name).numpy()
                   for f in sched.__dataclass_fields__.values()})
    want = {k[len(name) + 1:]: v for k, v in schedules.items()
            if k.startswith(name + "/")}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_create_gives_the_scripts_defaults():
    """StepSchedule.create(S) holds the defaults a script's empty steps
    compile to; an override replaces its field, an unknown one raises."""
    sim = _stance()
    empty = actions.build_schedule(
        {"steps": [{"step": []}, {"step": []}]}, sim.robot.base.position,
        sim.robot.base.quaternion, sim.feet_world, device="cpu")
    made = steps.StepSchedule.create(2, device="cpu", base_mode=[1, 0])
    for f in made.__dataclass_fields__:
        want = getattr(empty, f)
        if f == "base_mode":
            want = torch.tensor([1, 0], dtype=torch.int32)
        assert torch.equal(getattr(made, f), want), f
    with pytest.raises(TypeError, match="unknown"):
        steps.StepSchedule.create(1, device="cpu", leg_speed=1.0)


def test_frames_resolve_against_the_state():
    """foot_print: the feet's centroid with the base's yaw; base_link:
    the base pose; world: as given."""
    yaw = 0.3
    quat = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
    feet = np.array([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0]])
    ad = actions.FrameAdapter(torch.tensor([0.1, 0.2, 0.4]),
                              torch.tensor(quat), torch.tensor(feet))
    c, s = np.cos(yaw), np.sin(yaw)
    np.testing.assert_allclose(ad.position([1.0, 0, 0], "foot_print"),
                               [0.5 + c, 0.5 + s, 0.0], atol=1e-7)
    np.testing.assert_allclose(ad.position([1.0, 0, 0], "base_link"),
                               [0.1 + c, 0.2 + s, 0.4], atol=1e-7)
    np.testing.assert_allclose(ad.position([1.0, 2, 3], "odom"), [1, 2, 3])
    np.testing.assert_allclose(ad.orientation([0, 0, 0, 1], None), [1, 0, 0, 0])
    with pytest.raises(ValueError):
        ad.position([0, 0, 0], "map")


def test_knot_counts_are_checked():
    sim = _stance()
    script = ("steps:\n  - step:\n      - joint_trajectory:\n"
              "          name: LF_LEG\n          trajectory: {knots: []}\n")
    with pytest.raises(ValueError, match="knots"):
        actions.load_action(script, sim.robot.base.position,
                            sim.robot.base.quaternion, sim.feet_world,
                            device="cpu")


def test_registry_lists_the_jax_registry():
    """The same entries; each file the port's copy at the JAX package's
    path relative to its ``api/`` directory."""
    from quadruped_locomotion_tpu.api import action_loader as jax_loader

    ours, theirs = action_loader.default_registry(), jax_loader.default_registry()

    def entries(reg, module):
        api = Path(module.__file__).resolve().parent
        return [{**vars(a), "file": Path(a.file).relative_to(api)}
                for a in reg.list_actions()]

    assert entries(ours, action_loader) == entries(theirs, jax_loader)
    assert [vars(c) for c in ours.list_collections()] == [
        vars(c) for c in theirs.list_collections()]
    assert ([a.id for a in ours.list_actions("walk_demo")]
            == ["sitdown", "standup", "stational_walk"])
    yaml_ids = sorted(a.id for a in ours.list_actions() if a.type == "yaml")
    assert yaml_ids == sorted(make_refs.SCRIPT_NAMES)


@pytest.mark.parametrize("action_id", ["velocity_trot", "external_demo",
                                       "standup_then_rotate"])
def test_unported_action_types_refuse_to_compile(action_id):
    sim = _stance()
    with pytest.raises(NotImplementedError, match="through ActionLoader"):
        action_loader.default_registry().compile(
            action_id, sim.robot.base.position, sim.robot.base.quaternion,
            sim.feet_world, device="cpu")


def test_compile_sequence():
    sim = _stance()
    reg = action_loader.default_registry()
    args = (sim.robot.base.position, sim.robot.base.quaternion,
            sim.feet_world)
    seq = reg.compile_sequence("sit_stand", *args, device="cpu")
    assert [s.num_steps for s in seq] == [1, 1]
    torch.testing.assert_close(seq[1].base_height,
                               reg.compile("standup", *args,
                                           device="cpu").base_height)
    with pytest.raises(ValueError, match="not a sequence"):
        reg.compile_sequence("base_motions", *args, device="cpu")


# ------------------------------------------------------------------ console


def test_cli_lists(capsys):
    assert cli.main(["list-actions"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(action_loader.default_registry().actions)
    assert any(ln.split()[0] == "standup" and "stand up" in ln for ln in lines)
    assert cli.main(["list-actions", "--collection", "sit_stand"]) == 0
    assert [ln.split()[0] for ln in capsys.readouterr().out.splitlines()] == [
        "sitdown", "standup"]
    assert cli.main(["list-collections"]) == 0
    out = capsys.readouterr().out
    assert "walk_demo" in out and "[sequence]" in out


def test_cli_preview_json_line(capsys):
    """The JAX console's preview line for trot_test from the 0.4 m
    stance, ending where the committed JAX preview ends."""
    with np.load(PREVIEW) as g:
        ticks = len(g["trot_test/times"])
        base, feet = g["trot_test/base_position"][-1], g["trot_test/feet_world"][-1]
    rc = cli.main(["preview", "trot_test", "--device", "cpu", "--height",
                   "0.4", "--ticks", str(ticks)])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0
    assert set(line) == {"action", "ticks", "completed", "final_base",
                         "final_feet"}
    assert line["action"] == "trot_test" and line["ticks"] == ticks
    assert line["completed"] is True
    np.testing.assert_allclose(line["final_base"], base, atol=1e-6)
    np.testing.assert_allclose(line["final_feet"], feet, atol=1e-6)


def test_cli_run_json_line(capsys):
    """Two closed-loop ticks of standup from the console's 0.38 m stance:
    not completed (exit 1), the JAX golden's base position."""
    rc = cli.main(["run", "standup", "--device", "cpu", "--ticks", "2"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1 and line["completed"] is False
    assert set(line) == {"action", "ticks", "completed", "final_base",
                         "max_qp_kkt"}
    with np.load(SCRIPT) as g:
        np.testing.assert_allclose(line["final_base"],
                                   g["standup/tel/base_position"][1], atol=1e-6)
    assert line["max_qp_kkt"] < 1e-2


def test_cli_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["preview", "standup", "--ticks", "1"])
