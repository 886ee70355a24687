"""The port's scripted-motion building blocks against the JAX package:
the swing profiles (``gait/footstep.py``), the joint PID
(``control/swing.py``), the support polygon (``terrain/
support_polygon.py``), the BaseAuto pose cascade (``planning/
pose_optimization.py``) and the step executor (``planning/steps.py``).

Every JAX output is read from ``tests/data/torch_port_slice5_refs.npz``
(``scripts/make_torch_port_references.py --file slice5``); ``-m slow``
recomputes the sections live. Tolerances (observed on a CPU in the
docstrings of the checks):

* footstep splines, the PID's integral, the polygon: 1e-6 absolute and
  relative (the same float32 algebra, reductions ordered differently);
  spline evaluations 1e-5 absolute and relative, PID torques 1e-5 N·m;
* poses: 1e-5 (positions in m, quaternions), the check verdicts exactly;
* the executor: integer and boolean fields exactly, times and durations
  (``inf`` before the first step included) and every pose, spline and
  output within 1e-5.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.control.swing import joint_pid_gravity_torques
from quadruped_locomotion_tpu_torch.gait import footstep as fs
from quadruped_locomotion_tpu_torch.planning import pose_optimization as po
from quadruped_locomotion_tpu_torch.planning import steps
from quadruped_locomotion_tpu_torch.terrain import support_polygon as sp
from quadruped_locomotion_tpu_torch.types import RobotModel, RobotState

ROOT = Path(__file__).resolve().parent.parent
REFS = ROOT / "tests" / "data" / "torch_port_slice5_refs.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402
from make_torch_port_golden import flatten  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)
POSE_TOL = dict(atol=1e-5, rtol=0)
EXEC_TOL = dict(atol=1e-5, rtol=1e-6)
MODEL = RobotModel.simpledog("cpu")


def _section(name):
    with np.load(REFS) as f:
        p = f"{name}/"
        return {k[len(p):]: f[k] for k in f.files if k.startswith(p)}


@pytest.fixture(scope="module")
def refs():
    return {s: _section(s) for s in ("footstep", "pid", "support", "pose",
                                     "advance")}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ footstep


def port_splines(r, profile=None):
    """The port's swing_trajectory on the refs' legs: per-leg profile
    codes (the executor's call) or one int profile for every leg."""
    kw = dict(profile_height=_t(r["in/height"]),
              average_velocity=_t(r["in/avg_velocity"]))
    prof = _t(r["in/profile"]) if profile is None else profile
    return fs.swing_trajectory(_t(r["in/start"]), _t(r["in/target"]),
                               profile=prof, **kw)


def check_footstep(r, profile):
    """Observed: knot times and tangents within 6e-8, values exact;
    positions and velocities within 3e-8, accelerations (up to 70 m/s²)
    within 1.9e-6."""
    legs = r["in/profile"] == profile
    for sp_ in (port_splines(r), port_splines(r, profile)):
        for k in ("times", "values", "tangents", "num_knots", "duration"):
            np.testing.assert_allclose(getattr(sp_, k).numpy()[legs],
                                       r[f"spline/{k}"][legs], **TOL,
                                       err_msg=k)
        t = _t(r["in/t"])
        for k in ("evaluate", "velocity", "acceleration"):
            got = getattr(sp_, k)(t).numpy()[legs]
            np.testing.assert_allclose(got, r[f"eval/{k}"][legs], atol=1e-5,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("profile", [fs.PROFILE_TRIANGLE, fs.PROFILE_SQUARE,
                                     fs.PROFILE_STRAIGHT,
                                     fs.PROFILE_TRAPEZOID],
                         ids=["triangle", "square", "straight", "trapezoid"])
def test_footstep_profiles_match_jax(refs, profile):
    check_footstep(refs["footstep"], profile)


def test_profile_tensor_gives_the_int_path_bit_for_bit(refs):
    """A per-leg code tensor selects exactly what the single-profile call
    computes (the gait engine's triangle call stays as it was)."""
    r = refs["footstep"]
    mixed = port_splines(r)
    for p in range(4):
        legs = torch.from_numpy(r["in/profile"] == p)
        one = port_splines(r, p)
        for k in ("times", "values", "tangents", "num_knots", "duration"):
            assert torch.equal(getattr(mixed, k)[legs], getattr(one, k)[legs]), k


def test_step_in_place(refs):
    """The last row steps in place: the straight profile has no path, so
    its spline is a zero-length hold; the others still lift, for at least
    the 0.3 s minimum."""
    r = refs["footstep"]
    dur = port_splines(r).duration[-1].numpy()
    straight = r["in/profile"][-1] == fs.PROFILE_STRAIGHT
    assert (dur[straight] == 0).all()
    assert (dur[~straight] >= fs.DEFAULT_MIN_DURATION * (1 - 1e-6)).all()


# ---------------------------------------------------------------- joint PID


def check_pid(r):
    """Observed: torques within 1.9e-6 N·m (up to 146 N·m), the integral
    exact."""
    base = RobotState.neutral((len(r["in/q"]),), "cpu")
    st = base.replace(base=base.base.replace(quaternion=_t(r["in/quaternion"])),
                      q=_t(r["in/q"]), qd=_t(r["in/qd"]))
    tau, integral = joint_pid_gravity_torques(
        MODEL, st, _t(r["in/q_des"]), _t(r["in/qd_des"]),
        _t(r["in/integral"]), make_refs.PID_DT)
    np.testing.assert_allclose(tau.numpy(), r["tau"], atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(integral.numpy(), r["integral"], **TOL)


def test_joint_pid_matches_jax(refs):
    check_pid(refs["pid"])


def test_joint_pid_clamps_the_integral(refs):
    r = refs["pid"]
    _, integral = joint_pid_gravity_torques(
        MODEL, RobotState.neutral((len(r["in/q"]),), "cpu").replace(
            q=_t(r["in/q"])), _t(r["in/q_des"]), _t(r["in/qd_des"]),
        _t(r["in/integral"]), 10.0)
    assert integral.abs().max() == pytest.approx(1000.0)


# ------------------------------------------------------------ support polygon


SUPPORT_GROUPS = {"quad": 4, "three_legs": 3, "two_legs": 2, "one_leg": 1,
                  "none": 0}


def check_support(r, n_legs):
    """Observed: normals exact, offsets within 1.5e-8."""
    rows = r["in/support"].sum(-1) == n_legs
    normals, offsets = sp.support_halfspaces(
        _t(r["in/feet"][rows]), _t(r["in/support"][rows]),
        _t(r["in/margin"][rows]))
    np.testing.assert_allclose(normals.numpy(), r["normals"][rows], **TOL)
    np.testing.assert_allclose(offsets.numpy(), r["offsets"][rows], **TOL)
    pts = _t(r["in/points"][rows])
    viol = sp.violation(normals[:, None], offsets[:, None], pts)
    np.testing.assert_allclose(viol.numpy(), r["violation"][rows], **TOL)
    inside = sp.point_inside(normals[:, None], offsets[:, None], pts)
    clear = np.abs(r["violation"][rows]) > 1e-5  # not on an edge
    np.testing.assert_array_equal(inside.numpy()[clear], r["inside"][rows][clear])
    inside = sp.point_inside(normals[:, None], offsets[:, None], pts, tol=1e-3)
    clear = np.abs(r["violation"][rows] - 1e-3) > 1e-5
    np.testing.assert_array_equal(inside.numpy()[clear],
                                  r["inside_tol"][rows][clear])


@pytest.mark.parametrize("group", SUPPORT_GROUPS)
def test_support_halfspaces_match_jax(refs, group):
    check_support(refs["support"], SUPPORT_GROUPS[group])


def test_support_regions():
    """tests/test_pose_optimization.py's invariants: the origin inside the
    stance quad, outside with a 0.17 m margin; on the LF-RH diagonal
    line, and 5 cm off it outside."""
    feet = torch.tensor(make_refs.stance_feet()[:, :2])
    every = torch.ones(4, dtype=torch.bool)
    n, o = sp.support_halfspaces(feet, every, margin=0.0)
    assert sp.point_inside(n, o, torch.zeros(2))
    assert not sp.point_inside(n, o, torch.tensor([1.0, 0.0]))
    n, o = sp.support_halfspaces(feet, every, margin=0.17)
    assert not sp.point_inside(n, o, torch.tensor([0.0, 0.01]))
    diag = torch.tensor([True, False, True, False])
    n, o = sp.support_halfspaces(feet, diag, margin=0.0)
    assert sp.point_inside(n, o, torch.zeros(2), tol=1e-6)
    assert not sp.point_inside(n, o, torch.tensor([0.0, 0.05]))


# ------------------------------------------------------------- pose cascade


def _case(r, name):
    c = {k[len(f"{name}/in/"):]: _t(v) for k, v in r.items()
         if k.startswith(f"{name}/in/")}
    kw = {k: c[k] for k in ("polygon_feet", "polygon_support", "limb_feet",
                            "limb_support") if k in c}
    return c, kw


def check_pose_case(r, name):
    """Observed: final positions within 1.9e-9 m, quaternions within
    6e-15."""
    c, kw = _case(r, name)
    nominal = po.default_nominal_stance(MODEL, c["height"])
    geo = po.geometric_pose(c["feet"], c["support"], nominal)
    pq = po.pose_qp(MODEL, geo, c["feet"], c["support"], nominal,
                    margin=c["margin"], polygon_feet=kw.get("polygon_feet"),
                    polygon_support=kw.get("polygon_support"))
    ok = po.check_pose(MODEL, pq, c["feet"], c["support"], **kw)
    pose, status = po.optimize_pose(MODEL, c["feet"], c["support"],
                                    height=c["height"], margin=c["margin"],
                                    return_status=True, **kw)
    for stage, got in (("geometric", geo), ("qp", pq), ("pose", pose)):
        for k in ("position", "quaternion"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       r[f"{name}/{stage}/{k}"], **POSE_TOL,
                                       err_msg=f"{stage}/{k}")
    assert bool(ok) == bool(r[f"{name}/qp_ok"])
    assert bool(status) == bool(r[f"{name}/status"])


@pytest.mark.parametrize("name", ["qp", "sqp", "steps"])
def test_pose_cascade_matches_jax(refs, name):
    check_pose_case(refs["pose"], name)


def test_pose_cases_cover_both_branches(refs):
    r = refs["pose"]
    assert bool(r["qp/qp_ok"]) and not bool(r["sqp/qp_ok"])


def test_pose_batch_matches_vmap(refs, monkeypatch):
    """B = 2 (a QP pass and an SQP case) against jax.vmap of the
    cascade: the SQP runs once, on the whole batch, and each instance
    keeps its own branch."""
    r, cases = refs["pose"], make_refs.pose_cases()
    stack = lambda k: torch.from_numpy(np.stack(  # noqa: E731
        [cases["qp"][k], cases["sqp"][k]]))
    calls = []
    sqp = po.pose_sqp
    monkeypatch.setattr(po, "pose_sqp",
                        lambda *a, **k: calls.append(1) or sqp(*a, **k))
    pose, status = po.optimize_pose(MODEL, stack("feet"), stack("support"),
                                    height=stack("height"), return_status=True)
    assert len(calls) == 1
    for k in ("position", "quaternion"):
        np.testing.assert_allclose(getattr(pose, k).numpy(),
                                   r[f"batch/pose/{k}"], **POSE_TOL)
    np.testing.assert_array_equal(status.numpy(), r["batch/status"])
    # the QP-pass instance is its QP pose, untouched by the SQP
    np.testing.assert_allclose(pose.position[0].numpy(), r["qp/qp/position"],
                               **POSE_TOL)


def test_sqp_is_skipped_when_every_check_passes(refs, monkeypatch):
    monkeypatch.setattr(po, "pose_sqp", lambda *a, **k: pytest.fail("SQP ran"))
    c, kw = _case(refs["pose"], "qp")
    po.optimize_pose(MODEL, c["feet"], c["support"], height=c["height"])


def test_sqp_frozen_iterations_only_normalize():
    """After every instance converged, the remaining iterations leave
    the pose as the reference's frozen steps do: the same result for any
    iteration count past convergence."""
    feet = torch.tensor(make_refs.stance_feet())
    every = torch.ones(4, dtype=torch.bool)
    nominal = po.default_nominal_stance(MODEL, 0.4)
    pose0 = po.Pose(torch.tensor([0.15, -0.1, 0.5]),
                    torch.tensor([0.9848, 0.0, 0.0, 0.1736]))
    a = po.pose_sqp(MODEL, pose0, feet, every, nominal)
    np.testing.assert_allclose(a.position.numpy(), [0.0, 0.0, 0.4], atol=0.02)
    b = po.pose_sqp(MODEL, pose0, feet, every, nominal, iterations=12)
    torch.testing.assert_close(a.position, b.position, atol=0, rtol=0)
    torch.testing.assert_close(a.quaternion, b.quaternion, atol=1e-7, rtol=0)


# ---------------------------------------------------------------- executor


def _sched(name):
    r = _section("schedule")
    return convert.from_numpy(steps.StepSchedule,
                              convert.unflatten(r, f"{name}/"), "cpu")


def _advance(sched, tree, dt=0.01, active_steps=None):
    es = convert.from_numpy(steps.ExecState, tree["es"], "cpu")
    return steps.advance(MODEL, sched, es, _t(tree["feet"]), _t(tree["bpos"]),
                         _t(tree["bquat"]), dt, q_now=_t(tree["q_now"]),
                         active_steps=active_steps)


def _compare(got: dict, want: dict, where: str):
    for k, v in want.items():
        g = got[k]
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(g, v, err_msg=f"{where}: {k}")
        else:
            np.testing.assert_allclose(g, v, **EXEC_TOL, err_msg=f"{where}: {k}")


def _pick(tree, j):
    """Row ``j`` of every leaf of a nested dict of stacked arrays."""
    return {k: _pick(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def _check_row(sched, row, where, dt=0.01, active_steps=None):
    es2, out = _advance(sched, row["in"], dt, active_steps)
    _compare(flatten(convert.to_numpy(es2)), flatten(row["es"]), where + " es")
    _compare(flatten(convert.to_numpy(out)), flatten(row["out"]),
             where + " out")


def check_advance(r, name):
    """Observed: foot accelerations within 1.1e-6, base velocities within
    2e-7, every other float within 1.2e-7; integers and flags equal."""
    sched = _sched(name)
    tree = convert.unflatten(r, f"{name}/")
    tree = {k: tree[k] for k in ("in", "es", "out")}
    for j, n in enumerate(r[f"{name}/calls"]):
        _check_row(sched, _pick(tree, j), f"{name} call {n}")


@pytest.mark.parametrize("name", make_refs.ADVANCE_SCRIPTS)
def test_advance_matches_jax(refs, name):
    check_advance(refs["advance"], name)


def test_advance_pause_and_cut_match_jax(refs):
    """At trot_test's step switch: a dt = 0 pause tick (no switch, time
    stands still) and active_steps = 1 (the switch becomes the end)."""
    tree = convert.unflatten(refs["advance"], "trot_test/extra/")
    sched = _sched("trot_test")
    for j, tag in enumerate(("pause", "cut")):
        row = _pick(tree, j)
        _check_row(sched, row, tag, float(tree["dt"][j]),
                   int(tree["active_steps"][j]))
    pause, cut = _pick(tree, 0), _pick(tree, 1)
    assert pause["es"]["step_index"] == pause["in"]["es"]["step_index"]
    assert cut["es"]["done"] and not cut["in"]["es"]["done"]


def test_advance_batch_clamps_past_the_end(refs):
    """Two executors in one batch: one enters its next step while the
    other finishes the last step, so its next index is past the end of
    the schedule (clamped in the gather, its entry discarded). Each
    instance gets what it gets alone."""
    tree = convert.unflatten(refs["advance"], "trot_test/")
    sched = _sched("trot_test")
    rows = [_pick({k: tree[k] for k in ("in", "es", "out")}, j)
            for j in range(len(tree["calls"]))]
    switch = next(r for r in rows if r["es"]["step_index"]
                  != r["in"]["es"]["step_index"] >= 0)
    end = next(r for r in rows if r["es"]["done"] and not r["in"]["es"]["done"])
    assert end["in"]["es"]["step_index"] == sched.num_steps - 1
    pair = [switch["in"], end["in"]]
    both = convert.unflatten({k: np.stack([flatten(p)[k] for p in pair])
                              for k in flatten(pair[0])})
    es2, out = _advance(sched, both)
    for i, row in enumerate(pair):
        alone = _advance(sched, row)
        for got, want in zip((es2, out), alone):
            g, w = flatten(convert.to_numpy(got)), flatten(convert.to_numpy(want))
            for k in w:
                np.testing.assert_array_equal(g[k][i], w[k], err_msg=k)
    assert bool(es2.done[1]) and not bool(es2.done[0])
    assert int(es2.step_index[0]) == int(switch["es"]["step_index"])


@pytest.mark.slow
def test_slice5_references_match_live_jax():
    live = {name: {k: np.asarray(v) for k, v in
                   make_refs.SECTIONS[name]().items()}
            for name in ("footstep", "pid", "support", "pose", "advance")}
    for p in range(4):
        check_footstep(live["footstep"], p)
    check_pid(live["pid"])
    for n in SUPPORT_GROUPS.values():
        check_support(live["support"], n)
    for name in ("qp", "sqp", "steps"):
        check_pose_case(live["pose"], name)
    for name in make_refs.ADVANCE_SCRIPTS:
        check_advance(live["advance"], name)
