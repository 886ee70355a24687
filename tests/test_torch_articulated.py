"""The port's articulated 18-DoF plant (``rollout/articulated.py``)
against the JAX package's, and the port's closed loop through it.

Seeded numpy states (joint angles in ±0.8 rad, random joint and base
velocities, random unit quaternions, mixed pin states; generated by
``scripts/make_torch_port_references.py``) go through the JAX functions
one scenario at a time (the committed ``articulated/`` section of
``tests/data/torch_port_slice2_refs.npz``; ``-m slow`` recomputes it
live and repeats every check) and through the port as one batch. Both
sides evaluate the same closed-form kinematics with forward-mode
autodiff in float32, summed in another order, so M agrees to 1e-5
relative to its largest entry and h to 1e-5 relative (observed 1e-7);
one step agrees to 1e-4 in joint velocity and 1e-5 in base state, with
identical pin states.

The closed loop is held against ``tests/data/torch_port_articulated_golden.npz``
(``scripts/make_torch_port_golden.py --plant articulated``: the JAX
batched rollout with the articulated plant, 2 trot scenarios, 10
planner ticks, generic XLA QP); ``-m slow`` regenerates it live.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
from quadruped_locomotion_tpu_torch.model.dynamics import leg_mass_matrix
from quadruped_locomotion_tpu_torch.ops.qp import QpSolution
from quadruped_locomotion_tpu_torch.rollout import articulated as tart
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.rollout.simulator import SimState
from quadruped_locomotion_tpu_torch.types import BaseState, RobotModel
from quadruped_locomotion_tpu_torch.utils.logging import counters

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_articulated_golden.npz"
REFS = ROOT / "tests" / "data" / "torch_port_slice2_refs.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)

B = make_refs.B_ART
SUPPORT_CMD = make_refs.ART_SUPPORT_CMD


@pytest.fixture(scope="module")
def states():
    return make_refs.articulated_inputs()


@pytest.fixture(scope="module")
def refs():
    with np.load(REFS) as f:
        return {k[len("articulated/"):]: f[k] for k in f.files
                if k.startswith("articulated/")}


def _port_base(tree):
    return BaseState(**{k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()})


def check_dynamics_terms(refs, states, what):
    c = states["config"]
    tm = RobotModel.simpledog("cpu")
    base = _port_base(c["base"])
    q, qd = torch.from_numpy(c["q"]), torch.from_numpy(c["qd"])
    got = (tart.mass_matrix(tm, base, q) if what == "mass_matrix"
           else tart.bias_forces(tm, base, q, qd)).numpy()
    for i in range(B):
        want = refs[what][i]
        np.testing.assert_allclose(got[i], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def check_step(refs, states, friction_mu):
    tm = RobotModel.simpledog("cpu")
    sim = convert.from_numpy(SimState, states["sim"], "cpu")
    out = tart.step(tm, sim, torch.from_numpy(states["tau"]), 0.0025,
                    support=torch.from_numpy(SUPPORT_CMD), friction_mu=friction_mu)
    got = convert.to_numpy(out)
    tag = "stick" if friction_mu is None else "slide"
    ref = lambda k: refs[f"step_{tag}/{k}"]  # noqa: E731
    r = got["robot"]
    np.testing.assert_array_equal(r["support"], ref("robot/support"))
    for k in ("position", "quaternion", "linear_velocity", "angular_velocity"):
        np.testing.assert_allclose(r["base"][k], ref(f"robot/base/{k}"),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(r["q"], ref("robot/q"), atol=1e-6)
    np.testing.assert_allclose(r["qd"], ref("robot/qd"), atol=1e-4)
    np.testing.assert_allclose(got["feet_world"], ref("feet_world"), atol=1e-6)


def check_free_flight(refs, states):
    c = states["config"]
    tm = RobotModel.simpledog("cpu")
    got = tart.unconstrained_accel(tm, _port_base(c["base"]), torch.from_numpy(c["q"]),
                                   torch.from_numpy(c["qd"]),
                                   torch.from_numpy(states["tau"])).numpy()
    for i in range(B):
        want = refs["free_flight"][i]
        np.testing.assert_allclose(got[i], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("what", ["mass_matrix", "bias_forces"])
def test_dynamics_terms_match_jax(refs, states, what):
    check_dynamics_terms(refs, states, what)


def test_mass_matrix_structure():
    """As tests/test_articulated.py: symmetric positive definite, the
    linear block is m_total·I, and the joint blocks equal the port's own
    per-leg mass matrices at an identity base."""
    rng = np.random.default_rng(1)
    tm = RobotModel.simpledog("cpu")
    q = torch.from_numpy(rng.uniform(-0.8, 0.8, (2, 4, 3)).astype(np.float32))
    m = tart.mass_matrix(tm, BaseState.identity((2,), "cpu"), q)
    torch.testing.assert_close(m, m.mT, atol=1e-5, rtol=0)
    torch.testing.assert_close(m[:, :3, :3], torch.eye(3).expand(2, 3, 3)
                               * tm.total_mass, rtol=1e-5, atol=1e-5)
    legs = leg_mass_matrix(tm, q)
    for leg in range(4):
        sl = slice(6 + 3 * leg, 9 + 3 * leg)
        torch.testing.assert_close(m[:, sl, sl], legs[:, leg], rtol=2e-4,
                                   atol=1e-6)
    assert torch.linalg.eigvalsh(m).min() > 1e-4


@pytest.mark.parametrize("friction_mu", [None, 0.05])
def test_step_matches_jax(refs, states, friction_mu):
    """One 2.5 ms step (2 substeps) from perturbed standing states with
    mixed pins and commands, rigid stick and a μ = 0.05 cone."""
    check_step(refs, states, friction_mu)


def test_friction_cone_changes_the_step(states):
    """μ = 0.05 lets at least one pinned foot of these states slide: the
    step differs from the rigid-stick one."""
    tm = RobotModel.simpledog("cpu")
    sim = convert.from_numpy(SimState, states["sim"], "cpu")
    tau, sup = torch.from_numpy(states["tau"]), torch.from_numpy(SUPPORT_CMD)
    stick = tart.step(tm, sim, tau, 0.0025, support=sup)
    slide = tart.step(tm, sim, tau, 0.0025, support=sup, friction_mu=0.05)
    assert (stick.robot.qd - slide.robot.qd).abs().max() > 1e-3


def test_free_flight_accel_matches_jax(refs, states):
    check_free_flight(refs, states)


@pytest.mark.slow
def test_references_match_live_jax(states):
    """Recomputes the JAX references (eager JAX, per scenario) and repeats
    every check against them."""
    live = {k: np.asarray(v)
            for k, v in make_refs.articulated_references().items()}
    for what in ("mass_matrix", "bias_forces"):
        check_dynamics_terms(live, states, what)
    for mu in make_refs.ART_MU:
        check_step(live, states, mu)
    check_free_flight(live, states)


def test_convert_round_trips_articulated_state_and_qp_solution(states):
    """A SimState after articulated steps (pinned anchors in feet_world)
    and a QpSolution go numpy -> port -> numpy bit for bit."""
    tm = RobotModel.simpledog("cpu")
    sim = convert.from_numpy(SimState, states["sim"], "cpu")
    for _ in range(2):
        sim = tart.step(tm, sim, torch.from_numpy(states["tau"]), 0.0025,
                        support=torch.from_numpy(SUPPORT_CMD))
    tree = convert.to_numpy(sim)
    back = convert.to_numpy(convert.from_numpy(SimState, tree, "cpu"))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    assert tree["robot"]["support"].dtype == bool
    rng = np.random.default_rng(2)
    sol = {"x": rng.normal(size=(3, 12)), "z": rng.normal(size=(3, 20)),
           "y": np.zeros((3, 0)), "s": rng.normal(size=(3, 20)),
           "iterations": np.full(3, 15, np.int32), "kkt_error": rng.random(3)}
    port = convert.from_numpy(QpSolution, sol, "cpu")
    assert isinstance(port, QpSolution) and port.iterations.dtype == torch.int32
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert.to_numpy(port), sol)


# ---------------------------------------------------------------------------
# closed loop
# ---------------------------------------------------------------------------


def _port_inputs(golden: dict):
    return tuple(
        convert.from_numpy(cls, convert.unflatten(golden, prefix), "cpu")
        for cls, prefix in (
            (RobotModel, "model/"), (ControllerParams, "params/"),
            (GaitParams, "gait_params/"), (cl.LocomotionState, "ls0/"),
            (cl.Command, "cmd/"),
        ))


def _run_port(golden: dict):
    counters["qp.kernel_launches"] = 0
    _, tel = cl.rollout(*_port_inputs(golden), int(golden["meta/ticks"]),
                        qp_backend="plain", device="cpu")  # default plant
    assert counters["qp.kernel_launches"] == 0
    return {k: v.numpy() for k, v in tel.items()}


def _compare(golden: dict, port: dict):
    """After one tick base and feet within 1e-4 m and both QP KKTs below
    1e-3; over the run base positions within 5e-3 m, orientation within
    1e-3, the gait's support sequence and the FSM exactly, everything
    finite (the two QP solvers sit 0.1-0.5 N apart in the W = 1e-4 flat
    valley and the loop integrates that)."""
    assert str(golden["meta/plant"]) == "articulated"
    ref = {k[len("tel/"):]: v for k, v in golden.items() if k.startswith("tel/")}
    assert set(port) == set(ref)
    for k, v in port.items():
        assert v.shape == ref[k].shape, k
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k
    np.testing.assert_allclose(port["base_position"][0], ref["base_position"][0],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(port["feet_world"][0], ref["feet_world"][0],
                               atol=1e-4, rtol=0)
    assert port["qp_kkt"][0].max() < 1e-3 and ref["qp_kkt"][0].max() < 1e-3
    np.testing.assert_allclose(port["base_position"], ref["base_position"],
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(port["base_quaternion"], ref["base_quaternion"],
                               atol=1e-3, rtol=0)
    np.testing.assert_array_equal(port["support"], ref["support"])
    np.testing.assert_array_equal(port["leg_state"], ref["leg_state"])


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def test_articulated_rollout_matches_jax_golden(golden):
    _compare(golden, _run_port(golden))


@pytest.mark.slow
def test_articulated_rollout_matches_live_jax():
    """Regenerates the golden from the JAX package (minutes of XLA:CPU
    compilation) and repeats the comparison."""
    from make_torch_port_golden import make_golden

    golden = make_golden(batch=2, ticks=10, seed=0, plant="articulated")
    _compare(golden, _run_port(golden))


def _small(batch=2):
    model = RobotModel.simpledog("cpu")
    gp = GaitParams.trot_defaults("cpu")
    ls0 = cl.init_locomotion(model, gp, batch, device="cpu")
    cmd = cl.Command(linear_velocity=torch.zeros(batch, 3),
                     yaw_rate=torch.zeros(batch))
    return model, ControllerParams.defaults("cpu"), gp, ls0, cmd


def test_friction_mu_reaches_the_articulated_plant(monkeypatch):
    """planner_tick passes friction_mu to the articulated plant only, as
    the JAX closed loop does."""
    seen = []
    real = dict(cl.PLANTS)

    def spy(plant):
        def step(*a, **kw):
            seen.append((plant, kw.get("friction_mu")))
            return real[plant](*a, **kw)
        return step

    for plant in ("articulated", "none"):
        monkeypatch.setitem(cl.PLANTS, plant, spy(plant))
    args = _small()
    _, tel = cl.rollout(*args, 1, friction_mu=0.6, device="cpu")
    cl.rollout(*args, 1, plant="none", friction_mu=0.6, device="cpu")
    assert seen[:4] == [("articulated", 0.6)] * 4
    assert seen[4:] == [("none", None)] * 4
    assert all(np.isfinite(v.numpy()).all() for v in tel.values()
               if v.is_floating_point())


def test_articulated_is_the_default_plant_and_needs_cuda(monkeypatch):
    import inspect

    for fn in (cl.rollout, cl.planner_tick):
        assert inspect.signature(fn).parameters["plant"].default == "articulated"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cl.rollout(*_small(), 1)
