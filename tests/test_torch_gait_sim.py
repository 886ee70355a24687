"""PyTorch port vs JAX reference: the gait engine (phase timers, Hermite
splines, swing trajectories, ten flat-ground trot ticks of
``gait_generator.advance``) and one step of the massless plant, on
seeded inputs.

Tolerances: phase timers and masks must agree exactly up to float32
rounding of the same additions (atol 1e-6 s); spline and gait-engine
positions to atol 1e-5 m (a few ulps of O(1) coordinates through the
same cubic), velocities and accelerations scaled by the segment length
(1/h and 1/h² with h ~ 0.1 s amplify those ulps: atol 1e-4 and 1e-2,
rtol 1e-4). The plant step goes through the torch.func leg dynamics and
3×3 solves; its outputs agree to atol 1e-5 (positions, angles) and 1e-4
(velocities, which carry τ·dt/m of forces up to 1e3 N).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu.gait import footstep as jfoot
from quadruped_locomotion_tpu.gait import gait_generator as jgg
from quadruped_locomotion_tpu.gait import phase as jphase
from quadruped_locomotion_tpu.gait import spline as jspline
from quadruped_locomotion_tpu.rollout import simulator as jsim
from quadruped_locomotion_tpu.types import RobotModel as JRobotModel
from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.gait import footstep as tfoot
from quadruped_locomotion_tpu_torch.gait import gait_generator as tgg
from quadruped_locomotion_tpu_torch.gait import phase as tphase
from quadruped_locomotion_tpu_torch.gait import spline as tspline
from quadruped_locomotion_tpu_torch.rollout import simulator as tsim
from quadruped_locomotion_tpu_torch.types import RobotModel as TRobotModel

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_torch_port_golden import jax_to_numpy  # noqa: E402

torch.set_num_threads(1)

B = 4
DT = 0.01
POS = dict(atol=1e-5, rtol=1e-5)
VEL = dict(atol=1e-4, rtol=1e-4)
ACC = dict(atol=1e-2, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _assert_tree_close(port_tree, ref_tree, tol, path=""):
    """Nested numpy dicts: bool/int leaves exactly, floats within tol."""
    for k, ref in ref_tree.items():
        got = port_tree[k]
        if isinstance(ref, dict):
            _assert_tree_close(got, ref, tol, f"{path}{k}/")
        elif ref.dtype.kind in "bi":
            np.testing.assert_array_equal(got, ref, err_msg=path + k)
        else:
            np.testing.assert_allclose(got, ref, err_msg=path + k, **tol)


@pytest.fixture(scope="module")
def gait_params():
    return (jphase.GaitParams.trot_defaults(),
            tphase.GaitParams.trot_defaults(device="cpu"))


# ---------------------------------------------------------------- phase


@pytest.mark.parametrize("gait", ["trot", "pace"])
def test_phase_advance_trajectory(gait):
    """200 ticks (2 s, several cycles) from the standing start."""
    if gait == "trot":
        jp, tp = jphase.GaitParams.trot_defaults(), \
            tphase.GaitParams.trot_defaults(device="cpu")
        js, ts = jphase.PhaseState.init_trot(jp), tphase.PhaseState.init_trot(tp)
    else:
        jp, tp = jphase.GaitParams.pace_defaults(), \
            tphase.GaitParams.pace_defaults(device="cpu")
        js, ts = jphase.PhaseState.init_pace(jp), tphase.PhaseState.init_pace(tp)
    step = jax.jit(lambda s: jphase.advance(s, jp, DT))
    for _ in range(200):
        js, ts = step(js), tphase.advance(ts, tp, DT)
        _assert_tree_close(convert.to_numpy(ts), jax_to_numpy(js),
                           dict(atol=1e-6, rtol=0))


def test_phase_advance_random_states(gait_params):
    jp, tp = gait_params
    rng = np.random.default_rng(1)
    n = 64
    state = dict(swing_phase=rng.uniform(0, 0.5, (n, 4)).astype(np.float32),
                 stance_phase=rng.uniform(0, 0.5, (n, 4)).astype(np.float32),
                 is_swing=rng.random((n, 4)) < 0.5,
                 ready_to_swing=rng.random((n, 4)) < 0.5)
    ref = jax.vmap(lambda s: jphase.advance(s, jp, DT))(
        jphase.PhaseState(**state))
    port = tphase.advance(tphase.PhaseState(**{k: _t(v) for k, v in state.items()}),
                          tp, DT)
    _assert_tree_close(convert.to_numpy(port), jax_to_numpy(ref),
                       dict(atol=1e-6, rtol=0))
    _close(tphase.com_weights(port, tp),
           jax.vmap(lambda s: jphase.com_weights(s, jp))(ref), POS)


# --------------------------------------------------------------- spline


@pytest.fixture(scope="module")
def splines():
    """Seeded knot tables with 2-5 real knots, some zero-length segments,
    padded by repeating the last knot."""
    rng = np.random.default_rng(2)
    n = 32
    k = rng.integers(2, 6, n).astype(np.int32)
    steps = rng.uniform(0.05, 0.2, (n, 5))
    steps[:, 0] = 0.0
    steps[rng.random((n, 5)) < 0.15] = 0.0  # degenerate segments
    times = np.cumsum(steps, axis=1)
    values = rng.normal(0, 0.2, (n, 5, 3))
    for i in range(n):
        times[i, k[i]:] = times[i, k[i] - 1]
        values[i, k[i]:] = values[i, k[i] - 1]
    t_eval = rng.uniform(-0.05, times[:, -1] + 0.05)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(times=f32(times), values=f32(values),
                v0=f32(rng.normal(0, 0.5, (n, 3))),
                v1=f32(rng.normal(0, 0.5, (n, 3))), k=k, t=f32(t_eval))


@pytest.mark.parametrize("what", ["evaluate", "velocity", "acceleration"])
def test_spline_fit_and_eval(splines, what):
    s = splines
    jsp = jax.vmap(jspline.fit)(s["times"], s["values"], s["v0"], s["v1"], s["k"])
    tsp = tspline.fit(*(_t(s[k]) for k in ("times", "values", "v0", "v1", "k")))
    _assert_tree_close(convert.to_numpy(tsp), jax_to_numpy(jsp), VEL)
    ref = jax.vmap(lambda sp, t: getattr(sp, what)(t))(jsp, s["t"])
    port = getattr(tsp, what)(_t(s["t"]))
    _close(port, ref, {"evaluate": POS, "velocity": VEL,
                       "acceleration": ACC}[what])


def test_swing_trajectory():
    rng = np.random.default_rng(3)
    start = rng.normal(0, 0.3, (B, 4, 3)).astype(np.float32)
    target = (start + rng.normal(0, 0.1, (B, 4, 3))).astype(np.float32)
    ref = jax.vmap(jax.vmap(lambda a, b: jfoot.swing_trajectory(
        a, b, profile=jfoot.PROFILE_TRIANGLE, profile_height=0.15)))(start, target)
    port = tfoot.swing_trajectory(_t(start), _t(target), profile_height=0.15)
    _assert_tree_close(convert.to_numpy(port), jax_to_numpy(ref), VEL)


# ---------------------------------------------------------- gait engine


def _perturbed_stance(rng):
    """B seeded robot states around the standing start (numpy dicts in
    the SimState layout)."""
    sim = jax_to_numpy(jsim.default_stance_state(JRobotModel.simpledog()))
    tile = lambda a: np.broadcast_to(a, (B,) + a.shape).copy()  # noqa: E731
    sim = jax.tree_util.tree_map(tile, sim)
    base = sim["robot"]["base"]
    yaw = rng.uniform(-0.3, 0.3, B)
    base["quaternion"] = np.stack(
        [np.cos(yaw / 2), np.zeros(B), np.zeros(B), np.sin(yaw / 2)], -1
    ).astype(np.float32)
    base["position"] = (base["position"]
                        + rng.uniform(-0.02, 0.02, (B, 3))).astype(np.float32)
    base["linear_velocity"] = rng.normal(0, 0.1, (B, 3)).astype(np.float32)
    base["angular_velocity"] = rng.normal(0, 0.1, (B, 3)).astype(np.float32)
    sim["robot"]["q"] = (sim["robot"]["q"]
                         + rng.normal(0, 0.03, (B, 4, 3))).astype(np.float32)
    sim["robot"]["qd"] = rng.normal(0, 0.5, (B, 4, 3)).astype(np.float32)
    sim["feet_world"] = (sim["feet_world"]
                         + rng.normal(0, 0.01, (B, 4, 3))).astype(np.float32)
    return sim


def _to_jax(template, tree):
    """Numpy dict ``tree`` (field-name keys) -> the JAX dataclass of
    ``template``'s type, leaves in the dataclasses' field order."""
    def leaves(tmpl, t):
        for k, v in tmpl.items():
            if isinstance(v, dict):
                yield from leaves(v, t[k])
            else:
                yield jnp.asarray(t[k])

    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        list(leaves(jax_to_numpy(template), tree)))


def test_gait_advance_ten_flat_trot_ticks(gait_params):
    jp, tp = gait_params
    rng = np.random.default_rng(4)
    sim = _perturbed_stance(rng)
    jm, tm = JRobotModel.simpledog(), TRobotModel.simpledog(device="cpu")
    lin = np.stack([rng.uniform(-0.1, 0.4, B), rng.uniform(-0.1, 0.1, B),
                    np.zeros(B)], -1).astype(np.float32)
    wz = rng.uniform(-0.3, 0.3, B).astype(np.float32)

    tstate = convert.from_numpy(tsim.SimState, sim, "cpu")
    jrobot = _to_jax(jsim.default_stance_state(jm).robot, sim["robot"])
    jfeet = jnp.asarray(sim["feet_world"])

    jg = jax.vmap(lambda f: jgg.init_gait_state(jphase.TROT, jp, f))(jfeet)
    tg = tgg.init_gait_state(tphase.TROT, tp, tstate.feet_world)
    _assert_tree_close(convert.to_numpy(tg), jax_to_numpy(jg), POS)

    jadv = jax.jit(jax.vmap(lambda g, r, f, v, w: jgg.advance(
        jm, g, r, f, jp, v, w, DT)))
    for _ in range(10):
        jg, jsup, jsw, jtgt, jn = jadv(jg, jrobot, jfeet, lin, wz)
        tg, tsup, tsw, ttgt, tn = tgg.advance(
            tm, tg, tstate.robot, tstate.feet_world, tp, _t(lin), _t(wz), DT)
        np.testing.assert_array_equal(tsup.numpy(), np.asarray(jsup))
        for a, b, tol in zip(tsw, jsw, (POS, VEL, ACC)):
            _close(a, b, tol)
        _assert_tree_close(convert.to_numpy(ttgt), jax_to_numpy(jtgt), VEL)
        _close(tn, jn, POS)
        _assert_tree_close(convert.to_numpy(tg), jax_to_numpy(jg), VEL)


def test_gait_advance_runs_terrain(gait_params):
    """Terrain runs: on flat per-scenario maps the gait engine gives the
    flat-ground support, targets snapped to the maps' cell centres and
    upright normals."""
    from quadruped_locomotion_tpu_torch.terrain.heightfield import Heightfield

    _, tp = gait_params
    tm = TRobotModel.simpledog(device="cpu")
    sim = tsim.default_stance_state(tm, batch=(B,))
    g = tgg.init_gait_state(tphase.TROT, tp, sim.feet_world)
    lin = torch.tensor([[0.2, 0.0, 0.0]] * B)
    hf = Heightfield.flat(B, device="cpu")
    gf, sup_f, _, _, _ = tgg.advance(tm, g, sim.robot, sim.feet_world, tp,
                                     lin, torch.zeros(B), DT)
    gt, sup_t, (pos, _, _), _, nrm = tgg.advance(
        tm, g, sim.robot, sim.feet_world, tp, lin, torch.zeros(B), DT,
        terrain=hf)
    torch.testing.assert_close(sup_t, sup_f)
    lifted = ~sup_t  # the legs whose targets were set this tick
    assert lifted.any()
    cells = (gt.swing_targets[lifted][:, :2] + 4.0) / 0.04
    torch.testing.assert_close(cells, torch.round(cells), atol=1e-4, rtol=0)
    torch.testing.assert_close(gt.swing_targets, gf.swing_targets, atol=0.021,
                               rtol=0)
    torch.testing.assert_close(nrm, torch.tensor([0.0, 0.0, 1.0]).expand(
        B, 4, 3))
    assert torch.isfinite(pos).all()


# ---------------------------------------------------------------- plant


def test_default_stance_state():
    ref = jax_to_numpy(jsim.default_stance_state(JRobotModel.simpledog()))
    port = convert.to_numpy(tsim.default_stance_state(
        TRobotModel.simpledog(device="cpu")))
    _assert_tree_close(port, ref, POS)


@pytest.mark.parametrize("field", ["position", "quaternion", "linear_velocity",
                                   "angular_velocity", "q", "qd", "feet_world",
                                   "support"])
def test_massless_step(field):
    rng = np.random.default_rng(5)
    sim = _perturbed_stance(rng)
    support = rng.random((B, 4)) < 0.6
    support[0] = True
    sim["robot"]["support"] = support
    lift = ~support & (rng.random((B, 4)) < 0.7)  # most swing feet airborne
    sim["feet_world"][..., 2] += np.where(lift, 0.05, 0.0).astype(np.float32)
    tau = rng.normal(0, 20.0, (B, 4, 3)).astype(np.float32)
    jm, tm = JRobotModel.simpledog(), TRobotModel.simpledog(device="cpu")
    jstate = _to_jax(jsim.default_stance_state(jm), sim)
    ref = jax.jit(jax.vmap(lambda s, t, sp: jsim.step(
        jm, s, t, 0.0025, support=sp)))(jstate, tau, support)
    tstate = convert.from_numpy(tsim.SimState, sim, "cpu")
    port = tsim.step(tm, tstate, _t(tau), 0.0025, support=_t(support))
    ref, port = jax_to_numpy(ref), convert.to_numpy(port)
    if field == "feet_world":
        got, want = port[field], ref[field]
    elif field in ("q", "qd", "support"):
        got, want = port["robot"][field], ref["robot"][field]
    else:
        got, want = port["robot"]["base"][field], ref["robot"]["base"][field]
    if field == "support":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, VEL if field.endswith("velocity") or field == "qd"
               else POS)
