"""Write the JAX reference outputs that the port's CPU tests compare
against: ``tests/test_torch_{qp,headline,articulated}.py`` (slice 2) and
``tests/test_torch_fd_qp.py`` (the QP kernel).

Every input is made here from numpy seeds (the tests import the same
generators) or from the JAX package's own test inputs, goes through the
JAX package's functions on the CPU, and the outputs are saved to
compressed ``.npz`` files with ``/``-joined keys. The slice-2 file
(``tests/data/torch_port_slice2_refs.npz``) has three sections:

* ``qp/``: ``ops/qp.py::solve_qp`` on the cases of ``tests/test_qp.py``
  (the quadprog++ worked example, random inequality and equality QPs, a
  warm start with the light polish);
* ``headline/``: ``bench.build_batch`` on one 1024-instance tile and the
  kernel trace ``qp_pallas.solve_weighted_ls_fd_qp(emulate=True)`` on it;
  ``tests/test_balance.py``'s load-factor batch and the JAX
  ``distribute`` on it;
* ``articulated/``: ``rollout/articulated.py``'s ``mass_matrix``,
  ``bias_forces``, ``unconstrained_accel`` and one ``step`` (rigid and
  μ = 0.05) on seeded states.

The QP-kernel file (``tests/data/torch_port_fd_qp_refs.npz``) has one
section, ``fd_qp/``: the problems of ``tests/test_torch_fd_qp.py`` (the
stance classes of ``tests/test_qp_pallas.py::_stance_problems`` with G, g
formed at full precision, seeded random positive-definite QPs, then the
QPs recorded on the card in ``tests/data/torch_port_chip_qps.npz``: the
phase-3 violators and the worst-KKT QPs of the massless rollout at 100
and at 25 ticks, of the articulated rollout and of the config-5 sweep)
and what the JAX kernel trace (``qp_pallas.solve_fd_qp_emulated``) and
the XLA IPM (``jax.vmap(qp.solve_qp)``) return on them, plus the trace on
63 ulp-perturbed copies of each worst QP (where the reference's own
outcome is chaotic). Regenerate it after refreshing the recorded QPs.

The slice-4 file (``tests/data/torch_port_slice4_refs.npz``) holds the
inputs and JAX outputs of ``tests/test_torch_{terrain,sweep,estimated}.py``:

* ``terrain/``: ``Heightfield.from_height_array`` on three maps of one
  shape (``tests/test_terrain.py``'s bumps, its steep-walled pit, and a
  one-cell spike on a map of binary-fraction cells whose four diagonal
  neighbours tie in the foothold search), ``height_at`` / ``normal_at`` /
  ``traversability_at`` / ``cell_index`` at seeded points (clamped
  borders included) and ``optimize_footholds`` with and without hips;
* ``gait_b6/``, ``gait_b4/``: ten ticks of ``gait_generator.advance``
  with per-scenario maps and per-scenario (trot/pace, then scaled)
  ``GaitParams`` on perturbed states;
* ``sweep/``: ``bench.build_scenarios(16)`` and ``jax.image.resize`` of
  its coarse grid;
* ``ekf/``: ``state_estimator.predict``, ``update`` and
  ``synthesize_imu`` on seeded states.

The slice-5 file (``tests/data/torch_port_slice5_refs.npz``) holds the
inputs and JAX outputs of ``tests/test_torch_{planning,actions}.py``:

* ``footstep/``: ``swing_trajectory`` on seeded legs of all four
  profiles (per-leg heights and velocities, steps in place included)
  and its evaluations at seeded times;
* ``pid/``: ``joint_pid_gravity_torques`` on seeded states (an integral
  at its windup clamp included);
* ``support/``: ``support_halfspaces`` for every support set of four
  legs on two stances, with ``point_inside`` / ``violation`` at seeded
  points;
* ``pose/``: the cascade's stages and ``optimize_pose`` on a QP-pass, an
  SQP and an executor-shaped case, and ``jax.vmap`` of it over two;
* ``schedule/``: ``load_action`` of every bundled motion script and
  the INLINE_SCRIPTS against the default stance;
* ``advance/``: ``steps.advance`` on the previews' executor states
  around every step switch and the end of the schedule (a pause tick
  and a cut schedule too).

The slice-6 file (``tests/data/torch_port_slice6_refs.npz``) holds the
JAX outputs of ``tests/test_torch_runtime.py``: ``runtime/``, the JAX
``ControllerManager`` + ``SimHardware`` + ``BalanceStandController``
standing for 400 ticks, ``balance_update`` on five of its samples, and
the single-leg and freeze controllers' torques.

The slice-8 file (``tests/data/torch_port_slice8_refs.npz``) holds the
inputs and JAX outputs of ``tests/test_torch_parallel.py``: ``parallel/``,
the JAX package's ``parallel/`` on an 8-device mesh (XLA:CPU's virtual
devices, as ``tests/conftest.py`` sets them): ``make_sharded_qp_sweep``
(the XLA backend, 15 iterations) on ``bench.build_batch(16)``; the kernel
trace ``solve_weighted_ls_fd_qp(emulate=True)`` (15 iterations) on
``bench.build_batch(64)`` (one instance's trace does not depend on its
device or its neighbours: ``tests/test_parallel.py``); ``make_sharded_rollout``
(3 steps) from the default stance toward seeded displaced targets; and
``make_sharded_locomotion_rollout`` (3 ticks, XLA backend) from the
standing start under the seed-0 commands of ``__graft_entry__.py``.

The slice-7 file (``tests/data/torch_port_slice7_refs.npz``) holds the
JAX outputs of ``tests/test_torch_{messages,utils}.py``: ``messages/``,
``to_json`` of the goals of :func:`slice7_goals` and of the feedback,
result and robot-state messages, and ``goal_to_schedule`` of each goal
against the default stance at two heights; ``item6/``, the reference
functions that had no counterpart (rotations, leg dynamics, differential
IK, the single-foot ``optimize_foothold``, ``foot_heights``, the
stateless ``contact_fsm``, ``spd_solve``, ``rollout(telemetry_fn=)``) on
seeded inputs; ``logging/``, the ring log's capture order.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_references.py \\
        [--file slice2|fd_qp|slice4|slice5|slice6|slice7|slice8|all]

Takes about two minutes per file on a CPU, most of it XLA compilation and
the eager kernel trace. The tests recompute each section live under
``-m slow``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
DEFAULT_OUT = os.path.join(DATA, "torch_port_slice2_refs.npz")
FD_QP_OUT = os.path.join(DATA, "torch_port_fd_qp_refs.npz")
SLICE4_OUT = os.path.join(DATA, "torch_port_slice4_refs.npz")
SLICE5_OUT = os.path.join(DATA, "torch_port_slice5_refs.npz")
SLICE6_OUT = os.path.join(DATA, "torch_port_slice6_refs.npz")
SLICE7_OUT = os.path.join(DATA, "torch_port_slice7_refs.npz")
SLICE8_OUT = os.path.join(DATA, "torch_port_slice8_refs.npz")
CHIP_QPS = os.path.join(DATA, "torch_port_chip_qps.npz")

TILE = 1024  # one (8, 128) tile of the JAX kernel trace
LOAD_FACTORS = np.array([1.0, 1.0, 0.5, 1.0], np.float32)
B_LF = 4  # tests/test_balance.py's load-factor batch
B_ART = 4
ART_SUPPORT = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 1, 1]],
                       bool)
ART_SUPPORT_CMD = np.array([[1, 1, 1, 1], [1, 1, 1, 1], [0, 1, 1, 0],
                            [1, 0, 0, 1]], bool)
ART_MU = (None, 0.05)
FD_ITERS = 15
FD_N_RANDOM = 8
# rows of the recorded chip QPs, in order: chip_smoke.py's --dump prefixes
FD_CHIP_ROWS = {"chip_violators": "violators", "rollout_worst": "worst",
                "articulated_worst": "art_worst", "sweep_worst": "sweep_worst",
                "rollout25_worst": "rollout25_worst"}
# the rows (one QP each) whose outcome is chaotic: the kernel trace also
# runs on FD_ENSEMBLE - 1 copies with every entry moved by -1, 0 or +1 ulp
FD_ENSEMBLE_ROWS = ("rollout_worst", "articulated_worst", "sweep_worst",
                    "rollout25_worst")
FD_ENSEMBLE = 64


def _tree(obj):
    """JAX dataclass / NamedTuple / dict tree -> nested dict of numpy
    arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: _tree(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: _tree(v) for k, v in obj.items()}
    return np.asarray(obj)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# inputs (numpy seeds)
# ---------------------------------------------------------------------------


def worked_example():
    """quadprog++'s documented example: x = [1, 2], f = 12."""
    return dict(G=np.array([[4.0, -2.0], [-2.0, 4.0]]), g=np.array([6.0, 0.0]),
                D=np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
                d=np.array([0.0, 0.0, 2.0]), C=np.array([[1.0, 1.0]]),
                c=np.array([3.0]))


def ineq_problems():
    """tests/test_qp.py::test_random_inequality_qps_vs_scipy, seeds 0-5:
    stacked (G, g, D, d)."""
    out = []
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n, mi = 6, 9
        A = rng.normal(size=(n, n))
        out.append((A @ A.T + n * np.eye(n), rng.normal(size=n) * 2,
                    rng.normal(size=(mi, n)), rng.uniform(-1.0, 0.2, size=mi)))
    return [np.stack(a) for a in zip(*out)]


def eq_problems():
    """tests/test_qp.py::test_random_equality_qps_vs_scipy, seeds 100-102:
    stacked (G, g, D, d, C, c)."""
    out = []
    for seed in range(3):
        rng = np.random.default_rng(seed + 100)
        n, mi, me = 6, 8, 2
        A = rng.normal(size=(n, n))
        G, g = A @ A.T + n * np.eye(n), rng.normal(size=n)
        D, d = rng.normal(size=(mi, n)), rng.uniform(-1.5, -0.5, size=mi)
        C = rng.normal(size=(me, n))
        out.append((G, g, D, d, C, C @ np.zeros(n)))
    return [np.stack(a) for a in zip(*out)]


def balance_noise():
    """tests/test_balance.py's ±2 cm base offsets (numpy seed 7)."""
    return np.random.default_rng(7).uniform(-0.02, 0.02, size=(B_LF, 3)
                                            ).astype(np.float32)


def fd_random_problems():
    """Seeded random positive-definite QPs (G, g, D, d) of the QP-kernel
    tests, 12 variables and 20 rows (numpy seed 0)."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(FD_N_RANDOM, 12, 12))
    G = np.einsum("bij,bik->bjk", M, M) + 3 * np.eye(12)
    g = rng.normal(size=(FD_N_RANDOM, 12))
    D = rng.normal(size=(FD_N_RANDOM, 20, 12))
    d = rng.normal(size=(FD_N_RANDOM, 20)) - 1.0
    return G, g, D, d


def articulated_inputs():
    """Random configurations (for M, h and free flight) and perturbed
    standing states with mixed pins and commands (for a step), float32."""
    from quadruped_locomotion_tpu.rollout import simulator as jsim
    from quadruped_locomotion_tpu.types import RobotModel

    rng = np.random.default_rng(0)
    quat = rng.normal(size=(B_ART, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    base = {"position": rng.normal(size=(B_ART, 3)), "quaternion": quat,
            "linear_velocity": rng.normal(size=(B_ART, 3)),
            "angular_velocity": rng.normal(size=(B_ART, 3))}
    config = {"base": {k: v.astype(np.float32) for k, v in base.items()},
              "q": rng.uniform(-0.8, 0.8, (B_ART, 4, 3)).astype(np.float32),
              "qd": (0.5 * rng.normal(size=(B_ART, 4, 3))).astype(np.float32)}
    stand = _tree(jsim.default_stance_state(RobotModel.simpledog()))

    def batched(t):
        return ({k: batched(v) for k, v in t.items()} if isinstance(t, dict)
                else np.broadcast_to(t, (B_ART,) + t.shape).copy())

    sim = batched(stand)
    r = sim["robot"]
    r["base"]["linear_velocity"] += 0.1 * rng.normal(size=(B_ART, 3)).astype(np.float32)
    r["base"]["angular_velocity"] += 0.2 * rng.normal(size=(B_ART, 3)).astype(np.float32)
    r["qd"] += 0.3 * rng.normal(size=(B_ART, 4, 3)).astype(np.float32)
    r["support"] = ART_SUPPORT.copy()
    tau = (20.0 * rng.normal(size=(B_ART, 4, 3))).astype(np.float32)
    tau[..., 1] -= 30.0
    return {"config": config, "sim": sim, "tau": tau}


# ---------------------------------------------------------------------------
# references (JAX)
# ---------------------------------------------------------------------------


def qp_references() -> dict:
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.ops import qp

    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    w = worked_example()
    we = qp.solve_qp(*(f32(w[k]) for k in "GgDd"), C=f32(w["C"]), c=f32(w["c"]))
    G, g, D, d = map(f32, ineq_problems())
    ineq = jax.vmap(lambda *a: qp.solve_qp(*a, iters=30))(G, g, D, d)
    warm = jax.vmap(lambda G, g, D, d, xw, zw: qp.solve_qp(
        G, g, D, d, iters=8, warm=(xw, zw), polish="light"))(
        G, g, D, d, ineq.x, ineq.z)
    eq = [qp.solve_qp(*(f32(a[i]) for a in eq_problems()[:4]),
                      C=f32(eq_problems()[4][i]), c=f32(eq_problems()[5][i]),
                      iters=30).x for i in range(3)]
    return {"worked/x": we.x, "worked/y": we.y, "ineq/x": ineq.x,
            "ineq/z": ineq.z, "ineq/iterations": ineq.iterations,
            "warm_light/x": warm.x, "eq/x": np.stack(eq)}


def headline_references() -> dict:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import bench
    from quadruped_locomotion_tpu.control import force_distribution as fd
    from quadruped_locomotion_tpu.control.vmc import compute_virtual_wrench
    from quadruped_locomotion_tpu.ops import qp_pallas
    from quadruped_locomotion_tpu.rollout import simulator as simlib
    from quadruped_locomotion_tpu.types import (
        BaseTarget, CfdParams, RobotModel, VmcGains,
    )

    A, b, S, W, D, d = bench.build_batch(TILE)
    x, _, _, kkt = qp_pallas.solve_weighted_ls_fd_qp(
        A, S, b, W, D, d, iters=15, emulate=True)
    out = {f"tile/{k}": v for k, v in zip("AbSWDd", (A, b, S, W, D, d))}
    out.update({"tile/x_emulated": x, "tile/kkt_emulated": kkt})

    model, gains, cfd = RobotModel.simpledog(), VmcGains.gazebo_defaults(), CfdParams.defaults()
    sim = simlib.default_stance_state(model, height=0.4)
    target = BaseTarget.from_base(sim.robot.base)

    def state(n):
        return sim.robot.replace(base=sim.robot.base.replace(
            position=sim.robot.base.position + n))

    def build(n):
        st = state(n)
        return fd.build_qp(model, cfd, st, *compute_virtual_wrench(
            model, gains, st, target))

    noise = jnp.asarray(balance_noise())
    qp_data = jax.jit(jax.vmap(build))(noise)
    out.update({f"balance/{k}": v for k, v in zip("AbSWDd", qp_data)})
    grf, wrench = [], []
    for i in range(B_LF):  # per scenario, as the reference test does
        st = state(noise[i])
        r = fd.distribute(model, cfd, st, *compute_virtual_wrench(
            model, gains, st, target), iters=25,
            load_factors=jnp.asarray(LOAD_FACTORS))
        grf.append(r.ground_reaction)
        wrench.append(r.virtual_wrench_realized)
    out.update({"balance/grf_distribute": np.stack(grf),
                "balance/wrench_distribute": np.stack(wrench)})
    return out


def articulated_references() -> dict:
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.rollout import articulated as art
    from quadruped_locomotion_tpu.rollout import simulator as simlib
    from quadruped_locomotion_tpu.types import BaseState, RobotModel, RobotState

    model = RobotModel.simpledog()
    inp = articulated_inputs()
    c, s = inp["config"], inp["sim"]

    def base(tree, i):
        return BaseState(**{k: jnp.asarray(v[i]) for k, v in tree.items()})

    def sim(i):
        r = s["robot"]
        robot = RobotState(base=base(r["base"], i),
                           **{k: jnp.asarray(v[i]) for k, v in r.items()
                              if k != "base"})
        return simlib.SimState(robot=robot,
                               feet_world=jnp.asarray(s["feet_world"][i]),
                               time=jnp.asarray(s["time"][i]))

    out = {"mass_matrix": [], "bias_forces": [], "free_flight": []}
    steps = {mu: [] for mu in ART_MU}
    for i in range(B_ART):
        q, qd = jnp.asarray(c["q"][i]), jnp.asarray(c["qd"][i])
        out["mass_matrix"].append(art.mass_matrix(model, base(c["base"], i), q))
        out["bias_forces"].append(art.bias_forces(model, base(c["base"], i), q, qd))
        out["free_flight"].append(art.unconstrained_accel(
            model, base(c["base"], i), q, qd, jnp.asarray(inp["tau"][i])))
        for mu in ART_MU:
            steps[mu].append(_flatten(_tree(art.step(
                model, sim(i), jnp.asarray(inp["tau"][i]), 0.0025,
                support=jnp.asarray(ART_SUPPORT_CMD[i]), friction_mu=mu))))
    refs = {k: np.stack(v) for k, v in out.items()}
    for mu, per in steps.items():
        tag = "stick" if mu is None else "slide"
        refs.update({f"step_{tag}/{k}": np.stack([p[k] for p in per])
                     for k in per[0]})
    return refs


def fd_qp_problems() -> dict:
    """(G, g, D, d) float32 over every row, the stance rows' (A, S, b, W),
    and ``rows/<name>`` = [start, stop) for the row groups ``stance``,
    ``random`` and those of ``FD_CHIP_ROWS``."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_qp_pallas import _stance_problems

    A, b, S, W, D, d = (np.asarray(a) for a in _stance_problems())
    with jax.default_matmul_precision("highest"):
        SA = A * S[..., :, None]
        G = 2.0 * jnp.einsum("bij,bik->bjk", A, SA) + jax.vmap(jnp.diag)(W)
        g = -2.0 * jnp.einsum("bij,bi->bj", SA, b)
    groups = [("stance", (G, g, D, d)), ("random", fd_random_problems())]
    with np.load(CHIP_QPS) as chip:
        for name, key in FD_CHIP_ROWS.items():
            rows = [chip[f"{key}_{k}"] for k in ("G", "g", "D", "d")]
            if rows[0].ndim == 2:  # one QP
                rows = [r[None] for r in rows]
            groups.append((name, rows))
    out, start = {}, 0
    for name, rows in groups:
        out[f"rows/{name}"] = np.array([start, start + len(rows[0])])
        start += len(rows[0])
    for i, k in enumerate("GgDd"):
        out[k] = np.concatenate([np.asarray(r[i]) for _, r in groups]
                                ).astype(np.float32)
    out.update(A=A, S=S, b=b, W=W)
    return out


def fd_ulp_ensemble(p: dict) -> dict:
    """(G, g, D, d) of FD_ENSEMBLE - 1 perturbed copies of each row of
    FD_ENSEMBLE_ROWS, in that order: every entry moved by -1, 0 or +1 ulp
    (numpy seed 1)."""
    rng = np.random.default_rng(1)
    out = {k: [] for k in "GgDd"}
    for name in FD_ENSEMBLE_ROWS:
        i = int(p[f"rows/{name}"][0])
        for _ in range(FD_ENSEMBLE - 1):
            for k in "GgDd":
                a = p[k][i]
                step = rng.integers(-1, 2, a.shape)
                toward = np.where(step > 0, np.float32(np.inf), np.float32(-np.inf))
                out[k].append(np.where(step == 0, a, np.nextafter(a, toward)))
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


def fd_qp_references() -> dict:
    """``problems/...`` (:func:`fd_qp_problems`), the JAX kernel trace's and
    the XLA IPM's answers on them, and ``ensemble/<rows>/{x,kkt}``: the
    trace on each row of FD_ENSEMBLE_ROWS (member 0) and on its
    :func:`fd_ulp_ensemble` copies, all in one trace call."""
    import jax

    from quadruped_locomotion_tpu.ops import qp, qp_pallas

    p = fd_qp_problems()
    n = len(p["G"])
    ens = fd_ulp_ensemble(p)
    G, g, D, d = (np.concatenate([p[k], ens[k]]) for k in "GgDd")
    emu = [np.asarray(a) for a in qp_pallas.solve_fd_qp_emulated(
        G, g, D, d, iters=FD_ITERS)]
    xla = jax.jit(jax.vmap(lambda G, g, D, d: qp.solve_qp(
        G, g, D, d, iters=FD_ITERS)))(*(p[k] for k in "GgDd"))
    out = {f"problems/{k}": v for k, v in p.items()}
    out.update({"emulated/x": emu[0][:n], "emulated/kkt": emu[3][:n],
                "xla/x": xla.x})
    for j, name in enumerate(FD_ENSEMBLE_ROWS):
        i = int(p[f"rows/{name}"][0])
        copies = slice(n + j * (FD_ENSEMBLE - 1), n + (j + 1) * (FD_ENSEMBLE - 1))
        for key, a in (("x", emu[0]), ("kkt", emu[3])):
            out[f"ensemble/{name}/{key}"] = np.concatenate([a[i:i + 1],
                                                            a[copies]])
    return out


# ---------------------------------------------------------------------------
# slice 4: terrain, mixed gaits, the sweep's scenarios, the EKF
# ---------------------------------------------------------------------------

TERRAIN_CELLS = 100
TERRAIN_POINTS = 64
GAIT_TICKS = 10
GAIT_BATCHES = (6, 4)  # B = 4: a (B,) leaf against the leg axis broadcasts
GAIT_FLAT_ZONE = (0.3, 0.2)  # small, so the footholds reach the bumps
SWEEP_BATCH = 16
B_EKF = 6
EKF_DT = 0.0025


def terrain_inputs() -> dict:
    """Three maps of one shape: tests/test_terrain.py's ±3 cm bumps and its
    20 cm pit (2 cm cells), and a 0.5 m one-cell spike on 1/16 m cells
    (exact binary-fraction centres) at (0, 0); per-scenario origin and
    resolution. Seeded query points over and beyond the maps, and nominal
    footholds: seeded ones, the pit's centre, and the spike cell's centre
    (its four diagonal neighbours are traversable and equidistant)."""
    n = TERRAIN_CELLS
    rng = np.random.default_rng(3)
    res = np.array([0.02, 0.02, 0.0625], np.float32)
    origin = np.array([[-1.0, -1.0], [-1.0, -1.0], [-3.125, -3.125]],
                      np.float32)
    xs = -1.0 + np.arange(n) * 0.02
    X, Y = np.meshgrid(xs, xs)
    bumps = 0.03 * np.sin(2 * np.pi * X / 0.9) * np.cos(2 * np.pi * Y / 1.1)
    pit = np.zeros((n, n))
    pit[(X - 0.3) ** 2 + Y ** 2 < 0.06 ** 2] = -0.2
    spike = np.zeros((n, n))
    spike[50, 50] = 0.5  # the cell centred on (0, 0)
    height = np.stack([bumps, pit, spike]).astype(np.float32)
    lo, hi = origin - 0.3, origin + (n - 1) * res[:, None] + 0.3
    points = rng.uniform(lo[:, None, :], hi[:, None, :],
                         (3, TERRAIN_POINTS, 2)).astype(np.float32)
    points[:, :4] = np.stack([lo, hi, np.stack([lo[:, 0], hi[:, 1]], -1),
                              origin], 1)  # corners, beyond them, cell (0, 0)
    nominal = np.concatenate([
        rng.uniform(-0.6, 0.6, (3, 4, 2)), np.zeros((3, 4, 1))], -1)
    nominal[1, 0, :2] = [0.3, 0.0]  # on the pit
    nominal[2, 0, :2] = [0.0, 0.0]  # on the spike: a four-way tie
    nominal[2, 1, :2] = [0.0625, 0.0]  # beside it
    nominal = nominal.astype(np.float32)
    hips = nominal + np.array([0.0, 0.0, 0.4], np.float32)
    return {"height": height, "origin": origin, "resolution": res,
            "points": points, "nominal": nominal, "hips": hips}


def terrain_references() -> dict:
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.terrain import heightfield as jh

    inp = terrain_inputs()
    hf = jax.vmap(lambda h, o, r: jh.Heightfield.from_height_array(
        h, origin=o, resolution=r))(*(jnp.asarray(inp[k]) for k in (
            "height", "origin", "resolution")))
    # resolution as a traced value: the normals' 2·res is then float32
    # arithmetic, as the port's per-scenario resolution tensor gives it
    pts = jnp.asarray(inp["points"])
    per_point = lambda f: jax.vmap(lambda m, p: jax.vmap(  # noqa: E731
        lambda q: f(m, q))(p))(hf, pts)
    ix, iy = per_point(lambda m, q: m.cell_index(q))
    out = {f"in/{k}": v for k, v in inp.items()}
    out.update({f"hf/{k}": v for k, v in _tree(hf).items()})
    out.update({
        "height_at": per_point(lambda m, q: m.height_at(q)),
        "normal_at": per_point(lambda m, q: m.normal_at(q)),
        "traversability_at": per_point(lambda m, q: m.traversability_at(q)),
        "cell_ix": ix, "cell_iy": iy,
    })
    nominal, hips = jnp.asarray(inp["nominal"]), jnp.asarray(inp["hips"])
    for tag, fn in (("no_hips", lambda m, n, h: jh.optimize_footholds(m, n)),
                    ("hips", jh.optimize_footholds)):
        f, nrm, found = jax.vmap(fn)(hf, nominal, hips)
        out.update({f"{tag}/footholds": f, f"{tag}/normals": nrm,
                    f"{tag}/found": found})
    return out


def mixed_gait_params(batch: int) -> dict:
    """Per-scenario GaitParams (numpy, the JAX field layout): scenario i
    paces where i % 4 == 3 (bench.py's interleave), then every leaf is
    scaled by a seeded factor in [0.9, 1.1] so that no two scenarios
    share their parameters (vel_cmd_blend in [0.8, 1])."""
    from quadruped_locomotion_tpu.gait.phase import GaitParams

    rng = np.random.default_rng(5)
    trot, pace = _tree(GaitParams.trot_defaults()), _tree(GaitParams.pace_defaults())
    is_pace = np.arange(batch) % 4 == 3
    out = {}
    for k in trot:
        a = np.where(is_pace.reshape((-1,) + (1,) * trot[k].ndim),
                     pace[k], trot[k])
        scale = (rng.uniform(0.8, 1.0, a.shape) if k == "vel_cmd_blend"
                 else rng.uniform(0.9, 1.1, a.shape))
        out[k] = (a * scale).astype(np.float32)
    return out, is_pace


def sweep_heights(batch: int, seed: int, flat_zone) -> dict:
    """bench.build_scenarios' terrain draws (after its velocity draws) with
    the flat spawn box's half-widths set to ``flat_zone``: (B, 48, 48)
    heights, through jax.image.resize as bench.py does."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    for _ in range(6):
        rng.uniform(size=batch)  # vx, vy, wz: both branches each
    coarse = jnp.asarray(rng.normal(size=(batch, 8, 8)), jnp.float32)
    rough = jax.image.resize(coarse, (batch, 48, 48), method="cubic")
    amp = np.where(np.arange(batch) % 4 == 2, 0.0,
                   rng.uniform(0.01, 0.03, batch)).astype(np.float32)
    xs = -2.4 + np.arange(48) * 0.1
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    box = np.maximum(np.abs(gx) / flat_zone[0], np.abs(gy) / flat_zone[1])
    ramp = jnp.asarray(np.clip((box - 1.0) / 0.4, 0.0, 1.0), jnp.float32)
    return np.asarray(rough * amp[:, None, None] * ramp[None])


def perturbed_stance(batch: int, rng) -> dict:
    """``batch`` seeded robot states around the standing start (numpy
    dicts in the SimState layout)."""
    from quadruped_locomotion_tpu.rollout import simulator as jsim
    from quadruped_locomotion_tpu.types import RobotModel

    sim = _tree(jsim.default_stance_state(RobotModel.simpledog()))

    def tile(t):
        return ({k: tile(v) for k, v in t.items()} if isinstance(t, dict)
                else np.broadcast_to(t, (batch,) + t.shape).copy())

    sim = tile(sim)
    base = sim["robot"]["base"]
    yaw = rng.uniform(-0.3, 0.3, batch)
    base["quaternion"] = np.stack([np.cos(yaw / 2), np.zeros(batch),
                                   np.zeros(batch), np.sin(yaw / 2)],
                                  -1).astype(np.float32)
    base["position"] = (base["position"] + rng.uniform(
        -0.02, 0.02, (batch, 3))).astype(np.float32)
    base["linear_velocity"] = rng.normal(0, 0.1, (batch, 3)).astype(np.float32)
    base["angular_velocity"] = rng.normal(0, 0.1, (batch, 3)).astype(np.float32)
    sim["robot"]["q"] = (sim["robot"]["q"] + rng.normal(
        0, 0.03, (batch, 4, 3))).astype(np.float32)
    sim["robot"]["qd"] = rng.normal(0, 0.5, (batch, 4, 3)).astype(np.float32)
    sim["feet_world"] = (sim["feet_world"] + rng.normal(
        0, 0.01, (batch, 4, 3))).astype(np.float32)
    return sim


def gait_references(batch: int) -> dict:
    """GAIT_TICKS ticks of the JAX gait engine over ``batch`` perturbed
    states (held fixed, as tests/test_torch_gait_sim.py does) with
    per-scenario maps (the sweep's generator, GAIT_FLAT_ZONE) and
    per-scenario GaitParams, from the mixed trot/pace init."""
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.gait import gait_generator as jgg
    from quadruped_locomotion_tpu.gait import phase as jphase
    from quadruped_locomotion_tpu.gait.phase import GaitParams
    from quadruped_locomotion_tpu.terrain.heightfield import Heightfield
    from quadruped_locomotion_tpu.types import BaseState, RobotModel, RobotState

    rng = np.random.default_rng(10 + batch)
    model = RobotModel.simpledog()
    gp_np, is_pace = mixed_gait_params(batch)
    gp = GaitParams(**{k: jnp.asarray(v) for k, v in gp_np.items()})
    sim = perturbed_stance(batch, rng)
    lin = np.stack([rng.uniform(-0.1, 0.4, batch), rng.uniform(-0.1, 0.1, batch),
                    np.zeros(batch)], -1).astype(np.float32)
    wz = rng.uniform(-0.3, 0.3, batch).astype(np.float32)
    height = sweep_heights(batch, 20 + batch, GAIT_FLAT_ZONE)
    hf = jax.vmap(lambda h: Heightfield.from_height_array(
        h, origin=(-2.4, -2.4), resolution=0.1))(jnp.asarray(height))

    r = sim["robot"]
    robot = RobotState(
        base=BaseState(**{k: jnp.asarray(v) for k, v in r["base"].items()}),
        **{k: jnp.asarray(v) for k, v in r.items() if k != "base"})
    feet = jnp.asarray(sim["feet_world"])

    def init(g, f, pace):
        trot_s = jgg.init_gait_state(jphase.TROT, g, f)
        pace_s = jgg.init_gait_state(jphase.PACE, g, f)
        return jax.tree_util.tree_map(lambda a, b: jnp.where(pace, b, a),
                                      trot_s, pace_s)

    gait = jax.vmap(init)(gp, feet, jnp.asarray(is_pace))
    adv = jax.jit(jax.vmap(lambda g, r, f, v, w, p, t: jgg.advance(
        model, g, r, f, p, v, w, 0.01, terrain=t)))
    out = {"in/gait_params/" + k: v for k, v in gp_np.items()}
    out.update({"in/is_pace": is_pace, "in/lin": lin, "in/wz": wz,
                "in/height": height})
    out.update(_flatten(sim, "in/sim/"))
    out.update(_flatten(_tree(gait), "gait0/"))
    ticks = []
    for _ in range(GAIT_TICKS):
        gait, sup, sw, tgt, nrm = adv(gait, robot, feet, jnp.asarray(lin),
                                      jnp.asarray(wz), gp, hf)
        ticks.append({"support": sup, "pos": sw[0], "vel": sw[1],
                      "acc": sw[2], "target": _tree(tgt), "normals": nrm,
                      "swing_targets": gait.swing_targets,
                      "base_ref_pos": gait.base_ref_pos})
    for k in ticks[0]:
        if isinstance(ticks[0][k], dict):
            for f in ticks[0][k]:
                out[f"tick/{k}/{f}"] = np.stack([np.asarray(t[k][f])
                                                 for t in ticks])
        else:
            out[f"tick/{k}"] = np.stack([np.asarray(t[k]) for t in ticks])
    return out


def gait_b6_references() -> dict:
    return gait_references(GAIT_BATCHES[0])


def gait_b4_references() -> dict:
    return gait_references(GAIT_BATCHES[1])


def sweep_references() -> dict:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import bench

    ls, cmd, gp, hf, axes = bench.build_scenarios(SWEEP_BATCH)
    coarse = np.random.default_rng(7).normal(size=(SWEEP_BATCH, 8, 8)
                                             ).astype(np.float32)
    out = _flatten({"ls0": _tree(ls), "cmd": _tree(cmd),
                    "gait_params": _tree(gp), "terrain": _tree(hf)})
    out.update({"resize/coarse": coarse, "resize/fine": jax.image.resize(
        jnp.asarray(coarse), (SWEEP_BATCH, 48, 48), method="cubic"),
        "axes": np.asarray(axes)})
    return out


def ekf_inputs() -> dict:
    """B_EKF seeded filter states and sensor samples: perturbed stance
    poses, feet near their FK positions, a covariance grown by random
    factors, mixed contacts, a short recorded base trajectory."""
    rng = np.random.default_rng(11)
    sim = perturbed_stance(B_EKF, rng)
    base = sim["robot"]["base"]
    M = rng.normal(size=(B_EKF, 21, 21)) * 0.01
    P = np.einsum("bij,bkj->bik", M, M) + np.eye(21) * 1e-4
    contact = rng.random((B_EKF, 4)) < 0.7
    contact[0] = True
    T = 7
    t = np.arange(T)[:, None] * EKF_DT
    traj_pos = (base["position"][None] + np.sin(
        3.0 * t[..., None] + rng.uniform(0, 1, (1, B_EKF, 3))) * 0.02)
    ang = rng.normal(0, 0.2, (1, B_EKF, 3)) * t[..., None] + rng.normal(
        0, 0.05, (1, B_EKF, 3))
    half = np.linalg.norm(ang, axis=-1, keepdims=True) / 2
    quat = np.concatenate([np.cos(half), np.sin(half) * ang / np.maximum(
        2 * half, 1e-12)], -1)
    return {
        "position": base["position"],
        "velocity": base["linear_velocity"],
        "quaternion": base["quaternion"],
        "foot_positions": (sim["feet_world"] + rng.normal(
            0, 0.005, (B_EKF, 4, 3))).astype(np.float32),
        "covariance": P.astype(np.float32),
        "gyro": rng.normal(0, 0.3, (B_EKF, 3)).astype(np.float32),
        "accel": (np.array([0.0, 0.0, 9.8]) + rng.normal(
            0, 0.5, (B_EKF, 3))).astype(np.float32),
        "q": sim["robot"]["q"],
        "contact": contact,
        "traj_pos": traj_pos.astype(np.float32),
        "traj_quat": quat.astype(np.float32),
    }


def ekf_references() -> dict:
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.control import state_estimator as se
    from quadruped_locomotion_tpu.types import RobotModel

    inp = ekf_inputs()
    model, params = RobotModel.simpledog(), se.EstimatorParams.defaults()
    est = se.EstimatorState(**{k: jnp.asarray(inp[k]) for k in (
        "position", "velocity", "quaternion", "foot_positions", "covariance")})
    pred = jax.vmap(lambda e, g, a, c: se.predict(params, e, g, a, c, EKF_DT))(
        est, *(jnp.asarray(inp[k]) for k in ("gyro", "accel", "contact")))
    upd = jax.vmap(lambda e, q, c: se.update(model, params, e, q, c))(
        est, jnp.asarray(inp["q"]), jnp.asarray(inp["contact"]))
    gyro, accel = jax.vmap(lambda q, p: se.synthesize_imu(q, p, EKF_DT),
                           in_axes=1, out_axes=1)(
        jnp.asarray(inp["traj_quat"]), jnp.asarray(inp["traj_pos"]))
    out = {f"in/{k}": v for k, v in inp.items()}
    out.update(_flatten(_tree(pred), "predict/"))
    out.update(_flatten(_tree(upd), "update/"))
    out.update({"imu/gyro": gyro, "imu/accel": accel})
    return out


# ---------------------------------------------------------------------------
# slice 5: scripted motion (footstep profiles, the joint PID, the support
# polygon, the BaseAuto pose cascade, YAML -> StepSchedule, the executor)
# ---------------------------------------------------------------------------

SCRIPTS_DIR = os.path.join(ROOT, "quadruped_locomotion_tpu", "api",
                           "motion_scripts")
SCRIPT_NAMES = tuple(sorted(os.path.splitext(f)[0]
                            for f in os.listdir(SCRIPTS_DIR)
                            if f.endswith(".yaml")))
STANCE_HEIGHT = 0.4  # preview_schedule's default stance
FOOT_SHAPE = (6, 4)  # footstep legs: rows of the four profiles
PID_BATCH = 5
PID_DT = 0.0025
SUPPORT_POINTS = 8
# inline scripts for what no bundled script uses: tests/test_actions.py's
# base_trajectory and end_effector_trajectory, and one with the square and
# trapezoid profiles and a custom_command hold
INLINE_SCRIPTS = {
    "inline_base_trajectory": """
adapt_coordinates:
  - transform:
      source_frame: base_link
steps:
  - step:
      - base_trajectory:
          trajectory:
            knots:
              - {time: 1.2, position: [0.0, 0.0, -0.04], orientation: [0.0, 0.0, 0.15]}
              - {time: 2.4, position: [0.0, 0.0, 0.0], orientation: [0.0, 0.0, 0.0]}
""",
    "inline_ee_trajectory": """
adapt_coordinates:
  - transform:
      source_frame: foot_print
steps:
  - step:
      - base_auto:
          height: 0.4
  - step:
      - base_auto:
          height: 0.4
      - leg_mode:
          name: LF_LEG
          support_leg: true
          ignore_for_pose_adaptation: true
          duration: 0.1
  - step:
      - end_effector_trajectory:
          name: LF_LEG
          ignore_contact: true
          ignore_for_pose_adaptation: true
          trajectory:
            knots:
              - {time: 0.8, position: [0.40, 0.25, 0.15]}
              - {time: 1.6, position: [0.50, 0.25, 0.10]}
""",
    "inline_profiles": """
adapt_coordinates:
  - transform:
      source_frame: foot_print
steps:
  - step:
      - base_auto: {height: 0.4, support_margin: 0.0}
      - footstep:
          name: LF_LEG
          profile_type: square
          profile_height: 0.06
          average_velocity: 0.4
          target: {position: [0.46, 0.175, 0.0]}
  - step:
      - base_target:
          ignore_timing_of_leg_motion: true
          target: {position: [0.0, 0.0, 0.38], orientation: [0.0, 0.0, 0.0, 1.0]}
      - footstep:
          name: RH_LEG
          profile_type: trapezoid
          profile_height: 0.07
          average_velocity: 0.5
          target: {position: [-0.36, -0.175, 0.0]}
  - step:
      - custom_command: {duration: 0.4, command: hold}
""",
}
PREVIEW_SCRIPTS = SCRIPT_NAMES + tuple(INLINE_SCRIPTS)
# scripts whose executor inputs and outputs are recorded around their step
# switches and the end of the schedule
ADVANCE_SCRIPTS = ("trot_test", "change_to_spot", "end_effectors_target_demo",
                   "inline_base_trajectory", "inline_ee_trajectory",
                   "inline_profiles")
ADVANCE_AFTER_END = 5  # calls recorded after the schedule's end


def script_source(name: str) -> str:
    """A bundled script's path or an inline script's text."""
    if name in INLINE_SCRIPTS:
        return INLINE_SCRIPTS[name]
    return os.path.join(SCRIPTS_DIR, name + ".yaml")


def footstep_inputs() -> dict:
    """Seeded swing starts and targets on FOOT_SHAPE legs, each row of
    four legs taking the four profiles; the last row steps in place
    (zero path length: the minimum-duration stretch of a zero total)."""
    rng = np.random.default_rng(21)
    start = rng.uniform(-0.5, 0.5, FOOT_SHAPE + (3,))
    start[..., 2] = rng.uniform(-0.05, 0.05, FOOT_SHAPE)
    target = start + rng.uniform(-0.25, 0.25, FOOT_SHAPE + (3,))
    target[..., 2] = rng.uniform(-0.05, 0.05, FOOT_SHAPE)
    target[-1] = start[-1]
    return {"start": start.astype(np.float32),
            "target": target.astype(np.float32),
            "profile": (np.arange(np.prod(FOOT_SHAPE)).reshape(FOOT_SHAPE)
                        % 4).astype(np.int32),
            "height": rng.uniform(0.03, 0.15, FOOT_SHAPE).astype(np.float32),
            "avg_velocity": rng.uniform(0.1, 1.2, FOOT_SHAPE).astype(np.float32),
            "t": rng.uniform(-0.1, 1.5, FOOT_SHAPE).astype(np.float32)}


def pid_inputs() -> dict:
    """PID_BATCH seeded robot states and joint targets; the last
    instance's integral sits at the windup clamp (±1000 for ki = 0.01)."""
    rng = np.random.default_rng(22)
    quat = rng.normal(size=(PID_BATCH, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    q = rng.uniform(-1.0, 1.0, (PID_BATCH, 4, 3))
    integral = rng.normal(0, 0.01, (PID_BATCH, 4, 3))
    integral[-1] = np.sign(rng.normal(size=(4, 3))) * 999.9999
    return {k: v.astype(np.float32) for k, v in {
        "quaternion": quat, "q": q, "qd": rng.normal(0, 1.0, q.shape),
        "q_des": q + rng.normal(0, 0.2, q.shape),
        "qd_des": rng.normal(0, 0.5, q.shape), "integral": integral}.items()}


def support_inputs() -> dict:
    """Every support set of four legs over the stance feet and over feet
    moved by up to 8 cm, margins 0 and 0.04 alternately, and seeded query
    points."""
    rng = np.random.default_rng(23)
    hips = np.array([[0.4, 0.175], [0.4, -0.175], [-0.4, -0.175],
                     [-0.4, 0.175]])
    feet = np.stack([hips, hips + rng.uniform(-0.08, 0.08, (4, 2))])
    sets = np.array([[(k >> leg) & 1 for leg in range(4)] for k in range(16)],
                    bool)
    n = 2 * len(sets)
    return {"feet": np.repeat(feet, len(sets), 0).astype(np.float32),
            "support": np.tile(sets, (2, 1)),
            "margin": np.where(np.arange(n) % 2 == 0, 0.0, 0.04
                               ).astype(np.float32),
            "points": rng.uniform(-0.6, 0.6, (n, SUPPORT_POINTS, 2)
                                  ).astype(np.float32)}


def stance_feet(dx=0.0, dy=0.0) -> np.ndarray:
    """tests/test_pose_optimization.py's symmetric_feet: the hips' xy on
    the ground, shifted by (dx, dy)."""
    feet = np.array([[0.4, 0.175, 0.0], [0.4, -0.175, 0.0],
                     [-0.4, -0.175, 0.0], [-0.4, 0.175, 0.0]])
    feet[:, 0] += dx
    feet[:, 1] += dy
    return feet.astype(np.float32)


def pose_cases() -> dict:
    """optimize_pose inputs: ``qp`` (the QP pose passes the check),
    ``sqp`` (a 0.55 m stance over-extends the limbs: the SQP runs), both
    with the default polygon and limb sets, and ``steps``:
    change_to_spot's RH fold step as ``steps._enter_step`` passes it (the
    polygon of the three legs that keep support, margin 0.04, the limb
    sets of both stances)."""
    feet = stance_feet()
    keep = np.array([True, True, False, True])
    return {
        "qp": {"feet": stance_feet(0.05, 0.02), "support": np.ones(4, bool),
               "height": np.float32(0.4), "margin": np.float32(0.0)},
        "sqp": {"feet": feet, "support": np.ones(4, bool),
                "height": np.float32(0.55), "margin": np.float32(0.0)},
        "steps": {"feet": feet, "support": np.ones(4, bool),
                  "height": np.float32(0.25), "margin": np.float32(0.04),
                  "polygon_feet": feet, "polygon_support": keep,
                  "limb_feet": np.concatenate([feet, feet]),
                  "limb_support": np.ones(8, bool)},
    }


def footstep_references() -> dict:
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.gait.footstep import swing_trajectory

    inp = footstep_inputs()
    flat = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:]))
            for k, v in inp.items()}
    sp = jax.vmap(lambda s, t, p, h, v: swing_trajectory(
        s, t, profile=p, profile_height=h, average_velocity=v))(
        flat["start"], flat["target"], flat["profile"], flat["height"],
        flat["avg_velocity"])
    ev = {k: jax.vmap(lambda s, t, f=k: getattr(s, f)(t))(sp, flat["t"])
          for k in ("evaluate", "velocity", "acceleration")}
    out = {f"in/{k}": v for k, v in inp.items()}
    out.update({f"spline/{k}": np.asarray(v).reshape(FOOT_SHAPE + v.shape[1:])
                for k, v in _tree(sp).items()})
    out.update({f"eval/{k}": np.asarray(v).reshape(FOOT_SHAPE + v.shape[1:])
                for k, v in ev.items()})
    return out


def pid_references() -> dict:
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.control.swing import joint_pid_gravity_torques
    from quadruped_locomotion_tpu.types import RobotModel, RobotState

    inp = pid_inputs()
    model = RobotModel.simpledog()

    def one(quat, q, qd, q_des, qd_des, integral):
        neutral = RobotState.neutral()
        st = neutral.replace(base=neutral.base.replace(quaternion=quat),
                             q=q, qd=qd)
        return joint_pid_gravity_torques(model, st, q_des, qd_des, integral,
                                         PID_DT)

    tau, integral = jax.vmap(one)(*(jnp.asarray(inp[k]) for k in (
        "quaternion", "q", "qd", "q_des", "qd_des", "integral")))
    out = {f"in/{k}": v for k, v in inp.items()}
    out.update({"tau": tau, "integral": integral})
    return out


def support_references() -> dict:
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.terrain import support_polygon as sp

    inp = support_inputs()
    normals, offsets = jax.vmap(sp.support_halfspaces)(
        jnp.asarray(inp["feet"]), jnp.asarray(inp["support"]),
        jnp.asarray(inp["margin"]))
    pts = jnp.asarray(inp["points"])
    per_point = lambda f: jax.vmap(lambda n, o, p: jax.vmap(  # noqa: E731
        lambda x: f(n, o, x))(p))(normals, offsets, pts)
    out = {f"in/{k}": v for k, v in inp.items()}
    out.update({"normals": normals, "offsets": offsets,
                "inside": per_point(sp.point_inside),
                "inside_tol": per_point(lambda n, o, x: sp.point_inside(
                    n, o, x, tol=1e-3)),
                "violation": per_point(sp.violation)})
    return out


def pose_references() -> dict:
    """Per case: the geometric pose, the QP pose and its check, the final
    pose and status of optimize_pose; ``batch/``: jax.vmap of
    optimize_pose over the ``qp`` and ``sqp`` cases (both branches run,
    selected per instance)."""
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.planning import pose_optimization as po
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    out = {}
    for name, case in pose_cases().items():
        c = {k: jnp.asarray(v) for k, v in case.items()}
        kw = {k: c[k] for k in ("polygon_feet", "polygon_support",
                                "limb_feet", "limb_support") if k in c}
        nominal = po.default_nominal_stance(model, c["height"])
        geo = po.geometric_pose(c["feet"], c["support"], nominal)
        pq = po.pose_qp(model, geo, c["feet"], c["support"], nominal,
                        margin=c["margin"],
                        polygon_feet=kw.get("polygon_feet"),
                        polygon_support=kw.get("polygon_support"))
        ok = po.check_pose(model, pq, c["feet"], c["support"], **kw)
        pose, status = jax.jit(lambda c, kw: po.optimize_pose(
            model, c["feet"], c["support"], height=c["height"],
            margin=c["margin"], return_status=True, **kw))(c, kw)
        out.update({f"{name}/in/{k}": np.asarray(v) for k, v in case.items()})
        out.update({f"{name}/geometric/{k}": v for k, v in _tree(geo).items()})
        out.update({f"{name}/qp/{k}": v for k, v in _tree(pq).items()})
        out.update({f"{name}/qp_ok": ok, f"{name}/status": status})
        out.update({f"{name}/pose/{k}": v for k, v in _tree(pose).items()})
    cases = pose_cases()
    stack = lambda k: jnp.asarray(np.stack(  # noqa: E731
        [cases["qp"][k], cases["sqp"][k]]))
    poses, status = jax.jit(jax.vmap(lambda f, s, h: po.optimize_pose(
        model, f, s, height=h, return_status=True)))(
        stack("feet"), stack("support"), stack("height"))
    out.update({f"batch/pose/{k}": v for k, v in _tree(poses).items()})
    out["batch/status"] = status
    return out


def _stance(height=STANCE_HEIGHT):
    from quadruped_locomotion_tpu.rollout import simulator as simlib
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    return model, simlib.default_stance_state(model, height=height)


def compile_script(name: str, sim):
    from quadruped_locomotion_tpu.api.actions import load_action

    return load_action(script_source(name), sim.robot.base.position,
                       sim.robot.base.quaternion, sim.feet_world)


def schedule_references() -> dict:
    """Every bundled script (and the inline ones) through the JAX
    load_action against the default stance."""
    _, sim = _stance()
    out = {"stance/base_position": sim.robot.base.position,
           "stance/base_quaternion": sim.robot.base.quaternion,
           "stance/feet_world": sim.feet_world}
    for name in PREVIEW_SCRIPTS:
        out.update({f"{name}/{k}": v for k, v in
                    _tree(compile_script(name, sim)).items()})
    return out


def preview_ticks(model, sched, sim, ticks: int):
    """The JAX batch_preview's tick, run one call at a time: yields
    (inputs of steps.advance, its ExecState and outputs) per tick, the
    kinematic plant's update done as batch_preview does it."""
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.model.kinematics import (
        forward_kinematics, inverse_kinematics,
    )
    from quadruped_locomotion_tpu.planning import steps
    from quadruped_locomotion_tpu.utils.rotations import (
        quat_inv_rotate, quat_normalize, quat_rotate,
    )

    adv = jax.jit(lambda es, f, p, q, dt, qn, act: steps.advance(
        model, sched, es, f, p, q, dt, q_now=qn, active_steps=act))
    feet, bpos, bquat = (sim.feet_world, sim.robot.base.position,
                         sim.robot.base.quaternion)
    es = steps.init_exec_state(feet, bpos, bquat)
    q_now = sim.robot.q
    for _ in range(ticks):
        inp = dict(es=es, feet=feet, bpos=bpos, bquat=bquat, q_now=q_now)
        es2, out = adv(es, feet, bpos, bquat, 0.01, q_now, sched.num_steps)
        yield inp, es2, out
        feet2 = jnp.where(out.support[:, None], feet, out.foot_pos)
        bpos, bquat = out.base.position, quat_normalize(out.base.quaternion)
        q4 = jnp.broadcast_to(bquat, (4, 4))
        q = inverse_kinematics(model, quat_inv_rotate(q4, feet2 - bpos))
        q = jnp.where(out.joint_mode[:, None], out.q_des, q)
        fk = bpos + quat_rotate(q4, forward_kinematics(model, q))
        feet = jnp.where(out.joint_mode[:, None], fk, feet2)
        es, q_now = es2, q


def advance_references() -> dict:
    """steps.advance on the executor states of ADVANCE_SCRIPTS' previews
    (q_now: the previous tick's joints): at call 0 (the first entry), at
    every step switch and the call before it, mid-step, at the call that
    ends the schedule and five calls later; ``<name>/calls`` lists them
    and every recorded field stacks them on its leading axis. At the
    first switch of trot_test also ``trot_test/extra/``: a pause tick
    (dt = 0) and a schedule cut to one live step (active_steps = 1, so
    the switch becomes the end)."""
    import jax

    from quadruped_locomotion_tpu.planning import steps

    def record(rows):
        trees = [_flatten(_tree({"in": i, "es": e, "out": o}))
                 for i, e, o in rows]
        return {k: np.stack([t[k] for t in trees]) for k in trees[0]}

    model, sim = _stance()
    out = {}
    for name in ADVANCE_SCRIPTS:
        sched = compile_script(name, sim)
        recs = []
        for rec in preview_ticks(model, sched, sim, sched.num_steps * 400):
            recs.append(rec)
            if (len(recs) > ADVANCE_AFTER_END
                    and bool(recs[-1 - ADVANCE_AFTER_END][1].done)):
                break
        ticks = len(recs)
        idx = np.array([int(r[1].step_index) for r in recs])
        done = np.array([bool(r[1].done) for r in recs])
        end = int(np.argmax(done))
        switches = [n for n in range(1, end) if idx[n] != idx[n - 1]]
        calls = {0, end - 1, end, min(end + ADVANCE_AFTER_END, ticks - 1)}
        for j, n in enumerate(switches):
            calls.update({n - 1, n, (n + (switches + [end])[j + 1]) // 2})
        calls = sorted(calls)
        out[f"{name}/calls"] = np.array(calls)
        out.update({f"{name}/{k}": v for k, v in
                    record([recs[n] for n in calls]).items()})
        if name == "trot_test":
            inp = recs[switches[0] if switches else end][0]
            rows, dts, acts = [], [], []
            for dt, act in ((0.0, sched.num_steps), (0.01, 1)):
                es2, o = jax.jit(lambda es, f, p, q, qn, dt=dt, act=act:
                                 steps.advance(model, sched, es, f, p, q, dt,
                                               q_now=qn, active_steps=act))(
                    inp["es"], inp["feet"], inp["bpos"], inp["bquat"],
                    inp["q_now"])
                rows.append((inp, es2, o))
                dts.append(dt)
                acts.append(act)
            out.update({f"{name}/extra/{k}": v
                        for k, v in record(rows).items()})
            out[f"{name}/extra/dt"] = np.array(dts, np.float32)
            out[f"{name}/extra/active_steps"] = np.array(acts, np.int32)
    return out


# ---------------------------------------------------------------------------
# slice 6: the runtime (balance tick, single-leg and freeze controllers,
# the standing manager loop on the massless plant)
# ---------------------------------------------------------------------------

RT_TICKS = 400  # tests/test_runtime.py's standing run: 1 s at 400 Hz
RT_BALANCE_TICKS = (0, 1, 5, 50, 399)  # samples balance_update is held on
RT_HOLD_TICKS = (50, 51, 52, 53)  # samples the single-leg / freeze torques
RT_LEG_OFFSET = np.array([0.05, 0.0, 0.05], np.float32)  # LF's task target


def runtime_references() -> dict:
    """``standing/``: the JAX ``ControllerManager`` + ``SimHardware`` +
    ``BalanceStandController`` from the 0.4 m stance for RT_TICKS ticks:
    each tick's sample (read at its start), commanded torques and the
    controller's warm (x, z) after it, and the final sample.
    ``balance/<tick>/``: ``balance_update`` on that tick's sample (cold,
    15 iterations, full polish, on tick 0; warm from the previous tick's
    (x, z), 8 iterations, light polish, on the others): the VMC wrench,
    the formed problem, the QP's x, z and KKT, and the torques.
    ``single_leg/``, ``freeze/``: those controllers started on the sample
    of tick RT_HOLD_TICKS[0] (single leg: LF toward its start foot
    position + RT_LEG_OFFSET) and updated on the RT_HOLD_TICKS samples."""
    import jax

    from quadruped_locomotion_tpu.control import force_distribution as fd
    from quadruped_locomotion_tpu.control.balance_controller import balance_update
    from quadruped_locomotion_tpu.control.vmc import compute_virtual_wrench
    from quadruped_locomotion_tpu.model.kinematics import forward_kinematics
    from quadruped_locomotion_tpu.runtime import hal, manager as mgr
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    hw = hal.SimHardware(model, height=0.4)
    m = mgr.ControllerManager(hw, model)
    bal = mgr.BalanceStandController(model)
    m.register(bal)
    m.switch(bal.name)
    rec = {k: [] for k in ("samples", "tau", "warm_x", "warm_z")}
    for _ in range(RT_TICKS):
        sample = m.tick()
        rec["samples"].append(sample.pack())
        rec["tau"].append(np.asarray(m._last_tau, np.float32))
        rec["warm_x"].append(np.asarray(bal._warm[0]))
        rec["warm_z"].append(np.asarray(bal._warm[1]))
    out = {f"standing/{k}": np.stack(v) for k, v in rec.items()}
    out["standing/final"] = hw.read_packed()
    out.update({f"standing/target/{k}": v
                for k, v in _flatten(_tree(bal._target)).items()})

    @jax.jit
    def tick(vec, warm_x, warm_z, cold):
        state = mgr._robot_state_from_vec(vec)
        vf, vt = compute_virtual_wrench(model, bal.gains, state, bal._target)
        problem = fd.build_qp(model, bal.cfd, state, vf, vt)
        def solve(warm, iters, polish):
            return balance_update(model, bal.gains, bal.cfd, state,
                                  bal._target, qp_iters=iters, warm=warm,
                                  polish=polish)
        tau, diag = jax.lax.cond(
            cold, lambda: solve(None, 15, "full"),
            lambda: solve((warm_x, warm_z), 8, "light"))
        sol = diag.distribution.qp_solution
        return dict(vf=vf, vt=vt, A=problem[0], b=problem[1], S=problem[2],
                    W=problem[3], D=problem[4], d=problem[5], x=sol.x,
                    z=sol.z, kkt=sol.kkt_error, tau=tau)

    samples = out["standing/samples"]
    for t in RT_BALANCE_TICKS:
        prev = max(t - 1, 0)
        res = tick(samples[t], out["standing/warm_x"][prev],
                   out["standing/warm_z"][prev], t == 0)
        out.update({f"balance/{t}/{k}": np.asarray(v) for k, v in res.items()})

    start = hal.RobotSample.unpack(samples[RT_HOLD_TICKS[0]])
    leg = mgr.SingleLegController(model, legs=(0,))
    leg.start(start)
    p_des = np.asarray(forward_kinematics(model, start.q)).copy()
    p_des[0] += RT_LEG_OFFSET
    leg.set_targets(p_des)
    frz = mgr.FreezeController(model)
    frz.start(start)
    for name, ctrl in (("single_leg", leg), ("freeze", frz)):
        out[f"{name}/tau"] = np.stack([
            ctrl.update(hal.RobotSample.unpack(samples[t]))
            for t in RT_HOLD_TICKS])
    out["single_leg/p_des"] = p_des
    return out


# --------------------------------------------------------------------------
# slice 7: the operator API's messages and the reference functions that
# had no counterpart
# --------------------------------------------------------------------------


def slice7_goals(msgs) -> dict:
    """The goals the slice-7 references compile, built with ``msgs``
    (either package's ``api/messages.py``: the dataclasses are the same):
    tests/test_messages.py's two goals, tests/test_action_server.py's
    footstep and base_auto goals, and tests/test_marker.py's foothold and
    knot-trajectory goals."""
    def footsteps(n_steps, preempt=msgs.PREEMPT_STEP, dx=0.06):
        steps, legs = [], ["LF_LEG", "RF_LEG"]
        x0 = {"LF_LEG": 0.42, "RF_LEG": 0.42}
        y = {"LF_LEG": 0.25, "RF_LEG": -0.25}
        for i in range(n_steps):
            leg = legs[i % 2]
            x0[leg] += dx
            steps.append(msgs.StepMsg(
                footsteps=[msgs.FootstepMsg(name=leg,
                                            target=(x0[leg], y[leg], 0.0))],
                base_auto=msgs.BaseAutoMsg(height=0.4)))
        return msgs.ExecuteStepsGoal(steps=steps, preempt=preempt,
                                     source_frame="foot_print")

    message_goal = msgs.ExecuteStepsGoal(source_frame="foot_print", steps=[
        msgs.StepMsg(base_auto=msgs.BaseAutoMsg(height=0.38),
                     footsteps=[msgs.FootstepMsg(
                         name="LF_LEG", target=(0.48, 0.175, 0.0),
                         profile_height=0.10, average_velocity=0.15)]),
        msgs.StepMsg(base_target=msgs.BaseTargetMsg(
            position=(0.0, 0.0, 0.0), orientation_rpy=(0.0, 0.0, 0.3),
            frame="base_link"))])
    full = msgs.ExecuteStepsGoal(source_frame="foot_print", steps=[
        msgs.StepMsg(
            footsteps=[msgs.FootstepMsg(
                name="LF_LEG", target=(0.48, 0.175, 0.0),
                surface_normal=(0.0, 0.1, 0.9),
                ignore_for_pose_adaptation=True)],
            base_auto=msgs.BaseAutoMsg(height=0.38, support_margin=0.06,
                                       ignore_timing_of_leg_motion=True)),
        msgs.StepMsg(
            end_effector_targets=[msgs.EndEffectorTargetMsg(
                name="RF_LEG", target_position=(0.45, -0.2, 0.05),
                average_velocity=0.2, ignore_contact=True)],
            base_target=msgs.BaseTargetMsg(
                position=(0.0, 0.0, 0.0), orientation_rpy=(0.0, 0.0, 0.2),
                frame="base_link")),
        msgs.StepMsg(end_effector_trajectories=[msgs.EndEffectorTrajectoryMsg(
            name="RH_LEG", knots=[
                msgs.TrajectoryKnotMsg(time=0.4, position=(-0.4, -0.18, 0.06)),
                msgs.TrajectoryKnotMsg(time=0.8, position=(-0.36, -0.18, 0.0))],
            ignore_contact=True)]),
        msgs.StepMsg(
            joint_trajectories=[msgs.JointTrajectoryMsg(
                name="LH_LEG", knots=[msgs.JointKnotMsg(
                    time=0.5, positions=(0.1, 0.7, -1.4))],
                ignore_contact=True)],
            custom_commands=[msgs.CustomCommandMsg(
                type="hold", duration=1.5, command="{}")]),
        msgs.StepMsg(joint_targets=[msgs.JointTargetMsg(
            name="LH_LEG", positions=(0.0, 0.8, -1.5), duration=0.6,
            ignore_contact=True)]),
        msgs.StepMsg(
            leg_modes=[msgs.LegModeMsg(name="LH_LEG", support_leg=True,
                                       duration=0.4,
                                       surface_normal=(0.0, 0.0, 1.0))],
            base_trajectory=msgs.BaseTrajectoryMsg(
                knots=[msgs.TrajectoryKnotMsg(
                    time=1.0, position=(0.02, 0.0, 0.40),
                    orientation_rpy=(0.0, 0.0, 0.1))],
                frame="foot_print"))])
    knots = [msgs.TrajectoryKnotMsg(time=t, position=p) for t, p in (
        (0.3, (0.44, 0.175, 0.06)), (0.6, (0.47, 0.165, 0.09)),
        (0.9, (0.49, 0.195, 0.0)))]
    return {
        "message": message_goal,
        "full": full,
        "footstep2": footsteps(2),
        "footstep3": footsteps(3),
        "footstep2_immediate": footsteps(2, msgs.PREEMPT_IMMEDIATE),
        "footstep2_no": footsteps(2, msgs.PREEMPT_NO),
        "footstep1_append": footsteps(1, dx=0.05),
        "base_auto": msgs.ExecuteStepsGoal(
            steps=[msgs.StepMsg(base_auto=msgs.BaseAutoMsg(height=0.38))],
            source_frame="foot_print"),
        "marker_foothold": msgs.ExecuteStepsGoal(steps=[msgs.StepMsg(
            footsteps=[msgs.FootstepMsg(name="LF_LEG",
                                        target=(0.50, 0.21, 0.0))],
            base_auto=msgs.BaseAutoMsg(height=0.4))]),
        "marker_trajectory": msgs.ExecuteStepsGoal(steps=[msgs.StepMsg(
            end_effector_trajectories=[msgs.EndEffectorTrajectoryMsg(
                name="LF_LEG", knots=knots)],
            base_auto=msgs.BaseAutoMsg(height=0.4))]),
    }


def slice7_messages(msgs) -> dict:
    """Feedback, result and robot-state messages, besides the goals."""
    return {
        "feedback": msgs.ExecuteStepsFeedback(
            step_id="step_3", step_number=3, number_of_steps_in_goal=4,
            queue_size=2, status=msgs.PROGRESS_PAUSED, description="x",
            duration=0.5071719288825989, phase=0.25,
            active_branches=["LF_LEG", "base"]),
        "result": msgs.ExecuteStepsResult(status=msgs.RESULT_PREEMPTED,
                                          goal_id=7),
    }


MESSAGE_HEIGHTS = (0.38, 0.4)  # stances the goals compile against
STATE_SUPPORT = np.array([True, True, False, True])
STATE_PHASES = (0.0, 0.0, 0.5, 0.0)


def messages_references() -> dict:
    """``json/<name>``: ``to_json`` of every goal and message (and of the
    0.4 m stance's ``robot_state_from_sim``); ``<height>/<goal>/``:
    ``goal_to_schedule`` of each goal against the default stance at that
    height; ``<height>/<goal>/doc``: the YAML-shaped document, as JSON
    (the JAX function builds it inline; the tests compare the port's
    ``goal_to_doc``)."""
    import json

    import quadruped_locomotion_tpu.api.messages as msgs
    from quadruped_locomotion_tpu.api import actions

    out = {}
    goals = slice7_goals(msgs)
    for name, m in {**goals, **slice7_messages(msgs)}.items():
        out[f"json/{name}"] = np.asarray(msgs.to_json(m))
    for h in MESSAGE_HEIGHTS:
        _, sim = _stance(h)
        out[f"json/robot_state_{h}"] = np.asarray(msgs.to_json(
            msgs.robot_state_from_sim(sim, STATE_SUPPORT, STATE_PHASES)))
        captured = {}
        real = actions.build_schedule

        def spy(doc, *a, **k):
            captured["doc"] = doc
            return real(doc, *a, **k)

        actions.build_schedule = spy
        try:
            for name, goal in goals.items():
                sched = msgs.goal_to_schedule(
                    goal, sim.robot.base.position, sim.robot.base.quaternion,
                    sim.feet_world)
                out.update({f"{h}/{name}/{k}": v
                            for k, v in _tree(sched).items()})
                out[f"{h}/{name}/doc"] = np.asarray(
                    json.dumps(captured["doc"]))
        finally:
            actions.build_schedule = real
    return out


def item6_inputs() -> dict:
    """Seeded inputs of the reference functions that had no counterpart."""
    rng = np.random.default_rng(7)
    n = 6
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-np.pi, np.pi, n)
    q1 = rng.normal(size=(n, 4))
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 = rng.normal(size=(n, 4))
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    # rotation matrices whose Shepperd branch differs: random ones and
    # rotations by ~pi about x, y, z (trace < 0, each diagonal largest)
    rots = [_rot_from_quat(q) for q in q1]
    for ax in np.eye(3):
        rots.append(_rot_from_quat(np.concatenate([[0.05], 0.99 * ax])))
    spd = {}
    for k in (6, 12, 18):
        a = rng.normal(size=(4, k, k))
        spd[f"A{k}"] = a @ np.swapaxes(a, -1, -2) + k * np.eye(k)
        spd[f"b{k}"] = rng.normal(size=(4, k))
    return {
        "axis": axis, "angle": angle, "q1": q1, "q2": q2,
        "rot": np.stack(rots),
        "q": rng.uniform(-0.6, 0.6, (n, 4, 3)) + np.array([0.0, 0.7, -1.4]),
        "qd": rng.normal(scale=0.5, size=(n, 4, 3)),
        "qdd": rng.normal(scale=2.0, size=(n, 4, 3)),
        "tau": rng.normal(scale=10.0, size=(n, 4, 3)),
        "v_feet": rng.normal(scale=0.3, size=(n, 4, 3)),
        "gravity": np.stack([_rot_from_quat(q).T @ np.array([0, 0, -9.8])
                             for q in q2]),
        "support": rng.random((n, 4)) < 0.6,
        "contact": rng.random((n, 4)) < 0.5,
        "swing_phase": rng.uniform(0.0, 0.5, (n, 4)),
        "t_swing": np.asarray(0.45),
        "feet": np.concatenate([rng.uniform(-0.6, 0.6, (n, 4, 2)),
                                rng.uniform(-0.02, 0.1, (n, 4, 1))], -1),
        "nominal_xy": rng.uniform(-0.7, 0.7, (n, 2)),
        "hips": np.concatenate([rng.uniform(-0.7, 0.7, (n, 2)),
                                np.full((n, 1), 0.4)], -1),
        **spd,
    }


def _rot_from_quat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


ITEM6_MAP = 48  # cells per side of the foothold map
ROLLOUT_TEL = (2, 2)  # scenarios, planner ticks of rollout(telemetry_fn=)


def item6_references() -> dict:
    """The JAX functions on :func:`item6_inputs`: the rotations, the leg
    dynamics per leg, the differential IK, ``optimize_foothold`` on a
    seeded bump map (with and without the hip reach check),
    ``foot_heights`` over that map, the stateless ``contact_fsm``,
    ``spd_solve`` at n = 6, 12, 18, and the batched massless
    ``rollout(telemetry_fn=)`` (``qp_backend="xla"``) of ROLLOUT_TEL trot
    scenarios recording each substep's torques and formed QP."""
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.control.contact_fsm import contact_fsm
    from quadruped_locomotion_tpu.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu.gait.phase import GaitParams
    from quadruped_locomotion_tpu.model import dynamics, kinematics
    from quadruped_locomotion_tpu.ops.linalgn import spd_solve
    from quadruped_locomotion_tpu.rollout import closed_loop as cl
    from quadruped_locomotion_tpu.rollout import simulator as simlib
    from quadruped_locomotion_tpu.terrain.heightfield import (
        Heightfield, optimize_foothold,
    )
    from quadruped_locomotion_tpu.types import RobotModel
    from quadruped_locomotion_tpu.utils import rotations as rot

    x = item6_inputs()
    f32 = {k: jnp.asarray(v, jnp.float32) if v.dtype.kind == "f" else
           jnp.asarray(v) for k, v in x.items()}
    model = RobotModel.simpledog()
    out = {f"inputs/{k}": v for k, v in x.items()}
    out["quat_identity"] = rot.quat_identity()
    out["quat_from_matrix"] = rot.quat_from_matrix(f32["rot"])
    out["quat_from_axis_angle"] = rot.quat_from_axis_angle(f32["axis"],
                                                           f32["angle"])
    out["quat_boxminus"] = rot.quat_boxminus(f32["q1"], f32["q2"])
    out["inverse_dynamics"] = jax.vmap(
        lambda q, qd, qdd, g: dynamics.inverse_dynamics(model, q, qd, qdd, g))(
        f32["q"], f32["qd"], f32["qdd"], f32["gravity"])
    out["leg_forward_dynamics"] = jnp.stack([jax.vmap(
        lambda q, qd, t, g: dynamics.leg_forward_dynamics(
            model, q[leg], qd[leg], t[leg], g, leg))(
        f32["q"], f32["qd"], f32["tau"], f32["gravity"])
        for leg in range(4)], axis=1)
    out["joint_velocities_from_foot_velocities"] = jax.vmap(
        lambda q, v: kinematics.joint_velocities_from_foot_velocities(
            model, q, v))(f32["q"], f32["v_feet"])
    rng = np.random.default_rng(11)
    height = (0.03 * rng.standard_normal((ITEM6_MAP, ITEM6_MAP))
              ).astype(np.float32)
    height[20:30, 10:20] += 0.15  # a box the search must step around
    out["map/height"] = height
    hf = Heightfield.from_height_array(jnp.asarray(height), origin=(-1.0, -1.0),
                                       resolution=0.04)
    for name, hips in (("no_reach", None), ("reach", f32["hips"])):
        fh, nrm, found = jax.vmap(lambda xy, h: optimize_foothold(
            hf, xy, h), in_axes=(0, None if hips is None else 0))(
            f32["nominal_xy"], hips)
        out.update({f"optimize_foothold/{name}/foothold": fh,
                    f"optimize_foothold/{name}/normal": nrm,
                    f"optimize_foothold/{name}/found": found})
    sim = simlib.default_stance_state(model, height=0.4)
    heights = []
    for feet in f32["feet"]:
        s = sim.replace(feet_world=feet)
        heights.append(jnp.stack([simlib.foot_heights(s),
                                  simlib.foot_heights(s, jax.vmap(hf.height_at))]))
    out["foot_heights"] = jnp.stack(heights)
    fsm = jax.vmap(lambda d, c, p: contact_fsm(d, c, p, f32["t_swing"]))(
        f32["support"], f32["contact"], f32["swing_phase"])
    out.update({f"contact_fsm/{k}": v for k, v in _tree(fsm).items()})
    for k in (6, 12, 18):
        out[f"spd_solve/{k}"] = spd_solve(f32[f"A{k}"], f32[f"b{k}"])

    batch, ticks = ROLLOUT_TEL
    params = ControllerParams.defaults()
    gp = GaitParams.trot_defaults()
    ls0 = jax.vmap(lambda _: cl.init_locomotion(model, gp))(jnp.arange(batch))
    cmd = cl.Command(
        linear_velocity=jnp.asarray([[0.2, 0.0, 0.0], [0.1, 0.05, 0.0]],
                                    jnp.float32),
        yaw_rate=jnp.asarray([0.0, 0.2], jnp.float32))

    def telemetry_fn(state, tau, diag, ctx):
        return {"tau": tau, "grf": diag.distribution.ground_reaction,
                "support": state.support, "G": ctx.G, "g": ctx.g,
                "D": ctx.D, "d": ctx.d}

    _, tel = jax.jit(lambda ls: cl.rollout(
        model, params, gp, ls, cmd, ticks, telemetry_fn=telemetry_fn,
        plant="massless", batched=True, qp_backend="xla"))(ls0)
    out.update({f"rollout_telemetry/{k}": v for k, v in
                _flatten(_tree(tel)).items()})
    out.update({f"rollout_telemetry/ls0/{k}": v
                for k, v in _flatten(_tree(ls0)).items()})
    out["rollout_telemetry/cmd/linear_velocity"] = cmd.linear_velocity
    out["rollout_telemetry/cmd/yaw_rate"] = cmd.yaw_rate
    return {k: np.asarray(v) for k, v in out.items()}


RING_CAPACITY = 5
RING_SAMPLES = 8


def logging_references() -> dict:
    """``utils/logging.py``'s ring: RING_SAMPLES seeded samples of a
    two-leaf tree recorded into a RING_CAPACITY log (under jit), then
    captured; and the same log after only three samples."""
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.utils import logging as qlog

    rng = np.random.default_rng(5)
    samples = {"tau": rng.normal(size=(RING_SAMPLES, 4, 3)).astype(np.float32),
               "step": np.arange(RING_SAMPLES, dtype=np.int32) * 3}
    out = {f"samples/{k}": v for k, v in samples.items()}
    first = {k: jnp.asarray(v[0]) for k, v in samples.items()}
    rec = jax.jit(qlog.record)
    for n in (3, RING_SAMPLES):
        log = qlog.ring_log(first, capacity=RING_CAPACITY)
        for i in range(n):
            log = rec(log, {k: jnp.asarray(v[i]) for k, v in samples.items()})
        cap = qlog.capture(log)
        out.update({f"capture_{n}/{k}": np.asarray(v) for k, v in cap.items()})
        out[f"capture_{n}/cursor"] = np.asarray(log.cursor)
        out[f"capture_{n}/total"] = np.asarray(log.total)
    return out


# --------------------------------------------------------------------------
# slice 8: the parallel layer
# --------------------------------------------------------------------------

PAR_DEVICES = 8  # the JAX mesh: tests/conftest.py's virtual CPU devices
PAR_B = 16  # the sweep's, the balance rollout's and the closed loop's batch
PAR_KERNEL_B = 64  # the kernel trace's batch (tests/test_parallel.py's)
PAR_STEPS = 3  # balance-rollout steps
PAR_TICKS = 3  # closed-loop planner ticks
PAR_TARGET_NOISE = 0.02  # m, the balance rollout's target displacement


def graft_commands(batch: int, seed: int = 0) -> dict:
    """``__graft_entry__.py``'s closed-loop commands: vx in [-0.1, 0.3],
    vy in ±0.1, yaw rate in ±0.2 rad/s from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    lin = np.stack([rng.uniform(-0.1, 0.3, batch),
                    rng.uniform(-0.1, 0.1, batch), np.zeros(batch)], axis=1)
    return {"linear_velocity": lin.astype(np.float32),
            "yaw_rate": rng.uniform(-0.2, 0.2, batch).astype(np.float32)}


def parallel_references() -> dict:
    """``inputs/``: the sweep's and the kernel's problems, the balance
    rollout's start and targets, the closed loop's start and commands;
    the JAX package's sharded outputs on them (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import bench
    from quadruped_locomotion_tpu.gait.phase import GaitParams
    from quadruped_locomotion_tpu.ops import qp_pallas
    from quadruped_locomotion_tpu.parallel import distributed as dist
    from quadruped_locomotion_tpu.parallel import mesh as pmesh
    from quadruped_locomotion_tpu.rollout import closed_loop as cl
    from quadruped_locomotion_tpu.rollout import simulator as simlib
    from quadruped_locomotion_tpu.types import BaseTarget, RobotModel

    mesh = pmesh.make_mesh(PAR_DEVICES)
    tile = lambda t, n: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.broadcast_to(x, (n,) + x.shape), t)
    out = {}

    prob = bench.build_batch(PAR_B)
    out.update({f"inputs/sweep/{k}": v for k, v in zip("AbSWDd", prob)})
    sweep = dist.make_sharded_qp_sweep(mesh, iters=FD_ITERS)
    sol, kkt, err = sweep(*dist.shard_problem(mesh, prob))
    out.update({"sweep/x": sol.x, "sweep/kkt": sol.kkt_error,
                "sweep/global_kkt": kkt, "sweep/global_err": err})

    A, b, S, W, D, d = bench.build_batch(PAR_KERNEL_B)
    out.update({f"inputs/kernel/{k}": v
                for k, v in zip("AbSWDd", (A, b, S, W, D, d))})
    x, _, _, kkt = qp_pallas.solve_weighted_ls_fd_qp(
        A, S, b, W, D, d, iters=FD_ITERS, emulate=True)
    out.update({"kernel/x": x, "kernel/kkt": kkt})

    model = RobotModel.simpledog()
    sims = tile(simlib.default_stance_state(model, height=0.4), PAR_B)
    targets = BaseTarget.from_base(sims.robot.base)
    noise = np.random.default_rng(8).uniform(
        -PAR_TARGET_NOISE, PAR_TARGET_NOISE, (PAR_B, 3)).astype(np.float32)
    targets = targets.replace(position=targets.position + noise)
    out.update({f"inputs/sims/{k}": v for k, v in _flatten(_tree(sims)).items()})
    out.update({f"inputs/targets/{k}": v
                for k, v in _flatten(_tree(targets)).items()})
    roll = pmesh.make_sharded_rollout(mesh, steps=PAR_STEPS)
    final, err, kkt = roll(pmesh.shard_batch(mesh, sims),
                           pmesh.shard_batch(mesh, targets))
    out.update({f"rollout/final/{k}": v
                for k, v in _flatten(_tree(final)).items()})
    out.update({"rollout/err": err, "rollout/kkt": kkt})

    ls0 = tile(cl.init_locomotion(model, GaitParams.trot_defaults()), PAR_B)
    cmds = cl.Command(**{k: jnp.asarray(v)
                         for k, v in graft_commands(PAR_B).items()})
    out.update({f"inputs/ls0/{k}": v for k, v in _flatten(_tree(ls0)).items()})
    out.update({f"inputs/cmd/{k}": v for k, v in _flatten(_tree(cmds)).items()})
    loco = pmesh.make_sharded_locomotion_rollout(mesh, PAR_TICKS,
                                                 qp_backend="xla")
    final, kkt, upright = loco(pmesh.shard_batch(mesh, ls0),
                               pmesh.shard_batch(mesh, cmds))
    out.update({f"loco/final/{k}": v
                for k, v in _flatten(_tree(final)).items()})
    out.update({"loco/kkt": kkt, "loco/upright": upright})
    return {k: np.asarray(v) for k, v in out.items()}


SECTIONS = {"qp": qp_references, "headline": headline_references,
            "articulated": articulated_references,
            "fd_qp": fd_qp_references, "terrain": terrain_references,
            "gait_b6": gait_b6_references, "gait_b4": gait_b4_references,
            "sweep": sweep_references, "ekf": ekf_references,
            "footstep": footstep_references, "pid": pid_references,
            "support": support_references, "pose": pose_references,
            "schedule": schedule_references, "advance": advance_references,
            "runtime": runtime_references,
            "messages": messages_references, "item6": item6_references,
            "logging": logging_references, "parallel": parallel_references}
FILES = {"slice2": (DEFAULT_OUT, ("qp", "headline", "articulated")),
         "fd_qp": (FD_QP_OUT, ("fd_qp",)),
         "slice4": (SLICE4_OUT, ("terrain", "gait_b6", "gait_b4", "sweep",
                                 "ekf")),
         "slice5": (SLICE5_OUT, ("footstep", "pid", "support", "pose",
                                 "schedule", "advance")),
         "slice6": (SLICE6_OUT, ("runtime",)),
         "slice7": (SLICE7_OUT, ("messages", "item6", "logging")),
         "slice8": (SLICE8_OUT, ("parallel",))}


def make_references(sections) -> dict:
    out = {}
    for name in sections:
        out.update({f"{name}/{k}": np.asarray(v)
                    for k, v in SECTIONS[name]().items()})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--file", default="all", choices=(*FILES, "all"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    # the slice-8 mesh: tests/conftest.py's virtual devices (set before JAX
    # starts; no other section depends on the device count)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={PAR_DEVICES}")
    for name, (path, sections) in FILES.items():
        if args.file not in (name, "all"):
            continue
        refs = make_references(sections)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **refs)
        print(f"wrote {path}: {len(refs)} arrays, "
              f"{os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
