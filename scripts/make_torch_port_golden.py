"""Write the JAX reference rollouts that the PyTorch port is held against.

Runs one of ``quadruped_locomotion_tpu``'s closed loops on the CPU and
saves its inputs and its per-tick telemetry to one compressed ``.npz``.
Keys are ``/``-joined field paths, e.g. ``ls0/sim/robot/base/position``
or ``tel/qp_kkt``. ``--path``:

* ``flat`` (default): the batched closed loop (``rollout(batched=True,
  plant=..., qp_backend="xla", terrain=None)``) over B trot scenarios
  whose velocity commands come from a seeded numpy generator. Defaults:
  the massless plant, B = 8, 25 ticks, written to
  ``tests/data/torch_port_rollout_golden.npz``; with ``--plant
  articulated``, B = 2, 10 ticks, written to
  ``tests/data/torch_port_articulated_golden.npz``.
* ``sweep``: bench.py's config-5 scenarios (per-scenario heightfields,
  the trot/pace mix, per-scenario commands; ``bench.build_scenarios``'
  draws) with the flat spawn box shrunk to just cover the stance feet,
  through the batched closed loop with ``terrain_batched`` and
  ``gait_params_batched``, articulated plant: B = 8, 20 ticks, written to
  ``tests/data/torch_port_sweep_golden.npz``.
* ``estimated``: ``rollout_estimated`` with ideal sensors (every noise
  and bias zero), articulated plant, vmapped over B = 3 trot scenarios
  with seeded commands, 10 ticks, written to
  ``tests/data/torch_port_estimated_golden.npz``.
* ``preview``: the kinematic preview (``preview_schedule``) of every
  bundled motion script and the inline ones of
  ``make_torch_port_references.py``, up to ten ticks past each one's end,
  written to ``tests/data/torch_port_preview_golden.npz``.
* ``script``: the closed loop of scripted motion over SCRIPT_WINDOWS
  (standup from tick 0, trot_test and change_to_spot windows) with the
  ``ScriptState`` at each window's start, written to
  ``tests/data/torch_port_script_golden.npz``.
* ``server``: the JAX action server (``FreeGaitActionServer``) run to
  each of SERVER_WINDOWS' snapshots (goal completion, a mid-run append
  from a feedback callback with paused ticks, the three stop modes, limb
  configure, the continuous trot's re-send) and SERVER_TICKS ticks after
  it; and the JAX ``ActionLoader`` sending the bundled python, combined
  and launch actions (LOADER_ACTIONS) to fresh servers; written to
  ``tests/data/torch_port_server_golden.npz``.
* ``console``: the JAX console's ``trot`` and ``pace`` (CONSOLE_SECONDS),
  ``edit --script`` and ``update``, written to
  ``tests/data/torch_port_console_golden.npz``.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden.py \
        [--path flat|sweep|estimated|preview|script|server|console] \
        [--plant massless|articulated] [--out PATH] [--batch B] \
        [--ticks T] [--seed 0]

Each run compiles its rollout on XLA:CPU: a few minutes (the
articulated plant longer).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
# plant -> (default output, batch, ticks)
DEFAULTS = {
    "massless": (os.path.join(DATA, "torch_port_rollout_golden.npz"), 8, 25),
    "articulated": (os.path.join(DATA, "torch_port_articulated_golden.npz"),
                    2, 10),
}
# --path sweep / estimated -> (default output, batch, ticks)
PATH_DEFAULTS = {
    "preview": (os.path.join(DATA, "torch_port_preview_golden.npz"), None,
                None),
    "script": (os.path.join(DATA, "torch_port_script_golden.npz"), None,
               None),
    "server": (os.path.join(DATA, "torch_port_server_golden.npz"), None,
               None),
    "console": (os.path.join(DATA, "torch_port_console_golden.npz"), None,
                None),
    "sweep": (os.path.join(DATA, "torch_port_sweep_golden.npz"), 8, 20),
    "estimated": (os.path.join(DATA, "torch_port_estimated_golden.npz"),
                  3, 10),
}
# the sweep golden's flat spawn box (half-widths x, y): the stance feet
# stand at (±0.4, ±0.175), so within 20 ticks the footholds and swing feet
# reach the bumps; bench.py's box is (0.65, 0.45)
SWEEP_GOLDEN_FLAT_ZONE = (0.45, 0.2)


def jax_to_numpy(obj):
    """JAX dataclass / NamedTuple tree -> nested dict of numpy arrays,
    keyed by field name (the layout ``quadruped_locomotion_tpu_torch.
    convert`` reads)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: jax_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: jax_to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: jax_to_numpy(v) for k, v in obj.items()}
    return np.asarray(obj)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def trot_commands(batch: int, seed: int):
    """Per-scenario trot commands over bench.py's trot ranges:
    vx in [-0.1, 0.4], vy in +-0.1, yaw rate in +-0.3 rad/s."""
    rng = np.random.default_rng(seed)
    vx = rng.uniform(-0.1, 0.4, batch)
    vy = rng.uniform(-0.1, 0.1, batch)
    wz = rng.uniform(-0.3, 0.3, batch)
    lin = np.stack([vx, vy, np.zeros(batch)], axis=1).astype(np.float32)
    return lin, wz.astype(np.float32)


def make_golden(batch: int = 8, ticks: int = 25, seed: int = 0,
                plant: str = "massless") -> dict:
    """Run the JAX reference and return the flat ``{key: array}`` dict."""
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu.gait.phase import GaitParams
    from quadruped_locomotion_tpu.rollout import closed_loop as cl
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    params = ControllerParams.defaults()
    gp = GaitParams.trot_defaults()
    ls_one = cl.init_locomotion(model, gp)
    ls0 = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape), ls_one
    )
    lin, wz = trot_commands(batch, seed)
    cmd = cl.Command(linear_velocity=jnp.asarray(lin),
                     yaw_rate=jnp.asarray(wz))

    run = jax.jit(
        lambda ls, c: cl.rollout(
            model, params, gp, ls, c, ticks, batched=True,
            plant=plant, qp_backend="xla", terrain=None,
        )
    )
    _, tel = run(ls0, cmd)
    tree = {
        "model": jax_to_numpy(model),
        "params": jax_to_numpy(params),
        "gait_params": jax_to_numpy(gp),
        "ls0": jax_to_numpy(ls0),
        "cmd": {"linear_velocity": lin, "yaw_rate": wz},
        "tel": jax_to_numpy(tel),
        "meta": {"batch": np.asarray(batch), "ticks": np.asarray(ticks),
                 "seed": np.asarray(seed), "plant": np.asarray(plant)},
    }
    return flatten(tree)


def make_sweep_golden(batch: int = 8, ticks: int = 20, seed: int = 0) -> dict:
    """bench.build_scenarios' scenarios with SWEEP_GOLDEN_FLAT_ZONE through
    the JAX batched closed loop (articulated plant, XLA QP)."""
    import jax
    import jax.numpy as jnp

    import bench
    from make_torch_port_references import sweep_heights
    from quadruped_locomotion_tpu.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu.rollout import closed_loop as cl
    from quadruped_locomotion_tpu.terrain.heightfield import Heightfield
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    params = ControllerParams.defaults()
    ls0, cmd, gp, _, _ = bench.build_scenarios(batch, seed)
    height = sweep_heights(batch, seed, SWEEP_GOLDEN_FLAT_ZONE)
    hf = jax.vmap(lambda h: Heightfield.from_height_array(
        h, origin=(-2.4, -2.4), resolution=0.1))(jnp.asarray(height))
    run = jax.jit(lambda ls: cl.rollout(
        model, params, gp, ls, cmd, ticks, batched=True,
        plant="articulated", qp_backend="xla", terrain=hf,
        terrain_batched=True, gait_params_batched=True))
    _, tel = run(ls0)
    return flatten({
        "model": jax_to_numpy(model), "params": jax_to_numpy(params),
        "gait_params": jax_to_numpy(gp), "ls0": jax_to_numpy(ls0),
        "cmd": jax_to_numpy(cmd), "terrain": jax_to_numpy(hf),
        "tel": jax_to_numpy(tel),
        "meta": {"batch": np.asarray(batch), "ticks": np.asarray(ticks),
                 "seed": np.asarray(seed),
                 "flat_zone": np.asarray(SWEEP_GOLDEN_FLAT_ZONE)},
    })


def make_estimated_golden(batch: int = 3, ticks: int = 10,
                          seed: int = 0) -> dict:
    """rollout_estimated with ideal sensors, vmapped over ``batch`` trot
    scenarios with commands from :func:`trot_commands`."""
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.control import state_estimator as se
    from quadruped_locomotion_tpu.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu.gait.phase import GaitParams
    from quadruped_locomotion_tpu.rollout import estimated_loop as el
    from quadruped_locomotion_tpu.rollout.closed_loop import Command
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    params = ControllerParams.defaults()
    gp = GaitParams.trot_defaults()
    ep = se.EstimatorParams.defaults()
    sensors = el.SensorParams.ideal()
    els0 = jax.vmap(lambda k: el.init_estimated(model, gp, k))(
        jax.random.split(jax.random.PRNGKey(seed), batch))
    lin, wz = trot_commands(batch, seed)
    cmd = Command(linear_velocity=jnp.asarray(lin), yaw_rate=jnp.asarray(wz))
    run = jax.jit(jax.vmap(lambda els, c: el.rollout_estimated(
        model, params, gp, ep, sensors, els, c, ticks)))
    _, tel = run(els0, cmd)
    # per scenario (B, T, ...) -> per tick (T, B, ...), as the port's
    tel = {k: np.swapaxes(np.asarray(v), 0, 1) for k, v in tel.items()}
    return flatten({
        "model": jax_to_numpy(model), "params": jax_to_numpy(params),
        "gait_params": jax_to_numpy(gp), "est_params": jax_to_numpy(ep),
        "loop0": jax_to_numpy(els0.loop), "est0": jax_to_numpy(els0.est),
        "cmd": {"linear_velocity": lin, "yaw_rate": wz}, "tel": tel,
        "meta": {"batch": np.asarray(batch), "ticks": np.asarray(ticks),
                 "seed": np.asarray(seed)},
    })


PREVIEW_MARGIN = 10  # ticks kept past each script's done tick
# Standup's base roll rate grows ~10x per tick from any asymmetry
# (ROADMAP §3): from the exact stance, each float32 run seeds it with its
# own rounding and two runs part by ~1e-3 m. Its window therefore starts
# with LF's hip abduction moved by this many radians, a seed both runs
# share: two XLA compilations then agree within 1.3e-6 m over 60 ticks.
STANDUP_SEED = 1e-5
# the closed-loop windows: script -> (stance height, start tick, ticks)
SCRIPT_WINDOWS = {
    # from the standing start (seeded, see STANDUP_SEED): the base rises
    # 0.38 -> 0.45 m (35 ticks) and settles
    "standup": (0.38, 0, 120),
    # the first footstep pair's touchdown and the second pair's lift-off
    # (the step switch at tick 30): the FSM's reflexes and the triangle
    # footstep
    "trot_test": (0.4, 24, 20),
    # the RH fold: RH under joint-space PID control (ticks ~84-185 of the
    # kinematic preview)
    "change_to_spot": (0.4, 120, 20),
}


def make_preview_golden() -> dict:
    """Every bundled motion script (and the inline ones of
    ``make_torch_port_references.INLINE_SCRIPTS``) compiled against the
    default 0.4 m stance and previewed by the JAX ``preview_schedule``
    for ``4 s x steps`` of planner ticks; each script's StateBatch is kept
    up to PREVIEW_MARGIN ticks past its first done tick
    (``<name>/done_tick``: ticks until done, counted from 1)."""
    import jax

    import make_torch_port_references as refs
    from quadruped_locomotion_tpu.rollout import preview as pv

    model, sim = refs._stance()
    out = {"meta/margin": np.asarray(PREVIEW_MARGIN),
           "meta/height": np.asarray(refs.STANCE_HEIGHT)}
    for name in refs.PREVIEW_SCRIPTS:
        sched = refs.compile_script(name, sim)
        ticks = sched.num_steps * 400
        batch = jax.jit(lambda: pv.preview_schedule(
            model, sched, height=refs.STANCE_HEIGHT, planner_ticks=ticks))()
        done = np.asarray(batch.done)
        if not done.any():
            raise RuntimeError(f"{name}: the preview never ends")
        done_tick = int(np.argmax(done)) + 1
        keep = min(done_tick + PREVIEW_MARGIN, ticks)
        for k, v in jax_to_numpy(batch).items():
            out[f"{name}/{k}"] = v[:keep]
        out[f"{name}/done_tick"] = np.asarray(done_tick)
        print(f"{name}: done at tick {done_tick}", flush=True)
    return out


def make_script_golden() -> dict:
    """The JAX closed-loop scripted motion (``script_loop.planner_tick``,
    massless plant, generic QP) over the SCRIPT_WINDOWS: the
    ``ScriptState`` at the window's start tick (``<name>/ss0/...``) and,
    per tick of the window, ``run_schedule``'s telemetry plus the
    executor's desired support and joint mode (``steps.advance`` on the
    tick's starting state, as planner_tick calls it). Standup starts
    from the stance with LF's hip abduction moved by STANDUP_SEED."""
    import jax
    import jax.numpy as jnp

    import make_torch_port_references as refs
    from quadruped_locomotion_tpu.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu.planning import steps
    from quadruped_locomotion_tpu.rollout import script_loop as sl
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    params = ControllerParams.defaults()
    out = {}
    for name, (height, start, ticks) in SCRIPT_WINDOWS.items():
        ss = sl.init_script_state(model, None, height=height)
        sched = refs.compile_script(name, ss.sim)
        if name == "standup":
            q = ss.sim.robot.q.at[0, 0].add(STANDUP_SEED)
            ss = ss.replace(sim=ss.sim.replace(robot=ss.sim.robot.replace(q=q)))
            out[f"{name}/meta/seed_lf_haa"] = np.asarray(STANDUP_SEED)
        tick = jax.jit(lambda ss: sl.planner_tick(model, params, sched, ss))
        adv = jax.jit(lambda ss: steps.advance(
            model, sched, ss.exec, ss.sim.feet_world,
            ss.sim.robot.base.position, ss.sim.robot.base.quaternion,
            0.01, q_now=ss.sim.robot.q)[1])
        for _ in range(start):
            ss, _ = tick(ss)
        out.update(flatten(jax_to_numpy(ss), f"{name}/ss0/"))
        out.update(flatten(jax_to_numpy(sched), f"{name}/sched/"))
        tel = {k: [] for k in ("base_position", "base_quaternion",
                               "feet_world", "joint_positions", "step_index",
                               "done", "qp_kkt", "support", "joint_mode")}
        for _ in range(ticks):
            o = adv(ss)
            ss, kkt = tick(ss)
            for k, v in (("base_position", ss.sim.robot.base.position),
                         ("base_quaternion", ss.sim.robot.base.quaternion),
                         ("feet_world", ss.sim.feet_world),
                         ("joint_positions", ss.sim.robot.q),
                         ("step_index", ss.exec.step_index),
                         ("done", ss.exec.done), ("qp_kkt", kkt),
                         ("support", o.support),
                         ("joint_mode", o.joint_mode)):
                tel[k].append(np.asarray(v))
        out.update({f"{name}/tel/{k}": np.stack(v) for k, v in tel.items()})
        out.update({f"{name}/meta/height": np.asarray(height),
                    f"{name}/meta/start": np.asarray(start),
                    f"{name}/meta/ticks": np.asarray(ticks)})
        print(f"{name}: ticks {start}-{start + ticks}, final z "
              f"{float(ss.sim.robot.base.position[2]):.4f}", flush=True)
    return out


# --------------------------------------------------------------------------
# --path server: JAX action-server snapshots and the ticks after each
# --------------------------------------------------------------------------

SERVER_CAPACITY = 12  # tests/test_action_server.py's buffer
SERVER_TICKS = 20  # ticks recorded after each snapshot
BRANCHES = ("LF_LEG", "RF_LEG", "RH_LEG", "LH_LEG", "base")
FEEDBACK_INTS = ("step_number", "number_of_steps_in_goal", "queue_size",
                 "status")
# window -> (events before tick i: {i: [op, ...]}, what it covers). Ops:
# "append" (goal footstep1_append submitted from the first goal's next
# feedback callback), "pause", "resume", "stop", "limb:<configure>".
SERVER_WINDOWS = {
    # a footstep goal 9 ticks before it completes; its first feedback
    # appends a second goal, ticks 1-3 are paused: the completion lands
    # on tick 11 and the appended goal runs after it
    "append_pause": ({0: ["append"], 1: ["pause"], 4: ["resume"]},
                     "mid-run append, pause and resume, goal completion"),
    # the same goal 2 ticks before it completes, nothing appended
    "complete": ({}, "goal completion, then the idle executor"),
    # a 3-step PREEMPT_STEP goal with LF's swing airborne in step 0
    "stop_step": ({0: ["stop"]}, "stop, PREEMPT_STEP"),
    # 60 ticks into a PREEMPT_IMMEDIATE / PREEMPT_NO goal
    "stop_immediate": ({0: ["stop"]}, "stop, PREEMPT_IMMEDIATE"),
    "stop_no": ({0: ["stop"]}, "stop, PREEMPT_NO"),
    # 20 ticks into a base_auto goal: an unknown string, then '>>'
    "limb": ({0: ["limb:??", "limb:>>"]}, "set_limb_configure"),
    # the continuous trot 2 ticks before its trigger re-sends a goal
    "trot": ({}, "the continuous trot's feedback-driven re-send"),
}


def server_snapshot(srv, to_numpy) -> dict:
    """A server's state, flat keys as ``FreeGaitActionServer.from_snapshot``
    reads them (``to_numpy`` maps the package's state structs to nested
    numpy dicts)."""
    goals = srv._goals
    out = {"active": np.asarray(srv._active), "ticks": np.asarray(srv.ticks),
           "paused": np.asarray(srv.paused),
           "preemption_type": np.asarray(srv.preemption_type),
           "next_goal_id": np.asarray(srv._next_goal_id),
           "goals/goal_id": np.asarray([g.goal_id for g in goals], np.int64),
           "goals/first_row": np.asarray([g.first_row for g in goals],
                                         np.int64),
           "goals/n_steps": np.asarray([g.n_steps for g in goals], np.int64),
           "goals/done": np.asarray([g.done for g in goals], bool),
           "goals/result_status": np.asarray(
               [-1 if g.result is None else g.result.status for g in goals],
               np.int64)}
    out.update(flatten(to_numpy(srv.state), "state/"))
    out.update(flatten(to_numpy(srv._sched), "sched/"))
    return out


def run_window(srv, name: str | None, ticks: int, msgs, goals: dict, host,
               action=None) -> dict:
    """Apply window ``name``'s events to a live server (JAX or the port's:
    the same API) and run ``ticks`` ticks, recording per tick the
    feedback (its ints, duration, phase, step id and branch mask), the
    base position, the executor's step index, time in step and done, the
    live row count, and the results as (tick, goal id, status), tick -1
    for results that fire before the first tick. ``host`` maps a state
    tensor to numpy; ``action`` is the continuous trot (for its count of
    goals sent). ``name`` None runs the ticks without events."""
    events = {} if name is None else SERVER_WINDOWS[name][0]
    seen = {g.goal_id for g in srv._goals if g.result is not None}
    results, limb = [], []

    def poll(tick):
        for g in srv._goals:
            if g.result is not None and g.goal_id not in seen:
                seen.add(g.goal_id)
                results.append((tick, g.goal_id, g.result.status))

    rec = {k: [] for k in (*FEEDBACK_INTS, "has_feedback", "step_id",
                           "duration", "phase", "branches", "base_position",
                           "step_index", "time_in_step", "done", "active",
                           "cycles_sent")}
    for i in range(ticks):
        for op in events.get(i, []):
            if op == "append":
                first = next(g for g in srv._goals if not g.done)
                sent = []

                def append(fb, sent=sent):
                    if not sent:
                        sent.append(srv.submit_goal(goals["footstep1_append"]))
                first.feedback_cb = append
            elif op == "pause":
                srv.pause(True)
            elif op == "resume":
                srv.pause(False)
            elif op == "stop":
                srv.stop()
            elif op.startswith("limb:"):
                limb.append(srv.set_limb_configure(op[5:]))
            else:
                raise ValueError(op)
        poll(i - 1)
        fb = srv.tick()
        poll(i)
        rec["has_feedback"].append(fb is not None)
        fb = fb or msgs.ExecuteStepsFeedback(step_id="step_-1")
        for k in FEEDBACK_INTS:
            rec[k].append(getattr(fb, k))
        rec["step_id"].append(int(fb.step_id.split("_")[1]))
        rec["duration"].append(fb.duration)
        rec["phase"].append(fb.phase)
        rec["branches"].append([b in fb.active_branches for b in BRANCHES])
        es = srv.state.exec
        rec["base_position"].append(host(srv.state.sim.robot.base.position))
        rec["step_index"].append(int(host(es.step_index)))
        rec["time_in_step"].append(float(host(es.time_in_step)))
        rec["done"].append(bool(host(es.done)))
        rec["active"].append(srv._active)
        rec["cycles_sent"].append(-1 if action is None else action.cycles_sent)
    out = {k: np.asarray(v) for k, v in rec.items()}
    out["results"] = np.asarray(results, np.int64).reshape(-1, 3)
    out["limb"] = np.asarray(limb, bool)
    out["ik_branch"] = np.asarray(host(srv.model.ik_branch)).astype(np.int64)
    return out


def restore_trot(action, golden: dict, prefix: str) -> None:
    """Put a freshly made VelocityTrotAction into the recorded one's state
    and give its in-flight goals its callbacks."""
    action._pair = int(golden[f"{prefix}action/pair"])
    action.cycles_sent = int(golden[f"{prefix}action/cycles_sent"])
    action.running = bool(golden[f"{prefix}action/running"])
    action.state = int(golden[f"{prefix}action/state"])
    action.goal_id = int(golden[f"{prefix}action/goal_id"])
    for g in action.server._goals:
        if not g.done:
            g.feedback_cb = action._feedback_callback
            g.result_cb = action._result_callback


LOADER_ACTIONS = ("velocity_trot", "standup_then_rotate", "external_demo")
LOADER_TICKS = 3  # ticks recorded after sending a python / combined action


def run_loader(loader, action_id: str, msgs, goals: dict, host) -> dict:
    """Send a registry action through an ActionLoader over a fresh server
    (JAX or the port's) and record the action's type and state, its goal
    document (JSON), the server's live schedule rows, and LOADER_TICKS
    ticks of ``run_window``; a launch action is pumped until DONE and its
    lifecycle log and exit code are recorded instead."""
    import json

    act = loader.send_action(action_id)
    out = {"type": np.asarray(type(act).__name__),
           "state_after_send": np.asarray(act.state)}
    if isinstance(act.goal, dict):
        out["doc"] = np.asarray(json.dumps(act.goal, sort_keys=True))
    if action_id == "external_demo":
        if not loader.pump_until(5, max_ticks=100):  # ActionState.DONE
            raise RuntimeError("the launch action did not finish")
        out["state_log"] = np.asarray(loader.state_log, np.int64)
        out["returncode"] = np.asarray(act.proc.returncode)
        return out
    srv = loader.server
    out["active"] = np.asarray(srv._active)
    out.update({f"rows/{k}": np.asarray(v)[:srv._active] for k, v in
                flatten(srv_rows(srv, host)).items()})
    out.update({f"tel/{k}": v for k, v in run_window(
        srv, None, LOADER_TICKS, msgs, goals, host,
        act if action_id == "velocity_trot" else None).items()})
    out["state_log"] = np.asarray(loader.state_log, np.int64)
    return out


def srv_rows(srv, host) -> dict:
    """The server's padded schedule as a nested numpy dict."""
    import dataclasses as dc

    return {f.name: host(getattr(srv._sched, f.name))
            for f in dc.fields(srv._sched)}


def make_server_golden() -> dict:
    """The JAX FreeGaitActionServer (capacity SERVER_CAPACITY) run up to
    each SERVER_WINDOWS snapshot (``<name>/snap/``), then SERVER_TICKS
    ticks with the window's events (``<name>/tel/``); the trot window
    also records its VelocityTrotAction (``<name>/snap/action/``)."""
    import make_torch_port_references as refs
    import quadruped_locomotion_tpu.api.messages as msgs
    from quadruped_locomotion_tpu.api.continuous_actions import (
        VelocityTrotAction,
    )
    from quadruped_locomotion_tpu.runtime.action_server import (
        FreeGaitActionServer,
    )
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    goals = refs.slice7_goals(msgs)
    base = FreeGaitActionServer(model, capacity=SERVER_CAPACITY)

    def new():
        srv = FreeGaitActionServer(model, capacity=SERVER_CAPACITY)
        srv._tick_fn = base._tick_fn  # one compilation for every server
        return srv

    def ticks_to_result(goal):
        srv = new()
        gid = srv.submit_goal(goal)
        while srv.result_of(gid) is None:
            srv.tick()
        return srv.ticks

    t_done = ticks_to_result(goals["footstep2"])
    out = {"meta/t_done_footstep2": np.asarray(t_done)}
    for name in SERVER_WINDOWS:
        srv, action = new(), None
        if name in ("append_pause", "complete"):
            srv.submit_goal(goals["footstep2"])
            srv.run(t_done - (9 if name == "append_pause" else 2))
        elif name == "stop_step":
            srv.submit_goal(goals["footstep3"])
            while not (srv.current_row == 0
                       and float(srv.state.sim.feet_world[0, 2]) > 0.02):
                srv.tick()
        elif name in ("stop_immediate", "stop_no"):
            srv.submit_goal(goals["footstep2_" + name[5:]])
            srv.run(60)
        elif name == "limb":
            srv.submit_goal(goals["base_auto"])
            srv.run(20)
        elif name == "trot":
            probe = new()
            act = VelocityTrotAction(probe, velocity=(0.12, 0.0))
            act.start()
            while act.cycles_sent < 2:
                probe.tick()
            action = VelocityTrotAction(srv, velocity=(0.12, 0.0))
            action.start()
            srv.run(probe.ticks - 2)
            out.update({f"{name}/snap/action/{k}": np.asarray(v) for k, v in (
                ("pair", action._pair), ("cycles_sent", action.cycles_sent),
                ("running", action.running), ("state", action.state),
                ("goal_id", action.goal_id))})
        out.update({f"{name}/snap/{k}": v for k, v in
                    server_snapshot(srv, jax_to_numpy).items()})
        tel = run_window(srv, name, SERVER_TICKS, msgs, goals, np.asarray,
                         action)
        out.update({f"{name}/tel/{k}": v for k, v in tel.items()})
        print(f"{name}: snapshot at tick {int(out[f'{name}/snap/ticks'])}, "
              f"results {tel['results'].tolist()}", flush=True)
    from quadruped_locomotion_tpu.api.action_loader import (
        ActionLoader, default_registry,
    )

    for action_id in LOADER_ACTIONS:
        loader = ActionLoader(new(), default_registry())
        rec = run_loader(loader, action_id, msgs, goals, np.asarray)
        out.update({f"loader/{action_id}/{k}": v for k, v in rec.items()})
        print(f"loader {action_id}: {rec['type']}, log "
              f"{rec['state_log'].tolist()}", flush=True)
    return out


# --------------------------------------------------------------------------
# --path console: the JAX console's trot / pace / edit / update
# --------------------------------------------------------------------------

CONSOLE_SECONDS = 0.5  # trot / pace: 50 planner ticks
EDIT_SCRIPT = ("show", "foot LF 0.50 0.21", "send LF", "tick 3", "nudge RF 0.04 0.0",
               "show", "bogus", "quit")


def make_console_golden() -> dict:
    """``python -m quadruped_locomotion_tpu trot|pace --seconds
    CONSOLE_SECONDS`` (its printed JSON line and the rollout's telemetry,
    taken from the ``--plot`` hook), ``edit --script`` over EDIT_SCRIPT
    (its printed lines) and ``update`` (its line)."""
    import contextlib
    import io
    import json
    import tempfile

    import quadruped_locomotion_tpu.viz as viz
    from quadruped_locomotion_tpu.api import cli

    out = {}
    captured = {}
    real = viz.plot_telemetry

    def hook(tel, path, title=None):
        captured["tel"] = tel
        return path

    viz.plot_telemetry = hook
    try:
        for gait in ("trot", "pace"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([gait, "--seconds", str(CONSOLE_SECONDS),
                               "--plot", "unused.png"])
            line = buf.getvalue().strip().splitlines()[-1]
            out[f"{gait}/json"] = np.asarray(line)
            out[f"{gait}/rc"] = np.asarray(rc)
            for k, v in captured["tel"].items():
                if not isinstance(v, dict):
                    out[f"{gait}/tel/{k}"] = np.asarray(v)
            print(f"{gait}: {line}", flush=True)
    finally:
        viz.plot_telemetry = real
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "edit.txt")
        with open(script, "w") as f:
            f.write("\n".join(EDIT_SCRIPT) + "\n")
        for name, argv in (("edit", ["edit", "--script", script]),
                           ("update", ["update"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out[f"{name}/rc"] = np.asarray(cli.main(argv))
            out[f"{name}/stdout"] = np.asarray(buf.getvalue())
    print(json.dumps({k: str(v) for k, v in out.items()
                      if k.endswith("stdout")})[:2000], flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("flat", "sweep", "estimated",
                                       "preview", "script", "server",
                                       "console"),
                    default="flat")
    ap.add_argument("--plant", choices=sorted(DEFAULTS), default="massless",
                    help="plant of --path flat")
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    if args.path in ("preview", "script", "server", "console"):
        out = args.out or PATH_DEFAULTS[args.path][0]
        golden = {"preview": make_preview_golden, "script": make_script_golden,
                  "server": make_server_golden,
                  "console": make_console_golden}[args.path]()
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(out, **golden)
        print(f"wrote {out}: {len(golden)} arrays, "
              f"{os.path.getsize(out)} bytes")
        return
    if args.path == "flat":
        out, batch, ticks = DEFAULTS[args.plant]
        make = lambda b, t, s: make_golden(b, t, s, plant=args.plant)  # noqa: E731
    else:
        out, batch, ticks = PATH_DEFAULTS[args.path]
        make = (make_sweep_golden if args.path == "sweep"
                else make_estimated_golden)
    out = args.out or out
    golden = make(args.batch or batch, args.ticks or ticks, args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **golden)
    print(f"wrote {out}: {len(golden)} arrays, {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
