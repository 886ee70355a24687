"""Driver of the config-5 closed loop: a caller that makes one call per
planner tick of every scenario, from the standing start on, and reads the
tick's largest QP KKT residual on the host before the next call.

Set-up draws the scenarios (``harness.traffic``: terrain, gait and
velocity of each), builds them through the program
(``sweep.scenarios_from_draws``) and warms up on one tick from the
standing start, as ``sweep.measure`` does. Each call is
``rollout.closed_loop.planner_tick`` with the arguments ``sweep.run``
gives it (per-scenario heightfields, the configuration's ``plant``,
``qp_iters`` and ``qp_backend="auto"``), and its ``telemetry_fn`` copies
the judged substeps' whole input and output (``loop.record``). A call's
latency runs on the host's clock from just before the call to just after
the read. The window starts at tick 0.

``correct``: once the window has closed, the reference
(``reference/loop.py``) works out again, in float64 and from each judged
substep's recorded state at its start, the controller's QP (solved to the
optimum by ``reference/qp.py``), the stance torques of the program's
forces and the plant's next state from the program's torques, and judges
every scenario of tick 0's four substeps and of ``later_substeps`` more
drawn from the seed.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..harness import spans as spans_mod
from ..harness import traffic as traffic_mod
from ..harness.outcome import (
    Context, Outcome, no_larger_than, note, peak_bytes, sync,
)
from ..reference import loop as ref_loop
from ..reference import qp as ref_qp
from ..reference.robot import Robot

SUBSTEPS = 4  # control substeps a planner tick (400 Hz under 100 Hz)
TRACED_TICKS = 2
CALIBRATION_TICKS = 4
CHUNK = 8192  # scenarios the reference works on at once
# The float64 reference's scaled KKT residual on every instance: far
# below the objective gaps judged.
REFERENCE_KKT = 1e-6
CONTROL = {"float64": "float32", "float32": "tf32"}
STATE_KEYS = ("p", "quat", "v", "w", "q", "qd", "pinned")


def _sim_state(sim) -> dict:
    r = sim.robot
    return {"p": r.base.position, "quat": r.base.quaternion,
            "v": r.base.linear_velocity, "w": r.base.angular_velocity,
            "q": r.q, "qd": r.qd, "pinned": r.support}


class Recorder:
    """The ``telemetry_fn`` of the calls: copies the judged substeps'
    input (the controller's state and target, the plant's state, pinned
    set, anchors and ground heights, the program's forces and torques) and
    the plant's output, the next substep's state. ``judged``: the set of
    (tick, substep) to copy."""

    def __init__(self, judged):
        self.judged, self.tick, self.substep = set(judged), 0, 0
        self.records, self.pending = {}, None

    def _close(self, sim):
        if self.pending is not None:
            self.pending.update({f"next_{k}": v.clone()
                                 for k, v in _sim_state(sim).items()})
            self.pending = None

    def __call__(self, state, tau, diag, ctx, inputs):
        self._close(inputs.sim)
        key = (self.tick, self.substep)
        if key in self.judged:
            t, sim = inputs.target, inputs.sim
            rec = {k: v.clone() for k, v in _sim_state(sim).items()}
            rec.update(
                support=state.support.clone(),
                normal=state.surface_normal.clone(),
                target_p=t.position.clone(), target_quat=t.quaternion.clone(),
                target_v=t.linear_velocity.clone(),
                target_w=t.angular_velocity.clone(),
                anchors=sim.feet_world.clone(),
                gz=inputs.ground_height.clone(),
                x=diag.distribution.ground_reaction.flatten(-2).clone(),
                tau=tau.clone())
            self.records[key] = rec
            self.pending = rec
        self.substep += 1
        return {}

    def end_tick(self, ls):
        self._close(ls.sim)
        self.tick, self.substep = self.tick + 1, 0


def judged_substeps(ctx: Context, last: int | None = None) -> list:
    """Tick 0's substeps and ``later_substeps`` of the later ticks drawn
    from the seed, among ticks ``later_ticks`` (up to tick ``last`` where
    the window stops there). A window too short to reach a drawn substep
    leaves it unjudged; tick 0's are always reached."""
    j = ctx.cell.traffic["judged"]
    first = [(t, s) for t in j["ticks"] for s in range(SUBSTEPS)]
    lo, hi = j["later_ticks"]
    hi = hi if last is None else min(hi, last)
    pool = [(t, s) for t in range(lo, hi + 1) for s in range(SUBSTEPS)]
    if not pool:
        return first
    r = traffic_mod.rng(ctx.seed, 2)
    pick = r.choice(len(pool), size=min(j["later_substeps"], len(pool)),
                    replace=False)
    return first + [pool[i] for i in sorted(pick)]


def setup(ctx: Context):
    """Draws, the program's scenarios and tick, one warm-up tick; then a
    full garbage collection, and what survives it (the imports', the
    scenarios', the program's) frozen out of later collections until
    :func:`window` ends: a collection of the oldest generation otherwise
    scans those ~270,000 objects, 40-240 ms on the card's host, and one
    falling inside a ~1.5 s tick moves the window's p95."""
    from quadruped_locomotion_tpu_torch import sweep
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.types import full_f32_matmuls

    if not hasattr(cl, "SubstepInputs") or not hasattr(
            sweep, "scenarios_from_draws"):
        raise SystemExit("drivers/sweep.py: the program hands no substep "
                         "inputs to its telemetry (closed_loop.SubstepInputs)"
                         " or builds no scenarios from draws; it cannot run "
                         "this cell")
    cfg = ctx.cell.config
    B = cfg["batch_per_chip"]
    draws = traffic_mod.generate(ctx.cell.traffic, B, ctx.seed)
    note(ctx, "inputs drawn")
    full_f32_matmuls()
    sc = sweep.scenarios_from_draws(draws, ctx.device)
    gp = sc.gait_params.per_scenario(B)

    def call(ls, recorder):
        ls, (kkt, _) = cl.planner_tick(
            sc.model, sc.params, gp, ls, sc.command, qp_iters=cfg["qp_iters"],
            terrain=sc.terrain, plant=cfg["plant"], qp_backend="auto",
            telemetry_fn=recorder, telemetry_inputs=True)
        recorder.end_tick(ls)
        return ls, kkt

    sync(ctx.device)
    note(ctx, "program's scenarios built")
    call(sc.ls0, Recorder([(0, s) for s in range(SUBSTEPS)]))  # warm-up
    sync(ctx.device)
    note(ctx, "warm-up tick made")
    gc.collect()
    gc.freeze()
    return SimpleNamespace(ls0=sc.ls0, call=call, batch=B)


def window(ctx: Context, s, judged, max_ticks: int | None = None):
    """The measured (or traced) window from tick 0; it ends the freeze
    of :func:`setup`. Returns (ticks, wall seconds, per-tick latencies in
    ms, ticks whose read was not finite, the recorder)."""
    rec = Recorder(judged)
    lat, bad, ticks, ls = [], 0, 0, s.ls0
    sync(ctx.device)
    t0 = time.perf_counter()
    try:
        while True:
            t_call = time.perf_counter()
            ls, kkt = s.call(ls, rec)
            read = float(kkt.amax())
            lat.append(1e3 * (time.perf_counter() - t_call))
            bad += not np.isfinite(read)
            ticks += 1
            if max_ticks is not None:
                if ticks >= max_ticks:
                    break
            elif time.perf_counter() - t0 >= ctx.seconds:
                break
        wall = time.perf_counter() - t0
    finally:
        gc.unfreeze()
    return ticks, wall, lat, bad, rec


def _outputs(rec: dict) -> dict:
    """What the program produced in a recorded substep: its forces, its
    torques and the plant's next state."""
    return {"x": rec["x"], "tau": rec["tau"],
            **{k: rec[f"next_{k}"] for k in STATE_KEYS}}


def control_outputs(cfg: dict, rec: dict, device) -> dict:
    """The reference computed in the precision below the configuration's,
    put in the program's place: its QP's answer, the stance torques of
    that answer (the program's torques on swing legs), and the plant's
    next state from the program's torques."""
    ar = ref_qp.Arith(CONTROL[cfg["precision"]])
    robot = Robot(cfg, ar, device)
    r = ref_loop.cast(rec, ar)
    A, b, S, W, D, d = ref_loop.controller_qp(robot, cfg, r)
    G, g = ref_qp.form(A, S, W, b, ar)
    x, _, _ = ref_qp.solve(G, g, D, d, ar)
    x = x * r["support"].repeat_interleave(3, -1).to(x.dtype)
    tau = torch.where(r["support"][..., None],
                      ref_loop.stance_torques(robot, r, x), r["tau"])
    st, _ = ref_loop.plant_step(robot, cfg, r, r["tau"])
    return {"x": x, "tau": tau, **{k: st[k] for k in STATE_KEYS}}


def judge_substep(cfg: dict, rec: dict, out: dict, device) -> dict:
    """The compared numbers of one recorded substep, every scenario:
    the largest objective gap and cone violation of the forces ``out["x"]``
    on the reference's QP, the largest relative error of the stance legs'
    torques, the largest error of the plant's next state and the feet
    whose pin state after the substep differs from the reference's."""
    ar = ref_qp.Arith("float64")
    robot = Robot(cfg, ar, device)
    got = {"obj_gap": 0.0, "cone_violation_n": 0.0, "stance_torque_rel": 0.0,
           "plant_state_rel": 0.0, "mismatched_feet": 0, "feet": 0,
           "scenarios": 0}
    B = rec["p"].shape[0]
    for i in range(0, B, CHUNK):
        r = ref_loop.cast({k: v[i:i + CHUNK] for k, v in rec.items()}, ar)
        o = ref_loop.cast({k: v[i:i + CHUNK] for k, v in out.items()}, ar)
        A, b, S, W, D, d = ref_loop.controller_qp(robot, cfg, r)
        G, g = ref_qp.form(A, S, W, b, ar)
        x_ref, _, kkt = ref_qp.solve(G, g, D, d, ar)
        if float(kkt.max()) > REFERENCE_KKT:
            raise RuntimeError(f"the float64 reference did not reach the "
                               f"optimum (KKT {float(kkt.max()):.3g})")
        j = ref_qp.judge(A, b, S, W, D, d, o["x"], x_ref)
        got["obj_gap"] = max(got["obj_gap"], no_larger_than(j["gap"].max()))
        got["cone_violation_n"] = max(got["cone_violation_n"],
                                      no_larger_than(j["viol"].max()))
        tau_ref = ref_loop.stance_torques(robot, r, o["x"])
        rel = ((o["tau"] - tau_ref).abs().amax(-1)
               / (1.0 + tau_ref.abs().amax(-1)))
        rel = torch.where(r["support"], rel, torch.zeros_like(rel))
        got["stance_torque_rel"] = max(got["stance_torque_rel"],
                                       no_larger_than(rel.max()))
        st, err, _ = ref_loop.follow_program(robot, cfg, r, r["tau"], o)
        got["plant_state_rel"] = max(got["plant_state_rel"],
                                     no_larger_than(err.max()))
        got["mismatched_feet"] += int((st["pinned"] != o["pinned"]).sum())
        got["feet"] += o["pinned"].numel()
        got["scenarios"] += int(r["p"].shape[0])
    return got


def judge(ctx: Context, records: dict, control: bool = False) -> dict:
    """The compared numbers over the judged substeps (``control``: of the
    reference in the precision below the configuration's, in the
    program's place)."""
    cfg, B = ctx.cell.config, ctx.cell.config["batch_per_chip"]
    out = {"obj_gap": 0.0, "cone_violation_n": 0.0, "stance_torque_rel": 0.0,
           "plant_state_rel": 0.0}
    mismatched, feet, tick0 = 0, 0, 0
    # tick 0 counts only from the standing start: every scenario at rest
    first = records.get((0, 0))
    at_rest = first is not None and all(
        bool((first[k] == 0).all()) for k in ("v", "w", "qd"))
    for (tick, _), rec in sorted(records.items()):
        if "next_p" not in rec:
            continue
        prog = (control_outputs(cfg, rec, ctx.device) if control
                else _outputs(rec))
        got = judge_substep(cfg, rec, prog, ctx.device)
        for k in out:
            out[k] = max(out[k], got[k])
        mismatched += got["mismatched_feet"]
        feet += got["feet"]
        tick0 += tick == 0 and at_rest and got["scenarios"] == B
    judged_ticks = ctx.cell.traffic["judged"]["ticks"]
    out["contact_mismatch"] = mismatched / feet if feet else float("inf")
    out["tick0_unjudged"] = SUBSTEPS * len(judged_ticks) - tick0
    return out


def _iterations() -> int:
    """The program's count of QP interior-point iterations asked for."""
    from quadruped_locomotion_tpu_torch.utils import logging as qlog

    return qlog.counters["qp.instance_iterations"]


def run(ctx: Context) -> Outcome:
    s = setup(ctx)
    window_start = time.time()
    note(ctx, "window opened")
    counts = {"batch": s.batch}
    iters = _iterations()
    if ctx.trace:
        judged = judged_substeps(ctx, TRACED_TICKS - 1)
        (ticks, wall, lat, bad, rec), trace, rows, cover = spans_mod.traced(
            lambda: window(ctx, s, judged, TRACED_TICKS), ctx.device,
            keep=lambda name: name.startswith("loop."))
        counts.update(busy_s=trace.busy_s(), spans=rows, span_cover=cover)
        note(ctx, f"traced: {100 * cover:.3f} % of the device time under "
                  "the program's loop.* spans")
    else:
        judged = judged_substeps(ctx)
        ticks, wall, lat, bad, rec = window(ctx, s, judged)
        trace = None
    counts.update(ticks=ticks, substeps=ticks * SUBSTEPS)
    peak = peak_bytes(ctx.device)
    s.call = None
    note(ctx, f"window closed after {ticks} ticks, "
              f"{_iterations() - iters} QP instance-iterations; tick ms "
              + " ".join(f"{x:.1f}" for x in lat) + "; judging")
    got = judge(ctx, rec.records)
    limits = ctx.cell.traffic["limits"]
    return Outcome(
        metrics={"qp_solves_per_s": SUBSTEPS * s.batch * ticks / wall,
                 "qp_call_p95_ms": float(np.percentile(lat, 95)),
                 "setup_s": window_start - ctx.t0},
        attempted=ticks, failed=bad, memory_peak_bytes=peak,
        checks={k: (v, limits[k]) for k, v in got.items()},
        trace=trace, counts=counts)


def calibration(ctx: Context, control: bool) -> dict:
    """Readings for setting the limits: the program's numbers over
    ``CALIBRATION_TICKS`` ticks from the standing start and, with
    ``control``, those of the reference put in the program's place, in the
    precision below the configuration's, on the same substeps."""
    s = setup(ctx)
    judged = judged_substeps(ctx, CALIBRATION_TICKS - 1)
    *_, rec = window(ctx, s, judged, CALIBRATION_TICKS)
    s.call = None
    out = {"program": judge(ctx, rec.records)}
    if control:
        out["control"] = judge(ctx, rec.records, control=True)
    return out
