"""The closed-loop cell ``sweep.config5`` on the CPU at 8 scenarios: runs
past the harness's look for a card with the timed path sound (``correct``
true) and broken underneath by each fault it can have (``correct``
false); a plant that keeps feet that pull, caught by the judge of one
substep; the spans' join; the cell's files."""

import time

import pytest
import torch

import benchmark.run as run
from benchmark.drivers import sweep as drv
from benchmark.harness import spans, spec, traffic
from benchmark.tests import sweep_faults

B = 8
SEED = 2**31 + 17
CPU = torch.device("cpu")


def _measure(seconds=0.5):
    cell = spec.load_cell("sweep.config5")
    cell.config["batch_per_chip"] = B
    return run.measure(cell, SEED, seconds, False, "cpu", time.time())


@pytest.mark.parametrize("fault", [None, *sweep_faults.FAULTS])
def test_sweep_correct_only_when_sound(fault):
    undo = sweep_faults.plant(fault) if fault else (lambda: None)
    try:
        line = _measure()
    finally:
        undo()
    assert line["correct"] is (fault is None), line["checks"]
    assert line["checks"]["tick0_unjudged"]["value"] == (
        4 if fault == "tick0_skipped" else 0)


def test_a_plant_that_keeps_pulling_feet_is_caught():
    """The window's ticks pull no foot (the first touchdowns come after
    0.45 s), so the release is judged on a recorded substep whose torques
    are turned until the stance feet pull: the program's plant releases
    them, a plant without the release re-solve keeps them pinned."""
    from quadruped_locomotion_tpu_torch import sweep
    from quadruped_locomotion_tpu_torch.rollout import articulated as art
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
    from quadruped_locomotion_tpu_torch.rollout.simulator import SimState
    from quadruped_locomotion_tpu_torch.types import BaseState

    cell = spec.load_cell("sweep.config5")
    cfg = dict(cell.config, batch_per_chip=B)
    draws = traffic.generate(cell.traffic, B, SEED)
    sc = sweep.scenarios_from_draws(draws, CPU)
    rec = drv.Recorder([(0, 1)])
    ls, _ = cl.planner_tick(
        sc.model, sc.params, sc.gait_params.per_scenario(B), sc.ls0,
        sc.command, qp_iters=cfg["qp_iters"], terrain=sc.terrain,
        telemetry_fn=rec, telemetry_inputs=True)
    rec.end_tick(ls)
    r = dict(rec.records[(0, 1)])
    r["tau"] = -40.0 * r["tau"]  # the stance legs turned over: feet pull
    support = r["support"]

    def step(release: float):
        old = art.RELEASE_FORCE
        art.RELEASE_FORCE = release
        try:
            sim = SimState(
                robot=sc.ls0.sim.robot.replace(
                    base=BaseState(position=r["p"], quaternion=r["quat"],
                                   linear_velocity=r["v"],
                                   angular_velocity=r["w"]),
                    q=r["q"], qd=r["qd"], support=r["pinned"]),
                feet_world=r["anchors"], time=sc.ls0.sim.time)
            out = art.step(sc.model, sim, r["tau"], cl.CONTROL_DT,
                           support=support, ground_height=r["gz"])
        finally:
            art.RELEASE_FORCE = old
        got = dict(r)
        b = out.robot
        got.update(next_p=b.base.position, next_quat=b.base.quaternion,
                   next_v=b.base.linear_velocity,
                   next_w=b.base.angular_velocity, next_q=b.q, next_qd=b.qd,
                   next_pinned=b.support)
        return drv.judge_substep(cfg, got, drv._outputs(got), CPU)

    limits = cell.traffic["limits"]
    sound = step(art.RELEASE_FORCE)
    kept = step(float("-inf"))
    assert sound["mismatched_feet"] == 0
    assert sound["plant_state_rel"] <= limits["plant_state_rel"]
    assert kept["mismatched_feet"] > 0
    assert kept["plant_state_rel"] > limits["plant_state_rel"]


def test_the_join_puts_each_operation_under_its_innermost_span():
    from types import SimpleNamespace as S

    tick = S(name="loop.tick", start_ns=0, end_ns=100, id=0)
    plant = S(name="loop.plant", start_ns=40, end_ns=60, id=1)
    ops = [("a", 0, 5, 10), ("b", 5, 9, 50), ("c", 9, 12, 70),
           ("d", 12, 13, None), ("e", 13, 20, 150)]
    rows = spans.by_span(ops, [tick, plant], keep=lambda n: True)
    assert rows["loop.tick"]["ops"] == 2 and rows["loop.plant"]["ops"] == 1
    assert rows[spans.UNLINKED]["ops"] == 1 and rows[spans.OUTSIDE]["ops"] == 1
    assert abs(rows["loop.plant"]["device_s"] - 4e-9) < 1e-15
    # a span left out hands its operations to the innermost one kept
    rows = spans.by_span(ops, [tick, plant], keep=lambda n: n != "loop.plant")
    assert rows["loop.tick"]["ops"] == 3 and "loop.plant" not in rows


def test_the_cell_judges_tick0_and_four_later_substeps():
    cell = spec.load_cell("sweep.config5")
    from benchmark.harness.outcome import Context

    ctx = Context(cell=cell, seed=SEED, seconds=10.0, trace=False, device=CPU,
                  t0=0.0)
    judged = drv.judged_substeps(ctx)
    assert judged[:4] == [(0, s) for s in range(4)]
    assert len(judged) == 8 and all(1 <= t <= 3 for t, _ in judged[4:])
    assert judged == drv.judged_substeps(ctx)  # drawn from the seed
    assert all(t == 1 for t, _ in drv.judged_substeps(ctx, last=1)[4:])
