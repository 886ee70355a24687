"""The closed loop's stages replayed from CUDA graphs
(``utils/cuda_graphs.Graphed``: the contact, prepare and finish stages of
``rollout/closed_loop.py`` and ``rollout/articulated.graphed_step``): off
the card they are the eager functions; on the card (the tests marked
``cuda``) their replays equal eager runs bit for bit and hand the caller
tensors of its own. Without a card those tests skip. On the card, where
the JAX package is absent:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py
"""

from __future__ import annotations

import pytest
import torch

from quadruped_locomotion_tpu_torch import sweep
from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
from quadruped_locomotion_tpu_torch.rollout import articulated as art
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.types import RobotModel, map_tensors
from quadruped_locomotion_tpu_torch.utils import cuda_graphs

B, DT = 16, cl.CONTROL_DT


def _inputs(device, B=B):
    """The simpledog standing on flat ground, every foot commanded in
    support, under seeded joint torques of a few N·m."""
    model = RobotModel.simpledog(device)
    sim = cl.init_locomotion(model, GaitParams.trot_defaults(device), B,
                             device=device).sim
    gen = torch.Generator().manual_seed(5)
    tau = (5.0 * torch.randn(B, 4, 3, generator=gen)).to(device)
    gz = torch.zeros(B, 4, device=device)
    return model, sim, tau, gz


def _leaves(tree):
    out = []
    map_tensors(tree, out.append)
    return out


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


class _Eager:
    """A stage of the closed loop run eagerly, in a ``Graphed``'s place."""

    def __init__(self, graphed):
        self.fn = graphed.fn

    def __call__(self, bound, *args):
        return self.fn(*bound, *args)


def _ticks(sc, B, ticks):
    """``ticks`` planner ticks of the config-5 scenarios from the standing
    start: (the states after each, the per-scenario KKT maxima)."""
    ls, out = sc.ls0, []
    for _ in range(ticks):
        ls, kkt = cl.planner_tick(
            sc.model, sc.params, sc.gait_params.per_scenario(B), ls,
            sc.command, qp_iters=30, terrain=sc.terrain)
        out.append((ls, kkt))
    return out


def _eager_ticks(monkeypatch, sc, B, ticks):
    with monkeypatch.context() as m:
        for k, g in cl.STAGES.items():
            m.setitem(cl.STAGES, k, _Eager(g))
        m.setitem(cl.PLANTS, "articulated", art.step)
        return _ticks(sc, B, ticks)


def test_the_closed_loop_runs_the_graphed_plant():
    assert cl.PLANTS["articulated"] is art.graphed_step


@pytest.mark.parametrize("friction_mu", [None, 0.6])
def test_off_the_card_it_is_the_eager_step(friction_mu):
    model, sim, tau, gz = _inputs(torch.device("cpu"))
    kept = dict(art._STEP.graphs)
    got = art.graphed_step(model, sim, tau, DT, support=sim.robot.support,
                           ground_height=gz, friction_mu=friction_mu)
    want = art.step(model, sim, tau, DT, support=sim.robot.support,
                    ground_height=gz, friction_mu=friction_mu)
    assert _same(got, want)
    assert dict(art._STEP.graphs) == kept  # nothing captured


def test_off_the_card_a_tick_is_the_eager_tick(monkeypatch):
    sc = sweep.build_scenarios(4, seed=3, device="cpu")
    got = _ticks(sc, 4, 1)
    want = _eager_ticks(monkeypatch, sc, 4, 1)
    assert _same(got, want)
    assert not any(g.graphs for g in cl.STAGES.values())


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,friction_mu", [(16, None), (16, 0.6),
                                               (256, None)])
def test_replays_equal_eager_steps_bit_for_bit(cuda_device, batch,
                                               friction_mu):
    """Five chained steps, each replayed and stepped eagerly from the same
    state, the eager steps' LU through cuSOLVER and cuBLAS as the graph's
    (PyTorch's default takes MAGMA from 64 systems on); the first call
    captures, the other four replay."""
    model, sim, tau, gz = _inputs(cuda_device, batch)
    art._STEP.graphs.clear()
    linalg = torch.backends.cuda.preferred_linalg_library()
    for _ in range(5):
        got = art.graphed_step(model, sim, tau, DT, support=sim.robot.support,
                               ground_height=gz, friction_mu=friction_mu)
        torch.backends.cuda.preferred_linalg_library("cusolver")
        try:
            want = art.step(model, sim, tau, DT, support=sim.robot.support,
                            ground_height=gz, friction_mu=friction_mu)
        finally:
            torch.backends.cuda.preferred_linalg_library(linalg)
        assert _same(got, want)
        sim = got
    (graph,) = art._STEP.graphs.values()
    assert graph.replays == 5


@pytest.mark.cuda
def test_a_replay_leaves_earlier_results_alone(cuda_device):
    """The caller owns what a replay returns: the next replay, and a
    capture for another layout, overwrite only the graph's own tensors;
    the last ``cuda_graphs.KEPT`` graphs are kept."""
    model, sim, tau, gz = _inputs(cuda_device)
    art._STEP.graphs.clear()
    first = art.graphed_step(model, sim, tau, DT, ground_height=gz)
    copy = map_tensors(first, torch.clone)
    art.graphed_step(model, first, tau, DT, ground_height=gz)
    assert _same(first, copy)
    for b in range(1, cuda_graphs.KEPT + 2):
        part = map_tensors(sim, lambda t: t[:b])
        art.graphed_step(model, part, tau[:b], DT, ground_height=gz[:b])
    assert _same(first, copy)
    assert len(art._STEP.graphs) == cuda_graphs.KEPT


@pytest.mark.cuda
def test_graphed_ticks_equal_eager_ticks_bit_for_bit(cuda_device,
                                                     monkeypatch):
    """Three planner ticks of 16 config-5 scenarios (heightfields, the
    trot/pace mix, the QP kernel at 30 iterations) with the stages
    replayed and run eagerly: every state and KKT maximum is equal, and
    each stage captured once and replayed in every substep."""
    sc = sweep.build_scenarios(B, seed=3, device=cuda_device)
    for g in (*cl.STAGES.values(), art._STEP):
        g.graphs.clear()
    got = _ticks(sc, B, 3)
    want = _eager_ticks(monkeypatch, sc, B, 3)
    assert _same(got, want)
    for g in (*cl.STAGES.values(), art._STEP):
        (graph,) = g.graphs.values()
        assert graph.replays == 3 * cl.CONTROL_SUBSTEPS
