"""The port's one CUDA-graph capture (``utils/cuda_graphs.Capture``) and
the closed loop's stages replayed from it (``utils/cuda_graphs.Graphed``:
the contact, prepare and finish stages of ``rollout/closed_loop.py``): off
the card they are the eager functions; on the card (the tests marked
``cuda``) their replays equal eager runs bit for bit and hand the caller
tensors of its own, and a counted kernel inside a graph, captured directly,
as a runtime ``Tick`` or as a ``Graphed`` stage, is counted once a replay
and not at the capture. Without a card those tests skip. On the card,
where the JAX package is absent:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py
"""

from __future__ import annotations

import pytest
import torch

from quadruped_locomotion_tpu_torch import sweep
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.runtime import graph as runtime_graph
from quadruped_locomotion_tpu_torch.types import map_tensors
from quadruped_locomotion_tpu_torch.utils import cuda_graphs
from quadruped_locomotion_tpu_torch.utils.logging import counters

B = 16


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
        return _ticks(sc, B, ticks)


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


class _Recorder:
    """A stage run eagerly in a ``Graphed``'s place, keeping a copy of the
    arguments of each call."""

    def __init__(self, graphed):
        self.fn, self.calls = graphed.fn, []

    def __call__(self, bound, *args):
        self.calls.append((bound, map_tensors(args, torch.clone)))
        return self.fn(*bound, *args)


def _finish_calls(monkeypatch, device, batch):
    """The finish stage's arguments in the 4 substeps of one planner tick
    of ``batch`` config-5 scenarios."""
    sc = sweep.build_scenarios(batch, seed=3, device=device)
    rec = _Recorder(cl.STAGES["finish"])
    with monkeypatch.context() as m:
        m.setitem(cl.STAGES, "finish", rec)
        _ticks(sc, batch, 1)
    return rec.calls


@pytest.mark.cuda
def test_a_replay_leaves_earlier_results_alone(cuda_device, monkeypatch):
    """The caller owns what a replay of the finish stage returns: the next
    replay, and captures for other layouts (batches of 1, 2 and 3),
    overwrite only the graph's own tensors; the last ``cuda_graphs.KEPT``
    graphs are kept; each result equals the eager stage's bit for bit."""
    finish = cl.STAGES["finish"]
    calls = _finish_calls(monkeypatch, cuda_device, B)
    others = [_finish_calls(monkeypatch, cuda_device, b)[0]
              for b in range(1, cuda_graphs.KEPT + 2)]
    finish.graphs.clear()
    bound, args = calls[0]
    first = finish(bound, *args)
    assert _same(first, finish.fn(*bound, *args))
    copy = map_tensors(first, torch.clone)
    bound, args = calls[1]
    assert _same(finish(bound, *args), finish.fn(*bound, *args))
    assert _same(first, copy)
    for bound, args in others:
        assert _same(finish(bound, *args), finish.fn(*bound, *args))
    assert _same(first, copy)
    assert len(finish.graphs) == cuda_graphs.KEPT


@pytest.mark.cuda
def test_graphed_ticks_equal_eager_ticks_bit_for_bit(cuda_device,
                                                     monkeypatch):
    """Three planner ticks of 16 config-5 scenarios (heightfields, the
    trot/pace mix, the QP kernel at 30 iterations) with the stages
    replayed and run eagerly: every state and KKT maximum is equal, and
    each stage captured once and replayed in every substep."""
    sc = sweep.build_scenarios(B, seed=3, device=cuda_device)
    for g in cl.STAGES.values():
        g.graphs.clear()
    got = _ticks(sc, B, 3)
    want = _eager_ticks(monkeypatch, sc, B, 3)
    assert _same(got, want)
    for g in cl.STAGES.values():
        (graph,) = g.graphs.values()
        assert graph.replays == 3 * cl.CONTROL_SUBSTEPS


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["capture", "tick", "graphed"])
def test_a_counted_kernel_is_counted_once_a_replay(cuda_device, how):
    """The QP kernel at B = 3 inside a graph: its eager warm-ups count, the
    capture does not, and each of 3 replays counts one launch of 3."""
    G = torch.eye(12, device=cuda_device).expand(3, 12, 12).contiguous()
    g = torch.ones((3, 12), device=cuda_device)
    D = torch.zeros((3, 20, 12), device=cuda_device)
    d = -torch.ones((3, 20), device=cuda_device)

    def launches():
        return counters["qp.kernel_launches"], counters["qp.kernel_instances"]

    before = launches()
    if how == "capture":
        graph = cuda_graphs.Capture(lambda: fk.solve_fd_qp(G, g, D, d),
                                    cuda_device, warmups=1)
        replay, warmups = graph.replay, 1
    elif how == "tick":
        tick = runtime_graph.Tick(lambda: fk.solve_fd_qp(G, g, D, d),
                                  cuda_device)
        graph, replay = tick.graph, tick
        warmups = runtime_graph.WARMUP_RUNS
    else:
        stage = cuda_graphs.Graphed(fk.solve_fd_qp)
        stage((), G, g, D, d)  # the capture, after one warm-up, and a replay
        (graph,) = stage.graphs.values()
        replay, warmups = (lambda: stage((), G, g, D, d)), 2
    assert isinstance(graph, cuda_graphs.Capture)
    assert graph.counted == {"qp.kernel_launches": 1, "qp.kernel_instances": 3,
                             "qp.instance_iterations": 3 * 15}
    assert launches() == (before[0] + warmups, before[1] + 3 * warmups)
    for _ in range(3):
        replay()
    torch.cuda.synchronize()
    assert launches() == (before[0] + warmups + 3,
                          before[1] + 3 * (warmups + 3))
