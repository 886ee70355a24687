"""The port's span and counter recorder (``utils/logging.py``) on the CPU:

* off (the default), :func:`span` is one shared no-op and nothing is
  recorded, through a whole QP entry or planner tick;
* nesting, parents, call ids, attributes and self time on a made-up tree;
* the clock: a span around a ``record_function`` region lies within
  100 µs of the region on ``torch.profiler``'s timeline;
* the QP entry records ``qp.entry`` ⊃ {``qp.form``, ``qp.solve``}, and a
  planner tick ``loop.tick`` ⊃ ``loop.gait_advance`` and four of each
  substep span with ``substep`` 0-3;
* :func:`attribute` on a made-up window: every device op put down once,
  the idle split (the device's queue replayed on the host's clock)
  summing to the gaps, a gap that starts in the caller and ends in
  ``qp.form`` split between the two, the device clock's offset moving
  nothing;
* the Chrome trace a profiler session writes holds its spans.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from quadruped_locomotion_tpu_torch import headline
from quadruped_locomotion_tpu_torch.control import force_distribution as tfd
from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.types import RobotModel
from quadruped_locomotion_tpu_torch.utils import logging as qlog

SUBSTEP_SPANS = ("loop.contact_fsm", "loop.prepare", "loop.qp",
                 "loop.finish", "loop.plant")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with recording off and nothing kept."""
    qlog.disable_spans()
    qlog.collect_spans()
    yield
    qlog.disable_spans()
    qlog.collect_spans()


def _qp_batch(batch: int = 4):
    A, b, S, W, D, d = headline.build_batch(batch, "cpu")
    return A, b, S, W, D, d


def test_off_records_nothing_and_returns_the_shared_no_op():
    first, second = qlog.span("qp.entry"), qlog.span("x", substep=1)
    assert first is second
    with first as inner:
        assert inner is first
    tfd.solve_fd_qp_batched(*_qp_batch(), iters=3)
    assert qlog.collect_spans() == []


def test_nesting_parents_calls_and_self_time():
    qlog.enable_spans()
    with qlog.span("a"):
        with qlog.span("b", k=1):
            time.sleep(0.002)
        with qlog.span("c"):
            with qlog.span("d"):
                time.sleep(0.001)
    with qlog.span("e"):
        pass
    qlog.disable_spans()
    with qlog.span("after"):
        pass
    spans = {s.name: s for s in qlog.collect_spans()}
    assert set(spans) == {"a", "b", "c", "d", "e"}
    a, b, c, d, e = (spans[k] for k in "abcde")
    assert a.parent is None and e.parent is None
    assert (b.parent, c.parent, d.parent) == (a.id, a.id, c.id)
    assert {s.call for s in (a, b, c, d)} == {0} and e.call == 1
    assert a.id == 0 and b.attrs == {"k": 1} and a.attrs == {}
    for outer, inner in ((a, b), (a, c), (c, d)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert b.end_ns <= c.start_ns and a.end_ns <= e.start_ns
    own = qlog.self_ns(list(spans.values()))
    dur = {k: s.end_ns - s.start_ns for k, s in spans.items()}
    assert own[a.id] == dur["a"] - dur["b"] - dur["c"]
    assert own[c.id] == dur["c"] - dur["d"] and own[d.id] == dur["d"]
    assert dur["b"] >= 2_000_000 and own[a.id] >= 0
    assert qlog.collect_spans() == []


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    qlog.enable_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):  # the first regions of a session pay its set-up
            with qlog.span("outer", i=i):
                with record_function(f"region{i}"):
                    torch.ones(64).sum()
    qlog.disable_spans()
    outer = qlog.collect_spans()[-1]
    (region,) = [e for e in prof.profiler.kineto_results.events()
                 if e.name() == "region2"]
    assert abs(region.start_ns() - outer.start_ns) < 100_000
    assert abs(region.end_ns() - outer.end_ns) < 100_000


def test_qp_entry_records_formation_and_solve():
    qlog.enable_spans()
    tfd.solve_fd_qp_batched(*_qp_batch(), iters=3)
    qlog.disable_spans()
    spans = qlog.collect_spans()
    assert sorted(s.name for s in spans) == ["qp.entry", "qp.form", "qp.solve"]
    entry = next(s for s in spans if s.name == "qp.entry")
    assert entry.parent is None
    for s in spans:
        assert s.call == entry.call
        if s is not entry:
            assert s.parent == entry.id
            assert entry.start_ns <= s.start_ns <= s.end_ns <= entry.end_ns
    form, solve = (next(s for s in spans if s.name == k)
                   for k in ("qp.form", "qp.solve"))
    assert form.end_ns <= solve.start_ns


def test_planner_tick_records_its_stages_per_substep():
    torch.set_num_threads(1)
    B = 8
    model, gp = RobotModel.simpledog("cpu"), GaitParams.trot_defaults("cpu")
    ls = cl.init_locomotion(model, gp, B, device="cpu")
    cmd = cl.Command(
        linear_velocity=torch.tensor([[0.2, 0.0, 0.0]]).expand(B, 3),
        yaw_rate=torch.zeros(B))
    args = (model, ControllerParams.defaults("cpu"), gp.per_scenario(B), ls,
            cmd)
    cl.planner_tick(*args, qp_iters=3, plant="massless")
    assert qlog.collect_spans() == []  # recording off
    qlog.enable_spans()
    cl.planner_tick(*args, qp_iters=3, plant="massless")
    qlog.disable_spans()
    spans = qlog.collect_spans()
    names = [s.name for s in spans]
    (tick,) = [s for s in spans if s.name == "loop.tick"]
    assert names.count("loop.gait_advance") == 1
    assert tick.parent is None and all(s.call == tick.call for s in spans)
    for name in SUBSTEP_SPANS:
        mine = [s for s in spans if s.name == name]
        assert [s.attrs["substep"] for s in mine] == list(range(4)), name
        assert all(s.parent == tick.id for s in mine), name
    # on CPU tensors the QP's plain version runs inside loop.qp
    solves = [s for s in spans if s.name == "qp.solve"]
    qp_ids = {s.id for s in spans if s.name == "loop.qp"}
    assert len(solves) == 4 and {s.parent for s in solves} == qp_ids


def _span(name, start, end, id_, parent=None, call=0):
    return qlog.Span(name, start, end, id_, parent, call, 1, {})


def test_attribute_splits_ops_and_idle_over_spans():
    # the caller, then a call: qp.entry [100, 400) holding qp.form
    # [110, 200) and qp.solve [200, 380), on the host's clock; the device
    # clock stands 1000 ns off it
    spans = [_span("qp.form", 110, 200, 1, 0),
             _span("qp.solve", 200, 380, 2, 0),
             _span("qp.entry", 100, 400, 0)]
    Op = qlog.DeviceOp
    ops = [Op("read", 1045, 1055, 40),  # launched by the caller
           Op("gemm", 1125, 1145, 120),  # launched in qp.form
           Op("add", 1145, 1150, 130),  # queued behind gemm
           Op("fd_qp_ipm", 1255, 1455, 250),  # launched in qp.solve
           Op("copy", 1455, 1465, 390),  # launched in qp.entry itself
           Op("memset", 1470, 1480, None)]  # no runtime call kept
    got = qlog.attribute(ops, spans)
    assert sum(row["ops"] for row in got.values()) == len(ops)
    assert {k: row["ops"] for k, row in got.items()} == {
        qlog.OUTSIDE: 1, "qp.form": 2, "qp.solve": 1, "qp.entry": 1,
        qlog.UNLINKED: 1}
    assert got["qp.solve"]["device_s"] == pytest.approx(200e-9)
    # replayed on the host's clock: read [40, 50), gemm [120, 140), add
    # [140, 145), fd_qp_ipm [250, 450), copy [450, 460)
    gaps = qlog.idle_intervals(ops)
    assert gaps == [(50, 120), (145, 250)]
    idle = {k: row["idle_s"] for k, row in got.items() if row["idle_s"]}
    assert sum(idle.values()) == pytest.approx(
        sum(b - a for a, b in gaps) * 1e-9)
    # the gap [50, 120) begins in the caller and ends in qp.form: 50 ns of
    # caller, 10 of qp.entry's own, 10 of qp.form
    assert idle == pytest.approx({qlog.OUTSIDE: 50e-9, "qp.entry": 10e-9,
                                  "qp.form": (10 + 55) * 1e-9,
                                  "qp.solve": 50e-9})
    # where the device clock stands does not move the split
    shifted = [op._replace(start_ns=op.start_ns - 5000,
                           end_ns=op.end_ns - 5000) for op in ops]
    assert qlog.attribute(shifted, spans) == got


def test_profiler_session_writes_spans_into_its_chrome_trace(tmp_path):
    qlog.start_profiler(str(tmp_path))
    with qlog.span("outer", substep=2):
        with qlog.trace_annotation("inner"):
            torch.ones(3).sum()
    path = qlog.stop_profiler()
    with open(path) as f:
        trace = json.load(f)
    mine = {e["name"]: e for e in trace["traceEvents"]
            if e.get("cat") == "program_span"}
    assert set(mine) == {"outer", "inner"}
    outer, inner = mine["outer"], mine["inner"]
    assert outer["ph"] == "X" and outer["args"]["substep"] == 2
    assert inner["args"]["parent"] == outer["args"]["id"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    # on the trace's own time base: beside the operators it recorded
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and all(abs(e["ts"] - outer["ts"]) < 1e6 for e in ops)
    assert qlog.span("x") is qlog.span("y")  # the session turned it off
