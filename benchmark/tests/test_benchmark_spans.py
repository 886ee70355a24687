"""The program's spans (``quadruped_locomotion_tpu_torch/utils/logging.py``)
and the card's trace, in a traced window of the QP cell's caller
(``drivers/fd_qp.py``, its 300 calls at the cell's batch): every
``fd_qp_ipm`` kernel's launch (a host event of the profiler) lies inside
its call's ``qp.solve`` span; the device runs the operations in launch
order, as the idle split's replay of the queue on the host's clock
assumes, and that replay's idle time is the trace's less the launches'
latency; every device operation is put down to exactly one span or to the
caller, and the idle split covers the replay's gaps. With recording off,
the same window records no span and issues the same device operations,
and a call makes no host-device synchronisation either way.

The device's own timestamps are not held to the host's clock: on the
H100 they stood up to 2.3 ms ahead of it in some windows (PERF.md §6)."""

import time

import pytest
import torch

from benchmark.drivers import fd_qp
from benchmark.harness import spec
from benchmark.harness.outcome import Context

SEED = 2**31 + 11


def _window(ctx, s, record: bool):
    """(device ops, spans) of one traced window, recording on or off."""
    from torch.profiler import ProfilerActivity, profile

    from quadruped_locomotion_tpu_torch.utils import logging as qlog

    torch.cuda.synchronize(ctx.device)
    if record:
        qlog.enable_spans()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fd_qp.window(ctx, s, fd_qp.TRACED_CALLS)
            torch.cuda.synchronize(ctx.device)
    finally:
        qlog.disable_spans()
    return qlog.profiler_device_ops(prof), qlog.collect_spans()


@pytest.mark.cuda
def test_spans_hold_their_launches_and_split_the_idle_time(cuda_device):
    from quadruped_locomotion_tpu_torch.control.force_distribution import (
        solve_fd_qp_batched,
    )
    from quadruped_locomotion_tpu_torch.utils import logging as qlog

    ctx = Context(cell=spec.load_cell("qp.balance"), seed=SEED, seconds=0.0,
                  trace=True, device=cuda_device, t0=time.time())
    s = fd_qp.setup(ctx)
    ops_off, spans_off = _window(ctx, s, record=False)
    ops, spans = _window(ctx, s, record=True)
    assert spans_off == []
    assert sorted(op.name for op in ops) == sorted(op.name for op in ops_off)

    calls = fd_qp.TRACED_CALLS
    solves = sorted((sp for sp in spans if sp.name == "qp.solve"),
                    key=lambda sp: sp.start_ns)
    kernels = sorted((op for op in ops if "fd_qp_ipm" in op.name),
                     key=lambda op: op.start_ns)
    assert len(solves) == len(kernels) == calls
    assert sum(sp.name == "qp.entry" and sp.parent is None
               for sp in spans) == calls
    assert all(op.launch_ns is not None for op in ops)
    for sp, k in zip(solves, kernels):
        assert sp.start_ns <= k.launch_ns <= sp.end_ns, (sp, k)
    by_launch = sorted(ops, key=lambda op: op.launch_ns)
    assert by_launch == sorted(ops, key=lambda op: op.start_ns)
    replayed = sum(b - a for a, b in qlog.idle_intervals(ops))
    traced, busy_until = 0, by_launch[0].end_ns  # the trace's own gaps
    for op in by_launch[1:]:
        traced += max(0, op.start_ns - busy_until)
        busy_until = max(busy_until, op.end_ns)
    lead = max(op.launch_ns - op.start_ns for op in ops)  # device clock ahead
    assert 0.5 * traced < replayed <= 1.01 * traced, (replayed, traced, lead)

    rows = qlog.attribute(ops, spans)
    assert qlog.UNLINKED not in rows
    assert sum(row["ops"] for row in rows.values()) == len(ops)
    assert sum(row["idle_s"] for row in rows.values()) == pytest.approx(
        replayed * 1e-9, rel=1e-9)

    for record in (False, True):
        if record:
            qlog.enable_spans()
        torch.cuda.set_sync_debug_mode("error")
        try:
            solve_fd_qp_batched(*s.pool[0], iters=ctx.cell.config["qp_iters"],
                                backend="auto")
        finally:
            torch.cuda.set_sync_debug_mode("default")
            qlog.disable_spans()
    torch.cuda.synchronize(cuda_device)
    assert [sp.name for sp in qlog.collect_spans()] == [
        "qp.form", "qp.solve", "qp.entry"]
