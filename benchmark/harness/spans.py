"""A traced window with the program's spans: each device operation joined
by correlation id to the CUDA runtime call that launched it, and put down
to the innermost program span open at that launch.

The program records its spans (``utils/logging.py``: ``enable_spans``,
``collect_spans``) on the profiler's clock, epoch nanoseconds, and the
profiler records the runtime calls (host events named ``cu*``) beside the
device operations, with the same correlation id on both. This file does
the join itself; the program's own ``attribute()`` was the model for it,
not a part of the yardstick. Where the program records no spans (it lacks
``enable_spans``), every operation falls outside them and the readers of
span sums find nothing.
"""

from __future__ import annotations

import importlib
import time
from bisect import bisect_right

import torch

from .trace import Trace

OUTSIDE = "(outside program spans)"
UNLINKED = "(launch not traced)"


def _program_logging():
    """The program's span recorder, or None where it has none."""
    try:
        mod = importlib.import_module(
            "quadruped_locomotion_tpu_torch.utils.logging")
    except ImportError:
        return None
    return mod if hasattr(mod, "enable_spans") else None


def _owners(spans):
    """(starts, names): the timeline cut at every span's start and end,
    ``names[k]`` the innermost of ``spans`` open from ``starts[k]`` on
    (the one opened last), None where none is."""
    edges = sorted((t, opening, i) for i, s in enumerate(spans)
                   for t, opening in ((s.start_ns, 1), (s.end_ns, 0)))
    starts, names, open_ = [], [], []
    for t, opening, i in edges:
        if opening:
            open_.append(i)
        else:
            open_.remove(i)
        top = max(open_, key=lambda j: (spans[j].start_ns, spans[j].id),
                  default=None)
        name = None if top is None else spans[top].name
        if starts and starts[-1] == t:
            names[-1] = name
        else:
            starts.append(t)
            names.append(name)
    return starts, names


def by_span(ops, spans, keep) -> dict:
    """{span name: {"ops", "device_s"}} of device operations
    ``(name, start_ns, end_ns, launch_ns or None)``, each put down to the
    innermost span that ``keep`` (of its name) selects."""
    starts, names = _owners([s for s in spans if keep(s.name)])
    out = {}
    for _, start, end, launch in ops:
        if launch is None:
            key = UNLINKED
        else:
            k = bisect_right(starts, launch) - 1
            key = names[k] if k >= 0 and names[k] is not None else OUTSIDE
        row = out.setdefault(key, {"ops": 0, "device_s": 0.0})
        row["ops"] += 1
        row["device_s"] += (end - start) * 1e-9
    return out


def traced(fn, device, keep):
    """Run ``fn`` under the profiler with the program's spans recorded:
    (its result, the window's ``Trace``, {span name: {"ops", "device_s"}}
    over the spans ``keep`` selects, the share of the device time put down
    to one of them)."""
    from torch.profiler import ProfilerActivity, profile

    qlog = _program_logging()
    torch.cuda.synchronize(device)
    if qlog is not None:
        qlog.enable_spans()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(device)
            window = time.perf_counter() - t0
    finally:
        if qlog is not None:
            qlog.disable_spans()
    spans = qlog.collect_spans() if qlog is not None else []
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() == cpu and e.name().startswith("cu")}
    ops = [(e.name(), e.start_ns(), e.end_ns(), launch.get(e.correlation_id()))
           for e in events if e.device_type() == cuda]
    if not ops:
        raise RuntimeError("the profiler recorded no device activity")
    rows = by_span(ops, spans, keep)
    total = sum(r["device_s"] for r in rows.values())
    inside = sum(r["device_s"] for k, r in rows.items()
                 if k not in (OUTSIDE, UNLINKED))
    trace = Trace([(n, s * 1e-3, e * 1e-3) for n, s, e, _ in ops], window)
    return out, trace, rows, (inside / total if total else 0.0)
