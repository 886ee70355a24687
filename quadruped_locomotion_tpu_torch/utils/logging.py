"""Observability: ring-buffer logging on the device, host timers, the
program's spans and counters, and profiler sessions (≙
``quadruped_locomotion_tpu/utils/logging.py``).

* :class:`RingLog` — fixed-capacity buffers over a sample tree (a tensor,
  a dict or a dataclass of tensors) with a write cursor; :func:`record`
  is pure and reads nothing back to the host (an ``index_copy`` per leaf
  at a cursor kept on the device), so it may run inside a tick captured
  as a CUDA graph.
* :func:`capture` — the reference's ``/capture_log_data``: one copy of the
  cursor and count, then the buffers, returned oldest first.
* :class:`Timer` — pin/split wall-clock timing with named laps.
* :func:`span` (alias :func:`trace_annotation`) — a named, nested host
  interval of the program. Recording is off by default: :func:`span`
  then returns one shared no-op context manager, and records, allocates
  and synchronises nothing. :func:`enable_spans` turns it on; each span
  then keeps its name, start, end, parent and call id (the sequence
  number of its root span; spans of one call share it) in memory until
  :func:`collect_spans` returns them on the profiler's clock. A span
  reads the host's clock only, so it is safe in code that a CUDA graph
  captures; a graph's replay runs no host code and records no span.
* :data:`counters` — named integer counters, always on:
  ``qp.kernel_launches`` (launches of the QP kernel),
  ``qp.kernel_instances`` (the QP instances those launches solved),
  ``qp.wls_launches`` (``solve_weighted_ls_fd_qp`` calls that launched
  it) and ``qp.instance_iterations`` (the interior-point iterations
  ``ops.fd_qp_kernel.solve_fd_qp`` asked for, B × ``iters`` a call, on
  the card and off it: what a caller's iteration count above the
  default 15 costs); ``plant.kernel_launches`` (launches of the
  articulated plant's kernel) and ``plant.kernel_instances`` (the
  scenarios those launches stepped).
* :func:`profiler_device_ops` and :func:`attribute` — the device
  operations of a profiled window, each joined to the CUDA runtime call
  that launched it and put down to the innermost span open at that
  launch, and the device's idle time (:func:`idle_intervals`, on the
  host's clock) split over the spans the host was in while the device
  waited.
* :func:`start_profiler` / :func:`stop_profiler` — a profiler session,
  spans recorded, that writes a Chrome trace with the spans above the
  operators and kernels into a log directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from bisect import bisect_right
from collections import Counter
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

DEFAULT_CAPACITY = 10_000  # ≙ the reference controller's ring buffers


def _tree_map(fn, tree, *rest):
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name),
                              *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tensor tree: {type(tree)!r}")


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    _tree_map(lambda t: out.append(t) or t, tree)
    return out


@dataclass
class RingLog:
    """Fixed-capacity ring buffer over a sample tree."""

    buffers: Any  # tree; each leaf (capacity, *sample_shape)
    cursor: torch.Tensor  # () int32: the next write slot
    total: torch.Tensor  # () int32: samples ever written

    @property
    def capacity(self) -> int:
        return _leaves(self.buffers)[0].shape[0]


def ring_log(sample: Any, capacity: int = DEFAULT_CAPACITY) -> RingLog:
    """A log sized for ``sample``'s tree, on the sample's device."""
    bufs = _tree_map(lambda x: torch.zeros((capacity,) + tuple(x.shape),
                                           dtype=x.dtype, device=x.device),
                     sample)
    dev = _leaves(bufs)[0].device
    return RingLog(buffers=bufs,
                   cursor=torch.zeros((), dtype=torch.int32, device=dev),
                   total=torch.zeros((), dtype=torch.int32, device=dev))


def record(log: RingLog, sample: Any) -> RingLog:
    """Append one sample (pure; no host read)."""
    idx = log.cursor.reshape(1).long()
    bufs = _tree_map(lambda buf, x: torch.index_copy(
        buf, 0, idx, x.to(buf.dtype).unsqueeze(0)), log.buffers, sample)
    return RingLog(buffers=bufs,
                   cursor=torch.remainder(log.cursor + 1, log.capacity),
                   total=log.total + 1)


def capture(log: RingLog):
    """≙ ``/capture_log_data``: the samples on the host (numpy), oldest
    first, with a leading time axis of ``min(total, capacity)``."""
    total, cursor = (int(v) for v in torch.stack(
        [log.total, log.cursor]).cpu().tolist())
    cap = log.capacity
    n = min(total, cap)

    def order(buf):
        host = buf.detach().cpu().numpy()
        if total <= cap:
            return host[:n]
        return np.concatenate([host[cursor:], host[:cursor]], axis=0)

    return _tree_map(order, log.buffers)


class Timer:
    """Wall-clock pin/split timer with named laps
    (≙ ``std_utils::HighResolutionClockTimer``)."""

    def __init__(self):
        self._pins: dict[str, float] = {}
        self.laps: dict[str, list[float]] = {}

    def pin(self, name: str = "default") -> None:
        self._pins[name] = time.perf_counter()

    def split(self, name: str = "default") -> float:
        dt = time.perf_counter() - self._pins[name]
        self.laps.setdefault(name, []).append(dt)
        return dt

    def mean(self, name: str = "default") -> float:
        xs = self.laps.get(name, [])
        return sum(xs) / len(xs) if xs else float("nan")

    @contextlib.contextmanager
    def lap(self, name: str = "default"):
        self.pin(name)
        try:
            yield self
        finally:
            self.split(name)


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

counters: Counter = Counter()  # name -> count; a name never counted reads 0

OUTSIDE = "(outside program spans)"  # time and operations under no span
UNLINKED = "(launch not traced)"  # device operations with no runtime call


class Span(NamedTuple):
    """A recorded span. ``start_ns``/``end_ns`` are on the clock of the
    recorder until :func:`collect_spans` returns them on the profiler's
    (epoch nanoseconds, ``time.time_ns``). ``id`` is the span's sequence
    number since recording was turned on; ``parent`` the id of the span it
    opened inside (None for a root); ``call`` the sequence number of its
    root among the roots, shared by every span of one call."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    call: int
    thread: int  # the operating system's id of the recording thread
    attrs: dict


class _NoSpan:
    """What :func:`span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


class _Recorder:
    def __init__(self):
        self.on = False
        self.anchor = (0, 0)  # (time_ns, perf_counter_ns) taken together
        self.done: list[Span] = []  # finished spans, on perf_counter_ns
        self.ids = itertools.count()
        self.calls = itertools.count()
        # per thread: .stack, its open spans, and .thread, its operating
        # system id (a system call, so read once per thread)
        self.local = threading.local()

    def local_stack(self) -> tuple[list, int]:
        local = self.local
        try:
            return local.stack, local.thread
        except AttributeError:
            local.stack, local.thread = [], threading.get_native_id()
            return local.stack, local.thread


_RECORDER = _Recorder()


class _LiveSpan:
    __slots__ = ("name", "attrs", "id", "parent", "call", "thread", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack, self.thread = _RECORDER.local_stack()
        self.id = next(_RECORDER.ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, next(_RECORDER.calls)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _RECORDER.local.stack.pop()
        _RECORDER.done.append(Span(
            self.name, self.start, end, self.id, self.parent, self.call,
            self.thread, self.attrs))
        return None


def span(name: str, **attrs):
    """A context manager around one named host interval of the program,
    with ``attrs`` kept beside it. While recording is off (the default)
    it is one shared no-op object."""
    if not _RECORDER.on:
        return _NO_SPAN
    return _LiveSpan(name, attrs)


trace_annotation = span  # the reference's name for its timer hooks


def enable_spans() -> None:
    """Turn span recording on: drop what was recorded, restart the ids,
    and take the anchor that puts spans on the profiler's clock."""
    before = time.perf_counter_ns()
    now = time.time_ns()
    after = time.perf_counter_ns()
    _RECORDER.anchor = (now, (before + after) // 2)
    _RECORDER.done = []
    _RECORDER.ids, _RECORDER.calls = itertools.count(), itertools.count()
    _RECORDER.on = True


def disable_spans() -> None:
    """Turn span recording off; what was recorded stays to be collected."""
    _RECORDER.on = False


def collect_spans() -> list[Span]:
    """The spans finished since the last collection, in the order they
    finished, on the profiler's clock (epoch ns); the recorder drops them."""
    done, _RECORDER.done = _RECORDER.done, []
    shift = _RECORDER.anchor[0] - _RECORDER.anchor[1]
    return [s._replace(start_ns=s.start_ns + shift, end_ns=s.end_ns + shift)
            for s in done]


def self_ns(spans: list[Span]) -> dict[int, int]:
    """Each span's self time (its duration less its children's), by id."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


class DeviceOp(NamedTuple):
    """One device operation (kernel, copy, set) of a profiled window, on
    the profiler's clock; ``launch_ns`` is the start of the CUDA runtime
    or driver call that issued it, None where the profiler has none."""

    name: str
    start_ns: int
    end_ns: int
    launch_ns: int | None


def profiler_device_ops(prof) -> list[DeviceOp]:
    """The device operations of a finished ``torch.profiler.profile``
    session, each joined by correlation id to the CUDA runtime or driver
    call that launched it: a host event named ``cuda*`` or ``cu*`` (the
    operators' own events, ``aten::*``, count their ids apart)."""
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() == cpu and e.name().startswith("cu")}
    return [DeviceOp(e.name(), e.start_ns(), e.end_ns(),
                     launch.get(e.correlation_id()))
            for e in events if e.device_type() == cuda]


def _timeline(spans: list[Span]):
    """The timeline cut at every span's start and end: (starts, owners),
    ``owners[k]`` the innermost span (the latest opened) open from
    ``starts[k]`` to ``starts[k + 1]``, None where no span is open."""
    edges = sorted((t, opening, i) for i, s in enumerate(spans)
                   if s.end_ns > s.start_ns
                   for t, opening in ((s.start_ns, 1), (s.end_ns, 0)))
    starts, owners, open_ = [], [], set()
    for t, opening, i in edges:
        (open_.add if opening else open_.remove)(i)
        top = spans[max(open_, key=lambda j: (spans[j].start_ns, spans[j].id))
                    ] if open_ else None
        if starts and starts[-1] == t:
            owners[-1] = top
        else:
            starts.append(t)
            owners.append(top)
    return starts, owners


def idle_intervals(ops: list[DeviceOp]) -> list[tuple[int, int]]:
    """The device's idle intervals on the host's clock: its queue replayed
    in launch order, each operation starting at its launch or when the
    work queued before it ends, whichever is later, and running for its
    device duration; a gap runs from that end to the next launch. Device
    timestamps give durations only: the profiler's device clock can stand
    milliseconds off the host's within a window (PERF.md §6), while
    launches are host events. One in-order queue is assumed (the QP's and
    the loop's operations all go to the current stream); operations with
    no launch are left out."""
    gaps, busy_until = [], None
    for op in sorted((o for o in ops if o.launch_ns is not None),
                     key=lambda o: o.launch_ns):
        if busy_until is not None and op.launch_ns > busy_until:
            gaps.append((busy_until, op.launch_ns))
        start = (op.launch_ns if busy_until is None
                 else max(op.launch_ns, busy_until))
        busy_until = start + op.end_ns - op.start_ns
    return gaps


def attribute(ops: list[DeviceOp], spans: list[Span],
              key=lambda s: s.name) -> dict:
    """Where the device's operations and idle time go, by ``key(span)``:
    ``{key: {"ops", "device_s", "idle_s"}}``. Each operation goes to the
    innermost span open at its launch (:data:`OUTSIDE` where none is,
    :data:`UNLINKED` where the profiler kept no launch); each idle gap of
    :func:`idle_intervals` is split by time over the innermost spans open
    during it, the part under no span to :data:`OUTSIDE`, so that the
    host's time between two calls stays the caller's. Every time is the
    host's."""
    starts, owners = _timeline(spans)
    names = [OUTSIDE if s is None else key(s) for s in owners]
    out: dict = {}

    def row(name):
        return out.setdefault(name, {"ops": 0, "device_s": 0.0, "idle_s": 0.0})

    def name(k):  # of the timeline's piece k; -1 is before the first
        return names[k] if k >= 0 else OUTSIDE

    for op in ops:
        got = row(UNLINKED if op.launch_ns is None
                  else name(bisect_right(starts, op.launch_ns) - 1))
        got["ops"] += 1
        got["device_s"] += (op.end_ns - op.start_ns) * 1e-9
    for a, b in idle_intervals(ops):
        k = bisect_right(starts, a) - 1
        while a < b:
            end = min(b, starts[k + 1]) if k + 1 < len(starts) else b
            row(name(k))["idle_s"] += (end - a) * 1e-9
            a, k = end, k + 1
    return out


def _write_spans(path: str, spans: list[Span]) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` as complete events on
    the recording thread's row, on the trace's own time base."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name,
         "pid": os.getpid(), "tid": s.thread,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"call": s.call, "id": s.id, "parent": s.parent, **s.attrs}}
        for s in spans)
    with open(path, "w") as f:
        json.dump(trace, f)

_PROFILER: dict = {}


def start_profiler(logdir: str) -> None:
    """Start a ``torch.profiler`` session (CPU, and CUDA where a card is
    present) and span recording; :func:`stop_profiler` writes the Chrome
    trace to ``logdir``."""
    if _PROFILER:
        raise RuntimeError("a profiler session is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    enable_spans()
    prof.__enter__()
    _PROFILER.update(prof=prof, logdir=logdir)


def stop_profiler() -> str:
    """End the session and span recording; returns the path of the Chrome
    trace written, the session's spans in it as complete events."""
    prof, logdir = _PROFILER.pop("prof"), _PROFILER.pop("logdir")
    prof.__exit__(None, None, None)
    disable_spans()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _write_spans(path, collect_spans())
    return path
