"""The port's one CUDA-graph capture (:class:`Capture`) and a pure function
of tensors replayed from it (:class:`Graphed`, the closed loop's stages,
``rollout/closed_loop.py``): each stage's hundreds to thousands of small
launches, many of them made through ``torch.func`` transforms, cost the
host more time than the card takes to run them, and a replay is one
launch. The runtime's ticks (``runtime/graph.Tick``) and the headline's
chain of solves (``headline.ChainGraph``) are captured here too."""

from __future__ import annotations

from collections import Counter, OrderedDict

import torch

from ..types import map_tensors
from . import logging as qlog

KEPT = 2  # graphs each Graphed keeps, the last used last


def _leaves(tree) -> list:
    out = []
    map_tensors(tree, out.append)
    return out


def _key(obj):
    return obj if isinstance(obj, (bool, int, float, str, type(None))) else id(obj)


class Capture:
    """``fn()`` captured as a CUDA graph on ``device`` after ``warmups``
    eager runs on a side stream (they make the cached constants, library
    handles and workspaces, which a capture may not create); ``out`` is
    what the captured call returned, the graph's own tensors. The launch
    counters (``utils/logging.counters``) tick when a kernel is enqueued,
    so the capture's change to them, ``counted``, is taken back (nothing
    ran) and added again by every :meth:`replay`: a counted kernel inside
    the graph is counted once a replay. A capture that fails raises."""

    def __init__(self, fn, device: torch.device, warmups: int):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmups):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        before = Counter(qlog.counters)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        self.counted = Counter({k: v - before[k]
                                for k, v in qlog.counters.items()
                                if v != before[k]})
        qlog.counters.subtract(self.counted)
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        qlog.counters.update(self.counted)
        self.replays += 1


class _Capture(Capture):
    """``fn(*bound, *args)`` over static copies of ``args``, captured after
    one eager run."""

    def __init__(self, fn, bound, args):
        self.bound = bound  # the graph reads their tensors where they lie
        self.inputs = []
        self.args = map_tensors(
            args, lambda t: self.inputs.append(t.clone()) or self.inputs[-1])
        super().__init__(lambda: fn(*bound, *self.args),
                         self.inputs[0].device, warmups=1)

    def __call__(self, leaves):
        for static, t in zip(self.inputs, leaves):
            static.copy_(t)
        self.replay()
        return map_tensors(self.out, torch.clone)


class Graphed:
    """``fn(*bound, *args)``, the same kernels in the same order, replayed
    on the card from a CUDA graph captured at the first call of each ``bound`` (objects the
    graph reads in place, such as the model, or plain numbers) and layout
    of ``args`` (trees of tensors, copied in at every call); the last
    :data:`KEPT` graphs are kept. Off the card, inside a capture or with
    inputs that need gradients it calls ``fn`` itself. The result is the
    caller's own: the graph's outputs are copied out. A capture that fails
    raises."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs: OrderedDict = OrderedDict()

    def __call__(self, bound: tuple, *args):
        leaves = _leaves(args)
        if (not leaves[0].is_cuda or torch.cuda.is_current_stream_capturing()
                or any(t.requires_grad for t in leaves)):
            return self.fn(*bound, *args)
        key = (tuple(_key(b) for b in bound),
               tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))
        graph = self.graphs.pop(key, None)
        if graph is None:
            graph = _Capture(self.fn, bound, args)
            while len(self.graphs) >= KEPT:
                self.graphs.popitem(last=False)
        self.graphs[key] = graph
        return graph(leaves)
