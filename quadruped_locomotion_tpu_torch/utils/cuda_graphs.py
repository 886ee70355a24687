"""A pure function of tensors replayed from a CUDA graph on the card (the
closed loop's stages, ``rollout/closed_loop.py``): each stage's hundreds
to thousands of small launches, many of them made through ``torch.func``
transforms, cost the host more time than the card takes to run them, and
a replay is one launch."""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..types import map_tensors

KEPT = 2  # graphs each Graphed keeps, the last used last


def _leaves(tree) -> list:
    out = []
    map_tensors(tree, out.append)
    return out


def _key(obj):
    return obj if isinstance(obj, (bool, int, float, str, type(None))) else id(obj)


class _Capture:
    """``fn(*bound, *args)`` over static copies of ``args``, captured after
    one eager run on a side stream (it makes the cached constants and the
    library handles and workspaces, which a capture may not create)."""

    def __init__(self, fn, bound, args):
        self.bound = bound  # the graph reads their tensors where they lie
        self.inputs = []
        self.args = map_tensors(
            args, lambda t: self.inputs.append(t.clone()) or self.inputs[-1])
        device = self.inputs[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*bound, *self.args)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*bound, *self.args)
        self.replays = 0

    def __call__(self, leaves):
        for static, t in zip(self.inputs, leaves):
            static.copy_(t)
        self.graph.replay()
        self.replays += 1
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
