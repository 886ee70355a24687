"""One runtime tick over static buffers, captured once as a CUDA graph on
the card (the port's counterpart of the JAX package compiling a tick
once with ``jax.jit`` and reusing it every tick)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..utils.cuda_graphs import Capture

WARMUP_RUNS = 2  # eager runs on a side stream before the capture


class Tick:
    """``fn()`` reads and writes only tensors that outlive it (the static
    buffers of its owner). On a CUDA ``device`` it is captured here
    (``utils/cuda_graphs.Capture``) after ``WARMUP_RUNS`` eager runs;
    ``keep`` lists the state tensors that those runs change and that are
    restored after the capture. Calling the tick then replays the graph:
    the same kernels in the same order. On the CPU calling it runs ``fn``
    eagerly. A capture that fails raises."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 keep: Sequence[torch.Tensor] = ()):
        self.fn = fn
        self.graph: Capture | None = None
        if device.type != "cuda":
            return
        saved = [t.clone() for t in keep]
        self.graph = Capture(fn, device, WARMUP_RUNS)
        for t, s in zip(keep, saved):
            t.copy_(s)

    @property
    def replays(self) -> int:
        return 0 if self.graph is None else self.graph.replays

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()
