"""One runtime tick over static buffers, captured once as a CUDA graph on
the card (the port's counterpart of the JAX package compiling a tick
once with ``jax.jit`` and reusing it every tick)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

WARMUP_RUNS = 2  # eager runs on a side stream before the capture


class Tick:
    """``fn()`` reads and writes only tensors that outlive it (the static
    buffers of its owner). On a CUDA ``device`` it is captured here, after
    ``WARMUP_RUNS`` eager runs on a side stream (they make the tick's
    cached constants, library handles and workspaces, which a capture may
    not create); ``keep`` lists the state tensors that those runs change
    and that are restored after the capture. Calling the tick then replays
    the graph: the same kernels in the same order. On the CPU calling it
    runs ``fn`` eagerly. A capture that fails raises."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 keep: Sequence[torch.Tensor] = ()):
        self.fn = fn
        self.graph: torch.cuda.CUDAGraph | None = None
        self.replays = 0
        if device.type != "cuda":
            return
        saved = [t.clone() for t in keep]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            fn()
        for t, s in zip(keep, saved):
            t.copy_(s)

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()
            self.replays += 1
