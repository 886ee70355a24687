"""What a driver hands back to ``run.py``, and the context it runs in."""

from __future__ import annotations

from dataclasses import dataclass, field

import sys
import time

import torch


@dataclass
class Context:
    cell: object  # spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # wall clock (time.time()) at the start of the run's first process
    rank: int = 0
    world: int = 1


@dataclass
class Outcome:
    metrics: dict  # end-to-end metric name -> value (trace off)
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict  # number compared -> (value, limit)
    trace: object = None  # trace.Trace of the traced window (trace on)
    counts: dict = field(default_factory=dict)  # what the readers divide by

    @property
    def correct(self) -> bool:
        return all(value <= limit for value, limit in self.checks.values())


def no_larger_than(value: float) -> float:
    """A compared number as judged: NaN reads as infinity."""
    value = float(value)
    return float("inf") if value != value else value


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on a CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    """The process's peak of allocated device memory on ``device``."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def note(ctx: Context, what: str) -> None:
    """One line on standard error (rank 0): ``what`` and the seconds since
    the run started, so that the set-up's stages can be read apart."""
    if ctx.rank == 0:
        print(f"[{time.time() - ctx.t0:8.3f} s] {what}", file=sys.stderr,
              flush=True)
