"""The traced window: the card's activity under ``torch.profiler`` and what
the per-layer readers and the result line take from it.

Only device activity (kernels, copies, sets) is recorded: a planner tick
issues tens of thousands of host operators, and parsing their events
costs more than the window. The busy and idle arithmetic follows
``scripts/profile_torch_rollout.py`` (commit 8388f9c), with busy time
taken as the union of the operations' intervals so that operations that
overlap on two streams (a collective beside a kernel) count once.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass

import torch

NAME_CHARS = 160  # kernel names are C++ signatures; the ledger keeps the head
TOP = 10  # entries of each breakdown list


@dataclass
class Trace:
    ops: list  # (name, start_us, end_us) of every device operation
    window_s: float  # host clock over the traced window, synchronised

    def count(self, keep=lambda name: True) -> int:
        return sum(1 for name, _, _ in self.ops if keep(name))

    def seconds(self, keep=lambda name: True) -> float:
        """Summed device time of the operations ``keep`` selects."""
        return sum(end - start for name, start, end in self.ops
                   if keep(name)) * 1e-6

    def _merged(self):
        spans = sorted((start, end, name) for name, start, end in self.ops)
        merged = []  # [start, end, name of the first op, name of the last op]
        for start, end, name in spans:
            if merged and start <= merged[-1][1]:
                if end > merged[-1][1]:
                    merged[-1][1], merged[-1][3] = end, name
            else:
                merged.append([start, end, name, name])
        return merged

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(end - start for start, end, _, _ in self._merged()) * 1e-6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps between operations, each named by the operation before and
        the one after it (what the host was dispatching between them)."""
        by_op, by_gap = {}, {}
        for name, start, end in self.ops:
            key = name[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + (end - start) * 1e-6
        merged = self._merged()
        for before, after in zip(merged, merged[1:]):
            key = f"{short_name(before[3])} -> {short_name(after[2])}"
            by_gap[key] = by_gap.get(key, 0.0) + (after[0] - before[1]) * 1e-6
        top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                               key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def traced(fn, device):
    """Run ``fn`` under the profiler on ``device``: (its result, the Trace
    of the window, from a synchronised start to a synchronised end)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    ops = [(e.name, float(e.time_range.start), float(e.time_range.end))
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the profiler recorded no device activity")
    return out, Trace(ops, window)


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists; for
    PyTorch's elementwise and reduction kernels, with the functor that
    says what they compute."""
    name = name.replace("(anonymous namespace)::", "")
    head = re.sub(r"^(void |std::enable_if<[^>]*>::type )", "", name)
    head = re.split(r"[<(]", head, maxsplit=1)[0].strip()
    for pattern in (r"\w*Functor\w*", r"\w*_kernel_cuda\w*", r"\w*Op\b"):
        what = re.search(pattern, name)
        if what and what.group(0) not in head:
            return f"{head}[{what.group(0)}]"[:NAME_CHARS]
    return head[:NAME_CHARS]


def is_collective(name: str) -> bool:
    return "nccl" in name.lower()
