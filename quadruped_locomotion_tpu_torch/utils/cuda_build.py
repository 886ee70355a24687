"""The one seam between the port's Python and its hand-written CUDA
kernels (``csrc/``): :class:`CudaKernel` builds a kernel with ``nvcc``
into the package's ``build/`` directory once per source hash, loads it
with ``ctypes`` once per process, reads the launch geometry its library
reports, and at each launch checks the tensors once, allocates the
outputs, launches on the current stream, checks the return code and
counts the launch. ``ops/fd_qp_kernel.py`` (the force-distribution QP),
``rollout/articulated.py`` (the articulated plant's step) and
``control/swing.py`` (the swing-leg torques) each declare their kernel as
one :class:`CudaKernel`; the last two read the robot model as
:func:`pack_model` packs it."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING

import torch

from . import logging as qlog

if TYPE_CHECKING:
    from ..types import RobotModel

BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class KernelBuild:
    path: Path  # the shared library
    seconds: float  # nvcc wall time of this process's build, 0.0 if reused
    log: str  # nvcc / ptxas output (-Xptxas -v: registers, spills)
    # launch geometry, read from the library: a block of threads_per_block
    # holds instances_per_block (a half-warp, 16 lanes, solves one QP
    # instance; a warp steps one scenario of the articulated plant)
    threads_per_block: int
    instances_per_block: int
    # cudaOccupancyMaxActiveBlocksPerMultiprocessor of the kernel
    resident_blocks_per_sm: int


def ptxas_report(log: str) -> dict:
    """Registers, shared memory, stack frame and spill bytes of the kernel
    from ``-Xptxas -v`` output (largest over the functions listed). Raises
    ValueError if the log holds no such report."""
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", log)
    used = re.findall(r"Used (\d+) registers", log)
    smem = re.findall(r"(\d+) bytes smem", log)
    if not frames or not used:
        raise ValueError("no ptxas register/spill report in the build log")
    top = lambda rows, i: max(int(r[i]) for r in rows)  # noqa: E731
    return dict(registers=max(map(int, used)),
                smem_bytes=max(map(int, smem), default=0),
                stack_bytes=top(frames, 0), spill_store_bytes=top(frames, 1),
                spill_load_bytes=top(frames, 2))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


def compile_library(source: Path) -> tuple[Path, float, str]:
    """Compile the CUDA source ``source`` with :data:`NVCC_FLAGS` into a
    shared library under ``build/``, named by the source's stem and a hash
    of the source and flags, unless it is there. Returns (the library,
    nvcc's wall time in this process, 0.0 if reused, its ptxas log).
    Raises if nvcc fails."""
    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        # both renames are atomic: a process that finds the library (ranks
        # of one host may build at once) finds its whole log beside it
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp_log, log_path)
        os.replace(tmp, so)
    return so, seconds, log_path.read_text() if log_path.exists() else ""


# RobotModel's fields in the order the kernels' Model struct reads them
MODEL_FIELDS = ("hip_pos", "hip_rot", "d", "l1", "l2", "link_mass",
                "link_com", "link_inertia", "base_mass", "leg_mass",
                "base_inertia", "hip_offset", "com_in_base", "joint_damping")
MODEL_FLOATS = 120

# the packings of the live model objects, by id (each entry goes with its
# model: a kernel packed inside a CUDA graph's capture would read memory
# that only the graph's replays fill, so every model the kernels are given
# keeps its own packing)
_packed: dict[int, torch.Tensor] = {}


def pack_model(model: RobotModel) -> torch.Tensor:
    """(120,) float32: the model's tensors in :data:`MODEL_FIELDS` order,
    on the model's device; packed at the first call for a model object and
    reused while it lives (a model is never written in place)."""
    key = id(model)
    packed = _packed.get(key)
    if packed is None:
        packed = torch.cat([getattr(model, f).reshape(-1).to(torch.float32)
                            for f in MODEL_FIELDS])
        _packed[key] = packed
        weakref.finalize(model, _packed.pop, key, None)
    return packed


@dataclass(frozen=True)
class Arg:
    """A tensor of a kernel's C entry: its name, its shape after the
    leading batch axis B (its whole shape where ``batched`` is False) and
    its dtype."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    batched: bool = True


class CudaKernel:
    """The kernel of ``source`` whose C entry ``<prefix>`` takes a pointer
    to each of ``inputs`` and then of ``outputs``, the batch size B (an
    int), one argument of each ctypes type in ``scalars`` and the CUDA
    stream, and returns a CUDA error code; ``<prefix>_error_string`` reads
    the code. Built and loaded at the first launch or :meth:`build` of the
    process. Every launch adds 1 to ``counters["<counter>.kernel_launches"]``
    and B to ``counters["<counter>.kernel_instances"]`` (``utils/logging``)."""

    def __init__(self, source: Path, prefix: str, counter: str,
                 inputs: tuple[Arg, ...], outputs: tuple[Arg, ...],
                 scalars: tuple = ()):
        self.source, self.prefix = source, prefix
        self.inputs, self.outputs, self.scalars = inputs, outputs, scalars
        self._launches = f"{counter}.kernel_launches"
        self._instances = f"{counter}.kernel_instances"
        self._entry = self._build = None

    def build(self) -> KernelBuild:
        """:func:`compile_library` and ``ctypes`` once per process. The
        library's C entries ``<prefix>_threads_per_block``,
        ``<prefix>_instances_per_block`` and
        ``<prefix>_resident_blocks_per_sm`` give its launch geometry (the
        last a CUDA error code, negated, if the occupancy query fails).
        Raises if nvcc or the occupancy query fails."""
        if self._build is None:
            prefix = self.prefix
            so, seconds, log = compile_library(self.source)
            lib = ctypes.CDLL(str(so))
            error_string = getattr(lib, f"{prefix}_error_string")
            error_string.argtypes = [ctypes.c_int]
            error_string.restype = ctypes.c_char_p
            resident = getattr(lib, f"{prefix}_resident_blocks_per_sm")()
            if resident <= 0:
                raise RuntimeError(f"{prefix} occupancy query failed: "
                                   + error_string(-resident).decode())
            entry = getattr(lib, prefix)
            entry.argtypes = ([ctypes.c_void_p] * (len(self.inputs)
                                                   + len(self.outputs))
                              + [ctypes.c_int, *self.scalars, ctypes.c_void_p])
            entry.restype = ctypes.c_int
            self._entry, self._error_string = entry, error_string
            self._build = KernelBuild(
                path=so, seconds=seconds, log=log,
                threads_per_block=getattr(lib, f"{prefix}_threads_per_block")(),
                instances_per_block=getattr(
                    lib, f"{prefix}_instances_per_block")(),
                resident_blocks_per_sm=resident)
        return self._build

    def geometry(self, batch: int) -> dict:
        """The launch at ``batch`` from the library's geometry: threads and
        instances per block, blocks, the blocks an SM holds at once, and
        ``slot_share``, the share of the running warps' instance slots (a
        half-warp for the QP, the warp for the plant) that carry an
        instance (a warp whose first instance lies beyond B returns at
        once). Builds the kernel if needed."""
        build = self.build()
        per_block = build.instances_per_block
        per_warp = per_block * 32 // build.threads_per_block
        return dict(threads_per_block=build.threads_per_block,
                    instances_per_block=per_block,
                    resident_blocks_per_sm=build.resident_blocks_per_sm,
                    blocks=-(-batch // per_block),
                    slot_share=batch / (per_warp * -(-batch // per_warp)))

    def check(self, *tensors: torch.Tensor) -> int:
        """Raises ValueError, naming the tensor, what was expected and what
        was got, unless ``tensors`` are the inputs in order, each of its
        shape (the first batched one's B leading), its dtype, contiguous
        and on the first input's device. Returns B. Any device passes
        here; :meth:`__call__` also requires CUDA."""
        dev = tensors[0].device
        lead = next(t.shape[:1] for t, a in zip(tensors, self.inputs)
                    if a.batched)
        for t, a in zip(tensors, self.inputs):
            shape = (*lead, *a.shape) if a.batched else a.shape
            if t.shape != shape:
                expected, got = f"shape {shape}", f"shape {tuple(t.shape)}"
            elif t.dtype != a.dtype:
                expected, got = a.dtype, t.dtype
            elif not t.is_contiguous():
                expected, got = "a contiguous tensor", f"strides {t.stride()}"
            elif t.device != dev:
                expected = f"a tensor on {dev}, {self.inputs[0].name}'s device"
                got = t.device
            else:
                continue
            raise ValueError(f"{a.name}: expected {expected}, got {got}")
        return lead[0]

    def __call__(self, *args):
        """One launch on the current stream: ``args`` are the input tensors
        (read in place) and then the scalars. Returns the outputs, newly
        allocated on the inputs' device, in order. Raises ValueError on
        inputs that :meth:`check` refuses or that are not on a CUDA device
        (before any build), RuntimeError if the kernel cannot be built or
        launched."""
        n = len(self.inputs)
        tensors, scalars = args[:n], args[n:]
        B = self.check(*tensors)
        dev = tensors[0].device
        if dev.type != "cuda":
            raise ValueError(f"{self.inputs[0].name}: expected a CUDA tensor "
                             f"({self.prefix} needs CUDA), got {dev}")
        if self._entry is None:
            self.build()
        outs = tuple(torch.empty((B, *a.shape), dtype=a.dtype, device=dev)
                     for a in self.outputs)
        rc = self._entry(*(t.data_ptr() for t in tensors),
                         *(t.data_ptr() for t in outs), B, *scalars,
                         torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.prefix} launch failed: "
                               + self._error_string(rc).decode())
        qlog.counters[self._launches] += 1
        qlog.counters[self._instances] += B
        return outs
