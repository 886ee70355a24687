"""Building and loading the port's hand-written CUDA kernels (``csrc/``):
``nvcc`` into the package's ``build/`` directory once per source hash, a
``ctypes`` library once per process, and the launch geometry each library
reports. ``ops/fd_qp_kernel.py`` (the force-distribution QP) and
``rollout/articulated.py`` (the articulated plant's step) load theirs
through :func:`load_kernel`."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

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


def load_kernel(source: Path, prefix: str) -> tuple[ctypes.CDLL, KernelBuild]:
    """:func:`compile_library` of ``source``, loaded with ``ctypes``. The
    library's C entries ``<prefix>_threads_per_block``,
    ``<prefix>_instances_per_block`` and ``<prefix>_resident_blocks_per_sm``
    give its launch geometry (the last a CUDA error code, negated, if the
    occupancy query fails), and ``<prefix>_error_string`` a CUDA error
    code's text. Returns (the library, its build). Raises if nvcc or the
    occupancy query fails."""
    so, seconds, log = compile_library(source)
    lib = ctypes.CDLL(str(so))
    error_string = getattr(lib, f"{prefix}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    resident = getattr(lib, f"{prefix}_resident_blocks_per_sm")()
    if resident <= 0:
        raise RuntimeError(f"{prefix} occupancy query failed: "
                           + error_string(-resident).decode())
    return lib, KernelBuild(
        path=so, seconds=seconds, log=log,
        threads_per_block=getattr(lib, f"{prefix}_threads_per_block")(),
        instances_per_block=getattr(lib, f"{prefix}_instances_per_block")(),
        resident_blocks_per_sm=resident)
