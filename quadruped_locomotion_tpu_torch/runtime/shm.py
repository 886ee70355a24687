"""ctypes binding of the native shared-memory ring (≙ ``quadruped_locomotion_tpu/
runtime/shm.py``): the realtime transport between a robot bus process
and the control process, a single-writer latest-value ring with a seqlock
per slot (``native/shm_ring.c``).

The C source is read in place from the repository's ``native/`` directory
and never modified; it is compiled on first use with the system C
compiler into this package's ``build/`` directory, named by a hash of the
source and flags, so that the reference's own build output
(``native/_shm_ring.so``) is neither read nor written.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "shm_ring.c"
BUILD_DIR = _PKG / "build"
CC_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``native/shm_ring.c`` into ``build/`` (once per source
    hash) and return the library's path. Raises if the compiler fails."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(CC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"shm_ring-{digest[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cc = os.environ.get("CC", "cc")
        proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cc} failed with code {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        u32, u64, ptr = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p
        for name, args, res in (
            ("qlt_ring_create", [ctypes.c_char_p, u32, u32], ctypes.c_int),
            ("qlt_ring_open", [ctypes.c_char_p], ptr),
            ("qlt_ring_push", [ptr, ptr, u32], ctypes.c_int64),
            ("qlt_ring_pop_latest", [ptr, ptr, u32], ctypes.c_int64),
            ("qlt_ring_read_at", [ptr, u64, ptr, u32], ctypes.c_int64),
            ("qlt_ring_head", [ptr], u64),
            ("qlt_ring_slot_size", [ptr], u32),
            ("qlt_ring_close", [ptr], None),
            ("qlt_ring_unlink", [ctypes.c_char_p], ctypes.c_int),
        ):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
        return lib


class ShmRing:
    """Single-writer / multi-reader latest-value ring over POSIX shared
    memory; each slot holds one flat float32 sample."""

    def __init__(self, name: str, ptr: int, slot_size: int):
        self._name = name
        self._ptr = ptr
        self.slot_size = slot_size

    @classmethod
    def create(cls, name: str, slot_floats: int, n_slots: int = 64):
        rc = _load().qlt_ring_create(name.encode(), 4 * slot_floats, n_slots)
        if rc != 0:
            raise OSError(f"qlt_ring_create({name}) failed: {rc}")
        return cls.open(name)

    @classmethod
    def open(cls, name: str):
        lib = _load()
        ptr = lib.qlt_ring_open(name.encode())
        if not ptr:
            raise OSError(f"qlt_ring_open({name}) failed")
        return cls(name, ptr, lib.qlt_ring_slot_size(ptr))

    def close(self) -> None:
        if self._ptr:
            _load().qlt_ring_close(self._ptr)
            self._ptr = 0

    @staticmethod
    def unlink(name: str) -> None:
        _load().qlt_ring_unlink(name.encode())

    def push(self, vec: np.ndarray) -> int:
        """Publish one float32 sample; never blocks. Returns its index."""
        v = np.ascontiguousarray(vec, np.float32)
        if v.nbytes > self.slot_size:
            raise ValueError("sample larger than slot")
        idx = _load().qlt_ring_push(
            self._ptr, v.ctypes.data_as(ctypes.c_void_p), v.nbytes)
        if idx < 0:
            raise OSError(f"push failed: {idx}")
        return int(idx)

    def pop_latest(self, n_floats: int):
        """The newest complete sample as (index, vector), or None."""
        out = np.empty(n_floats, np.float32)
        idx = _load().qlt_ring_pop_latest(
            self._ptr, out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
        if idx < 0:
            return None
        return int(idx), out

    def read_at(self, idx: int, n_floats: int):
        """The sample of index ``idx`` if still held, else None."""
        out = np.empty(n_floats, np.float32)
        rc = _load().qlt_ring_read_at(
            self._ptr, ctypes.c_uint64(idx),
            out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
        return None if rc < 0 else out

    @property
    def head(self) -> int:
        return int(_load().qlt_ring_head(self._ptr))
