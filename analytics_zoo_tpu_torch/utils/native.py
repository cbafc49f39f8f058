"""ctypes bindings for the repository's native sample store
(``csrc/sample_store.cpp``): the JAX package's ``utils/native.py`` for the
port.

The C++ source is the repository's own, read where it is.  It is host code
(no CUDA), built with ``g++`` on first use into
``build/analytics_zoo_tpu_torch/libsamplestore-<hash>.so``, the hash taken
over the source and the flags.  The build writes a temporary name and
publishes it with ``os.replace``, so another process that loads the
library meanwhile (the JAX package builds its own copy elsewhere; tests
run in parallel) never maps a half-written file.  A failed build raises
with the compiler's output; there is no pure-Python store to fall back
to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "csrc" / "sample_store.cpp"
BUILD_DIR = _REPO / "build" / "analytics_zoo_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the store builds to: the name carries a hash of the source
    and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libsamplestore-{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Build the store unless this source's library is there; returns its
    path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {SOURCE.name} failed (exit {res.returncode}): "
                f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.ss_create.restype = ctypes.c_void_p
            lib.ss_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int64]
            lib.ss_write.restype = ctypes.c_int
            lib.ss_write.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int64]
            lib.ss_write_bulk.restype = ctypes.c_int
            lib.ss_write_bulk.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_void_p, ctypes.c_int64]
            lib.ss_gather.restype = ctypes.c_int
            lib.ss_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_int]
            lib.ss_size.restype = ctypes.c_int64
            lib.ss_size.argtypes = [ctypes.c_void_p]
            lib.ss_destroy.restype = None
            lib.ss_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class NativeSampleStore:
    """Fixed-stride sample arena with parallel minibatch gather.

    `path=None` -> anonymous RAM arena (DRAM tier); a file path -> mmap'd arena
    (DISK_AND_DRAM/PMEM tier)."""

    def __init__(self, n_samples: int, sample_shape, dtype=np.float32,
                 path: Optional[str] = None, n_threads: int = 4):
        self.lib = get_lib()
        self.sample_shape = tuple(int(i) for i in sample_shape)
        self.dtype = np.dtype(dtype)
        self.sample_bytes = int(np.prod(self.sample_shape) * self.dtype.itemsize)
        self.n_samples = int(n_samples)
        self.n_threads = n_threads
        self._h = self.lib.ss_create(
            path.encode() if path else None, self.n_samples, self.sample_bytes)
        if not self._h:
            raise MemoryError("failed to create native sample store")

    def write_bulk(self, start: int, samples: np.ndarray):
        arr = np.ascontiguousarray(samples, self.dtype)
        if arr.shape[1:] != self.sample_shape:
            raise ValueError(f"samples of shape {arr.shape[1:]}, the store "
                             f"holds {self.sample_shape}")
        rc = self.lib.ss_write_bulk(self._h, start,
                                    arr.ctypes.data_as(ctypes.c_void_p),
                                    arr.shape[0])
        if rc != 0:
            raise IndexError("write_bulk out of range")

    def gather(self, indices: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(indices, np.int64)
        out = np.empty((idx.shape[0],) + self.sample_shape, self.dtype)
        rc = self.lib.ss_gather(self._h, idx.ctypes.data_as(ctypes.c_void_p),
                                idx.shape[0],
                                out.ctypes.data_as(ctypes.c_void_p),
                                self.n_threads)
        if rc != 0:
            raise IndexError("gather index out of range")
        return out

    def close(self):
        if self._h:
            self.lib.ss_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        return self.n_samples
