"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library with a
plain C interface -> ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into
``build/analytics_zoo_tpu_torch/lib<name>-<hash>.so`` beside the package
(the hash covers the source, every header ``csrc/*.cuh``, the flags and
any macros defined for the build, so an edited source or header never
loads a stale library).  No
PyTorch headers are involved, which keeps a build to seconds.  Nothing is
compiled at import: the CPU tests import every module on machines with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple, Union

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "analytics_zoo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
# name -> wall seconds of the nvcc run (absent when the library was cached)
BUILD_SECONDS: Dict[str, float] = {}
# name -> the compiler's stderr (ptxas register / shared-memory report):
# this process's build, or the report kept beside a cached library
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels build on a machine with the CUDA toolkit")
    return path


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of every header ``csrc/*.cuh`` (whether or not this source
    includes it, so an edited header rebuilds every kernel), of the flags
    and of ``defines`` (``-D`` macros: a variant of the source)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def report_path(library: Path) -> Path:
    """Where the compiler's report of ``library``'s build is kept."""
    return library.with_name(library.name + ".ptxas.txt")


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with the ``-D`` macros ``defines``)
    unless its library is already built.  The output is written under a
    temporary name and renamed, so a concurrent build never loads a
    half-written file.  The compiler's report is written beside the
    library before it, and a library counts as built only with its
    report, which is read back into ``BUILD_LOG``."""
    out = library_path(name, defines)
    report = report_path(out)
    if out.exists() and report.exists():
        if not defines:
            BUILD_LOG[name] = report.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    tmp_report = report.with_name(f"{tmp.name}.ptxas.txt")
    tmp_report.write_text(proc.stderr)
    os.replace(tmp_report, report)
    os.replace(tmp, out)
    if not defines:
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = proc.stderr
    return out


def build_all(names: Iterable[Union[str, Tuple[str, Sequence[str]]]]
              ) -> None:
    """Build several kernels at once: one ``nvcc`` per source (a name, or
    a name and its ``defines``), all started together."""
    jobs = [(n, ()) if isinstance(n, str) else n for n in names]
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        for fut in [pool.submit(build, n, d) for n, d in jobs]:
            fut.result()


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (with ``defines``),
    built on first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, key[1])))
            _libs[key] = lib
        return lib
