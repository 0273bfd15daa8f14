"""Build, load and count the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`
(no PyTorch headers, so a build takes seconds).  Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout; a library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused; the compiler's output (ptxas's
register and spill report) is kept beside each library.  All sources are
compiled together, one ``nvcc`` process each, at first use: importing
this module compiles nothing.

Each C launcher takes device pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()``; :func:`check` raises on a non-zero
code.  Each wrapper adds one to its kernel's launch count
(:func:`count_launch`) where it launches, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
_launches: Dict[str, int] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _report(src: Path) -> Path:
    return _target(src).with_suffix(".log")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def ensure_built() -> float:
    """Compile every source whose library is missing, all at once.
    Returns the wall seconds spent (0.0 when everything was built)."""
    with _lock:
        todo = [(s, _target(s)) for s in sources()
                if not (_target(s).exists() and _report(s).exists())]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cc = nvcc()
        t0 = time.perf_counter()
        procs = []
        for src, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                [cc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                _report(src).write_text(log)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return time.perf_counter() - t0


def report(name: str) -> str:
    """The compiler's output of the build of ``csrc/<name>.cu``, built
    first if needed."""
    ensure_built()
    return _report(CSRC / f"{name}.cu").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        ensure_built()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(CSRC /
                                                            f"{name}.cu")))
    return lib


def function(lib: str, name: str, argtypes: Sequence):
    """A C launcher with its argument types declared; returns ``int``."""
    key = (lib, name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: error {err}")


def count_launch(kernel: str) -> None:
    _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()
