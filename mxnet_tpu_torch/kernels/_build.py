"""Build the CUDA sources in ``csrc/`` at first use and load them with
ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

into ``build/`` under the repository root (listed in ``.gitignore``).  The
file name carries a hash of the source and the flags, so an edited source
never loads a stale library.  ``build_all()`` starts one ``nvcc`` for every
source at once; ``load(name)`` builds one source if needed and returns the
loaded library.  The ``-Xptxas -v`` report (registers, shared memory,
spills per kernel) is kept in ``build_logs`` and beside the library
(``build/<name>-<hash>.log``), so a library built earlier keeps its
report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

from ..base import MXNetError

__all__ = ["load", "build_all", "build_logs", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                         "build on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc (None when the library is already built)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise MXNetError(f"nvcc failed on csrc/{name}.cu "
                         f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Build every source in ``csrc/`` in parallel (one nvcc each, all
    started together); returns the ptxas reports of what was built."""
    with _lock:
        started = {n: _start(n) for n in sources()}
        for n, s in started.items():
            _finish(n, s)
    for n in started:
        if n not in build_logs:
            saved = _target(n).with_suffix(".log")
            build_logs[n] = saved.read_text() if saved.exists() else ""
    return {n: build_logs[n] for n in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
