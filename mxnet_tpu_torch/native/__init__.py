"""The host-side native io core, built at first use with g++ and bound
with ctypes.

Counterpart of ``mxnet_tpu/native/__init__.py`` (:38-104: ``_build``,
``load_io``, ``io_available``) for ``io_core.cc`` alone; the predict,
symbol and ndarray C ABIs are not ported.  The core is host C++, not a
device kernel:

    g++ -O3 -std=c++17 -shared -fPIC -o build/libmxio-<hash>.so
        native/io_core.cc -ljpeg -lpthread

into ``build/`` under the repository root (listed in ``.gitignore``),
never beside its source, so it cannot collide with the JAX package's
``libmxtpu_io.so``.  The name carries a hash of the source and the flags;
the compiler writes a temporary name that ``os.replace`` moves into
place, so processes that build at once each load a whole library.  Where
libjpeg's headers or library are missing the core is built again with
``-DMXIO_NO_JPEG`` (``RAWN`` records only; a JPEG record fails its batch
with an error naming the missing decoder); ``has_jpeg()`` says which.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["load_io", "io_available", "has_jpeg", "SOURCE", "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parent / "io_core.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
JPEG_LIBS = ["-ljpeg", "-lpthread"]
NO_JPEG = ["-DMXIO_NO_JPEG", "-lpthread"]

_LOCK = threading.Lock()
_LIB = None
_LOAD_ERR = None


def _target(extra: list) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS + extra)
                       .encode())
    return BUILD_DIR / f"libmxio-{h.hexdigest()[:16]}.so"


def _build(extra: list) -> Path:
    """The library built with ``extra`` flags (built now if missing)."""
    out = _target(extra)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE), *extra]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise MXNetError(f"native io build failed: {e}") from e
    if r.returncode != 0:
        raise MXNetError(
            f"native io build failed: {' '.join(cmd)}\n{r.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def _bind(lib) -> None:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.MXIOCreate.restype = ctypes.c_void_p
    lib.MXIOCreate.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, c_float_p, c_float_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.MXIONext.restype = ctypes.c_int
    lib.MXIONext.argtypes = [ctypes.c_void_p, c_float_p, c_float_p]
    lib.MXIONumSamples.restype = ctypes.c_int64
    lib.MXIONumSamples.argtypes = [ctypes.c_void_p]
    lib.MXIONumBatches.restype = ctypes.c_int64
    lib.MXIONumBatches.argtypes = [ctypes.c_void_p]
    lib.MXIOHasJpeg.restype = ctypes.c_int
    lib.MXIOHasJpeg.argtypes = []
    lib.MXIOLastError.restype = ctypes.c_char_p
    lib.MXIOLastError.argtypes = [ctypes.c_void_p]
    lib.MXIOReset.argtypes = [ctypes.c_void_p]
    lib.MXIODestroy.argtypes = [ctypes.c_void_p]


def load_io():
    """The loaded io core (built at first use); cached process-wide.
    Raises ``MXNetError`` when no build succeeds."""
    global _LIB, _LOAD_ERR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LOAD_ERR is not None:
            raise _LOAD_ERR
        errors = []
        for extra in (JPEG_LIBS, NO_JPEG):
            try:
                lib = ctypes.CDLL(str(_build(extra)))
                break
            except (MXNetError, OSError) as e:
                errors.append(str(e))
        else:
            _LOAD_ERR = MXNetError(
                "cannot build or load the native io core:\n"
                + "\n".join(errors))
            raise _LOAD_ERR
        _bind(lib)
        _LIB = lib
        return _LIB


def io_available() -> bool:
    try:
        load_io()
        return True
    except MXNetError:
        return False


def has_jpeg() -> bool:
    """Whether the loaded io core decodes JPEG (built with libjpeg)."""
    return bool(load_io().MXIOHasJpeg())
