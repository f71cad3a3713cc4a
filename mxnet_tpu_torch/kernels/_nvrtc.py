"""A private ctypes binding of NVRTC and the CUDA driver API, for ``rtc``.

NVRTC compiles a CUDA C++ source string to a CUBIN for Hopper
(``--gpu-architecture=sm_90a``); the driver API loads it
(``cuModuleLoadData``), looks kernels up (``cuModuleGetFunction``) and
launches them on a torch stream (``cuLaunchKernel``).  Both libraries are
loaded at first use, never at import, so that this module imports on a
machine without CUDA; there, the first call raises ``MXNetError``.

Where the libraries are looked for, in order: the CUDA toolkit
(``$CUDA_HOME``, else ``/usr/local/cuda``, ``lib64``), the NVIDIA wheel
that PyTorch's CUDA build depends on (``site-packages/nvidia/
cuda_nvrtc/lib``), then the dynamic loader's own path.  ``libcuda`` comes
with the driver.  The toolkit's ``include`` directory is passed to NVRTC
(``-I``) so that a source can include ``cuda_fp16.h``.

Every driver call runs with the device's primary context current on the
calling thread (``cuDevicePrimaryCtxRetain``, then ``cuCtxSetCurrent`` where
another context is current): PyTorch's runtime uses that context, but a
thread that has made no runtime call, such as the one on which torch runs
a backward pass, may have none current.
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["compile_program", "load_module", "unload_module",
           "get_function", "set_max_dynamic_shared", "launch",
           "STATIC_SHARED_LIMIT"]

ARCH = "sm_90a"
STATIC_SHARED_LIMIT = 48 * 1024     # above it, dynamic shared memory only
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_CUDA_ERROR_NOT_FOUND = 500

_c_p = ctypes.c_void_p
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_primary: Dict[int, ctypes.c_void_p] = {}


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _nvrtc_dirs() -> List[Path]:
    dirs = [_cuda_home() / "lib64"]
    import torch
    dirs.append(Path(torch.__file__).resolve().parents[1] / "nvidia"
                / "cuda_nvrtc" / "lib")
    return dirs


def _open_nvrtc() -> ctypes.CDLL:
    tried = []
    for d in _nvrtc_dirs():
        libs = sorted(d.glob("libnvrtc.so*"))
        if not libs:
            tried.append(str(d))
            continue
        # libnvrtc loads its builtins library by name; load it first from
        # the same directory so that the two always match
        for b in sorted(d.glob("libnvrtc-builtins.so*")):
            ctypes.CDLL(str(b), mode=ctypes.RTLD_GLOBAL)
            break
        return ctypes.CDLL(str(libs[-1]))
    for name in ("libnvrtc.so.12", "libnvrtc.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            tried.append(name)
    raise MXNetError(f"NVRTC not found (looked in {tried}); rtc compiles "
                     f"on a machine with the CUDA toolkit or PyTorch's "
                     f"CUDA wheels")


def _open_cuda() -> ctypes.CDLL:
    for name in ("libcuda.so.1", "libcuda.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise MXNetError("libcuda (the CUDA driver) not found; rtc launches "
                     "kernels on an NVIDIA card")


def _declare(lib, specs):
    for name, restype, argtypes in specs:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _nvrtc() -> ctypes.CDLL:
    with _lock:
        lib = _libs.get("nvrtc")
        if lib is None:
            lib = _open_nvrtc()
            i, p, sz, s = ctypes.c_int, _c_p, ctypes.c_size_t, ctypes.c_char_p
            _declare(lib, [
                ("nvrtcGetErrorString", s, [i]),
                ("nvrtcCreateProgram", i, [ctypes.POINTER(_c_p), s, s, i,
                                           p, p]),
                ("nvrtcAddNameExpression", i, [p, s]),
                ("nvrtcCompileProgram", i, [p, i, ctypes.POINTER(s)]),
                ("nvrtcGetProgramLogSize", i, [p, ctypes.POINTER(sz)]),
                ("nvrtcGetProgramLog", i, [p, ctypes.c_char_p]),
                ("nvrtcGetCUBINSize", i, [p, ctypes.POINTER(sz)]),
                ("nvrtcGetCUBIN", i, [p, ctypes.c_char_p]),
                ("nvrtcGetLoweredName", i, [p, s, ctypes.POINTER(s)]),
                ("nvrtcDestroyProgram", i, [ctypes.POINTER(_c_p)]),
            ])
            _libs["nvrtc"] = lib
    return lib


def _cuda() -> ctypes.CDLL:
    with _lock:
        lib = _libs.get("cuda")
        if lib is None:
            lib = _open_cuda()
            i, u, p = ctypes.c_int, ctypes.c_uint, _c_p
            _declare(lib, [
                ("cuInit", i, [u]),
                ("cuGetErrorString", i, [i, ctypes.POINTER(ctypes.c_char_p)]),
                ("cuDeviceGet", i, [ctypes.POINTER(i), i]),
                ("cuDevicePrimaryCtxRetain", i, [ctypes.POINTER(p), i]),
                ("cuCtxGetCurrent", i, [ctypes.POINTER(p)]),
                ("cuCtxSetCurrent", i, [p]),
                ("cuModuleLoadData", i, [ctypes.POINTER(p), p]),
                ("cuModuleUnload", i, [p]),
                ("cuModuleGetFunction", i, [ctypes.POINTER(p), p,
                                            ctypes.c_char_p]),
                ("cuFuncSetAttribute", i, [p, i, i]),
                ("cuLaunchKernel", i, [p, u, u, u, u, u, u, u, p, p, p]),
            ])
            _check(lib, lib.cuInit(0), "cuInit")
            _libs["cuda"] = lib
    return lib


def _check(lib, res: int, what: str) -> None:
    if res != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(res, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise MXNetError(f"{what} failed: CUDA error {res} ({text})")


def _nvrtc_check(lib, res: int, what: str) -> None:
    if res != 0:
        raise MXNetError(f"{what} failed: "
                         f"{lib.nvrtcGetErrorString(res).decode()}")


def _log(lib, prog) -> str:
    size = ctypes.c_size_t()
    lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
    buf = ctypes.create_string_buffer(size.value)
    lib.nvrtcGetProgramLog(prog, buf)
    return buf.value.decode(errors="replace")


def compile_program(source: str, options: Sequence[str] = (),
                    exports: Sequence[str] = ()
                    ) -> Tuple[bytes, Dict[str, str], str]:
    """Compile ``source``: returns the CUBIN, the lowered (mangled) name of
    every name expression in ``exports``, and NVRTC's log.  A compile
    error raises ``MXNetError`` carrying the log."""
    lib = _nvrtc()
    opts = list(options)
    if not any(o.startswith(("-arch", "--gpu-architecture")) for o in opts):
        opts.insert(0, f"--gpu-architecture={ARCH}")
    inc = _cuda_home() / "include"
    if inc.is_dir():
        opts.append(f"-I{inc}")
    prog = _c_p()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_source.cu", 0, None,
        None), "nvrtcCreateProgram")
    try:
        for name in exports:
            _nvrtc_check(lib, lib.nvrtcAddNameExpression(prog, name.encode()),
                         f"nvrtcAddNameExpression({name!r})")
        c_opts = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), c_opts)
        log = _log(lib, prog)
        if res != 0:
            raise MXNetError(
                f"NVRTC failed to compile the CUDA source "
                f"({lib.nvrtcGetErrorString(res).decode()}), options "
                f"{opts}:\n{log}")
        size = ctypes.c_size_t()
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            _nvrtc_check(lib, lib.nvrtcGetLoweredName(
                prog, name.encode(), ctypes.byref(out)),
                f"nvrtcGetLoweredName({name!r})")
            lowered[name] = out.value.decode()
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(lib, device: int) -> None:
    """The device's primary context current on this thread."""
    ctx = _primary.get(device)
    if ctx is None:
        with _lock:
            ctx = _primary.get(device)
            if ctx is None:
                dev = ctypes.c_int()
                _check(lib, lib.cuDeviceGet(ctypes.byref(dev), device),
                       "cuDeviceGet")
                ctx = _c_p()
                _check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                         dev.value),
                       "cuDevicePrimaryCtxRetain")
                _primary[device] = ctx
    cur = _c_p()
    _check(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def load_module(cubin: bytes, device: int) -> int:
    """Load a CUBIN on ``device``; returns the module handle."""
    lib = _cuda()
    _make_current(lib, device)
    mod = _c_p()
    _check(lib, lib.cuModuleLoadData(ctypes.byref(mod), cubin),
           "cuModuleLoadData")
    return mod.value


def unload_module(module: int, device: int) -> None:
    """Unload a module, unless the interpreter is already shutting down
    (its context may be gone; the process's exit frees it)."""
    lib = _libs.get("cuda")
    if lib is None or sys.is_finalizing():
        return
    _make_current(lib, device)
    lib.cuModuleUnload(module)


def get_function(module: int, name: str, device: int) -> Optional[int]:
    """The kernel ``name`` (its lowered name) in ``module``, or None when
    the module has no such symbol."""
    lib = _cuda()
    _make_current(lib, device)
    fn = _c_p()
    res = lib.cuModuleGetFunction(ctypes.byref(fn), module, name.encode())
    if res == _CUDA_ERROR_NOT_FOUND:
        return None
    _check(lib, res, f"cuModuleGetFunction({name!r})")
    return fn.value


def set_max_dynamic_shared(function: int, nbytes: int, device: int) -> None:
    lib = _cuda()
    _make_current(lib, device)
    _check(lib, lib.cuFuncSetAttribute(
        function, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, nbytes),
        "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")


def launch(function: int, grid: Sequence[int], block: Sequence[int],
           shared_mem: int, stream: int, params, device: int) -> None:
    """``cuLaunchKernel`` with ``params``, a ctypes array of pointers to
    each argument's storage (the caller keeps the storage alive)."""
    lib = _cuda()
    _make_current(lib, device)
    _check(lib, lib.cuLaunchKernel(function, *grid, *block, shared_mem,
                                   stream, params, None), "cuLaunchKernel")
