"""Kernels compiled at run time from CUDA source strings: ``CudaModule``
and ``CudaKernel``.

Counterpart of ``mxnet_tpu/rtc.py``, whose ``PallasKernel._build`` (:50)
hands a user's Pallas kernel function to ``pl.pallas_call``.  On the card
the user's kernel language is CUDA C++, so the port has the API of
upstream MXNet 1.x's ``mx.rtc``:

    mod = CudaModule(source, options=(), exports=())
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha, int n")
    k.launch([x, y, 2.0, n], gpu(0), grid_dims=(g, 1, 1),
             block_dims=(256, 1, 1), shared_mem=0)

- ``CudaModule`` compiles ``source`` with NVRTC for ``sm_90a`` when it is
  built (``compile_ms`` records how long that took) and loads the CUBIN
  with ``cuModuleLoadData`` on each device at first use.  A compile error
  raises ``MXNetError`` carrying NVRTC's log; so does a machine without
  NVRTC, the CUDA driver or a card.  There is no CPU fallback.
- ``get_kernel(name, signature)``: ``name`` is an ``extern "C"`` kernel, or
  a C++ name expression listed in ``exports`` (a template instance
  ``"axpy<float>"``, a name in a namespace), which NVRTC lowers to its
  mangled symbol.  ``signature`` lists the kernel's C parameters,
  comma-separated: ``[const] T *name`` is a tensor, ``[const] T name`` a
  scalar, the name optional, with ``T`` one of ``float``, ``double``,
  ``__half``, ``uint8_t``, ``int8_t``, ``char``, ``int``, ``int32_t``,
  ``int64_t``.  Anything else is refused.
- ``CudaKernel.launch(args, ctx, grid_dims, block_dims, shared_mem=0)``
  checks every argument against the signature before any driver call
  (an array, ``NDArray`` or tensor, or a number; dtype, device ``ctx``,
  contiguous), then launches on
  ``torch.cuda.current_stream(ctx)`` without synchronising.  A launch
  asking for more than 48 KB of dynamic shared memory raises the kernel's
  limit first (``cuFuncSetAttribute``).  A driver error raises
  ``MXNetError`` with the driver's text.

Launches write in place into the arrays passed, as upstream's did.  The
JAX package's ``PallasKernel.launch`` returns a new array instead, only
because TPU buffers are immutable.

Each ``CudaKernel`` counts its launches in ``launches``; the module-level
``launches`` is the total over every kernel.  ``PallasModule`` and
``PallasKernel`` raise: a Pallas kernel function cannot target this card.
"""
from __future__ import annotations

import ctypes
import re
import threading
import time
import weakref
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError
from .context import DeviceLike, as_device
from .kernels import _nvrtc, counters
from .ndarray.ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel"]

launches = 0                 # every CudaKernel's launches, in total

# C type -> (tensor dtype, ctypes type of a scalar)
_CPP_TYPES: Dict[str, Tuple[torch.dtype, type]] = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
}
_ARG = re.compile(r"^\s*(const\s+)?(\w+)\s*(\*)?\s*(\w+)?\s*$")


class _Arg:
    __slots__ = ("text", "ctype", "dtype", "is_tensor")

    def __init__(self, text: str, ctype: str, is_tensor: bool):
        self.text = text
        self.ctype = ctype
        self.dtype = _CPP_TYPES[ctype][0]
        self.is_tensor = is_tensor


def parse_signature(signature: str) -> List[_Arg]:
    """The parameters of a kernel's C signature (see the module
    docstring); an empty signature is a kernel without parameters."""
    if not signature.strip():
        return []
    out = []
    for text in signature.split(","):
        m = _ARG.match(text)
        if not m or m.group(2) == "const":
            raise MXNetError(f"invalid kernel parameter {text.strip()!r}: "
                             f"the form is '[const] type [*] [name]'")
        if m.group(2) not in _CPP_TYPES:
            raise MXNetError(f"unsupported kernel parameter type in "
                             f"{text.strip()!r}; supported: "
                             f"{', '.join(_CPP_TYPES)}")
        out.append(_Arg(text.strip(), m.group(2), bool(m.group(3))))
    return out


def _dims(name: str, dims) -> Tuple[int, int, int]:
    if len(dims) != 3 or not all(isinstance(d, (int, np.integer)) and d > 0
                                 for d in dims):
        raise MXNetError(f"{name} must be 3 positive integers, got {dims}")
    return tuple(int(d) for d in dims)


def _scalar(arg: _Arg, value, i: int):
    """The ctypes storage of a scalar argument, checked against its C
    type."""
    ctype = _CPP_TYPES[arg.ctype][1]
    if isinstance(value, torch.Tensor) or not isinstance(
            value, (int, float, np.integer, np.floating)):
        raise MXNetError(f"argument {i} ({arg.text}) takes a number, got "
                         f"{type(value).__name__}")
    if arg.dtype.is_floating_point:
        if arg.ctype == "__half":
            return ctype(int(np.float16(value).view(np.uint16)))
        return ctype(float(value))
    if not isinstance(value, (int, np.integer)):
        raise MXNetError(f"argument {i} ({arg.text}) takes an integer, got "
                         f"{value!r}")
    info = torch.iinfo(arg.dtype)
    if not info.min <= int(value) <= info.max:
        raise MXNetError(f"argument {i} ({arg.text}): {value} is out of "
                         f"range for {arg.ctype}")
    return ctype(int(value))


class CudaKernel:
    """A kernel of a :class:`CudaModule`, with its parsed signature; made
    by ``CudaModule.get_kernel``."""

    def __init__(self, module: "CudaModule", name: str, symbol: str,
                 args: List[_Arg]):
        self._module = module
        self.name = name
        self._symbol = symbol
        self._args = args
        self._raised: Dict[int, int] = {}   # device -> dynamic smem limit
        self.launches = 0

    def _check_args(self, args: Sequence, dev: torch.device) -> List:
        if len(args) != len(self._args):
            raise MXNetError(f"CudaKernel({self.name}) takes "
                             f"{len(self._args)} arguments, got {len(args)}")
        storage = []
        for i, (arg, value) in enumerate(zip(self._args, args)):
            if not arg.is_tensor:
                storage.append(_scalar(arg, value, i))
                continue
            if isinstance(value, NDArray):
                value = value._data
            if not isinstance(value, torch.Tensor):
                raise MXNetError(f"argument {i} ({arg.text}) takes an "
                                 f"NDArray or a tensor, got "
                                 f"{type(value).__name__}")
            if value.dtype != arg.dtype:
                raise MXNetError(f"argument {i} ({arg.text}) takes "
                                 f"{arg.dtype}, got {value.dtype}")
            if value.device != dev:
                raise MXNetError(f"argument {i} ({arg.text}) is on "
                                 f"{value.device}, the launch on {dev}")
            if not value.is_contiguous():
                raise MXNetError(f"argument {i} ({arg.text}) must be "
                                 f"contiguous")
            storage.append(ctypes.c_void_p(value.data_ptr()))
        return storage

    def launch(self, args: Sequence, ctx: DeviceLike,
               grid_dims: Sequence[int], block_dims: Sequence[int],
               shared_mem: int = 0) -> None:
        """Launch on ``ctx``'s current stream; writes into the tensors in
        ``args``.  Does not synchronise."""
        dev = as_device(ctx)
        if dev.type != "cuda":
            raise MXNetError(f"CudaKernel({self.name}): a CUDA kernel "
                             f"launches on a CUDA device, not {dev}")
        grid, block = _dims("grid_dims", grid_dims), \
            _dims("block_dims", block_dims)
        if shared_mem < 0:
            raise MXNetError(f"shared_mem {shared_mem} < 0")
        storage = self._check_args(args, dev)
        params = (ctypes.c_void_p * max(1, len(storage)))(
            *[ctypes.addressof(s) for s in storage])
        fn = self._module._function(self._symbol, dev.index)
        if shared_mem > self._raised.get(dev.index,
                                         _nvrtc.STATIC_SHARED_LIMIT):
            _nvrtc.set_max_dynamic_shared(fn, shared_mem, dev.index)
            self._raised[dev.index] = shared_mem
        stream = torch.cuda.current_stream(dev).cuda_stream
        _nvrtc.launch(fn, grid, block, shared_mem, stream, params, dev.index)
        counters.bump(self, "launches")
        counters.bump(globals(), "launches")


class CudaModule:
    """CUDA C++ ``source`` compiled by NVRTC for ``sm_90a`` (see the module
    docstring).  ``options`` go to NVRTC as they are; ``exports`` are the
    C++ name expressions that ``get_kernel`` may ask for."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        options = (options,) if isinstance(options, str) else tuple(options)
        exports = (exports,) if isinstance(exports, str) else tuple(exports)
        t0 = time.perf_counter()
        self._cubin, self._lowered, self.log = _nvrtc.compile_program(
            source, options, exports)
        self.compile_ms = (time.perf_counter() - t0) * 1e3
        self._exports = exports
        self._modules: Dict[int, int] = {}       # device -> CUmodule
        self._functions: Dict[Tuple[int, str], int] = {}
        self._lock = threading.Lock()
        weakref.finalize(self, _unload_all, self._modules).atexit = False
        if not torch.cuda.is_available():
            raise MXNetError("CudaModule: no CUDA device; rtc kernels run "
                             "on an NVIDIA card")
        self._module(torch.cuda.current_device())

    def _module(self, device: int) -> int:
        with self._lock:
            mod = self._modules.get(device)
            if mod is None:
                mod = _nvrtc.load_module(self._cubin, device)
                self._modules[device] = mod
        return mod

    def _function(self, symbol: str, device: int) -> int:
        fn = self._functions.get((device, symbol))
        if fn is None:
            fn = _nvrtc.get_function(self._module(device), symbol, device)
            if fn is None:
                raise MXNetError(
                    f"no kernel {symbol!r} in the module: a __global__ "
                    f"function without extern \"C\" has a mangled C++ "
                    f"name; declare it extern \"C\", or pass its name "
                    f"expression in exports=(...) (exported: "
                    f"{list(self._exports)})")
            self._functions[(device, symbol)] = fn
        return fn

    def get_kernel(self, name: str, signature: str) -> CudaKernel:
        """The kernel ``name`` with its C ``signature``."""
        args = parse_signature(signature)
        symbol = self._lowered.get(name, name)
        self._function(symbol, torch.cuda.current_device())
        return CudaKernel(self, name, symbol, args)


def _unload_all(modules: Dict[int, int]) -> None:
    for device, mod in modules.items():
        _nvrtc.unload_module(mod, device)


class PallasKernel:
    """The JAX package's runtime-compiled Pallas kernel: not on this
    card."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "PallasKernel/PallasModule compile Pallas kernel functions for "
            "a TPU; on this card write the kernel in CUDA C++ and compile "
            "it with mxnet_tpu_torch.rtc.CudaModule")


class PallasModule(PallasKernel):
    """The JAX package's container of Pallas kernels: not on this card."""
