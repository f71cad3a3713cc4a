"""Multi-tensor SGD update: two hand-written CUDA kernels for Hopper and
their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``mxnet_tpu/kernels/multi_sgd.py``:
``sgd_kernel`` (``fused_multi_sgd``) and ``sgd_mom_kernel``
(``fused_multi_sgd_mom``).  For every tensor ``t`` of a group, in place:

    c   = g * rescale_grad, clipped to [-clip, clip] when clip_gradient > 0
    sgd:      w = w - lr_t * (c + wd_t * w)
    sgd_mom:  m = momentum * m - lr_t * (c + wd_t * w);  w = w + m

Both run one pass over memory and are bound by bytes: 12 bytes per element
(read w, g; write w) and 20 for the momentum form (read w, g, m; write w,
m), over the card's 3.35 TB/s.  The kernels (``csrc/multi_sgd.cu``) are a
multi-tensor apply: a table of pointers, sizes and each tensor's lr and
wd, passed by value, covers up to ``MAX_TENSORS`` tensors per launch; a
larger group takes several launches.  Each launch is sized to the card by
:func:`_launch_plans`: work items ("tiles") of a power of two between
``MIN_TILE`` and ``MAX_TILE`` elements, the largest that still gives about
``TILES_PER_SM`` tiles per SM, walked grid-stride by at most
``BLOCKS_PER_SM`` blocks per SM, so even a group of a few small tensors
spreads over every SM; each thread keeps 4 16-byte loads of every array
in flight.  The kernels round each operation as the plain version does,
so the two agree bit for bit.

``multi_sgd`` and ``multi_sgd_mom`` are the wrappers.  On CPU tensors they
run the plain version; on CUDA tensors they launch the kernel (fp32,
contiguous) or raise.  ``lrs``/``wds`` are sequences of host numbers (a
list, a numpy array, a CPU tensor).  Each wrapper counts its kernel
launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..base import MXNetError

__all__ = ["multi_sgd", "multi_sgd_mom", "multi_sgd_plain",
           "multi_sgd_mom_plain", "MAX_TENSORS"]

MAX_TENSORS = 64          # kMaxTensors of csrc/multi_sgd.cu
MIN_TILE, MAX_TILE = 512, 8192
BLOCKS_PER_SM = 3         # kBlocksPerSm: what the registers let stay resident
TILES_PER_SM = 2          # the least tiles per SM a tile size must give
_count_lock = threading.Lock()


class LaunchPlan(NamedTuple):
    """One kernel launch over the tensors ``[lo, hi)`` of a group:
    ``tile`` elements per work item, ``starts`` the prefix sums of each
    tensor's tiles (``starts[-1]`` tiles in all) and ``grid`` blocks, all
    handed to the kernel as they are."""
    lo: int
    hi: int
    tile: int
    starts: Tuple[int, ...]
    grid: int


def _tiles(n: int, tile: int) -> int:
    return -(-n // tile)


@functools.lru_cache(maxsize=1024)
def _launch_plans(sizes: Tuple[int, ...], num_sms: int) -> Tuple[LaunchPlan,
                                                                   ...]:
    """The launches of one group of tensors of ``sizes`` elements on a card
    with ``num_sms`` SMs: one per ``MAX_TENSORS`` tensors that hold at
    least one element.  The tile is the largest power of two in
    [``MIN_TILE``, ``MAX_TILE``] that gives at least ``TILES_PER_SM`` *
    ``num_sms`` tiles, else ``MIN_TILE``; tiles never span two tensors.
    The grid is min(tiles, ``BLOCKS_PER_SM`` * ``num_sms``): each block
    walks tiles b, b + grid, b + 2 grid and so on.  The kernel takes the
    plan as it is."""
    plans = []
    for lo in range(0, len(sizes), MAX_TENSORS):
        part = sizes[lo:lo + MAX_TENSORS]
        if not any(part):
            continue
        tile = MAX_TILE
        while (tile > MIN_TILE and sum(_tiles(n, tile) for n in part)
               < TILES_PER_SM * num_sms):
            tile //= 2
        starts = tuple(itertools.accumulate(
            (_tiles(n, tile) for n in part), initial=0))
        plans.append(LaunchPlan(lo, lo + len(part), tile, starts,
                                min(starts[-1], BLOCKS_PER_SM * num_sms)))
    return tuple(plans)


_sms: Dict[int, int] = {}


def _num_sms(device: torch.device) -> int:
    """The SM count of a CUDA device, read once per device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _clip(clip_gradient: Optional[float]) -> float:
    return -1.0 if clip_gradient is None else float(clip_gradient)


def _step(w, g, lr, wd, rescale_grad, clip):
    """``lr * (c(g) + wd * w)``, one rounding per operation."""
    c = g * rescale_grad
    if clip > 0:
        c = c.clamp(-clip, clip)
    return (c + wd * w) * lr


def multi_sgd_plain(weights: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], lrs, wds,
                    rescale_grad: float = 1.0,
                    clip_gradient: Optional[float] = -1.0) -> None:
    """The plain PyTorch version of ``sgd_kernel``, in place on
    ``weights``."""
    clip = _clip(clip_gradient)
    for w, g, lr, wd in zip(weights, grads, _floats(lrs), _floats(wds)):
        w.sub_(_step(w, g, lr, wd, rescale_grad, clip))


def multi_sgd_mom_plain(weights: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        moms: Sequence[torch.Tensor], lrs, wds,
                        momentum: float = 0.0, rescale_grad: float = 1.0,
                        clip_gradient: Optional[float] = -1.0) -> None:
    """The plain PyTorch version of ``sgd_mom_kernel``, in place on
    ``weights`` and ``moms``."""
    clip = _clip(clip_gradient)
    for w, g, m, lr, wd in zip(weights, grads, moms, _floats(lrs),
                               _floats(wds)):
        m.mul_(momentum).sub_(_step(w, g, lr, wd, rescale_grad, clip))
        w.add_(m)


def _floats(values) -> List[float]:
    return [float(v) for v in values]


_fn = None


def _kernel():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("multi_sgd").mxtpu_multi_sgd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + \
            [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, groups):
    """Every tensor of ``groups`` (lists of equal length) on one CUDA
    device, fp32, contiguous, and of its weight's size."""
    dev = groups[0][0].device
    for group in groups:
        for w, t in zip(groups[0], group):
            if t.device != dev:
                raise MXNetError(f"{name}: tensors on {t.device} and {dev}")
            if t.dtype != torch.float32:
                raise MXNetError(f"{name} kernel: dtype {t.dtype}; it "
                                 f"takes float32")
            if not t.is_contiguous():
                raise MXNetError(f"{name}: tensors must be contiguous")
            if t.numel() != w.numel():
                raise MXNetError(f"{name}: {tuple(t.shape)} does not match "
                                 f"its weight's {tuple(w.shape)}")


def _launch(wrapper, weights, grads, moms, lrs, wds, momentum,
            rescale_grad, clip) -> None:
    """Launch ``csrc/multi_sgd.cu`` on the current CUDA stream, as
    :func:`_launch_plans` plans it: one launch per ``MAX_TENSORS`` tensors
    that hold at least one element."""
    groups = [weights, grads] + ([moms] if moms is not None else [])
    _check(wrapper.__name__, groups)
    fn = _kernel()
    dev = weights[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = tuple(t.numel() for t in weights)
    for plan in _launch_plans(sizes, _num_sms(dev)):
        lo, hi = plan.lo, plan.hi
        k = hi - lo
        ptrs = [(ctypes.c_uint64 * k)(*(t.data_ptr() for t in grp[lo:hi]))
                for grp in groups]
        n = (ctypes.c_longlong * k)(*sizes[lo:hi])
        starts = (ctypes.c_int * (k + 1))(*plan.starts)
        lr = (ctypes.c_float * k)(*lrs[lo:hi])
        wd = (ctypes.c_float * k)(*wds[lo:hi])
        m_ptr = ptrs[2] if moms is not None else ptrs[0]
        err = fn(k, ctypes.addressof(ptrs[0]), ctypes.addressof(ptrs[1]),
                 ctypes.addressof(m_ptr), ctypes.addressof(n),
                 ctypes.addressof(starts), ctypes.addressof(lr), ctypes.addressof(wd),
                 int(moms is not None), float(momentum),
                 float(rescale_grad), clip, plan.tile, plan.grid, stream)
        if err != 0:
            raise MXNetError(f"{wrapper.__name__} kernel launch failed: "
                             f"CUDA error {err}")
        with _count_lock:
            wrapper.launches += 1


def _group(name, weights, others, lrs, wds):
    """The device type of a group, and its lrs/wds as host floats, after
    checking that every list has one entry per weight."""
    lrs, wds = _floats(lrs), _floats(wds)
    sizes = {len(weights), len(lrs), len(wds), *map(len, others)}
    if not weights or len(sizes) != 1:
        raise MXNetError(f"{name}: {len(weights)} weights, "
                         f"{[len(o) for o in others]} grads/moms, "
                         f"{len(lrs)} lrs, {len(wds)} wds")
    return weights[0].device.type, lrs, wds


def multi_sgd(weights: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], lrs, wds,
              rescale_grad: float = 1.0,
              clip_gradient: Optional[float] = -1.0) -> None:
    """SGD over a group, in place: the ``sgd_kernel`` kernel on CUDA
    tensors, :func:`multi_sgd_plain` on CPU tensors."""
    dev, lrs, wds = _group("multi_sgd", weights, [grads], lrs, wds)
    if dev == "cpu":
        multi_sgd_plain(weights, grads, lrs, wds, rescale_grad,
                        clip_gradient)
    elif dev == "cuda":
        _launch(multi_sgd, weights, grads, None, lrs, wds, 0.0,
                rescale_grad, _clip(clip_gradient))
    else:
        raise MXNetError(f"multi_sgd: no kernel for device {dev}")


def multi_sgd_mom(weights: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor],
                  moms: Sequence[torch.Tensor], lrs, wds,
                  momentum: float = 0.0, rescale_grad: float = 1.0,
                  clip_gradient: Optional[float] = -1.0) -> None:
    """SGD with momentum over a group, in place on weights and momenta:
    the ``sgd_mom_kernel`` kernel on CUDA tensors,
    :func:`multi_sgd_mom_plain` on CPU tensors."""
    dev, lrs, wds = _group("multi_sgd_mom", weights, [grads, moms], lrs,
                           wds)
    if dev == "cpu":
        multi_sgd_mom_plain(weights, grads, moms, lrs, wds, momentum,
                            rescale_grad, clip_gradient)
    elif dev == "cuda":
        _launch(multi_sgd_mom, weights, grads, moms, lrs, wds, momentum,
                rescale_grad, _clip(clip_gradient))
    else:
        raise MXNetError(f"multi_sgd_mom: no kernel for device {dev}")


multi_sgd.launches = 0
multi_sgd_mom.launches = 0
