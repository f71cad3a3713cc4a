"""Multi-tensor SGD update: hand-written CUDA kernels for Hopper and their
plain PyTorch versions.

Replaces the Pallas TPU kernels of ``mxnet_tpu/kernels/multi_sgd.py``:
``sgd_kernel`` (``fused_multi_sgd``) and ``sgd_mom_kernel``
(``fused_multi_sgd_mom``).  For every tensor ``t`` of a group, in place:

    c   = g * rescale_grad, clipped to [-clip, clip] when clip_gradient > 0
    sgd:      w = w - lr_t * (c + wd_t * w)
    sgd_mom:  m = momentum * m - lr_t * (c + wd_t * w);  w = w + m

Two families of wrappers:

- ``multi_sgd`` / ``multi_sgd_mom``: w, g (and m) in one dtype, float32,
  bfloat16 or float16, as the TPU kernel works in the weights' dtype.
  The JAX package's rounding holds: lr, wd and momentum are rounded to
  the weight's dtype and ``rescale_grad`` and the clip to the gradient's
  (``fused_multi_sgd*`` packs them in ``result_type(weights[0])`` and
  multiplies the gradient in its own dtype before the kernel, where
  Python scalars take the array's dtype).  The arithmetic runs in fp32
  from the stored values, ``c`` is rounded to the gradient's dtype, and
  each result is rounded once to nearest even (m first; w from the
  rounded m).  In fp32 every rounding is the identity.
- ``multi_mp_sgd`` / ``multi_mp_sgd_mom``, the mixed-precision update of
  ``multi_mp_sgd_mom_update`` (and ``mp_sgd_update``): bf16/fp16 weights
  and gradients, fp32 momenta and fp32 masters ``w32``.  The fp32 update
  runs on the master from the fp32-cast gradient (fp32 scalars), and
  each weight becomes its updated master rounded to its dtype, in the
  same pass (the JAX op casts the masters into the weights afterwards).

All are bound by bytes: per element 12 (fp32 sgd: read w, g; write w),
20 (fp32 sgd_mom, and the mixed momentum form: read g 2 + m 4 + w32 4,
write m 4 + w32 4 + w 2), 6 and 10 (bf16/fp16), 12 (mixed without
momentum), over the card's 3.35 TB/s.  The kernels
(``csrc/multi_sgd.cu``) are a multi-tensor apply: a table of pointers,
sizes and each tensor's lr and wd, passed by value, covers up to
``MAX_TENSORS`` tensors per launch; a larger group takes several
launches.  Each launch is sized to the card by :func:`_launch_plans`:
work items ("tiles") of a power of two between ``MIN_TILE`` and
``MAX_TILE`` fp32 elements (in 16-byte vectors: a 2-byte dtype's tile
holds twice the elements), the largest that still gives about
``TILES_PER_SM`` tiles per SM, walked grid-stride by at most
``BLOCKS_PER_SM`` blocks per SM, so even a group of a few small tensors
spreads over every SM; each thread keeps 16 elements of every array in
flight in 16-byte loads.  The kernels round each operation as the plain
versions do, so the two agree bit for bit.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernel (contiguous tensors of a dtype it takes) or raise.
``lrs``/``wds`` are sequences of host numbers (a list, a numpy array, a
CPU tensor).  Each wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from . import counters

__all__ = ["multi_sgd", "multi_sgd_mom", "multi_mp_sgd", "multi_mp_sgd_mom",
           "multi_sgd_plain", "multi_sgd_mom_plain", "multi_mp_sgd_plain",
           "multi_mp_sgd_mom_plain", "MAX_TENSORS"]

MAX_TENSORS = 64          # kMaxTensors of csrc/multi_sgd.cu
MIN_TILE, MAX_TILE = 512, 8192    # fp32 elements; x 2 in a 2-byte dtype
BLOCKS_PER_SM = 3         # kBlocksPerSm: what the registers let stay resident
TILES_PER_SM = 2          # the least tiles per SM a tile size must give
# the kernel's dtype codes (of w and g) and modes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LOW = (torch.bfloat16, torch.float16)
SGD, SGD_MOM, MP_SGD, MP_SGD_MOM = range(4)


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
def _launch_plans(sizes: Tuple[int, ...], num_sms: int,
                  vec: int = 4) -> Tuple[LaunchPlan, ...]:
    """The launches of one group of tensors of ``sizes`` elements on a card
    with ``num_sms`` SMs, ``vec`` elements to a 16-byte vector (4 fp32, 8
    bf16/fp16): one per ``MAX_TENSORS`` tensors that hold at least one
    element.  The tile is the largest power of two in [``MIN_TILE``,
    ``MAX_TILE``] x ``vec / 4`` that gives at least ``TILES_PER_SM`` *
    ``num_sms`` tiles, else the least; tiles never span two tensors.
    The grid is min(tiles, ``BLOCKS_PER_SM`` * ``num_sms``): each block
    walks tiles b, b + grid, b + 2 grid and so on.  The kernel takes the
    plan as it is."""
    min_tile, max_tile = MIN_TILE * vec // 4, MAX_TILE * vec // 4
    plans = []
    for lo in range(0, len(sizes), MAX_TENSORS):
        part = sizes[lo:lo + MAX_TENSORS]
        if not any(part):
            continue
        tile = max_tile
        while (tile > min_tile and sum(_tiles(n, tile) for n in part)
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


@functools.lru_cache(maxsize=4096)
def round_scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` through fp32 into ``dtype``, to nearest even, as a host
    float: what a Python scalar becomes next to an array of ``dtype`` in
    the JAX package."""
    return torch.tensor(float(x), dtype=torch.float32).to(dtype).item()


class _Scalars(NamedTuple):
    lrs: List[float]
    wds: List[float]
    momentum: float
    rescale: float
    clip: float


def _scalars(w_dtype, g_dtype, lrs, wds, momentum, rescale_grad,
             clip_gradient) -> _Scalars:
    """The update's scalars rounded as the JAX package rounds them: lr, wd
    and momentum to the weight's dtype, rescale and clip to the
    gradient's (fp32 for the mixed update, whose weight is the master)."""
    def rw(x):
        return round_scalar(float(x), w_dtype)

    def rg(x):
        return round_scalar(float(x), g_dtype)
    clip = _clip(clip_gradient)
    return _Scalars([rw(v) for v in lrs], [rw(v) for v in wds], rw(momentum),
                    rg(rescale_grad), rg(clip) if clip > 0 else clip)


def _step(w32, g, lr, wd, rescale, clip):
    """``lr * (c + wd * w)`` in fp32 from the fp32 weight ``w32`` and the
    stored gradient, one rounding per operation; ``c = g * rescale`` is
    rounded to the gradient's dtype and then clipped."""
    c = g.float() * rescale
    if g.dtype != torch.float32:
        c = c.to(g.dtype).float()
    if clip > 0:
        c = c.clamp(-clip, clip)
    return (c + wd * w32) * lr


def multi_sgd_plain(weights: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], lrs, wds,
                    rescale_grad: float = 1.0,
                    clip_gradient: Optional[float] = -1.0) -> None:
    """The plain PyTorch version of ``sgd_kernel``, in place on
    ``weights``."""
    for w, g, lr, wd in zip(weights, grads, lrs, wds):
        s = _scalars(w.dtype, g.dtype, [lr], [wd], 0.0, rescale_grad,
                     clip_gradient)
        w32 = w.float()
        w.copy_(w32 - _step(w32, g, s.lrs[0], s.wds[0], s.rescale, s.clip))


def multi_sgd_mom_plain(weights: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        moms: Sequence[torch.Tensor], lrs, wds,
                        momentum: float = 0.0, rescale_grad: float = 1.0,
                        clip_gradient: Optional[float] = -1.0) -> None:
    """The plain PyTorch version of ``sgd_mom_kernel``, in place on
    ``weights`` and ``moms``."""
    for w, g, m, lr, wd in zip(weights, grads, moms, lrs, wds):
        s = _scalars(w.dtype, g.dtype, [lr], [wd], momentum, rescale_grad,
                     clip_gradient)
        w32 = w.float()
        step = _step(w32, g, s.lrs[0], s.wds[0], s.rescale, s.clip)
        m.copy_(m.float() * s.momentum - step)
        w.copy_(w32 + m.float())


def multi_mp_sgd_plain(weights: Sequence[torch.Tensor],
                       grads: Sequence[torch.Tensor],
                       weights32: Sequence[torch.Tensor], lrs, wds,
                       rescale_grad: float = 1.0,
                       clip_gradient: Optional[float] = -1.0) -> None:
    """The plain PyTorch version of the mixed update without momentum
    (``mp_sgd_update``): the fp32 update of each master ``w32`` from the
    fp32-cast gradient, then the master rounded into its weight."""
    s = _scalars(torch.float32, torch.float32, lrs, wds, 0.0, rescale_grad,
                 clip_gradient)
    for w, g, w32, lr, wd in zip(weights, grads, weights32, s.lrs, s.wds):
        w32.sub_(_step(w32, g.float(), lr, wd, s.rescale, s.clip))
        w.copy_(w32)


def multi_mp_sgd_mom_plain(weights: Sequence[torch.Tensor],
                           grads: Sequence[torch.Tensor],
                           moms: Sequence[torch.Tensor],
                           weights32: Sequence[torch.Tensor], lrs, wds,
                           momentum: float = 0.0, rescale_grad: float = 1.0,
                           clip_gradient: Optional[float] = -1.0) -> None:
    """The plain PyTorch version of the mixed momentum update
    (``multi_mp_sgd_mom_update``): ``sgd_mom_kernel``'s fp32 update on the
    masters and fp32 momenta from the fp32-cast gradients, then each
    master rounded into its weight."""
    s = _scalars(torch.float32, torch.float32, lrs, wds, momentum,
                 rescale_grad, clip_gradient)
    for w, g, m, w32, lr, wd in zip(weights, grads, moms, weights32, s.lrs,
                                    s.wds):
        m.mul_(s.momentum).sub_(_step(w32, g.float(), lr, wd, s.rescale,
                                      s.clip))
        w32.add_(m)
        w.copy_(w32)


def _floats(values) -> List[float]:
    return [float(v) for v in values]


_fn = None


def _kernel():
    """The C entry point, built and bound at first use."""
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("multi_sgd").mxtpu_multi_sgd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + \
            [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, mode, groups):
    """Every tensor of ``groups`` (lists of equal length: weights,
    gradients, then momenta and/or masters) on one CUDA device,
    contiguous, of its weight's size and of a dtype the kernel of ``mode``
    takes: one of ``_DTYPES`` shared by all (plain modes), or bf16/fp16
    weights and gradients with fp32 momenta and masters (mixed)."""
    dev = groups[0][0].device
    mixed = mode in (MP_SGD, MP_SGD_MOM)
    w_dtype = groups[0][0].dtype
    takes = ("bfloat16/float16 weights and gradients with float32 momenta "
             "and masters" if mixed else f"one of {tuple(_DTYPES)}, shared")
    for k, group in enumerate(groups):
        want = torch.float32 if mixed and k >= 2 else w_dtype
        for w, t in zip(groups[0], group):
            if t.device != dev:
                raise MXNetError(f"{name}: tensors on {t.device} and {dev}")
            if t.dtype not in (_LOW if mixed and k < 2 else _DTYPES) \
                    or t.dtype != want:
                raise MXNetError(f"{name} kernel: dtype {t.dtype} (weights "
                                 f"{w_dtype}); it takes {takes}")
            if not t.is_contiguous():
                raise MXNetError(f"{name}: tensors must be contiguous")
            if t.numel() != w.numel():
                raise MXNetError(f"{name}: {tuple(t.shape)} does not match "
                                 f"its weight's {tuple(w.shape)}")


def _launch(wrapper, mode, weights, grads, moms, weights32, s: _Scalars
            ) -> None:
    """Launch ``csrc/multi_sgd.cu`` in ``mode`` on the current CUDA stream,
    as :func:`_launch_plans` plans it: one launch per ``MAX_TENSORS``
    tensors that hold at least one element.  ``s`` holds the scalars
    already rounded (``_scalars``)."""
    groups = [weights, grads] + [grp for grp in (moms, weights32)
                                 if grp is not None]
    _check(wrapper.__name__, mode, groups)
    fn = _kernel()
    dev = weights[0].device
    dtype = _DTYPES[weights[0].dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = tuple(t.numel() for t in weights)
    vec = 16 // weights[0].element_size()
    for plan in _launch_plans(sizes, _num_sms(dev), vec):
        lo, hi = plan.lo, plan.hi
        k = hi - lo

        def ptrs(grp):
            grp = weights if grp is None else grp
            return (ctypes.c_uint64 * k)(*(t.data_ptr() for t in grp[lo:hi]))
        arrays = [ptrs(grp) for grp in (weights, grads, moms, weights32)]
        n = (ctypes.c_longlong * k)(*sizes[lo:hi])
        starts = (ctypes.c_int * (k + 1))(*plan.starts)
        lr = (ctypes.c_float * k)(*s.lrs[lo:hi])
        wd = (ctypes.c_float * k)(*s.wds[lo:hi])
        err = fn(k, *(ctypes.addressof(a) for a in arrays),
                 ctypes.addressof(n), ctypes.addressof(starts),
                 ctypes.addressof(lr), ctypes.addressof(wd), dtype, mode,
                 s.momentum, s.rescale, s.clip, plan.tile, plan.grid,
                 stream)
        if err != 0:
            raise MXNetError(f"{wrapper.__name__} kernel launch failed: "
                             f"CUDA error {err}")
        counters.bump(wrapper, "launches")


def _group(name, weights, others, lrs, wds):
    """The device type of a group, and its lrs/wds as host floats, after
    checking that every list has one entry per weight."""
    lrs, wds = _floats(lrs), _floats(wds)
    sizes = {len(weights), len(lrs), len(wds), *map(len, others)}
    if not weights or len(sizes) != 1:
        raise MXNetError(f"{name}: {len(weights)} weights, "
                         f"{[len(o) for o in others]} grads/moms/masters, "
                         f"{len(lrs)} lrs, {len(wds)} wds")
    return weights[0].device.type, lrs, wds


def _dispatch(wrapper, mode, plain, weights, grads, moms, weights32, lrs,
              wds, momentum, rescale_grad, clip_gradient):
    others = [grp for grp in (grads, moms, weights32) if grp is not None]
    dev, lrs, wds = _group(wrapper.__name__, weights, others, lrs, wds)
    if dev == "cpu":
        plain()
    elif dev == "cuda":
        mixed = mode in (MP_SGD, MP_SGD_MOM)
        w_dtype = torch.float32 if mixed else weights[0].dtype
        g_dtype = torch.float32 if mixed else grads[0].dtype
        _launch(wrapper, mode, weights, grads, moms, weights32,
                _scalars(w_dtype, g_dtype, lrs, wds, momentum, rescale_grad,
                         clip_gradient))
    else:
        raise MXNetError(f"{wrapper.__name__}: no kernel for device {dev}")


def multi_sgd(weights: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], lrs, wds,
              rescale_grad: float = 1.0,
              clip_gradient: Optional[float] = -1.0) -> None:
    """SGD over a group, in place: the ``sgd_kernel`` kernel on CUDA
    tensors, :func:`multi_sgd_plain` on CPU tensors."""
    _dispatch(multi_sgd, SGD, lambda: multi_sgd_plain(
        weights, grads, lrs, wds, rescale_grad, clip_gradient),
        weights, grads, None, None, lrs, wds, 0.0, rescale_grad,
        clip_gradient)


def multi_sgd_mom(weights: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor],
                  moms: Sequence[torch.Tensor], lrs, wds,
                  momentum: float = 0.0, rescale_grad: float = 1.0,
                  clip_gradient: Optional[float] = -1.0) -> None:
    """SGD with momentum over a group, in place on weights and momenta:
    the ``sgd_mom_kernel`` kernel on CUDA tensors,
    :func:`multi_sgd_mom_plain` on CPU tensors."""
    _dispatch(multi_sgd_mom, SGD_MOM, lambda: multi_sgd_mom_plain(
        weights, grads, moms, lrs, wds, momentum, rescale_grad,
        clip_gradient), weights, grads, moms, None, lrs, wds, momentum,
        rescale_grad, clip_gradient)


def multi_mp_sgd(weights: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 weights32: Sequence[torch.Tensor], lrs, wds,
                 rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = -1.0) -> None:
    """The mixed update without momentum over a group, in place on
    weights and masters: the kernel's mixed path on CUDA tensors,
    :func:`multi_mp_sgd_plain` on CPU tensors."""
    _dispatch(multi_mp_sgd, MP_SGD, lambda: multi_mp_sgd_plain(
        weights, grads, weights32, lrs, wds, rescale_grad, clip_gradient),
        weights, grads, None, weights32, lrs, wds, 0.0, rescale_grad,
        clip_gradient)


def multi_mp_sgd_mom(weights: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     moms: Sequence[torch.Tensor],
                     weights32: Sequence[torch.Tensor], lrs, wds,
                     momentum: float = 0.0, rescale_grad: float = 1.0,
                     clip_gradient: Optional[float] = -1.0) -> None:
    """The mixed momentum update over a group, in place on weights,
    momenta and masters: the kernel's mixed path on CUDA tensors,
    :func:`multi_mp_sgd_mom_plain` on CPU tensors."""
    _dispatch(multi_mp_sgd_mom, MP_SGD_MOM, lambda: multi_mp_sgd_mom_plain(
        weights, grads, moms, weights32, lrs, wds, momentum, rescale_grad,
        clip_gradient), weights, grads, moms, weights32, lrs, wds, momentum,
        rescale_grad, clip_gradient)


multi_sgd.launches = 0
multi_sgd_mom.launches = 0
multi_mp_sgd.launches = 0
multi_mp_sgd_mom.launches = 0
