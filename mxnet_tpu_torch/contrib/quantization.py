"""int8 post-training quantization of a Gluon net: ``QuantizedDense``,
``QuantizedConv2D`` and ``quantize_net``.

Counterpart of ``mxnet_tpu/contrib/quantization.py``: ``quantize_net(net,
calib_data, calib_mode=...)`` swaps every ``Dense`` (and ``Conv2D``,
unless ``quantize_conv=False``) of the block tree for its int8 block, in
place, and returns ``net``.  A quantized block quantizes its input
(``quantize_v2``, with the range calibrated for it, or the batch's own
without calibration), runs the int8 op (``quantized_fully_connected``/
``quantized_conv``, exact int32 sums), dequantizes, then adds the float
bias and applies the activation.  ``calib_mode`` is ``"minmax"`` (MXNet's
``"naive"``, also accepted): each layer's input extrema over the batches;
or ``"entropy"``: two passes, the first fixing each layer's max |x|, the
second filling 8001-bin |x| histograms, and the KL-optimal clip
threshold of each (``_entropy_threshold``, the JAX package's numpy code
verbatim, as is ``_quantize_weight``).

The port's ``Block`` is a ``torch.nn.Module``: the calibration hooks are
``Block.register_forward_hook`` hooks, given ``(block, args, out)`` as
``NDArray``s as in the JAX package, and a child is swapped in its
parent's ``_modules``.  The int8 weight and its range live on the
weight's device, as tensors of the block that a captured graph reads in
place.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import Block, HybridBlock
from ..ndarray.register import get_op

__all__ = ["QuantizedDense", "QuantizedConv2D", "quantize_net"]


def _quantize_weight(w):
    """fp32 NDArray -> (int8 NDArray, min, max NDArrays), symmetric."""
    import numpy as np
    from .. import ndarray as F
    a = w.asnumpy()
    mx = float(np.max(np.abs(a))) or 1e-8
    q = np.clip(np.round(a / (mx / 127.0)), -127, 127).astype(np.int8)
    ctx = w.context
    return (F.array(q, ctx=ctx, dtype="int8"),
            F.array(np.float32(-mx), ctx=ctx),
            F.array(np.float32(mx), ctx=ctx))


class _QuantizedBase(HybridBlock):
    """The int8 weight and its range, the float bias, the activation and
    the calibrated input range of one quantized layer."""

    def __init__(self, weight, bias, act_type, calib_range, **kwargs):
        super().__init__(**kwargs)
        qw, wmin, wmax = _quantize_weight(weight.data())
        self._qw, self._wmin, self._wmax = qw._data, wmin._data, wmax._data
        self._fbias = None if bias is None else bias._tensor()
        self._act_type = act_type
        self._act = None if not act_type else \
            get_op("Activation").get_fn({"act_type": act_type})
        self._calib = calib_range
        self._quantize = get_op("_contrib_quantize_v2").get_fn(
            {} if calib_range is None else
            {"min_calib_range": float(calib_range[0]),
             "max_calib_range": float(calib_range[1])})
        self._dequantize = get_op("_contrib_dequantize").get_fn({})

    #: the int8 op's fn, and the shape the float bias takes beside it
    _int_op = None
    _bias_shape = (-1,)

    def forward(self, x):
        q, mn, mx = self._quantize(x)
        out32, omn, omx = self._int_op(q, self._qw, mn, mx, self._wmin,
                                       self._wmax)
        y = self._dequantize(out32, omn, omx)
        if self._fbias is not None:
            y = y + self._fbias.reshape(self._bias_shape)
        return y if self._act is None else self._act(y)

    def accumulate(self, x):
        """The int32 accumulator ``forward`` dequantizes for the input
        ``x``, and the int8 op's inputs that gave it (the quantized input,
        the int8 weight and the four ranges)."""
        q, mn, mx = self._quantize(x)
        ins = (q, self._qw, mn, mx, self._wmin, self._wmax)
        return self._int_op(*ins)[0], ins


class QuantizedDense(_QuantizedBase):
    """int8 ``Dense``: quantize the input, int8 x int8 -> int32, dequantize,
    then the float bias and activation."""

    def __init__(self, dense: nn.Dense, calib_range=None, **kwargs):
        super().__init__(dense.weight, getattr(dense, "bias", None),
                         dense._act_type, calib_range, **kwargs)
        self._units = dense._units
        self._flatten = dense._flatten
        self._int_op = get_op("_contrib_quantized_fully_connected").get_fn(
            {"num_hidden": self._units, "no_bias": True,
             "flatten": self._flatten})


class QuantizedConv2D(_QuantizedBase):
    """int8 ``Conv2D`` (NCHW)."""

    def __init__(self, conv: nn.Conv2D, calib_range=None, **kwargs):
        super().__init__(conv.weight, getattr(conv, "bias", None),
                         conv._act_type, calib_range, **kwargs)
        kw = conv._sym_kw
        self._kernel, self._stride = kw["kernel"], kw["stride"]
        self._pad, self._dilate = kw["pad"], kw["dilate"]
        self._groups, self._channels = kw["num_group"], conv._channels
        self._bias_shape = (1, -1, 1, 1)
        self._int_op = get_op("_contrib_quantized_conv").get_fn(
            {"kernel": self._kernel, "stride": self._stride,
             "pad": self._pad, "dilate": self._dilate,
             "num_filter": self._channels, "num_group": self._groups,
             "no_bias": True})


def _entropy_threshold(hist, bin_width, num_quantized_bins=255):
    """Pick the |x| clip threshold minimizing KL(P||Q) between the
    observed activation distribution and its int8-quantized rendition
    (reference: src/operator/quantization/calibrate.cc
    GetOptimalThreshold — the TensorRT-style algorithm)."""
    import numpy as np
    nbins = len(hist)
    if nbins <= num_quantized_bins:
        return nbins * bin_width
    best_kl, best_i = np.inf, nbins
    total = hist.sum()
    if total == 0:
        return nbins * bin_width
    for i in range(num_quantized_bins, nbins + 1,
                   max(1, (nbins - num_quantized_bins) // 64)):
        # reference dist: first i bins, outliers folded into the edge
        p = hist[:i].astype(np.float64).copy()
        p[i - 1] += hist[i:].sum()
        # quantized dist: the FOLDED p grouped into num_quantized_bins
        # levels and expanded back (building q from the raw hist would
        # zero the folded edge bin and wrongly veto every clipping
        # candidate via the q==0 guard)
        factor = i / num_quantized_bins
        q = np.zeros(i, np.float64)
        for j in range(num_quantized_bins):
            lo = int(np.floor(j * factor))
            hi = int(np.ceil((j + 1) * factor))
            chunk = p[lo:hi]
            live = chunk > 0
            if live.any():
                q[lo:hi][live] = chunk[live].sum() / live.sum()
        pm = p > 0
        ps = p[pm] / p.sum()
        qs = q[pm]
        if (qs == 0).any():
            continue
        qs = qs / q.sum()
        kl = float(np.sum(ps * np.log(ps / qs)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i * bin_width


def _children(block: Block):
    return [(name, child) for name, child in block._modules.items()
            if isinstance(child, Block)]


def _collect_ranges(net: HybridBlock, calib_data: Iterable, targets,
                    calib_mode: str = "minmax",
                    num_bins: int = 8001) -> Dict[int, tuple]:
    """Each target layer's input range over the batches, by ``id`` of
    the layer: the extrema (``"minmax"``) or the entropy threshold
    (``"entropy"``, two passes over the batches)."""
    import numpy as np
    calib_data = list(calib_data)
    stats: Dict[int, object] = {}
    handles = []

    def minmax_hook(blk, args, out):
        x = args[0].asnumpy()
        lo, hi = float(np.min(x)), float(np.max(x))
        cur = stats.get(id(blk))
        if cur is None:
            stats[id(blk)] = [lo, hi]
        else:
            cur[0] = min(cur[0], lo)
            cur[1] = max(cur[1], hi)

    def hist_hook(max_abs):
        def hook(blk, args, out):
            x = np.abs(args[0].asnumpy()).ravel()
            h, _ = np.histogram(x, bins=num_bins,
                                range=(0.0, max_abs[id(blk)]))
            cur = stats.get(id(blk))
            stats[id(blk)] = h.astype(np.int64) if cur is None else cur + h
        return hook

    def attach(block, hook):
        for _, child in _children(block):
            if isinstance(child, targets):
                handles.append(child.register_forward_hook(hook))
            else:
                attach(child, hook)

    def run(hook):
        attach(net, hook)
        try:
            for batch in calib_data:
                net(batch)
        finally:
            for h in handles:
                h.remove()
            handles.clear()

    run(minmax_hook)
    if calib_mode != "entropy":
        return {k: tuple(v) for k, v in stats.items()}
    max_abs = {k: max(abs(v[0]), abs(v[1])) or 1e-8
               for k, v in stats.items()}
    stats.clear()
    run(hist_hook(max_abs))
    out = {}
    for k, hist in stats.items():
        thr = _entropy_threshold(hist, max_abs[k] / num_bins)
        out[k] = (-thr, thr)
    return out


def quantize_net(net: HybridBlock, calib_data: Optional[Iterable] = None,
                 exclude_layers: Sequence[str] = (),
                 quantize_conv: bool = True,
                 calib_mode: str = "minmax") -> HybridBlock:
    """Swap ``net``'s ``Dense`` (and ``Conv2D``) layers for int8 blocks, in
    place, and return ``net``.  With ``calib_data`` (input batches) each
    layer's input range is calibrated and frozen; without it each batch
    is quantized by its own range.  ``exclude_layers`` names children
    (by their name in the parent) to keep in float."""
    if calib_mode not in ("minmax", "naive", "entropy"):
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    targets = (nn.Dense, nn.Conv2D) if quantize_conv else (nn.Dense,)
    ranges: Dict[int, tuple] = {}
    if calib_data is not None:
        ranges = _collect_ranges(
            net, calib_data, targets,
            "entropy" if calib_mode == "entropy" else "minmax")

    def swap(block):
        for name, child in _children(block):
            if name in exclude_layers:
                continue
            if isinstance(child, nn.Dense):
                q = QuantizedDense(child, ranges.get(id(child)))
            elif quantize_conv and isinstance(child, nn.Conv2D):
                q = QuantizedConv2D(child, ranges.get(id(child)))
            else:
                swap(child)
                continue
            block._modules[name] = q
        if isinstance(block, HybridBlock):
            block._cached_graph.cache_clear()
        return block
    return swap(net)
