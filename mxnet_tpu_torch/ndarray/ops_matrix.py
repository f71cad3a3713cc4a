"""Shape, indexing and contraction operators.

Counterpart of ``mxnet_tpu/ndarray/ops_matrix.py``: ``dot`` :32,
``batch_dot`` :42, ``reshape`` :62 (MXNet's codes 0, -1, -2, -3, -4),
``transpose`` :68, ``expand_dims`` :74, ``concat`` :133, ``split`` /
``SliceChannel`` :140-148, ``slice`` :159, ``take`` :198, ``Embedding``
:200-206, ``one_hot`` :231, ``pick`` :235-243, ``broadcast_to`` :285,
``stop_gradient`` (``BlockGrad``) :434, ``smooth_l1`` :440-447,
``pad`` :276, ``SequenceMask`` :322, ``SequenceLast`` :334,
``SequenceReverse`` :350 and ``moments`` :387, and ``linalg_gemm2`` :52,
``amp_cast``/``amp_multicast`` :108-120, ``shape_array``/``size_array``
:121-124, ``slice_like`` :177, ``_basic_index`` :183,
``_advanced_index`` :190, ``gather_nd`` :214, ``scatter_nd`` :223,
``broadcast_axis`` :302, ``diag`` :360, ``reshape_like`` :375,
``cumsum`` :394, ``trace``/``tril``/``triu`` :400-412,
``depth_to_space``/``space_to_depth`` :422-432 and ``identity`` :438,
with their conventions: ``dot`` contracts the last axis of the
left input with the first of the right (transposes reverse every axis),
``batch_dot`` is a batched matmul, ``slice`` takes None for "from the
edge", indices may arrive as floats and are truncated, ``broadcast_to``
keeps a dim given as 0, ``split`` returns one array for
``num_outputs=1`` and a tuple otherwise, ``Embedding`` clips its ids into
``[0, input_dim - 1]``.  ``dot``, ``batch_dot`` and ``linalg_gemm2`` are
torch's matmul: the JAX package computes them outside any Pallas kernel.

The indexing ops follow the JAX package's gathers and scatters, not
torch's (whose out-of-range index is a device-side assert on the card):
``gather_nd`` and ``_advanced_index`` wrap a negative index once (``-1``
is the last) and then clamp it into range, and an entry whose index was
out of range passes no gradient (the JAX gather's transpose drops it);
``scatter_nd`` wraps a
negative index once and drops an update still out of range, and where
indices repeat the last update wins (the JAX package's result on the
CPU; here on either device, by a max over the update's position, so
the card's order of writes does not decide).  ``shape_array`` and
``size_array`` are int32, as the JAX package's (MXNet's are int64).
``amp_cast`` casts every input, integers too, as the JAX op does;
``amp_multicast`` casts its inputs to their promoted dtype (bfloat16
with float16 gives float32).  ``depth_to_space``/``space_to_depth``
take MXNet's DCR channel order.  Every op
returns a new array, never a view of its input (MXNet's ops copy; only
``NDArray.reshape`` and basic slicing alias).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, torch_dtype
from .ndarray import resolve_reshape
from .ops_reduce import SMALL_INT, int32_result
from .register import register_op, simple_op


def _fresh(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` as a contiguous tensor of its own when it is a view of
    ``x``."""
    if y._base is not None or y.data_ptr() == x.data_ptr():
        return y.clone(memory_format=torch.contiguous_format)
    return y


def _reverse(t: torch.Tensor) -> torch.Tensor:
    return t.permute(*range(t.dim() - 1, -1, -1))


def dot_maker(transpose_a=False, transpose_b=False):
    def fn(a, b):
        if transpose_a:
            a = _reverse(a)
        if transpose_b:
            b = _reverse(b)
        if a.dim() <= 2 and b.dim() <= 2:
            return torch.matmul(a, b) if a.dim() and b.dim() else a * b
        return torch.tensordot(a, b, dims=1)
    return fn


def batch_dot_maker(transpose_a=False, transpose_b=False):
    def fn(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return fn


def reshape_maker(shape=None, reverse=False):
    def fn(x):
        return _fresh(x.reshape(resolve_reshape(x.shape, shape, reverse)), x)
    return fn


def transpose_maker(axes=None):
    def fn(x):
        y = x.permute(*axes) if axes else _reverse(x)
        return _fresh(y.contiguous(), x)
    return fn


def expand_dims_maker(axis=0):
    def fn(x):
        return _fresh(x.unsqueeze(axis), x)
    return fn


def squeeze_maker(axis=None):
    def fn(x):
        if axis is None:
            y = x.squeeze()
        else:
            axes = (axis,) if isinstance(axis, int) else tuple(axis)
            y = x.squeeze(tuple(a % x.dim() for a in axes))
        return _fresh(y, x)
    return fn


def flatten_maker():
    def fn(x):
        return _fresh(x.reshape(x.shape[0], -1), x)
    return fn


def swapaxes_maker(dim1=0, dim2=0):
    def fn(x):
        return _fresh(x.transpose(dim1, dim2).contiguous(), x)
    return fn


def cast_maker(dtype="float32"):
    dt = torch_dtype(dtype)

    def fn(x):
        return x.to(dt, copy=True)
    return fn


def amp_multicast_maker(num_outputs=1):
    def fn(*xs):
        widest = xs[0].dtype
        for x in xs[1:]:
            widest = torch.promote_types(widest, x.dtype)
        return tuple(x.to(widest, copy=True) for x in xs)
    return fn


def linalg_gemm2_maker(transpose_a=False, transpose_b=False, alpha=1.0):
    def fn(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return alpha * torch.matmul(a, b)
    return fn


def concat_maker(dim=1, num_args=None):
    def fn(*xs):
        return torch.cat(xs, dim=dim)
    return fn


def stack_maker(axis=0, num_args=None):
    def fn(*xs):
        return torch.stack(xs, dim=axis)
    return fn


def split_maker(num_outputs=1, axis=1, squeeze_axis=False):
    def fn(x):
        ax = axis % x.dim()
        if x.shape[ax] % num_outputs:
            raise MXNetError(f"split: axis {axis} of size {x.shape[ax]} "
                             f"does not divide into {num_outputs}")
        parts = [_fresh(p.squeeze(ax) if squeeze_axis else p, x).contiguous()
                 for p in torch.chunk(x, num_outputs, dim=ax)]
        return tuple(parts) if num_outputs > 1 else parts[0]
    return fn


def slice_maker(begin=(), end=(), step=None):
    steps = step if step is not None else (None,) * len(begin)
    key = tuple(slice(b, e, s) for b, e, s in zip(begin, end, steps))

    def fn(x):
        if any(s.step is not None and s.step < 0 for s in key):
            raise MXNetError("slice: a negative step is not ported")
        return _fresh(x[key], x)
    return fn


def slice_axis_maker(axis=0, begin=0, end=None):
    def fn(x):
        idx = [slice(None)] * x.dim()
        idx[axis % x.dim()] = slice(begin, end)
        return _fresh(x[tuple(idx)], x)
    return fn


def slice_like_maker(axes=()):
    def fn(x, like):
        idx = [slice(None)] * x.dim()
        for a in (axes if axes else range(x.dim())):
            idx[a % x.dim()] = slice(0, like.shape[a % x.dim()])
        return _fresh(x[tuple(idx)], x)
    return fn


def _thaw_key(key):
    """An index key as the JAX package's ``_freeze_key`` stores it (a
    slice as ``("__slice__", start, stop, step)``) made usable again."""
    if isinstance(key, tuple):
        if len(key) == 4 and key[0] == "__slice__":
            return slice(key[1], key[2], key[3])
        return tuple(_thaw_key(k) for k in key)
    return key


def basic_index_maker(key=None):
    k = _thaw_key(key)

    def fn(x):
        return _fresh(x[k], x).contiguous()
    return fn


def _in_range(idx: torch.Tensor, n: int):
    """Integer indices into an axis of ``n``: a negative one wrapped once,
    then clamped into ``[0, n - 1]`` (the JAX package's gather), and
    whether each was in range before the clamp."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def _gathered(out: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``out`` whose entries gathered by an out-of-range index pass no
    gradient (the JAX package's gather transposes to a scatter-add that
    drops them)."""
    valid = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
    return torch.where(valid, out, out.detach())


def advanced_index_maker():
    def fn(x, idx):
        rows, valid = _in_range(idx, x.shape[0])
        return _gathered(x[rows], valid)
    return fn


def gather_nd_maker():
    def fn(data, indices):
        parts = [_in_range(indices[i], data.shape[i])
                 for i in range(indices.shape[0])]
        valid = parts[0][1]
        for _, v in parts[1:]:
            valid = valid & v
        return _gathered(data[tuple(p for p, _ in parts)], valid)
    return fn


def scatter_nd_maker(shape=None):
    """``data`` written at ``indices`` into zeros of ``shape``; where
    indices repeat, the last update wins, and an update out of range
    (after one wrap of a negative index) is dropped."""
    shp = tuple(int(s) for s in shape)

    def fn(data, indices):
        m = indices.shape[0]
        lin = torch.zeros(indices.shape[1:], dtype=torch.long,
                          device=data.device)
        ok = torch.ones(indices.shape[1:], dtype=torch.bool,
                        device=data.device)
        for i in range(m):
            idx = indices[i].long()
            idx = torch.where(idx < 0, idx + shp[i], idx)
            ok &= (idx >= 0) & (idx < shp[i])
            lin = lin * shp[i] + idx
        rest = math.prod(shp[m:])
        lin, ok = lin.reshape(-1), ok.reshape(-1)
        vals = data.reshape(lin.numel(), rest)
        n_out = math.prod(shp[:m])
        # the last update of each target: the largest position aimed at it
        pos = torch.arange(lin.numel(), device=data.device)
        last = torch.full((n_out + 1,), -1, dtype=torch.long,
                          device=data.device)
        tgt = torch.where(ok, lin, n_out)
        last.scatter_reduce_(0, tgt, pos, reduce="amax")
        # losers and dropped updates land on a spare row, cut off after:
        # the shapes stay static (no mask, no host read)
        tgt = torch.where(ok & (last[tgt] == pos), tgt, n_out)
        out = torch.zeros((n_out + 1, rest), dtype=data.dtype,
                          device=data.device)
        return out.index_put((tgt,), vals)[:n_out].reshape(shp)
    return fn


def take_maker(axis=0, mode="clip"):
    if mode not in ("clip", "wrap"):
        raise MXNetError(f"take: mode {mode!r} not in ('clip', 'wrap')")

    def fn(a, indices):
        ax = axis % a.dim()
        n = a.shape[ax]
        idx = indices.long()
        idx = idx.clamp(0, n - 1) if mode == "clip" else idx.remainder(n)
        out = torch.index_select(a, ax, idx.reshape(-1))
        return out.reshape(a.shape[:ax] + indices.shape + a.shape[ax + 1:])
    return fn


def embedding_maker(input_dim=None, output_dim=None, dtype="float32",
                    sparse_grad=False):
    def fn(data, weight):
        ids = data.long().clamp(0, weight.shape[0] - 1)
        return torch.nn.functional.embedding(ids, weight)
    return fn


def one_hot_maker(depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    dt = torch_dtype(dtype)

    def fn(indices):
        idx = indices.long()
        hit = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device))
        return torch.where(hit, torch.tensor(on_value, dtype=dt,
                                             device=idx.device),
                           torch.tensor(off_value, dtype=dt,
                                        device=idx.device))
    return fn


def pick_maker(axis=-1, keepdims=False, mode="clip"):
    """``data``'s element at ``index`` along ``axis``: ``index`` has
    ``data``'s shape without that axis (float indices are truncated).
    ``mode="clip"`` clips indices into range, ``"wrap"`` wraps them.  The
    axis is kept with size 1 when ``keepdims``."""
    if mode not in ("clip", "wrap"):
        raise MXNetError(f"pick: mode {mode!r} not in ('clip', 'wrap')")

    def fn(data, index):
        ax = axis % data.dim()
        n = data.shape[ax]
        idx = index.long()
        idx = idx.clamp(0, n - 1) if mode == "clip" else idx.remainder(n)
        res = torch.take_along_dim(data, idx.unsqueeze(ax), dim=ax)
        return res if keepdims else res.squeeze(ax)
    return fn


def broadcast_to_maker(shape=()):
    def fn(x):
        tgt = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
        return _fresh(x.expand(tgt).contiguous(), x)
    return fn


def broadcast_like_maker(lhs_axes=None, rhs_axes=None):
    def fn(x, like):
        return _fresh(x.expand(like.shape).contiguous(), x)
    return fn


def broadcast_axis_maker(axis=(), size=()):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    sizes = size if isinstance(size, (tuple, list)) else (size,)

    def fn(x):
        tgt = list(x.shape)
        for a, n in zip(axes, sizes):
            tgt[a % x.dim()] = n
        return _fresh(x.expand(tgt).contiguous(), x)
    return fn


def tile_maker(reps=()):
    def fn(x):
        return torch.tile(x, tuple(reps))
    return fn


def repeat_maker(repeats=1, axis=None):
    def fn(x):
        if axis is None:
            return x.reshape(-1).repeat_interleave(repeats)
        return x.repeat_interleave(repeats, dim=axis)
    return fn


def reverse_maker(axis=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)

    def fn(x):
        return torch.flip(x, axes)
    return fn


def smooth_l1_maker(scalar=1.0):
    """``0.5 * (s * x)**2`` where ``|x| < 1 / s**2``, else ``|x| - 0.5 /
    s**2`` (the JAX op's branch and arithmetic)."""
    s2 = float(scalar) * float(scalar)

    def fn(x):
        return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * torch.square(x),
                           x.abs() - 0.5 / s2)
    return fn


def pad_maker(mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` gives (before, after) for every axis, leading axes
    first; ``constant`` fills ``constant_value``, ``edge`` repeats the
    border, ``reflect`` mirrors it (the latter two on the trailing 1-3
    axes only, as MXNet's op)."""
    if mode not in ("constant", "edge", "reflect"):
        raise MXNetError(f"pad: mode {mode!r} not in constant, edge, "
                         f"reflect")
    pw = [int(v) for v in pad_width]

    def fn(x):
        if len(pw) != 2 * x.dim():
            raise MXNetError(f"pad: pad_width {tuple(pw)} for a "
                             f"{x.dim()}-d input")
        first = next((i for i in range(x.dim())
                      if pw[2 * i] or pw[2 * i + 1]), x.dim())
        widths = []
        for i in reversed(range(first, x.dim())):
            widths += [pw[2 * i], pw[2 * i + 1]]
        if not widths:
            return x.clone()
        if mode == "constant":
            return torch.nn.functional.pad(x, widths, value=constant_value)
        return torch.nn.functional.pad(
            x, widths, mode="replicate" if mode == "edge" else "reflect")
    return fn


def _seq_mask(data, lengths, axis):
    """(T, N) or (N, T) of ``pos < length``, broadcast over ``data``'s
    trailing axes; time is ``axis`` (0 or 1) and the batch the other."""
    t = data.shape[axis]
    pos = torch.arange(t, device=data.device)
    lens = lengths.to(data.device).long()
    mask = pos[:, None] < lens[None, :] if axis == 0 else \
        pos[None, :] < lens[:, None]
    return mask.reshape(mask.shape + (1,) * (data.dim() - 2))


def sequence_mask_maker(use_sequence_length=False, value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value`` (time on
    ``axis``, 0 or 1, the batch on the other)."""
    def fn(data, sequence_length=None):
        if not use_sequence_length:
            return data.clone()
        return torch.where(_seq_mask(data, sequence_length, axis), data,
                           torch.tensor(value, dtype=data.dtype,
                                        device=data.device))
    return fn


def sequence_last_maker(use_sequence_length=False, axis=0):
    """Each sequence's last valid step."""
    def fn(data, sequence_length=None):
        if not use_sequence_length:
            return data.select(axis, -1).clone()
        last = sequence_length.to(data.device).long() - 1
        batch = torch.arange(data.shape[1 - axis], device=data.device)
        return data[last, batch] if axis == 0 else data[batch, last]
    return fn


def sequence_reverse_maker(use_sequence_length=False, axis=0):
    """The time axis (0) reversed, within each sequence's length; the
    steps past it stay where they are."""
    def fn(data, sequence_length=None):
        if not use_sequence_length:
            return torch.flip(data, (axis,))
        t = data.shape[0]
        pos = torch.arange(t, device=data.device)[:, None]
        lens = sequence_length.to(data.device).long()[None, :]
        idx = torch.where(pos < lens, lens - 1 - pos, pos)
        idx = idx.reshape(idx.shape + (1,) * (data.dim() - 2))
        return torch.take_along_dim(data, idx.expand(data.shape), dim=0)
    return fn


def moments_maker(axes=None, keepdims=False):
    """Mean and (biased) variance over ``axes`` (all if None)."""
    dims = tuple(axes) if axes is not None else None

    def fn(x):
        if x.dtype in SMALL_INT:
            x = x.float()                    # the JAX package's float32
        d = dims if dims is not None else tuple(range(x.dim()))
        var, mean = torch.var_mean(x, dim=d, keepdim=keepdims,
                                   correction=0)
        return mean, var
    return fn


def diag_maker(k=0, axis1=0, axis2=1):
    def fn(x):
        if x.dim() == 1:
            return torch.diag(x, k)
        return torch.diagonal(x, offset=k, dim1=axis1, dim2=axis2).clone(
            memory_format=torch.contiguous_format)
    return fn


def reshape_like_maker(lhs_begin=None, lhs_end=None, rhs_begin=None,
                       rhs_end=None):
    """``lhs``'s dims ``[lhs_begin, lhs_end)`` replaced by ``rhs``'s
    ``[rhs_begin, rhs_end)`` (all of both when no range is given)."""
    def fn(lhs, rhs):
        lb = 0 if lhs_begin is None else lhs_begin % (lhs.dim() + 1)
        le = lhs.dim() if lhs_end is None else lhs_end % (lhs.dim() + 1)
        rb = 0 if rhs_begin is None else rhs_begin % (rhs.dim() + 1)
        re = rhs.dim() if rhs_end is None else rhs_end % (rhs.dim() + 1)
        shape = lhs.shape[:lb] + rhs.shape[rb:re] + lhs.shape[le:]
        return _fresh(lhs.reshape(shape), lhs)
    return fn


def cumsum_maker(axis=None, dtype=None):
    dt = None if dtype is None else torch_dtype(dtype)

    def fn(x):
        keep = x.dtype if x.dtype in SMALL_INT else None
        out = torch.cumsum(x.reshape(-1) if axis is None else x,
                           dim=0 if axis is None else axis, dtype=keep)
        return out if dt is None else out.to(dt)
    return fn


def trace_maker(offset=0, axis1=0, axis2=1):
    def fn(x):
        return int32_result(x, torch.diagonal(
            x, offset=offset, dim1=axis1, dim2=axis2).sum(-1))
    return fn


def tril_maker(k=0):
    def fn(x):
        return torch.tril(x, k)
    return fn


def triu_maker(k=0):
    def fn(x):
        return torch.triu(x, k)
    return fn


def depth_to_space_maker(block_size=1):
    def fn(x):
        b, c, h, w = x.shape
        bs = block_size
        y = x.reshape(b, bs, bs, c // (bs * bs), h, w)
        y = y.permute(0, 3, 4, 1, 5, 2)
        return y.reshape(b, c // (bs * bs), h * bs, w * bs)
    return fn


def space_to_depth_maker(block_size=1):
    def fn(x):
        b, c, h, w = x.shape
        bs = block_size
        y = x.reshape(b, c, h // bs, bs, w // bs, bs)
        y = y.permute(0, 3, 5, 1, 2, 4)
        return y.reshape(b, c * bs * bs, h // bs, w // bs)
    return fn


def _register():
    register_op("dot", dot_maker)
    register_op("batch_dot", batch_dot_maker,
                aliases=("linalg_gemm2_batched",))
    register_op("reshape", reshape_maker, aliases=("Reshape",))
    register_op("transpose", transpose_maker)
    register_op("expand_dims", expand_dims_maker)
    register_op("squeeze", squeeze_maker)
    register_op("flatten", flatten_maker, aliases=("Flatten",))
    register_op("swapaxes", swapaxes_maker, aliases=("SwapAxis",))
    register_op("cast", cast_maker, aliases=("Cast",))
    register_op("amp_cast", cast_maker)
    register_op("amp_multicast", amp_multicast_maker)
    register_op("linalg_gemm2", linalg_gemm2_maker)
    simple_op("shape_array", lambda x: torch.tensor(
        tuple(x.shape), dtype=torch.int32, device=x.device))
    simple_op("size_array", lambda x: torch.tensor(
        [x.numel()], dtype=torch.int32, device=x.device))
    register_op("concat", concat_maker, aliases=("Concat",))
    register_op("stack", stack_maker)
    register_op("split", split_maker, aliases=("SliceChannel",))
    register_op("slice", slice_maker)
    register_op("slice_axis", slice_axis_maker)
    register_op("slice_like", slice_like_maker)
    register_op("_basic_index", basic_index_maker)
    register_op("_advanced_index", advanced_index_maker)
    register_op("gather_nd", gather_nd_maker)
    register_op("scatter_nd", scatter_nd_maker)
    register_op("take", take_maker)
    register_op("Embedding", embedding_maker, aliases=("embedding",))
    register_op("one_hot", one_hot_maker)
    register_op("pick", pick_maker)
    register_op("broadcast_to", broadcast_to_maker)
    register_op("broadcast_like", broadcast_like_maker)
    register_op("broadcast_axis", broadcast_axis_maker,
                aliases=("broadcast_axes",))
    register_op("tile", tile_maker)
    register_op("repeat", repeat_maker)
    register_op("reverse", reverse_maker, aliases=("flip",))
    simple_op("where", lambda c, x, y: torch.where(c != 0, x, y))
    simple_op("stop_gradient", torch.Tensor.detach,
              aliases=("BlockGrad", "block_grad"))
    register_op("smooth_l1", smooth_l1_maker)
    register_op("pad", pad_maker, aliases=("Pad",))
    register_op("SequenceMask", sequence_mask_maker,
                aliases=("sequence_mask",))
    register_op("SequenceLast", sequence_last_maker,
                aliases=("sequence_last",))
    register_op("SequenceReverse", sequence_reverse_maker,
                aliases=("sequence_reverse",))
    register_op("moments", moments_maker)
    register_op("diag", diag_maker)
    register_op("reshape_like", reshape_like_maker)
    register_op("cumsum", cumsum_maker, aliases=("_np_cumsum",))
    register_op("trace", trace_maker)
    register_op("tril", tril_maker)
    register_op("triu", triu_maker)
    register_op("depth_to_space", depth_to_space_maker)
    register_op("space_to_depth", space_to_depth_maker)
    simple_op("identity", lambda x: x.clone(), aliases=("_copy",))
    simple_op("zeros_like", lambda x: torch.zeros_like(
        x, memory_format=torch.contiguous_format))
    simple_op("ones_like", lambda x: torch.ones_like(
        x, memory_format=torch.contiguous_format))


_register()
