"""Core Gluon layers: Sequential, HybridSequential, HybridConcurrent,
Identity, Dense, Activation, the parametric and fixed activations
(LeakyReLU, PReLU, ELU, SELU, GELU, Swish), Flatten, Dropout, BatchNorm,
InstanceNorm, LayerNorm, GroupNorm, Embedding, Lambda, HybridLambda and
ReflectionPad2D.  Each hybrid layer's ``forward`` is its eager path (in
torch ops) and its ``hybrid_forward`` the JAX package's body, op for op,
which runs on ``Symbol``s (``Block`` symbolic mode, ``export``).

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``, with the same
parameter names, shapes (``(units, in_units)`` Dense weights) and defaults
(LayerNorm and BatchNorm eps 1e-5, BatchNorm momentum 0.9).  A width
left at 0 (``in_units``, ``in_channels``) is inferred from the first
input (``infer_shape``, as the JAX layers do).  The JAX
package leaves these to XLA, outside any Pallas kernel, so here they are
plain torch calls.  Dropout and BatchNorm follow ``autograd.is_training()``
(MXNet's global mode), not ``nn.Module.training``.  Under ``contrib.amp``
Dense ("FullyConnected") casts its input, weight and bias to the target
dtype and LayerNorm its input and parameters to float32; Embedding,
BatchNorm and the activations keep their input dtype, as in the JAX
package.  After ``Block.cast`` the layers run in the parameters' dtype
(the caller casts the input, as in MXNet).

``HybridLambda`` takes a function of ``(F, *inputs)``, ``F`` the op
namespace (``mxnet_tpu_torch.nd``), or the name of an op; ``Lambda`` a
function of the inputs or an op's name.  ``RowShardedEmbedding`` waits
for distribution.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from ... import autograd
from ... import ndarray as _nd
from ... import initializer as _init
from ...base import MXNetError, torch_dtype
from ...contrib.amp import amp as _amp
from ...ndarray.ops_nn import dropout_maker, groupnorm_maker, \
    instancenorm_maker, leaky_relu_maker
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "HybridConcurrent", "Identity",
           "Dense", "Activation", "LeakyReLU", "PReLU", "ELU", "SELU",
           "GELU", "Swish", "Flatten", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Lambda",
           "HybridLambda", "ReflectionPad2D"]

_ACTIVATIONS = {"relu": F.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus}


def _activation(name):
    if name not in _ACTIVATIONS:
        raise MXNetError(f"unknown activation {name!r}; expected one of "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


class _Stack:
    """What the sequential containers share: ``add``, ``len``, indexing
    and iteration over the children."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """Stacks blocks; ``forward`` runs them in order (never hybridized)."""

    def forward(self, x):
        for child in self._modules.values():
            x = child(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """Stacks blocks; ``forward`` runs them in order."""

    def forward(self, x):
        for child in self._modules.values():
            x = child(x)
        return x

    def hybrid_forward(self, F, x):
        return self.forward(x)


class HybridConcurrent(_Stack, HybridBlock):
    """Runs every child on the same input and concatenates the outputs on
    ``axis`` (the Inception, SqueezeNet and DenseNet branch container)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return torch.cat([child(x) for child in self._modules.values()],
                         dim=self.axis)

    def hybrid_forward(self, F, x):
        return F.concat(*[child(x) for child in self._modules.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    def forward(self, x):
        return x

    def hybrid_forward(self, F, x):
        return x


class Dense(HybridBlock):
    """Fully-connected layer: ``act(x @ W.T + b)``; weight shape
    ``(units, in_units)``, the MXNet convention."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        self._act = _activation(activation) if activation else None
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), dtype=dtype,
                init=bias_initializer) if use_bias else None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight._finish_deferred_init((self._units, in_units))

    def forward(self, x):
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        # FullyConnected: LP16 under AMP
        x, w, b = _amp.cast("FullyConnected", x, self.weight._tensor(),
                            None if self.bias is None else self.bias._tensor())
        out = F.linear(x, w, b)
        return out if self._act is None else self._act(out)

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   no_bias=False, flatten=self._flatten)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Activation(HybridBlock):
    """``relu``, ``sigmoid``, ``tanh`` or ``softrelu``."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act_type = activation
        self._act = _activation(activation)

    def forward(self, x):
        return self._act(x)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Flatten(HybridBlock):
    """``(N, ...)`` to ``(N, prod(...))``."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class LeakyReLU(HybridBlock):
    """``x`` where ``x >= 0``, else ``alpha * x``."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha
        self._fn = leaky_relu_maker("leaky", slope=alpha)

    def forward(self, x):
        return self._fn(x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope ``alpha`` of shape (1,)
    (initialized to 0.25)."""

    def __init__(self, alpha_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._fn = leaky_relu_maker("prelu")
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or _init.Constant(0.25))

    def forward(self, x):
        return self._fn(x, self.alpha._tensor())

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha
        self._fn = leaky_relu_maker("elu", slope=alpha)

    def forward(self, x):
        return self._fn(x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._fn = leaky_relu_maker("selu")

    def forward(self, x):
        return self._fn(x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    """The erf form."""

    def forward(self, x):
        return F.gelu(x)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class Dropout(HybridBlock):
    """Zeroes each unit with probability ``rate`` in training mode and
    scales the rest by ``1 / (1 - rate)``; with ``axes`` one draw is
    shared along those axes (the mask then comes from the port's
    generator, as ``nd.Dropout``'s)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)
        self._masked = dropout_maker(rate, axes=self._axes) if axes \
            else None

    def forward(self, x):
        if self._masked is not None:
            return self._masked(x)
        return F.dropout(x, self._rate, training=autograd.is_training())

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` (the channel axis, 1 for NCHW).

    The JAX layer's semantics (``mxnet_tpu/ndarray/ops_nn.py`` BatchNorm):

    - in training mode (``autograd.is_training()`` and not
      ``use_global_stats``) it normalises with the batch mean and the
      *biased* batch variance, and updates the running statistics in
      place, without autograd: ``new = momentum * old + (1 - momentum) *
      batch`` (MXNet's convention, the reverse of torch's), the variance
      biased and both taken in fp32;
    - otherwise it normalises with the running statistics;
    - ``scale=False`` fixes gamma at 1 (``fix_gamma``), and gamma then has
      ``grad_req='null'``; ``center=False`` leaves beta untrained.

    The normalisation itself is ``F.batch_norm`` without running buffers
    (torch would update them with the unbiased variance); the running
    statistics are updated here from ``torch.var_mean``, in the profiler
    range ``batchnorm_stats``.

    Under ``parallel.ShardedTrainer`` at ``dp`` > 1 (inside
    :func:`global_batch_stats`) the statistics are the global batch's,
    over every rank's rows, as the JAX package's one-jit step computes
    them: every rank's mean and sum of squared deviations from it reach
    every rank by one all-reduce in forward (each rank's in its own slot
    of a zero buffer, so exactly) and are combined there in rank order,
    the global sum of squared deviations as the ranks' own plus each
    one's rows times its mean's squared distance from the global mean
    (no difference of large sums), and the two sums the input gradient
    needs come by one all-reduce in backward; gamma's and beta's
    gradients stay the rank's own, for the trainer to sum.  ``gluon.Trainer`` over a
    distributed kvstore keeps each process's statistics, as MXNet does.

    Low precision: bf16/fp16 activations keep their dtype, and the batch
    statistics are taken in fp32 from ``x.float()``, as the JAX op does
    (``mxnet_tpu/ndarray/ops_nn.py:306-331``); the running statistics keep
    the parameters' dtype (fp32 under AMP, bf16 after ``cast("bfloat16")``).
    ``F.batch_norm`` takes parameters of another dtype than the input and
    normalises in fp32, rounding its output once (the JAX op normalises
    in the activations' dtype, op by op).  ``cast("float16")`` keeps the
    parameters fp32, as MXNet 1.x's ``BatchNorm.cast`` does (the JAX
    package casts them to fp16).
    """

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                grad_req="write" if scale else "null",
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                grad_req="write" if center else "null",
                allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, grad_req="null",
                allow_deferred_init=True)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer, grad_req="null",
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p._finish_deferred_init((c,))

    def cast(self, dtype) -> None:
        if torch_dtype(dtype) == torch.float16:
            dtype = torch.float32
        super().cast(dtype)

    def forward(self, x):
        ax = self._axis % x.ndim
        if ax == 1:
            return self._normalize(x)
        # F.batch_norm takes the channels on dim 1
        return self._normalize(x.movedim(ax, 1)).movedim(1, ax)

    def _normalize(self, x):
        gamma = self.gamma._tensor() if self._scale else None
        beta = self.beta._tensor()
        r_mean, r_var = self.running_mean._tensor(), self.running_var._tensor()
        if not (autograd.is_training() and not self._use_global_stats):
            return F.batch_norm(x, r_mean, r_var, gamma, beta, False, 0.0,
                                self._epsilon)
        sync = getattr(_stat_sync, "group", None)
        if sync is not None:
            return _GlobalBatchNorm.apply(x, gamma, beta, r_mean, r_var,
                                          self._momentum, self._epsilon,
                                          sync)
        # a named range, so that a profile can tell this pass apart
        with torch.no_grad(), \
                torch.profiler.record_function("batchnorm_stats"):
            dims = [d for d in range(x.ndim) if d != 1]
            var, mean = torch.var_mean(x.detach().float(), dim=dims,
                                       correction=0)
            mom = self._momentum
            r_mean.copy_(r_mean * mom + mean * (1 - mom))
            r_var.copy_(r_var * mom + var * (1 - mom))
        return F.batch_norm(x, None, None, gamma, beta, True, 0.0,
                            self._epsilon)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        # one output: the port's BatchNorm op updates the statistics in
        # place (the JAX op returns them as two more)
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis,
                           _training=autograd.is_training()
                           and not self._use_global_stats)


_stat_sync = threading.local()


@contextlib.contextmanager
def global_batch_stats(group, world: int):
    """Inside, every ``BatchNorm`` in training mode of this thread takes
    the statistics of the global batch over ``group``'s ``world`` ranks
    (no-op for a group of one)."""
    prev = getattr(_stat_sync, "group", None)
    _stat_sync.group = (group, world) if world > 1 else None
    try:
        yield
    finally:
        _stat_sync.group = prev


class _GlobalBatchNorm(torch.autograd.Function):
    """BatchNorm over the global batch of a process group (see
    ``BatchNorm``): channels on dim 1, statistics in fp32 (float64 for a
    float64 input), biased variance."""

    @staticmethod
    def forward(ctx, x, gamma, beta, r_mean, r_var, mom, eps, sync):
        from ...parallel import dist
        group, world = sync
        dims = [d for d in range(x.ndim) if d != 1]
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = x if x.dtype == torch.float64 else x.float()
        c = xf.shape[1]
        n = xf.numel() // c
        mean_r = xf.mean(dims)
        m2_r = torch.square(xf - mean_r.view(shape)).sum(dims)
        buf = xf.new_zeros(world, 2, c)
        buf[dist.rank(), 0] = mean_r
        buf[dist.rank(), 1] = m2_r
        dist.all_reduce(buf, group=group)
        total = n * world
        mean = buf[:, 0].sum(0) / world
        var = (buf[:, 1].sum(0) + n * torch.square(buf[:, 0] - mean)
               .sum(0)) / total
        with torch.profiler.record_function("batchnorm_stats"):
            r_mean.copy_(r_mean * mom + mean * (1 - mom))
            r_var.copy_(r_var * mom + var * (1 - mom))
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        y = xhat * gamma.view(shape).to(xf.dtype) if gamma is not None \
            else xhat
        y = y + beta.view(shape).to(xf.dtype)
        ctx.save_for_backward(xhat, invstd, gamma)
        ctx.sync, ctx.total, ctx.dims, ctx.shape = sync, total, dims, shape
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        from ...parallel import dist
        xhat, invstd, gamma = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        dyf = dy.to(xhat.dtype)
        c = xhat.shape[1]
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        buf = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(buf, group=ctx.sync[0])
        scale = invstd if gamma is None else gamma.to(xhat.dtype) * invstd
        dx = scale.view(shape) * (dyf - (buf[:c] / ctx.total).view(shape)
                                  - xhat * (buf[c:] / ctx.total).view(shape))
        dgamma = sum_dy_xhat.to(gamma.dtype) \
            if gamma is not None and ctx.needs_input_grad[1] else None
        dbeta = sum_dy.to(dy.dtype) if ctx.needs_input_grad[2] else None
        return dx.to(dy.dtype), dgamma, dbeta, None, None, None, None, None


class InstanceNorm(HybridBlock):
    """Normalises each sample's channel (axis 1) over its spatial axes,
    with per-channel ``gamma`` and ``beta``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if axis != 1:
            raise MXNetError("InstanceNorm: the port takes axis 1 only")
        self._epsilon = epsilon
        self._fn = instancenorm_maker(epsilon)
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        for p in (self.gamma, self.beta):
            p._finish_deferred_init((x.shape[1],))

    def forward(self, x):
        return self._fn(x, self.gamma._tensor(), self.beta._tensor())

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Normalises each sample over groups of channels; ``gamma`` and
    ``beta`` are per group, ``(num_groups,)``, as in the JAX package."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_groups, self._epsilon = num_groups, epsilon
        self._fn = groupnorm_maker(num_groups, epsilon)
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(num_groups,),
                                         init=gamma_initializer)
            self.beta = self.params.get("beta", shape=(num_groups,),
                                        init=beta_initializer)

    def forward(self, x):
        return self._fn(x, self.gamma._tensor(), self.beta._tensor())

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class LayerNorm(HybridBlock):
    """Normalises over ``axis`` (the last by default)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_shape(self, x, *args):
        for p in (self.gamma, self.beta):
            p._finish_deferred_init((x.shape[self._axis],))

    def forward(self, x):
        # FP32 under AMP
        x, gamma, beta = _amp.cast("LayerNorm", x, self.gamma._tensor(),
                                   self.beta._tensor())
        ax = self._axis % x.dim()
        if ax != x.dim() - 1:
            return F.layer_norm(x.movedim(ax, -1), (x.shape[ax],), gamma,
                                beta, self._epsilon).movedim(-1, ax)
        return F.layer_norm(x, (x.shape[-1],), gamma, beta, self._epsilon)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Integer ids -> dense vectors.  Out-of-range ids are clipped into
    ``[0, input_dim - 1]``, as the JAX package's gather does; ids are
    widened to int64 only for the lookup."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True): the port has no "
                             "row-sparse gradients; its gradient is dense")
        self._input_dim, self._output_dim = input_dim, output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def forward(self, x):
        ids = x.long().clamp(0, self._input_dim - 1)
        return F.embedding(ids, self.weight._tensor())

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim, sparse_grad=False)


class Lambda(Block):
    """A function of the inputs, or the name of an ``nd`` op, as a
    block."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._fn = getattr(_nd, function) if isinstance(function, str) \
            else function

    def forward(self, *args):
        return self._fn(*args)


class HybridLambda(HybridBlock):
    """``function(F, *inputs)`` with ``F`` the op namespace, or the op
    named by ``function`` on the inputs, through ``hybrid_forward``."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._fn_name = function if isinstance(function, str) else None
        self._fn = function

    def hybrid_forward(self, F, *args):
        if self._fn_name is not None:
            return getattr(F, self._fn_name)(*args)
        return self._fn(F, *args)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W (NCHW): ``padding`` an int, a
    4-tuple (left, right, top, bottom) or MXNet's 8-tuple ``pad_width``."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (padding,) * 4
        padding = tuple(padding)
        if len(padding) == 8:
            t, b, left, right = padding[4:]
            padding = (left, right, t, b)
        if len(padding) != 4:
            raise MXNetError(
                "ReflectionPad2D padding must be an int, a 4-tuple (left, "
                f"right, top, bottom) or an 8-tuple pad_width; got "
                f"{padding}")
        self._padding = padding

    def forward(self, x):
        return F.pad(x, self._padding, mode="reflect")

    def hybrid_forward(self, F, x):
        left, right, t, b = self._padding
        return F.pad(x, mode="reflect",
                     pad_width=(0, 0, 0, 0, t, b, left, right))
