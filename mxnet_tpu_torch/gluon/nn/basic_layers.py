"""Core Gluon layers of the BERT serving and the MLP/ResNet training
paths: HybridSequential, Dense, Activation, Flatten, Dropout, BatchNorm,
LayerNorm, Embedding.

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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ... import autograd
from ...base import MXNetError, torch_dtype
from ...contrib.amp import amp as _amp
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "Activation", "Flatten", "Dropout",
           "BatchNorm", "LayerNorm", "Embedding"]

_ACTIVATIONS = {"relu": F.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus}


def _activation(name):
    if name not in _ACTIVATIONS:
        raise MXNetError(f"unknown activation {name!r}; expected one of "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


class HybridSequential(HybridBlock):
    """Stacks blocks; ``forward`` runs them in order."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x):
        for child in self._modules.values():
            x = child(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())


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
        x, w, b = _amp.cast("FullyConnected", x, self.weight.data(),
                            None if self.bias is None else self.bias.data())
        out = F.linear(x, w, b)
        return out if self._act is None else self._act(out)


class Activation(HybridBlock):
    """``relu``, ``sigmoid``, ``tanh`` or ``softrelu``."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act = _activation(activation)

    def forward(self, x):
        return self._act(x)


class Flatten(HybridBlock):
    """``(N, ...)`` to ``(N, prod(...))``."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Dropout(HybridBlock):
    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate

    def forward(self, x):
        return F.dropout(x, self._rate, training=autograd.is_training())


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
        gamma = self.gamma.data() if self._scale else None
        beta = self.beta.data()
        r_mean, r_var = self.running_mean.data(), self.running_var.data()
        if not (autograd.is_training() and not self._use_global_stats):
            return F.batch_norm(x, r_mean, r_var, gamma, beta, False, 0.0,
                                self._epsilon)
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


class LayerNorm(HybridBlock):
    """Normalises over the last axis."""

    def __init__(self, epsilon=1e-5, beta_initializer="zeros",
                 gamma_initializer="ones", in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
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
            p._finish_deferred_init((x.shape[-1],))

    def forward(self, x):
        # FP32 under AMP
        x, gamma, beta = _amp.cast("LayerNorm", x, self.gamma.data(),
                                   self.beta.data())
        return F.layer_norm(x, (x.shape[-1],), gamma, beta, self._epsilon)


class Embedding(HybridBlock):
    """Integer ids -> dense vectors.  Out-of-range ids are clipped into
    ``[0, input_dim - 1]``, as the JAX package's gather does; ids are
    widened to int64 only for the lookup."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def forward(self, x):
        ids = x.long().clamp(0, self._input_dim - 1)
        return F.embedding(ids, self.weight.data())
