"""Fused recurrent layers: ``RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` over the ``RNN`` op
(``ndarray/ops_nn.py``): layouts "TNC" and "NTC", ``num_layers``,
``bidirectional``, ``dropout`` between layers, ``begin_state``, and the
JAX package's parameters, per layer ``i`` and direction (``l``, and
``r`` when bidirectional) ``{l,r}{i}_i2h_weight`` ``(gates * hidden,
input)``, ``{l,r}{i}_h2h_weight`` ``(gates * hidden, hidden)``,
``{l,r}{i}_i2h_bias`` and ``{l,r}{i}_h2h_bias`` (:19-75), in its
creation order.  Called as ``layer(x)`` it returns the output; as
``layer(x, states)`` the output and the final states, each ``(layers *
directions, N, hidden)``.

The layer runs one torch recurrent call a layer (``ops_nn.rnn_run``):
cuDNN on the card, torch's own loop on the CPU.  ``dropout`` applies to
every layer's output but the last in training mode, as MXNet's cuDNN op
does (the JAX op ignores it), with masks from the port's generator, so a
hybridized layer draws fresh masks at each replay, as ``Dropout`` does.
On the card each layer's parameters are views of one buffer laid out as
cuDNN wants it (``torch._cudnn_rnn_flatten_weight``, MXNet's
``_rnn_param_concat``), made at the first call on the card and again
whenever a parameter's storage was replaced (``cast``, ``reset_ctx``);
values set later (``set_data``, ``load_parameters``) are copied into the
buffer (``Parameter.keep_storage``), so cuDNN never copies the weights.
A capture that finds the buffer broken raises ``MXNetError`` instead.

``projection_size``, the LSTM state clips and ``use_sequence_length``,
which the JAX op ignores, raise ``MXNetError`` when set.
"""
from __future__ import annotations

import torch

from ... import autograd
from ...base import MXNetError
from ...ndarray.ops_nn import CUDNN_MODE, RNN_GATES, rnn_run
from ..block import HybridBlock
from .rnn_cell import _begin_state

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", projection_size=None,
                 h2r_weight_initializer=None, state_clip_min=None,
                 state_clip_max=None, state_clip_nan=False,
                 use_sequence_length=False, dtype="float32", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"layout must be TNC or NTC, got {layout}")
        for name, v in (("projection_size", projection_size),
                        ("state_clip_min", state_clip_min),
                        ("state_clip_max", state_clip_max),
                        ("state_clip_nan", state_clip_nan),
                        ("use_sequence_length", use_sequence_length)):
            if v:
                raise MXNetError(f"gluon.rnn: {name} is not ported")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = RNN_GATES[mode]
        self._by_layer = []          # per layer: its 4 * directions params
        self._flat = {}              # layer -> data_ptrs of its buffer
        ng, nh, ni = self._gates, hidden_size, input_size
        inits = (i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer)
        with self.name_scope():
            for i in range(num_layers):
                mine = []
                for j in ("lr"[:self._dir]):
                    for kind, shape, init in (
                            ("i2h_weight", (ng * nh, ni), inits[0]),
                            ("h2h_weight", (ng * nh, nh), inits[1]),
                            ("i2h_bias", (ng * nh,), inits[2]),
                            ("h2h_bias", (ng * nh,), inits[3])):
                        name = f"{j}{i}_{kind}"
                        p = self.params.get(name, shape=shape, init=init,
                                            allow_deferred_init=True)
                        setattr(self, name, p)
                        mine.append(p)
                self._by_layer.append(mine)
                ni = nh * self._dir

    def infer_shape(self, x, *args):
        if x.dim() != 3:
            raise MXNetError(f"rnn input must be 3-d, got {x.dim()}-d")
        width = x.shape[2]
        for j in range(self._dir):
            self._by_layer[0][4 * j]._finish_deferred_init(
                (self._gates * self._hidden_size, width))

    def state_info(self, batch_size=0):
        info = {"shape": (self._num_layers * self._dir, batch_size,
                          self._hidden_size), "__layout__": "LNC"}
        return [info, dict(info)] if self._mode == "lstm" else [info]

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states, ``func`` (``nd.zeros``) of shape ``(layers
        * directions, batch_size, hidden)`` on ``ctx``: ``h``, and ``c``
        for an LSTM."""
        return _begin_state(self.state_info(batch_size), func, ctx, kwargs)

    def _flatten(self) -> None:
        """On the card, make each layer's parameters views of one buffer
        in cuDNN's layout, unless they are already (see the module
        docstring)."""
        for i, params in enumerate(self._by_layer):
            datas = [p._data for p in params]
            if datas[0].device.type != "cuda":
                continue
            ptrs = tuple(d.data_ptr() for d in datas)
            if self._flat.get(i) == ptrs:
                continue
            if torch.cuda.is_current_stream_capturing():
                raise MXNetError(
                    f"{self.name}: layer {i}'s weights are not one cuDNN "
                    f"buffer inside a capture; call the layer once "
                    f"eagerly after replacing its parameters")
            with torch.no_grad():
                torch._cudnn_rnn_flatten_weight(
                    datas, 4, datas[0].shape[1], CUDNN_MODE[self._mode],
                    self._hidden_size, 0, 1, False, self._dir == 2)
            for p in params:
                p.keep_storage()
            self._flat[i] = tuple(d.data_ptr() for d in datas)

    def forward(self, inputs, states=None):
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        skip_states = states is None
        if skip_states:
            shape = (self._num_layers * self._dir, inputs.shape[1],
                     self._hidden_size)
            states = [torch.zeros(shape, dtype=inputs.dtype,
                                  device=inputs.device)
                      for _ in range(2 if self._mode == "lstm" else 1)]
        elif isinstance(states, torch.Tensor):
            states = [states]
        self._flatten()
        layers = [[p._tensor() for p in params] for params in self._by_layer]
        outs = rnn_run(self._mode, inputs, layers, states[0],
                       states[1] if self._mode == "lstm" else None,
                       self._dir == 2,
                       self._dropout if autograd.is_training() else 0.0)
        out = outs[0]
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        return out if skip_states else (out, list(outs[1:]))


class RNN(_RNNLayer):
    """Multi-layer Elman RNN, ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers,
                         layout, dropout, bidirectional, input_size, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (gates i, f, g, o)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (gates r, z, n; cuDNN's form of n)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
