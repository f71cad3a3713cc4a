"""``gluon.contrib.rnn``: the convolutional recurrent cells
``ConvRNNCell``, ``ConvLSTMCell`` and ``ConvGRUCell``, and
``VariationalDropoutCell``.

Counterpart of ``mxnet_tpu/gluon/contrib/rnn.py``.  A conv cell's gates
are convolutions over (C, H, W) state maps: its ``hybrid_forward`` is
the JAX package's body, run on the ``nd`` ops (and on ``mx.sym``'s).
``VariationalDropoutCell`` draws one mask a sequence for the inputs, the
first state and the outputs while recording, and reuses it at every
step; the masks come from the port's generator of the array's device
(``mx.random.generator``), so ``mx.random.seed`` replays them.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ..rnn.rnn_cell import RecurrentCell

__all__ = ["ConvRNNCell", "ConvLSTMCell", "ConvGRUCell",
           "VariationalDropoutCell"]


class _BaseConvRNNCell(RecurrentCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, activation, prefix=None, params=None,
                 conv_layout="NCHW"):
        super().__init__(prefix=prefix, params=params)
        if conv_layout != "NCHW":
            raise MXNetError("conv cells support NCHW only")
        self._input_shape = tuple(input_shape)        # (C, H, W)
        self._channels = hidden_channels
        self._i2h_kernel = self._t2(i2h_kernel)
        self._h2h_kernel = self._t2(h2h_kernel)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError("h2h_kernel must be odd (state shape "
                                 "must be preserved)")
        self._i2h_pad = self._t2(i2h_pad)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        self._activation = activation
        cin = self._input_shape[0]
        ng = self._num_gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(ng * hidden_channels, cin) + self._i2h_kernel,
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(ng * hidden_channels, hidden_channels)
                + self._h2h_kernel,
                allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_channels,), init="zeros",
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_channels,), init="zeros",
                allow_deferred_init=True)

    @staticmethod
    def _t2(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    @property
    def _num_gates(self):
        raise NotImplementedError

    def _state_shape(self, batch_size):
        _, h, w = self._input_shape
        # i2h stride 1: spatial dims preserved when i2h_pad matches the
        # kernel; the reference computes the conv output size the same way
        oh = h + 2 * self._i2h_pad[0] - self._i2h_kernel[0] + 1
        ow = w + 2 * self._i2h_pad[1] - self._i2h_kernel[1] + 1
        return (batch_size, self._channels, oh, ow)

    def state_info(self, batch_size=0):
        return [{"shape": self._state_shape(batch_size),
                 "__layout__": "NCHW"}]

    def _conv_gates(self, F, x, h, i2h_weight, h2h_weight, i2h_bias,
                    h2h_bias):
        ng = self._num_gates
        i2h = F.Convolution(x, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=ng * self._channels)
        h2h = F.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=ng * self._channels)
        return i2h, h2h


class ConvRNNCell(_BaseConvRNNCell):
    """Vanilla conv recurrence: h' = act(conv(x) + conv(h))."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), activation="tanh",
                 prefix=None, params=None):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, prefix, params)

    @property
    def _num_gates(self):
        return 1

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, x, states[0], i2h_weight, h2h_weight,
                                    i2h_bias, h2h_bias)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class ConvLSTMCell(_BaseConvRNNCell):
    """ConvLSTM (Shi et al. 2015; reference ConvLSTMCell).  Gate order
    i, f, c, o matches the dense LSTMCell."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), activation="tanh",
                 prefix=None, params=None):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, prefix, params)

    @property
    def _num_gates(self):
        return 4

    def state_info(self, batch_size=0):
        s = self._state_shape(batch_size)
        return [{"shape": s, "__layout__": "NCHW"},
                {"shape": s, "__layout__": "NCHW"}]

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h, c = states
        i2h, h2h = self._conv_gates(F, x, h, i2h_weight, h2h_weight,
                                    i2h_bias, h2h_bias)
        gates = i2h + h2h
        sl = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(sl[0])
        forget_gate = F.sigmoid(sl[1])
        in_trans = F.Activation(sl[2], act_type=self._activation)
        out_gate = F.sigmoid(sl[3])
        next_c = forget_gate * c + in_gate * in_trans
        next_h = out_gate * F.Activation(next_c,
                                         act_type=self._activation)
        return next_h, [next_h, next_c]


class ConvGRUCell(_BaseConvRNNCell):
    """ConvGRU; gate order r, z, o matches the dense GRUCell."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), activation="tanh",
                 prefix=None, params=None):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, activation, prefix, params)

    @property
    def _num_gates(self):
        return 3

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = states[0]
        i2h, h2h = self._conv_gates(F, x, h, i2h_weight, h2h_weight,
                                    i2h_bias, h2h_bias)
        ii = F.split(i2h, num_outputs=3, axis=1)
        hh = F.split(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(ii[0] + hh[0])
        update = F.sigmoid(ii[1] + hh[1])
        cand = F.Activation(ii[2] + reset * hh[2],
                            act_type=self._activation)
        next_h = (1.0 - update) * cand + update * h
        return next_h, [next_h]


class VariationalDropoutCell(RecurrentCell):
    """One dropout mask per sequence, reused at every step (Gal &
    Ghahramani 2016; reference VariationalDropoutCell) — applied to the
    base cell's inputs, states, and outputs."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.reset_mask()

    def reset_mask(self):
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        self.reset_mask()
        return self.base_cell.begin_state(batch_size, **kwargs)

    @staticmethod
    def _mask(p, like):
        from ... import random
        keep = 1.0 - p
        draw = torch.rand(like.shape, generator=random.generator(
            like.device), device=like.device)
        return (draw < keep).to(like.dtype) / keep

    def forward(self, x, states):
        from ... import autograd
        training = autograd.is_recording()
        if training and self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask(self.drop_inputs, x)
            x = x * self._input_mask
        if training and self.drop_states:
            if self._state_mask is None:
                self._state_mask = self._mask(self.drop_states, states[0])
            states = [s * self._state_mask for s in states[:1]] + \
                list(states[1:])
        out, new_states = self.base_cell(x, states)
        if training and self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask(self.drop_outputs, out)
            out = out * self._output_mask
        return out, new_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset_mask()
        return super().unroll(length, inputs, begin_state, layout,
                              merge_outputs, valid_length)
