"""Recurrent cells and their unrolling.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: ``RecurrentCell``
(``begin_state``, ``state_info``, ``unroll``), ``RNNCell``, ``LSTMCell``,
``GRUCell`` (the JAX package's parameters ``i2h_weight``, ``h2h_weight``,
``i2h_bias``, ``h2h_bias``; gates i, f, g, o and r, z, n), and the
modifiers ``SequentialRNNCell``, ``DropoutCell``, ``ResidualCell`` and
``BidirectionalCell``.  A cell's call is ``cell(x_t, states) -> (out,
states)`` on tensors (or ``NDArray``s, answered in kind); its forward is
torch code.

``unroll(length, inputs, begin_state, layout, merge_outputs,
valid_length)`` steps the cell over the time axis of ``layout`` ("NTC" or
"TNC"; ``inputs`` may also be a list of steps).  With ``valid_length``
the outputs past each sequence's length are zeroed (``SequenceMask``)
and the states returned are each sequence's at its last valid step, as
MXNet's ``unroll`` does (``SequenceLast``); the JAX package returns the
states after the last step of the batch.  ``BidirectionalCell`` reverses
each sequence within its valid length (``SequenceReverse``), as MXNet's;
the JAX package flips the whole time axis.  Both agree when no
``valid_length`` is given.
"""
from __future__ import annotations

import torch

from ... import ndarray as _nd
from ...base import MXNetError
from ...ndarray.ops_matrix import (sequence_last_maker, sequence_mask_maker,
                                   sequence_reverse_maker)
from ...ndarray.ops_nn import activation_maker, dropout_maker
from ...ndarray.register import call_on_tensors, has_ndarray
from ..block import HybridBlock

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "BidirectionalCell"]


def _begin_state(infos, func, ctx, kwargs):
    func = func or _nd.zeros
    return [func(shape=info["shape"], ctx=ctx, **kwargs) for info in infos]


def _steps(inputs, length: int, layout: str):
    """The list of per-step inputs and the batch size."""
    if isinstance(inputs, (list, tuple)):
        if len(inputs) != length:
            raise MXNetError(f"unroll: {len(inputs)} steps for length "
                             f"{length}")
        return list(inputs), inputs[0].shape[0]
    axis = layout.find("T")
    if inputs.shape[axis] != length:
        raise MXNetError(f"unroll: {inputs.shape[axis]} steps on axis "
                         f"{axis} for length {length}")
    return list(inputs.unbind(axis)), inputs.shape[layout.find("N")]


class RecurrentCell(HybridBlock):
    """A cell of one recurrent step (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states, ``func`` (``nd.zeros``) of each
        ``state_info`` shape on ``ctx``."""
        return _begin_state(self.state_info(batch_size), func, ctx, kwargs)

    def _zero_states(self, batch: int, like: torch.Tensor):
        return [torch.zeros(info["shape"], dtype=like.dtype,
                            device=like.device)
                for info in self.state_info(batch)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """``length`` steps of the cell over ``inputs``; returns the
        outputs (stacked on the time axis unless ``merge_outputs`` is
        False) and the final states."""
        args = (length, inputs, begin_state, layout, merge_outputs,
                valid_length)
        if has_ndarray(args, {}):
            return call_on_tensors(self._unroll, args, {})
        return self._unroll(*args)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"layout must be NTC or TNC, got {layout}")
        axis = layout.find("T")
        seq, batch = _steps(inputs, length, layout)
        states = list(begin_state) if begin_state is not None else \
            self._zero_states(batch, seq[0])
        outputs, history = [], []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
            if valid_length is not None:
                history.append(states)
        if valid_length is None:
            if merge_outputs or merge_outputs is None:
                outputs = torch.stack(outputs, dim=axis)
            return outputs, states
        last = sequence_last_maker(True, 0)
        states = [last(torch.stack(list(s), dim=0), valid_length)
                  for s in zip(*history)]
        merged = sequence_mask_maker(True, 0.0, axis)(
            torch.stack(outputs, dim=axis), valid_length)
        if merge_outputs is False:
            return list(merged.unbind(axis)), states
        return merged, states


def _gate_params(cell, gates, hidden_size, input_size, inits):
    i2h_w, h2h_w, i2h_b, h2h_b = inits
    with cell.name_scope():
        cell.i2h_weight = cell.params.get(
            "i2h_weight", shape=(gates * hidden_size, input_size),
            init=i2h_w, allow_deferred_init=True)
        cell.h2h_weight = cell.params.get(
            "h2h_weight", shape=(gates * hidden_size, hidden_size),
            init=h2h_w, allow_deferred_init=True)
        cell.i2h_bias = cell.params.get(
            "i2h_bias", shape=(gates * hidden_size,), init=i2h_b,
            allow_deferred_init=True)
        cell.h2h_bias = cell.params.get(
            "h2h_bias", shape=(gates * hidden_size,), init=h2h_b,
            allow_deferred_init=True)


class _GatedCell(RecurrentCell):
    """What RNNCell, LSTMCell and GRUCell share: ``gates`` blocks of
    ``hidden_size`` rows in each weight, the input width inferred at the
    first call, and the two projections of a step."""

    _gates = 1
    _n_states = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        _gate_params(self, self._gates, hidden_size, input_size,
                     (i2h_weight_initializer, h2h_weight_initializer,
                      i2h_bias_initializer, h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * self._n_states

    def infer_shape(self, x, *args):
        self.i2h_weight._finish_deferred_init(
            (self._gates * self._hidden_size, x.shape[-1]))

    def _projections(self, x, h):
        return (torch.nn.functional.linear(x, self.i2h_weight._tensor(),
                                           self.i2h_bias._tensor()),
                torch.nn.functional.linear(h, self.h2h_weight._tensor(),
                                           self.h2h_bias._tensor()))


class RNNCell(_GatedCell):
    """``h' = act(W_ih x + b_ih + W_hh h + b_hh)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix=prefix, params=params)
        self._activation = activation
        self._act = activation_maker(activation)

    def forward(self, x, states):
        i2h, h2h = self._projections(x, states[0])
        out = self._act(i2h + h2h)
        return out, [out]

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        """The symbolic body (``mxnet_tpu/gluon/rnn/rnn_cell.py:94-102``)."""
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """Gates i, f, g, o from ``W_ih x + b_ih + W_hh h + b_hh``."""

    _gates = 4
    _n_states = 2

    def forward(self, x, states):
        h, c = states
        i2h, h2h = self._projections(x, h)
        i, f, g, o = (i2h + h2h).chunk(4, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, [h_new, c_new]

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        """The symbolic body (``mxnet_tpu/gluon/rnn/rnn_cell.py:133-147``)."""
        h, c = states
        n = 4 * self._hidden_size
        gates = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=n) + \
            F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n)
        i, f, g, o = F.split(gates, num_outputs=4, axis=1)
        c_new = F.sigmoid(f) * c + F.sigmoid(i) * F.tanh(g)
        h_new = F.sigmoid(o) * F.tanh(c_new)
        return h_new, [h_new, c_new]


class GRUCell(_GatedCell):
    """Gates r, z from the summed projections, ``n = tanh(x_n + r *
    h_n)``, ``h' = (1 - z) n + z h``."""

    _gates = 3

    def forward(self, x, states):
        h = states[0]
        i2h, h2h = self._projections(x, h)
        xr, xz, xn = i2h.chunk(3, dim=1)
        hr, hz, hn = h2h.chunk(3, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        out = (1 - z) * n + z * h
        return out, [out]

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        """The symbolic body (``mxnet_tpu/gluon/rnn/rnn_cell.py:177-190``)."""
        h = states[0]
        n = 3 * self._hidden_size
        xr, xz, xn = F.split(F.FullyConnected(
            x, i2h_weight, i2h_bias, num_hidden=n), num_outputs=3, axis=1)
        hr, hz, hn = F.split(F.FullyConnected(
            h, h2h_weight, h2h_bias, num_hidden=n), num_outputs=3, axis=1)
        r = F.sigmoid(xr + hr)
        z = F.sigmoid(xz + hz)
        out = (1 - z) * F.tanh(xn + r * hn) + z * h
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its own
    slice of the states."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._cells = []

    def add(self, cell):
        self.register_child(cell)
        self._cells.append(cell)

    def state_info(self, batch_size=0):
        return [info for c in self._cells
                for info in c.state_info(batch_size)]

    def begin_state(self, batch_size=0, **kwargs):
        return [s for c in self._cells
                for s in c.begin_state(batch_size, **kwargs)]

    def forward(self, x, states):
        next_states, pos = [], 0
        for c in self._cells:
            n = len(c.state_info())
            x, s = c(x, states[pos:pos + n])
            pos += n
            next_states.extend(s)
        return x, next_states


class DropoutCell(RecurrentCell):
    """Dropout of the step's input in training mode; no states."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._drop = dropout_maker(rate, axes=tuple(axes))

    def state_info(self, batch_size=0):
        return []

    def forward(self, x, states):
        return (self._drop(x) if self._rate > 0 else x), states


class ResidualCell(RecurrentCell):
    """``base_cell``'s output plus the step's input."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, *args, **kwargs):
        return self.base_cell.begin_state(*args, **kwargs)

    def forward(self, x, states):
        out, states = self.base_cell(x, states)
        return out + x, states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed, their
    outputs concatenated on the features (``unroll`` only)."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def begin_state(self, *args, **kwargs):
        return self.l_cell.begin_state(*args, **kwargs) + \
            self.r_cell.begin_state(*args, **kwargs)

    def forward(self, x, states):
        raise MXNetError("BidirectionalCell supports unroll() only")

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        axis = layout.find("T")
        nl = len(self.l_cell.state_info())
        l_states = begin_state[:nl] if begin_state else None
        r_states = begin_state[nl:] if begin_state else None
        seq = torch.stack(list(inputs), dim=axis) \
            if isinstance(inputs, (list, tuple)) else inputs
        l_out, l_states = self.l_cell._unroll(length, seq, l_states, layout,
                                              True, valid_length)

        def reverse(t):
            if valid_length is None:
                return torch.flip(t, (axis,))
            tm = t.transpose(0, 1) if axis == 1 else t
            r = sequence_reverse_maker(True, 0)(tm, valid_length)
            return r.transpose(0, 1) if axis == 1 else r
        r_out, r_states = self.r_cell._unroll(length, reverse(seq),
                                              r_states, layout, True,
                                              valid_length)
        out = torch.cat([l_out, reverse(r_out)], dim=2)
        if merge_outputs is False:
            out = list(out.unbind(axis))
        return out, l_states + r_states
