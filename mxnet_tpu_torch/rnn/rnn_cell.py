"""Symbolic RNN cells: ``RNNParams``, ``BaseRNNCell``, ``RNNCell``,
``LSTMCell``, ``GRUCell``, ``FusedRNNCell``, ``SequentialRNNCell`` and the
modifier cells ``DropoutCell``, ``ResidualCell`` and
``BidirectionalCell``.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py``.  A cell builds Symbol
graphs: ``cell(inputs, states)`` appends one step, ``cell.unroll(T,
inputs)`` the whole sequence, each step its own nodes over the cell's
shared weight variables.  Gate orders are MXNet's (i, f, c, o for the
LSTM; r, z, o for the GRU).  ``LSTMCell``'s ``forget_bias`` is applied
at initialisation (an ``__init__`` attribute on the bias variable that
``Module.init_params`` reads), never at run time.  Without a
``begin_state``, ``unroll`` makes the zero states in the graph from the
first step's input, so they need no binding.

``FusedRNNCell.unroll`` is one ``RNN`` node (cuDNN on the card) over one
packed parameter vector, laid out as the JAX package's and cuDNN's: per
layer, per direction, ``i2h_weight``, ``h2h_weight``, ``i2h_bias``,
``h2h_bias``, gates in the order above; ``unpack_weights`` and
``pack_weights`` convert between it and the per-cell weights of
``unfuse()``'s cells (named ``{prefix}l{layer}_``/``r{layer}_``).  A
``SequentialRNNCell`` holding a cell that cannot step (``FusedRNNCell``,
``BidirectionalCell``) unrolls layer by layer, as MXNet 1.x's does (the
JAX package's steps every cell and raises there).
"""
from __future__ import annotations

import math
from typing import List, Optional

from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell"]


def _sym():
    from .. import symbol
    return symbol


class RNNParams:
    """Container for a cell's Symbol variables, keyed by name suffix."""

    def __init__(self, prefix: str = ""):
        self._prefix = prefix
        self._params = {}

    def get(self, name: str, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = _sym().var(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract cell: one step of computation on Symbol inputs."""

    def __init__(self, prefix: str = "", params: Optional[RNNParams] = None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self) -> None:
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self) -> RNNParams:
        self._own_params = False
        return self._params

    @property
    def state_info(self) -> List[dict]:
        raise NotImplementedError

    def __call__(self, inputs, states):
        raise NotImplementedError

    # -- states ------------------------------------------------------------
    def begin_state(self, func=None, **kwargs) -> List:
        """Zero initial states.  With no batch reference available the
        reference emits shape-(0,·) zeros resolved at bind; here each
        state becomes a variable named ``{prefix}begin_state_N`` that
        simple_bind treats as an auxiliary input (bind zeros), unless the
        caller passes ``batch_ref`` (any (N, ·) Symbol) — then the state
        is synthesized in-graph as broadcast zeros and needs no binding."""
        assert not self._modified, \
            "After applying modifier cells, call begin_state on the base"
        batch_ref = kwargs.pop("batch_ref", None)
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = f"{self._prefix}begin_state_{self._init_counter}"
            n_hidden = info["shape"][-1]
            if batch_ref is not None:
                sym = _sym()
                col = sym.zeros_like(
                    sym.slice_axis(batch_ref, axis=-1, begin=0, end=1))
                state = sym.broadcast_to(col, shape=(0, n_hidden))
            elif func is not None:
                state = func(name=name, **info)
            else:
                state = _sym().var(name, shape=info["shape"])
            states.append(state)
        return states

    # -- weights (the fused op's interchange) -------------------------------
    def unpack_weights(self, args: dict) -> dict:
        return dict(args)

    def pack_weights(self, args: dict) -> dict:
        return dict(args)

    # -- unroll ------------------------------------------------------------
    def _normalize_inputs(self, length: int, inputs, layout: str):
        sym = _sym()
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != length:
                raise MXNetError(f"unroll: {len(inputs)} inputs for "
                                 f"length {length}")
            return list(inputs)
        axis = layout.find("T")
        if axis not in (0, 1):
            raise MXNetError(f"unsupported layout {layout!r}")
        split = sym.split(inputs, num_outputs=length, axis=axis,
                          squeeze_axis=True)
        if length == 1:
            return [split]
        return [split[i] for i in range(length)]

    def unroll(self, length: int, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell ``length`` steps.

        Returns (outputs, states): outputs is a list of per-step Symbols,
        or one stacked Symbol when merge_outputs=True (stacked on the
        layout's T axis)."""
        self.reset()
        seq = self._normalize_inputs(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_ref=seq[0])
        states = begin_state
        outputs = []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
        if merge_outputs:
            axis = layout.find("T")
            outputs = _sym().stack(*outputs, axis=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla tanh/relu cell (reference RNNCell)."""

    def __init__(self, num_hidden: int, activation: str = "tanh",
                 prefix: str = "rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        sym = _sym()
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=self._num_hidden,
                                 name=f"{name}h2h")
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM (reference LSTMCell; gate order i, f, c, o).

    ``forget_bias`` follows the reference convention: applied at
    INITIALIZATION (an ``__init__`` attr on the bias variable consumed by
    Module.init_params), never at runtime — so trained weights stay
    bit-interchangeable with the fused RNN op's packed parameters."""

    def __init__(self, num_hidden: int, prefix: str = "lstm_", params=None,
                 forget_bias: float = 1.0):
        super().__init__(prefix=prefix, params=params)
        import json
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get(
            "i2h_bias",
            __init__=json.dumps(["lstmbias",
                                 {"forget_bias": forget_bias}]))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        sym = _sym()
        name = f"{self._prefix}t{self._counter}_"
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=4 * self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(data=states[0], weight=self._hW,
                                 bias=self._hB,
                                 num_hidden=4 * self._num_hidden,
                                 name=f"{name}h2h")
        gates = i2h + h2h
        g = sym.split(gates, num_outputs=4, axis=1,
                      name=f"{name}slice")
        in_gate = sym.Activation(g[0], act_type="sigmoid")
        forget_gate = sym.Activation(g[1], act_type="sigmoid")
        in_transform = sym.Activation(g[2], act_type="tanh")
        out_gate = sym.Activation(g[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU (reference GRUCell; gate order r, z, o)."""

    def __init__(self, num_hidden: int, prefix: str = "gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        sym = _sym()
        name = f"{self._prefix}t{self._counter}_"
        prev = states[0]
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{name}i2h")
        h2h = sym.FullyConnected(data=prev, weight=self._hW, bias=self._hB,
                                 num_hidden=3 * self._num_hidden,
                                 name=f"{name}h2h")
        ii = sym.split(i2h, num_outputs=3, axis=1)
        hh = sym.split(h2h, num_outputs=3, axis=1)
        reset = sym.Activation(ii[0] + hh[0], act_type="sigmoid")
        update = sym.Activation(ii[1] + hh[1], act_type="sigmoid")
        next_h_tmp = sym.Activation(ii[2] + reset * hh[2], act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """The whole sequence in one ``RNN`` node (JAX :281-472)."""

    def __init__(self, num_hidden: int, num_layers: int = 1,
                 mode: str = "lstm", bidirectional: bool = False,
                 dropout: float = 0.0, prefix: Optional[str] = None,
                 params=None, forget_bias: float = 1.0,
                 get_next_state: bool = False, input_size: int = 0):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        kw = {}
        if input_size:
            from ..ndarray.ops_nn import rnn_param_size
            kw["shape"] = (rnn_param_size(mode, num_layers, input_size,
                                          num_hidden, bidirectional),)
        self._param = self.params.get("parameters", **kw)

    @property
    def _dirs(self) -> int:
        return 2 if self._bidirectional else 1

    @property
    def state_info(self):
        info = {"shape": (self._dirs * self._num_layers, 0,
                          self._num_hidden), "__layout__": "LNC"}
        return [info, dict(info)] if self._mode == "lstm" else [info]

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot step; use unroll()")

    def unroll(self, length: int, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        sym = _sym()
        if isinstance(inputs, (list, tuple)):
            inputs = sym.stack(*inputs, axis=layout.find("T"))
        if layout == "NTC":                  # the RNN op takes TNC
            inputs = sym.swapaxes(inputs, dim1=0, dim2=1)
        if begin_state is None:
            # zero states (L * D, N, H) made in the graph from the data
            col = sym.zeros_like(sym.slice_axis(sym.slice_axis(
                inputs, axis=0, begin=0, end=1), axis=2, begin=0, end=1))
            zero = sym.broadcast_to(col, shape=(
                self._dirs * self._num_layers, 0, self._num_hidden))
            begin_state = [zero] * len(self.state_info)
        kwargs = {"state": begin_state[0]}
        if self._mode == "lstm":
            kwargs["state_cell"] = begin_state[1]
        out = sym.RNN(data=inputs, parameters=self._param,
                      state_size=self._num_hidden,
                      num_layers=self._num_layers, mode=self._mode,
                      bidirectional=self._bidirectional, p=self._dropout,
                      state_outputs=True, name=f"{self._prefix}rnn",
                      **kwargs)
        seq = out[0]
        if layout == "NTC":
            seq = sym.swapaxes(seq, dim1=0, dim2=1)
        states = [out[1]] + ([out[2]] if self._mode == "lstm" else [])
        if merge_outputs is False:
            split = sym.split(seq, num_outputs=length,
                              axis=layout.find("T"), squeeze_axis=True)
            seq = [split] if length == 1 else \
                [split[i] for i in range(length)]
        return seq, (states if self._get_next_state else [])

    def _slices(self, input_size: int):
        """(cell prefix, name, shape, offset) of each piece of the packed
        vector, and its length."""
        from ..ndarray.ops_nn import RNN_GATES
        g, h = RNN_GATES[self._mode], self._num_hidden
        out, offset, layer_in = [], 0, input_size
        for layer in range(self._num_layers):
            for d in range(self._dirs):
                cp = f"{self._prefix}{'lr'[d]}{layer}_"
                for nm, shape in (("i2h_weight", (g * h, layer_in)),
                                  ("h2h_weight", (g * h, h)),
                                  ("i2h_bias", (g * h,)),
                                  ("h2h_bias", (g * h,))):
                    out.append((cp, nm, shape, offset))
                    offset += math.prod(shape)
            layer_in = h * self._dirs
        return out, offset

    def _input_size(self, total: int) -> int:
        """Layer 0's input size from the packed vector's length."""
        from ..ndarray.ops_nn import RNN_GATES
        g, h = RNN_GATES[self._mode], self._num_hidden
        rest = sum(self._dirs * (g * h * h * self._dirs + g * h * h
                                 + 2 * g * h)
                   for _ in range(1, self._num_layers))
        first = self._dirs * (g * h * h + 2 * g * h)
        size, rem = divmod(total - rest - first, self._dirs * g * h)
        if rem or size <= 0:
            raise MXNetError(f"packed parameter length {total} does not "
                             f"match mode={self._mode} layers="
                             f"{self._num_layers} hidden={self._num_hidden}")
        return size

    def unpack_weights(self, args: dict) -> dict:
        """``{prefix}parameters`` split into ``unfuse()``'s cells'
        weights (views of one copy, where the vector was)."""
        from ..ndarray import NDArray
        key = f"{self._prefix}parameters"
        if key not in args:
            return dict(args)
        args = dict(args)
        packed = args.pop(key)
        flat = (packed._data if isinstance(packed, NDArray) else
                packed).detach().reshape(-1).clone()
        slices, _ = self._slices(self._input_size(flat.numel()))
        for cp, nm, shape, offset in slices:
            args[cp + nm] = NDArray(
                flat[offset:offset + math.prod(shape)].view(shape))
        return args

    def pack_weights(self, args: dict) -> dict:
        """The inverse of ``unpack_weights``."""
        import torch
        from ..ndarray import NDArray
        probe = f"{self._prefix}l0_i2h_weight"
        if probe not in args:
            return dict(args)
        args = dict(args)
        slices, _ = self._slices(args[probe].shape[-1])
        parts = []
        for cp, nm, _, _ in slices:
            a = args.pop(cp + nm)
            parts.append((a._data if isinstance(a, NDArray) else
                          a).detach().reshape(-1))
        args[f"{self._prefix}parameters"] = NDArray(torch.cat(parts))
        return args

    def unfuse(self) -> "SequentialRNNCell":
        """The unfused cells that compute the same thing."""
        make = {"rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
                "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
                "lstm": lambda p: LSTMCell(self._num_hidden, p),
                "gru": lambda p: GRUCell(self._num_hidden, p)}[self._mode]
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make(f"{self._prefix}l{i}_"),
                    make(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(make(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Cells applied in order each step."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells: List[BaseRNNCell] = []

    def add(self, cell: BaseRNNCell) -> None:
        self._cells.append(cell)

    @property
    def state_info(self):
        return [i for c in self._cells for i in c.state_info]

    def begin_state(self, func=None, **kwargs):
        return [s for c in self._cells
                for s in c.begin_state(func=func, **kwargs)]

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def unroll(self, length: int, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        if not any(isinstance(c, (FusedRNNCell, BidirectionalCell))
                   for c in self._cells):
            return super().unroll(length, inputs, begin_state, layout,
                                  merge_outputs)
        self.reset()
        states, p, last = [], 0, len(self._cells) - 1
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            inputs, st = cell.unroll(
                length, inputs,
                None if begin_state is None else begin_state[p:p + n],
                layout, merge_outputs if i == last else None)
            states.extend(st)
            p += n
        return inputs, states

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args


class DropoutCell(BaseRNNCell):
    """Dropout on each step's output (JAX :523-539)."""

    def __init__(self, dropout: float, prefix: str = "dropout_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = _sym().Dropout(inputs, p=self._dropout)
        return inputs, states


class ResidualCell(BaseRNNCell):
    """The base cell's output plus the step's input (JAX :541-563)."""

    def __init__(self, base_cell: BaseRNNCell):
        super().__init__(prefix=base_cell._prefix, params=base_cell._params)
        self.base_cell = base_cell
        base_cell._modified = True

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        self.base_cell._modified = False
        st = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return st

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class BidirectionalCell(BaseRNNCell):
    """One cell forward and one backward over the sequence, each step's
    outputs concatenated (JAX :565-613; unroll only)."""

    def __init__(self, l_cell: BaseRNNCell, r_cell: BaseRNNCell,
                 params=None, output_prefix: str = "bi_"):
        super().__init__(prefix="", params=params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, func=None, **kwargs):
        return (self._l_cell.begin_state(func=func, **kwargs) +
                self._r_cell.begin_state(func=func, **kwargs))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot step; use unroll()")

    def unroll(self, length: int, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        sym = _sym()
        seq = self._normalize_inputs(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_ref=seq[0])
        nl = len(self._l_cell.state_info)
        l_out, l_states = self._unroll_one(self._l_cell, seq,
                                           begin_state[:nl])
        r_out, r_states = self._unroll_one(self._r_cell, seq[::-1],
                                           begin_state[nl:])
        outputs = [sym.concat(lo, ro, dim=1,
                              name=f"{self._output_prefix}t{t}")
                   for t, (lo, ro) in enumerate(zip(l_out, r_out[::-1]))]
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=layout.find("T"))
        return outputs, l_states + r_states

    @staticmethod
    def _unroll_one(cell, seq, states):
        outs = []
        for x in seq:
            o, states = cell(x, states)
            outs.append(o)
        return outs, states
