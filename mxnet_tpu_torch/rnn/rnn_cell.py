"""Symbolic RNN cells: ``RNNParams``, ``BaseRNNCell``, ``RNNCell``,
``LSTMCell``, ``GRUCell`` and ``SequentialRNNCell``.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py``.  A cell builds Symbol
graphs: ``cell(inputs, states)`` appends one step, ``cell.unroll(T,
inputs)`` the whole sequence, each step its own nodes over the cell's
shared weight variables.  Gate orders are MXNet's (i, f, c, o for the
LSTM; r, z, o for the GRU).  ``LSTMCell``'s ``forget_bias`` is applied
at initialisation (an ``__init__`` attribute on the bias variable that
``Module.init_params`` reads), never at run time.  Without a
``begin_state``, ``unroll`` makes the zero states in the graph from the
first step's input, so they need no binding.  The cells over the fused
``RNN`` op (``FusedRNNCell``) and the modifier cells (``DropoutCell``,
``ResidualCell``, ``BidirectionalCell``) are not ported.
"""
from __future__ import annotations

from typing import List, Optional

from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell"]


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


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order each step."""

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
