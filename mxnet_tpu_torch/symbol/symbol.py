"""Symbol: a graph of registry ops, its shape and type inference, and its
JSON.

Counterpart of ``mxnet_tpu/symbol/symbol.py``.  A :class:`Symbol` is an
ordered list of heads ``(node, output index)`` over a DAG of ``_Node``s;
a node is a variable (``op`` None) or one op of the ``nd`` registry with
its attributes.  The graph is plain Python: ``compile(training)`` returns
a function that evaluates it eagerly, node by node, through the
registry's op functions on torch tensors (the JAX package lowers it to one
JAX function that ``simple_bind`` jits).  ``infer_shape`` runs that
function on ``meta`` tensors (shapes only, no data; the JAX package's
``jax.eval_shape``), after the parameter-shape rules of the common layers
fill in the variables no input determines; ``infer_type`` is the JAX
package's forward dtype pass.

The JSON is the JAX package's (``nodes`` with ``op``/``name``/``attrs``/
``inputs``, ``arg_nodes``, ``heads``), so a ``-symbol.json`` written by
either package loads in the other.  Attribute values are written as
strings (lists and tuples as JSON) and parsed back on load.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, torch_dtype

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json"]

_name_lock = threading.Lock()
_name_counters: Dict[str, int] = {}


def _op_kwargs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Node attributes minus ``__key__``-style entries (``__shape__``,
    ``__dtype__``, ``__init__``, ``__aux__``), which are metadata, never
    op parameters."""
    return {k: v for k, v in attrs.items()
            if not (k.startswith("__") and k.endswith("__"))}


def _auto_name(hint: str) -> str:
    with _name_lock:
        idx = _name_counters.get(hint, 0)
        _name_counters[hint] = idx + 1
    return f"{hint}{idx}"


class _Node:
    """One op application (or variable) in the graph."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op: Optional[str], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]], num_outputs: int = 1):
        self.op = op          # None for variables
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.num_outputs = num_outputs

    @property
    def is_var(self) -> bool:
        return self.op is None


class Symbol:
    """An ordered list of (node, output_index) heads."""

    def __init__(self, heads: List[Tuple[_Node, int]]):
        self._heads = heads

    # -- construction ------------------------------------------------------
    @staticmethod
    def var(name: str, shape=None, dtype=None, **kwargs) -> "Symbol":
        from .. import attribute
        attrs: Dict[str, Any] = attribute.current().get()
        if shape is not None:
            attrs["__shape__"] = tuple(shape)
        if dtype is not None:
            attrs["__dtype__"] = np.dtype(dtype).name
        attrs.update({k: v for k, v in kwargs.items() if v is not None})
        return Symbol([(_Node(None, name, attrs, []), 0)])

    # -- protocol ----------------------------------------------------------
    @property
    def name(self) -> str:
        node, idx = self._heads[0]
        if node.num_outputs > 1:
            return f"{node.name}_output{idx}"
        return node.name

    def __len__(self):
        return len(self._heads)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            idx = self.list_outputs().index(idx)
        return Symbol([self._heads[idx]])

    def __iter__(self):
        return (Symbol([h]) for h in self._heads)

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def _binop(self, opname, other, reverse=False):
        from ..ndarray.register import _SCALAR_MAP
        from .register import apply_op
        if isinstance(other, Symbol):
            args = (other, self) if reverse else (self, other)
            return apply_op(opname, list(args), {})
        fwd, rev = _SCALAR_MAP[opname]
        return apply_op(rev if reverse else fwd, [self],
                        {"scalar": float(other)})

    def __add__(self, o):
        return self._binop("broadcast_add", o)

    def __radd__(self, o):
        return self._binop("broadcast_add", o, True)

    def __sub__(self, o):
        return self._binop("broadcast_sub", o)

    def __rsub__(self, o):
        return self._binop("broadcast_sub", o, True)

    def __mul__(self, o):
        return self._binop("broadcast_mul", o)

    def __rmul__(self, o):
        return self._binop("broadcast_mul", o, True)

    def __truediv__(self, o):
        return self._binop("broadcast_div", o)

    def __rtruediv__(self, o):
        return self._binop("broadcast_div", o, True)

    def __pow__(self, o):
        return self._binop("broadcast_power", o)

    # comparisons build nodes; __eq__ stays identity (Symbols are graph
    # keys), use sym.broadcast_equal
    def __gt__(self, o):
        return self._binop("broadcast_greater", o)

    def __ge__(self, o):
        return self._binop("broadcast_greater_equal", o)

    def __lt__(self, o):
        return self._binop("broadcast_lesser", o)

    def __le__(self, o):
        return self._binop("broadcast_lesser_equal", o)

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float)):
            return self._binop("broadcast_not_equal", o)
        return NotImplemented

    def __neg__(self):
        from .register import apply_op
        return apply_op("negative", [self], {})

    # -- graph walks -------------------------------------------------------
    def _topo(self) -> List[_Node]:
        order, seen = [], set()
        stack = [(node, False) for node, _ in reversed(self._heads)]
        while stack:            # iterative: an unrolled graph is deep
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            stack.extend((p, False) for p, _ in reversed(node.inputs)
                         if id(p) not in seen)
        return order

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo()
                if n.is_var and not n.attrs.get("__aux__")]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._topo()
                if n.is_var and n.attrs.get("__aux__")]

    def list_inputs(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_var]

    def list_outputs(self) -> List[str]:
        return [f"{node.name}_output{idx}" if node.num_outputs > 1
                else f"{node.name}_output" for node, idx in self._heads]

    def get_internals(self) -> "Symbol":
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs)])

    def attr(self, key):
        attrs = self._heads[0][0].attrs
        v = attrs.get(key)
        if v is None and not key.startswith("__"):
            v = attrs.get(f"__{key}__")
        return v

    def attr_dict(self) -> Dict[str, Dict[str, Any]]:
        """name -> attrs of every node that has attributes (the
        initializer reads a variable's ``__init__``)."""
        return {n.name: dict(n.attrs) for n in self._topo() if n.attrs}

    # -- evaluation --------------------------------------------------------
    def compile(self, training: bool = False) -> Callable:
        """``fn(feed) -> list of output tensors`` for a ``name -> tensor``
        feed: each node's registry function in topological order, planned
        once (slots for every node output, the made op functions) so a
        call walks a flat list.  ``training`` is recorded on the function
        (``fn.training``); the caller sets MXNet's training mode
        (``autograd.train_mode``/``predict_mode``), which the ops read."""
        from ..ndarray.register import get_op
        order = self._topo()
        slot: Dict[Tuple[int, int], int] = {}
        feeds: List[Tuple[str, int]] = []
        steps: List[Tuple[Callable, List[int], List[int]]] = []
        n = 0
        for node in order:
            if node.is_var:
                slot[(id(node), 0)] = n
                feeds.append((node.name, n))
                n += 1
                continue
            fn = get_op(node.op).get_fn(_op_kwargs(node.attrs))
            ins = [slot[(id(p), i)] for p, i in node.inputs]
            outs = list(range(n, n + node.num_outputs))
            for i, s in enumerate(outs):
                slot[(id(node), i)] = s
            n += node.num_outputs
            steps.append((fn, ins, outs))
        heads = [slot[(id(node), i)] for node, i in self._heads]

        def run(feed: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
            vals: List[Any] = [None] * n
            for name, s in feeds:
                try:
                    vals[s] = feed[name]
                except KeyError:
                    raise MXNetError(f"symbol input {name!r} missing from "
                                     f"feed; have {sorted(feed)}") from None
            for fn, ins, outs in steps:
                res = fn(*[vals[i] for i in ins])
                if len(outs) == 1:
                    vals[outs[0]] = res[0] if isinstance(
                        res, (tuple, list)) else res
                else:
                    for s, r in zip(outs, res):
                        vals[s] = r
            return [vals[h] for h in heads]

        run.training = training
        run.steps = len(steps)
        return run

    def eval(self, ctx=None, **kwargs):
        """Evaluate with ``name=NDArray`` inputs; a list of ``NDArray``s."""
        from .. import autograd
        from ..ndarray.ndarray import NDArray
        feed = {k: v._data if isinstance(v, NDArray) else v
                for k, v in kwargs.items()}
        with torch.no_grad(), autograd.predict_mode():
            return [NDArray(t) for t in self.compile()(feed)]

    def eval_dict(self, feed: Dict[str, Any]):
        """Evaluate with a ``name -> NDArray`` feed: one ``NDArray``, or a
        list of them for a graph of many outputs."""
        outs = self.eval(**feed)
        return outs[0] if len(outs) == 1 else outs

    # -- shape/type inference ---------------------------------------------
    def infer_shape_partial(self, *args, **kwargs):
        """``infer_shape``, or ``(None, None, None)`` where a shape stays
        unknown (the JAX package's :348)."""
        try:
            return self.infer_shape(*args, **kwargs)
        except MXNetError:
            return None, None, None

    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the shapes of some
        inputs (positional in ``list_arguments`` order, or by name),
        the variables' declared ``__shape__`` (without a 0) and the
        parameter-shape rules of the common layers; raises ``MXNetError``
        if an input's shape stays unknown."""
        known: Dict[str, Tuple[int, ...]] = {}
        for n, s in zip(self.list_arguments(), args):
            if s is not None:
                known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        for node in self._topo():
            declared = node.attrs.get("__shape__") if node.is_var else None
            # a 0 is an unknown dimension (a deferred Gluon parameter's
            # var()), left to the layer rules, as in MXNet
            if declared and all(d > 0 for d in declared) and \
                    node.name not in known:
                known[node.name] = tuple(declared)
        missing = [n for n in self.list_inputs() if n not in known]
        if missing:
            known.update(_infer_missing(self, known))
        missing = [n for n in self.list_inputs() if n not in known]
        if missing:
            raise MXNetError(f"cannot infer shapes; unknown inputs "
                             f"{missing}")
        out_shapes = [tuple(t.shape) for t in self._meta_run(known)]
        return ([known[n] for n in self.list_arguments()], out_shapes,
                [known[n] for n in self.list_auxiliary_states()])

    def _meta_run(self, shapes: Dict[str, Tuple[int, ...]]):
        from .. import autograd
        feed = {n: torch.empty(shapes[n], device="meta")
                for n in self.list_inputs()}
        with torch.no_grad(), autograd.predict_mode():
            return self.compile()(feed)

    def infer_type(self, *args, **kwargs):
        """The JAX package's forward dtype pass: variable dtypes from the
        hints (positional or by name) or ``__dtype__`` (default float32),
        the Cast family (``amp_cast`` too) fixes its dtype, argmax/argmin/
        one_hot give float32, shape_array/size_array int32, argsort its
        ``dtype`` (float32), everything else promotes (floats decide;
        ``amp_multicast`` gives each output the promoted dtype).  The pass
        runs in torch dtypes; it returns them as ``NDArray.dtype`` does
        (numpy's; bfloat16 numpy's where ``ml_dtypes`` is loaded, else
        ``torch.bfloat16``)."""
        from ..ndarray.ndarray import _np_dtype
        order = self._topo()
        var_nodes = [n for n in order if n.is_var]
        arg_names = [n.name for n in var_nodes if not n.attrs.get("__aux__")]
        aux_names = [n.name for n in var_nodes if n.attrs.get("__aux__")]
        seeded: Dict[str, torch.dtype] = {}
        for n, t in zip(arg_names, args):
            if t is not None:
                seeded[n] = torch_dtype(t)
        all_inputs = {n.name for n in var_nodes}
        for k, v in kwargs.items():
            if k not in all_inputs:
                raise MXNetError(
                    f"infer_type got unknown argument {k!r}; inputs are "
                    f"{sorted(all_inputs)}")
            if v is not None:
                seeded[k] = torch_dtype(v)

        def parse_dt(v):
            try:
                return torch_dtype(v)
            except (MXNetError, TypeError):
                return torch.float32

        fixed = {"argmax": torch.float32, "argmin": torch.float32,
                 "one_hot": torch.float32, "shape_array": torch.int32,
                 "size_array": torch.int32, "argsort": torch.float32}
        dtypes: Dict[Tuple[int, int], torch.dtype] = {}
        name_to_dt: Dict[str, torch.dtype] = {}
        for node in order:
            if node.is_var:
                dt = seeded.get(node.name)
                if dt is None:
                    declared = node.attrs.get("__dtype__")
                    dt = parse_dt(declared) if declared else torch.float32
                dtypes[(id(node), 0)] = dt
                name_to_dt[node.name] = dt
                continue
            in_dts = [dtypes[(id(p), i)] for p, i in node.inputs]
            if node.op in ("Cast", "cast", "amp_cast") or \
                    (node.op in ("one_hot", "argsort") and
                     node.attrs.get("dtype")):
                out_dt = parse_dt(node.attrs.get("dtype", "float32"))
            elif node.op in fixed:
                out_dt = fixed[node.op]
            elif in_dts:
                floats = [d for d in in_dts if d.is_floating_point]
                out_dt, *rest = floats or in_dts
                for d in rest:
                    out_dt = torch.promote_types(out_dt, d)
            else:
                out_dt = torch.float32
            for i in range(node.num_outputs):
                dtypes[(id(node), i)] = out_dt
        return ([_np_dtype(name_to_dt[n]) for n in arg_names],
                [_np_dtype(dtypes[(id(n), i)]) for n, i in self._heads],
                [_np_dtype(name_to_dt[n]) for n in aux_names])

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    shared_arrays: Optional[Dict[str, Any]] = None,
                    **kwargs):
        """An :class:`Executor` with zero arrays of the inferred shapes
        (``kwargs``: input shapes by name) on ``ctx`` (the current
        context by default), gradient arrays for the arguments whose
        ``grad_req`` is not ``"null"``.  ``shared_arrays``: ``name ->
        (array, gradient array or None)`` bound as they are instead (a
        bucketing module's parameters)."""
        from ..context import current_context
        from ..ndarray.ndarray import zeros
        from .executor import Executor, grad_reqs
        ctx = ctx or current_context()
        shared_arrays = shared_arrays or {}
        type_dict = type_dict or {}
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        names = self.list_arguments()
        reqs = grad_reqs(grad_req, names)
        args, grads = [], []
        for n, s in zip(names, arg_shapes):
            if n in shared_arrays:
                arr, grad = shared_arrays[n]
            else:
                arr = zeros(s, ctx=ctx, dtype=type_dict.get(n))
                grad = None if reqs[n] == "null" else \
                    zeros(s, ctx=ctx, dtype=type_dict.get(n))
            args.append(arr)
            grads.append(grad)
        aux = [shared_arrays[n][0] if n in shared_arrays
               else zeros(s, ctx=ctx)
               for n, s in zip(self.list_auxiliary_states(), aux_shapes)]
        return Executor(self, ctx, args, grads, reqs, aux)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An :class:`Executor` over the given arrays (lists in
        ``list_arguments`` order, or name -> array dicts)."""
        from ..context import current_context
        from .executor import Executor, grad_reqs
        ctx = ctx or current_context()
        names = self.list_arguments()
        if isinstance(args, dict):
            args = [args[n] for n in names]
        if isinstance(args_grad, dict):
            args_grad = [args_grad.get(n) for n in names]
        if isinstance(aux_states, dict):
            aux_states = [aux_states[n]
                          for n in self.list_auxiliary_states()]
        grads = list(args_grad) if args_grad else [None] * len(names)
        reqs = grad_reqs(grad_req, names)
        reqs = {n: (r if g is not None else "null")
                for (n, r), g in zip(reqs.items(), grads)}
        return Executor(self, ctx, list(args), grads, reqs,
                        list(aux_states) if aux_states else [])

    # -- serialization -----------------------------------------------------
    def tojson(self) -> str:
        order = self._topo()
        nid = {id(n): i for i, n in enumerate(order)}
        nodes = [{"op": n.op if n.op else "null", "name": n.name,
                  "attrs": {k: _attr_str(v) for k, v in n.attrs.items()},
                  "inputs": [[nid[id(p)], i, 0] for p, i in n.inputs]}
                 for n in order]
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(order) if n.is_var],
            "node_row_ptr": [],
            "heads": [[nid[id(n)], i, 0] for n, i in self._heads],
            "attrs": {"mxnet_version": ["int", 10500]}}, indent=2)

    def save(self, fname: str) -> None:
        with open(fname, "w") as f:
            f.write(self.tojson())


def _attr_str(v) -> str:
    if isinstance(v, str):
        return v
    return json.dumps(v) if isinstance(v, (list, tuple, dict)) else str(v)


def _parse_attr(s):
    if not isinstance(s, str):
        return s
    low = s.strip()
    if low in ("True", "true"):
        return True
    if low in ("False", "false"):
        return False
    try:
        v = json.loads(low)
    except (ValueError, TypeError):
        return s
    return tuple(v) if isinstance(v, list) else v


def _infer_missing(sym: Symbol, known: Dict[str, Tuple[int, ...]]
                   ) -> Dict[str, Tuple[int, ...]]:
    """A forward walk that gives the parameters of the common layers their
    shapes from the data's (the role of the reference's InferShape
    pass): each node's output shape comes from its op on ``meta``
    tensors once its inputs' shapes are known."""
    from .. import autograd
    from ..ndarray.register import get_op
    out: Dict[str, Tuple[int, ...]] = {}
    shapes: Dict[Tuple[int, int], Tuple[int, ...]] = {}
    for node in sym._topo():
        if node.is_var:
            if node.name in known:
                shapes[(id(node), 0)] = tuple(known[node.name])
            continue
        in_shapes = [shapes.get((id(p), i)) for p, i in node.inputs]
        unknown = [(p, pos) for pos, (p, s) in
                   enumerate(zip(_through_casts(node), in_shapes))
                   if s is None and p.is_var]
        if unknown:
            _infer_node_params(node, in_shapes, unknown, out)
            for p, pos in unknown:
                if p.name in out:
                    shapes[(id(p), 0)] = in_shapes[pos] = out[p.name]
        if any(s is None for s in in_shapes):
            continue
        fn = get_op(node.op).get_fn(_op_kwargs(node.attrs))
        try:
            with torch.no_grad(), autograd.predict_mode():
                res = fn(*[torch.empty(s, device="meta")
                           for s in in_shapes])
        except (RuntimeError, TypeError, ValueError, IndexError,
                NotImplementedError, MXNetError):
            continue
        res = res if isinstance(res, (tuple, list)) else (res,)
        for i, r in enumerate(res):
            shapes[(id(node), i)] = tuple(r.shape)
    return out


def _through_casts(node: _Node) -> List[_Node]:
    """The nodes feeding ``node``, each seen through a chain of one-input
    casts (``amp_cast``, ``cast``): an AMP-converted graph wraps its
    parameters in casts, and the shape rules apply to the variable
    underneath (the JAX package's ``_infer_missing``)."""
    feeds = []
    for p, _ in node.inputs:
        while p.op in ("amp_cast", "cast", "Cast") and len(p.inputs) == 1:
            p = p.inputs[0][0]
        feeds.append(p)
    return feeds


def _infer_node_params(node: _Node, in_shapes, unknown, out) -> None:
    """Parameter-shape rules of the common layers (weight/bias/γ/β, the
    RNN's packed parameters and zero states)."""
    from ..ndarray.ops_nn import RNN_GATES, rnn_param_size
    a = node.attrs
    data = in_shapes[0]
    if data is None:
        return
    if node.op == "FullyConnected":
        nh = int(a.get("num_hidden"))
        in_units = int(np.prod(data[1:])) if a.get("flatten", True) \
            else data[-1]
        for p, pos in unknown:
            if pos == 1:
                out[p.name] = (nh, in_units)
            elif pos == 2:
                out[p.name] = (nh,)
    elif node.op in ("Convolution", "Deconvolution"):
        nf, k = int(a.get("num_filter")), tuple(a.get("kernel"))
        ng = int(a.get("num_group", 1))
        for p, pos in unknown:
            if pos == 1:
                out[p.name] = (nf, data[1] // ng) + k \
                    if node.op == "Convolution" else (data[1], nf // ng) + k
            elif pos == 2:
                out[p.name] = (nf,)
    elif node.op in ("BatchNorm", "BatchNorm_v1", "LayerNorm",
                     "InstanceNorm"):
        # InstanceNorm's gamma and beta are per channel, axis 1 (MXNet's;
        # the JAX package's rule reads the last axis)
        axis = int(a.get("axis", -1 if node.op == "LayerNorm" else 1))
        for p, _ in unknown:
            out[p.name] = (data[axis % len(data)],)
    elif node.op == "Embedding":
        for p, pos in unknown:
            if pos == 1:
                out[p.name] = (int(a.get("input_dim")),
                               int(a.get("output_dim")))
    elif node.op == "RNN":
        mode = a.get("mode", "lstm")
        if len(data) != 3 or a.get("state_size") is None or \
                mode not in RNN_GATES:
            return
        h, layers = int(a.get("state_size")), int(a.get("num_layers", 1))
        dirs = 2 if a.get("bidirectional") else 1
        for p, pos in unknown:
            if pos == 1:
                out[p.name] = (rnn_param_size(mode, layers, data[2], h,
                                              bool(a.get("bidirectional"))),)
            elif pos in (2, 3):
                out[p.name] = (dirs * layers, data[1], h)


def var(name: str, **kwargs) -> Symbol:
    return Symbol.var(name, **kwargs)


Variable = var


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol([h for s in symbols for h in s._heads])


_SUBGRAPH_ATTRS = ("subgraph", "cond_subgraph", "body_subgraph",
                   "then_subgraph", "else_subgraph")


def load_json(json_str: str) -> Symbol:
    data = json.loads(json_str)
    nodes: List[_Node] = []
    for entry in data["nodes"]:
        attrs = {k: _parse_attr(v) for k, v in entry.get("attrs", {}).items()}
        if entry["op"] in ("_foreach", "_while_loop", "_cond"):
            # a subgraph is nested JSON, as the JAX package writes it
            from ..ndarray.ops_control_flow import SubgraphAttr
            for key in _SUBGRAPH_ATTRS:
                if isinstance(attrs.get(key), dict):
                    attrs[key] = SubgraphAttr(
                        load_json(json.dumps(attrs[key])))
        inputs = [(nodes[i], oi) for i, oi, *_ in entry.get("inputs", [])]
        op = None if entry["op"] == "null" else entry["op"]
        nodes.append(_Node(op, entry["name"], attrs, inputs))
    # a node has as many outputs as its highest referenced index says
    for entry in data["nodes"]:
        for i, oi, *_ in entry.get("inputs", []):
            nodes[i].num_outputs = max(nodes[i].num_outputs, oi + 1)
    for i, oi, *_ in data["heads"]:
        nodes[i].num_outputs = max(nodes[i].num_outputs, oi + 1)
    from .register import num_outputs
    for node in nodes:
        if not node.is_var:
            node.num_outputs = max(node.num_outputs, num_outputs(
                node.op, _op_kwargs(node.attrs), len(node.inputs)))
    return Symbol([(nodes[i], oi) for i, oi, *_ in data["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())
