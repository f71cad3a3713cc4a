"""``mx.sym.contrib``: the frontends of the ``_contrib_*`` ops by their
short names, and the control-flow constructors ``foreach``,
``while_loop`` and ``cond``.

Counterpart of ``mxnet_tpu/symbol/contrib.py`` (:34-133), with its
tracing protocol: the user's function is called on fresh placeholder
variables (``_{name}{uid}_data{i}``, ``_state{i}``, ``_loop{i}``), what it
returns becomes the op's subgraph (``SubgraphAttr``), and every other
variable the traced graph reaches (a captured weight, a constant) is a
free variable, wired in as one of the op's inputs: ``simple_bind`` binds
it and ``backward`` yields its gradient.

A loop's body that uses a value computed outside it (an encoder's
states, a projection of them) takes that value as an input too: the
traced graph is cut where it stops depending on the placeholders, as
MXNet 1.x's ``_cut_subgraph`` does, and the outer node's output enters
under the name ``{node}_output`` (``_output{i}`` of a multi-output
node).  The JAX package wires in variables only, so there such a body
computes the outer value again at every step: the same values, at that
cost.  ``cond``'s branches are traced whole, as the JAX package's.
"""
from __future__ import annotations

import itertools
import sys

from ..base import MXNetError
from ..ndarray.ops_control_flow import SubgraphAttr
from ..ndarray.register import _registry
from .register import _make_frontend, apply_op
from .symbol import Group, Symbol, _Node

__all__ = ["foreach", "while_loop", "cond"]

_PREFIX = "_contrib_"
_mod = sys.modules[__name__]
for _name in list(_registry):
    if _name.startswith(_PREFIX):
        setattr(_mod, _name[len(_PREFIX):], _make_frontend(_name))

_uid = itertools.count()


def _as_list(x):
    return ([x], True) if isinstance(x, Symbol) else (list(x), False)


def _free_vars(inner: Symbol, placeholders):
    """The variables of ``inner`` other than the placeholders: nodes
    shared with the caller's graph, so wiring them in links the op into
    it."""
    syms, names = [], []
    for node in inner._topo():
        if node.is_var and node.name not in placeholders:
            syms.append(Symbol([(node, 0)]))
            names.append(node.name)
    return syms, names


def _cut(inner: Symbol, placeholders):
    """``inner`` cut where it stops depending on the placeholders: a copy
    of its nodes that depend on them, whose other inputs are variables
    (the outer variables themselves, and one new variable for each
    outer node's output used).  Returns the cut graph and its free
    inputs (outer Symbols) with their names in it."""
    order = inner._topo()
    inside = {}
    for node in order:
        inside[id(node)] = node.name in placeholders if node.is_var else \
            any(inside[id(p)] for p, _ in node.inputs)
    copies, cut, syms, names = {}, {}, [], []

    def ref(p, i):
        if inside[id(p)]:
            return (p if p.is_var else copies[id(p)], i)
        key = (id(p), i)
        if key not in cut:
            if p.is_var:
                cut[key] = p
                names.append(p.name)
            else:
                name = f"{p.name}_output{i}" if p.num_outputs > 1 \
                    else f"{p.name}_output"
                cut[key] = _Node(None, name, {}, [])
                names.append(name)
            syms.append(Symbol([(p, i)]))
        return (cut[key], 0)

    for node in order:
        if inside[id(node)] and not node.is_var:
            copies[id(node)] = _Node(node.op, node.name, dict(node.attrs),
                                     [ref(p, i) for p, i in node.inputs],
                                     node.num_outputs)
    return Symbol([ref(n, i) for n, i in inner._heads]), syms, names


def _split(res: Symbol, n_outs: int, out_single: bool, state_single: bool):
    heads = list(res)
    outs, states = heads[:n_outs], heads[n_outs:]
    return (outs[0] if out_single else outs), \
        (states[0] if state_single else states)


def foreach(body, data, init_states, name="foreach"):
    """Scan ``body(x_t, states) -> (out_t, new_states)`` over axis 0 of
    ``data`` inside the graph; returns ``(outputs, final_states)`` nested
    as the caller's."""
    tag = f"_{name}{next(_uid)}"
    data_list, data_single = _as_list(data)
    state_list, state_single = _as_list(init_states)
    data_ph = [Symbol.var(f"{tag}_data{i}") for i in range(len(data_list))]
    state_ph = [Symbol.var(f"{tag}_state{i}")
                for i in range(len(state_list))]
    outs, new_states = body(data_ph[0] if data_single else data_ph,
                            state_ph[0] if state_single else state_ph)
    outs_list, out_single = _as_list(outs)
    new_list, _ = _as_list(new_states)
    if len(new_list) != len(state_list):
        raise MXNetError(f"foreach body returned {len(new_list)} states, "
                         f"expected {len(state_list)}")
    inner, free_syms, free_names = _cut(
        Group(outs_list + new_list), {s.name for s in data_ph + state_ph})
    res = apply_op("_foreach", data_list + state_list + free_syms, {
        "subgraph": SubgraphAttr(inner),
        "data_names": tuple(s.name for s in data_ph),
        "state_names": tuple(s.name for s in state_ph),
        "free_names": tuple(free_names), "n_outs": len(outs_list)},
        name=name)
    return _split(res, len(outs_list), out_single, state_single)


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """A bounded while loop inside the graph: ``cond(*loop_vars)`` a
    scalar, ``func(*loop_vars) -> (step_output, new_loop_vars)``.  The
    outputs have ``max_iterations`` rows, zeros after the loop ended."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (static "
                         "shapes)")
    tag = f"_{name}{next(_uid)}"
    lv_list, lv_single = _as_list(loop_vars)
    lv_ph = [Symbol.var(f"{tag}_loop{i}") for i in range(len(lv_list))]
    cond_out = cond(*lv_ph)
    outs, new_lv = func(*lv_ph)
    outs_list, out_single = _as_list(outs)
    new_list, _ = _as_list(new_lv)
    if len(new_list) != len(lv_list):
        raise MXNetError(f"while_loop func returned {len(new_list)} "
                         f"loop_vars, expected {len(lv_list)}")
    if len(cond_out) != 1:
        raise MXNetError("while_loop cond must give one output")
    inner, free_syms, free_names = _cut(
        Group([cond_out] + outs_list + new_list), {s.name for s in lv_ph})
    res = apply_op("_while_loop", lv_list + free_syms, {
        "cond_subgraph": SubgraphAttr(Symbol(inner._heads[:1])),
        "body_subgraph": SubgraphAttr(Symbol(inner._heads[1:])),
        "loop_names": tuple(s.name for s in lv_ph),
        "free_names": tuple(free_names), "n_outs": len(outs_list),
        "max_iterations": int(max_iterations)}, name=name)
    return _split(res, len(outs_list), out_single, lv_single)


def cond(pred, then_func, else_func, name="cond"):
    """A conditional inside the graph: both branches are traced once and
    must give as many outputs (of one shape each)."""
    then_out, then_single = _as_list(then_func())
    else_out, _ = _as_list(else_func())
    if len(then_out) != len(else_out):
        raise MXNetError(f"cond branches disagree: {len(then_out)} vs "
                         f"{len(else_out)} outputs")
    free_syms, free_names = _free_vars(Group(then_out + else_out), set())
    res = apply_op("_cond", [pred] + free_syms, {
        "then_subgraph": SubgraphAttr(Group(then_out)),
        "else_subgraph": SubgraphAttr(Group(else_out)),
        "free_names": tuple(free_names), "n_outs": len(then_out)},
        name=name)
    heads = list(res)
    return heads[0] if then_single else heads
