"""Control-flow operators: ``_foreach``, ``_while_loop`` and ``_cond``.

Counterpart of ``mxnet_tpu/ndarray/ops_control_flow.py`` (:37-214).  Each
op carries its body as a ``Symbol`` in a node attribute (``SubgraphAttr``,
the JAX package's, kept here as the port's own copy) and runs it through
``Symbol.compile``, so a loop lives inside one graph: ``mx.sym.contrib``
traces the user's function into the subgraph, the body's free variables
(captured weights) are the op's trailing inputs, named by
``free_names``, and torch autograd sums their gradients over the steps.

- ``_foreach`` runs the body over axis 0 of its data: the stacked step
  outputs, then the final states.
- ``_while_loop`` runs exactly ``max_iterations`` steps under an
  ``active`` flag (the condition and'ed into it each step): once the
  condition has failed the step outputs are zeros and the loop variables
  are held.  Nothing is read on the host, so a CUDA graph can capture it.
- ``_cond``'s two branches are evaluated and one is selected with
  ``torch.where`` on the device, unless a branch draws random numbers in
  the current mode (``Dropout`` in training, the ``_random_*``/
  ``_sample_*`` draws): then the predicate is read on the host
  (``register.host_read``, so a hybridized block runs such a graph
  eagerly) and only the taken branch runs, so no draw is made whose
  result is thrown away.  The JAX package's ``lax.cond`` runs one branch
  on the device, with keys split per branch.

Draws inside a body come from the device's generator at each step, as
every draw of the port does (the JAX package splits a key per step: the
bits differ).  The JAX package's ``_training`` parameter is taken and
unused: the body's ops read MXNet's training mode when they run.

On ``meta`` tensors (shape inference) each op runs its body once, on
``meta`` tensors, for the step's shapes; ``_cond`` raises
``MXNetError`` naming the op where its branches disagree in shape.
"""
from __future__ import annotations

import json
from typing import List, Sequence

import torch

from .. import autograd
from ..base import MXNetError
from .register import host_read, register_op

__all__ = ["SubgraphAttr", "graph_draws", "names_of"]


class SubgraphAttr:
    """A Symbol-valued node attribute (the JAX package's, :37-61).

    Hashed by identity so the op's made functions can be cached on it;
    ``str()`` is the subgraph's JSON, which ``Symbol.tojson`` nests and
    ``load_json`` turns back into a ``SubgraphAttr``."""

    __slots__ = ("sym",)

    def __init__(self, sym):
        self.sym = sym

    def __hash__(self):
        return id(self.sym)

    def __eq__(self, other):
        return isinstance(other, SubgraphAttr) and other.sym is self.sym

    def __str__(self):
        return self.sym.tojson()

    def __repr__(self):
        return f"<SubgraphAttr {self.sym!r}>"


def names_of(v) -> tuple:
    """Name tuples arrive as JSON text or lists after a load."""
    if isinstance(v, str):
        v = json.loads(v)
    return tuple(v)


#: ops that draw whatever the mode (``Dropout`` and ``RNN`` draw only in
#: training mode)
_DRAW_PREFIXES = ("_random_", "_sample_", "_shuffle", "random_",
                  "sample_")


def graph_draws(sym, training: bool) -> bool:
    """Whether evaluating ``sym`` in that mode draws random numbers (a
    nested control-flow op's subgraphs included)."""
    for node in sym._topo():
        if node.is_var:
            continue
        op, a = node.op, node.attrs
        if op.startswith(_DRAW_PREFIXES) and "_pdf_" not in op:
            return True
        if training and op == "Dropout" and float(a.get("p", 0.5)) > 0:
            return True
        if training and op == "RNN" and float(a.get("p", 0.0)) > 0:
            return True
        if any(isinstance(v, SubgraphAttr) and graph_draws(v.sym, training)
               for v in a.values()):
            return True
    return False


def _is_meta(vals: Sequence[torch.Tensor]) -> bool:
    return any(isinstance(v, torch.Tensor) and v.is_meta for v in vals)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _stack(rows: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(rows) if len(rows) > 1 else rows[0].unsqueeze(0)


def _outputs(outs, states):
    out = tuple(outs) + tuple(states)
    return out if len(out) > 1 else out[0]


def foreach_maker(subgraph=None, data_names=(), state_names=(),
                  free_names=(), n_outs=1, _training=False):
    data_names, state_names = names_of(data_names), names_of(state_names)
    free_names = names_of(free_names)
    run = subgraph.sym.compile(training=bool(_training))
    nd_, ns, n_outs = len(data_names), len(state_names), int(n_outs)

    def fn(*vals):
        data, states = vals[:nd_], list(vals[nd_:nd_ + ns])
        free = vals[nd_ + ns:]

        def step(rows, states, free):
            feed = dict(zip(data_names, rows))
            feed.update(zip(state_names, states))
            feed.update(zip(free_names, free))
            res = run(feed)
            return res[:n_outs], list(res[n_outs:])

        steps = data[0].shape[0]
        meta = _is_meta(vals)
        if steps == 0 or meta:
            # the step's shapes from one step on meta tensors: the body
            # does not run when the loop does not
            with torch.no_grad():
                outs, new = step([_meta(d[0] if meta else d.new_empty(
                    d.shape[1:])) for d in data], [_meta(s) for s in states],
                    [_meta(f) for f in free])
            dev = torch.device("meta") if meta else data[0].device
            outs = [torch.zeros((steps,) + tuple(o.shape), dtype=o.dtype,
                                device=dev) for o in outs]
            return _outputs(outs, new if meta else states)
        rows: List[List[torch.Tensor]] = [[] for _ in range(n_outs)]
        for t in range(steps):
            outs, states = step([d[t] for d in data], states, free)
            for acc, o in zip(rows, outs):
                acc.append(o)
        return _outputs([_stack(r) for r in rows], states)
    return fn


def while_loop_maker(cond_subgraph=None, body_subgraph=None, loop_names=(),
                     free_names=(), n_outs=1, max_iterations=0,
                     _training=False):
    loop_names, free_names = names_of(loop_names), names_of(free_names)
    cond_run = cond_subgraph.sym.compile(training=bool(_training))
    body_run = body_subgraph.sym.compile(training=bool(_training))
    nl, n_outs, steps = len(loop_names), int(n_outs), int(max_iterations)

    def fn(*vals):
        lv = list(vals[:nl])
        free = dict(zip(free_names, vals[nl:]))

        def feed_of(lv):
            feed = dict(zip(loop_names, lv))
            feed.update(free)
            return feed

        if steps == 0 or _is_meta(vals):
            with torch.no_grad():
                outs = body_run(feed_of([_meta(v) for v in lv]) | {
                    k: _meta(v) for k, v in free.items()})[:n_outs]
            dev = vals[0].device
            return _outputs([torch.zeros((steps,) + tuple(o.shape),
                                         dtype=o.dtype, device=dev)
                             for o in outs], lv)
        active = torch.ones((), dtype=torch.bool, device=vals[0].device)
        rows: List[List[torch.Tensor]] = [[] for _ in range(n_outs)]
        for _ in range(steps):
            c = cond_run(feed_of(lv))[0]
            active = active & c.reshape(()).to(torch.bool)
            res = body_run(feed_of(lv))
            for acc, o in zip(rows, res[:n_outs]):
                acc.append(torch.where(active, o, torch.zeros_like(o)))
            lv = [torch.where(active, n, p)
                  for n, p in zip(res[n_outs:], lv)]
        return _outputs([_stack(r) for r in rows], lv)
    return fn


def cond_maker(then_subgraph=None, else_subgraph=None, free_names=(),
               n_outs=1, _training=False):
    free_names = names_of(free_names)
    then_run = then_subgraph.sym.compile(training=bool(_training))
    else_run = else_subgraph.sym.compile(training=bool(_training))
    n_outs = int(n_outs)
    draws = {mode: graph_draws(then_subgraph.sym, mode)
             or graph_draws(else_subgraph.sym, mode)
             for mode in (False, True)}

    def fn(pred, *frees):
        feed = dict(zip(free_names, frees))
        if draws[autograd.is_training()] and not pred.is_meta:
            host_read("_cond", pred)
            taken = then_run if bool(pred.reshape(())) else else_run
            return _outputs(taken(feed)[:n_outs], ())
        a, b = then_run(feed)[:n_outs], else_run(feed)[:n_outs]
        for x, y in zip(a, b):
            if x.shape != y.shape:
                raise MXNetError(f"_cond: the branches' outputs differ in "
                                 f"shape ({tuple(x.shape)} and "
                                 f"{tuple(y.shape)})")
        p = pred.reshape(()).to(torch.bool)
        return _outputs([torch.where(p, x, y.to(x.dtype))
                         for x, y in zip(a, b)], ())
    return fn


register_op("_foreach", foreach_maker)
register_op("_while_loop", while_loop_maker)
register_op("_cond", cond_maker)
