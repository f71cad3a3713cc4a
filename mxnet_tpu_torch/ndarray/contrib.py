"""``mx.nd.contrib``: the frontends of the ``_contrib_*`` ops by the name
after the prefix (``nd.contrib.MultiBoxTarget``, ``nd.contrib.box_nms``),
the control-flow operators ``foreach``, ``while_loop`` and ``cond`` and
the sampler ``rand_zipfian``.

Counterpart of ``mxnet_tpu/ndarray/contrib.py`` (:57-283).  The control
flow runs the user's function on ``NDArray``s in a Python loop, MXNet's
ndarray-mode semantics: inside ``autograd.record()`` the tape sees every
step's ops (gradients reach the loop's inputs and the parameters the
function captured), and outside it the values are those of the JAX
package's fused ``lax.scan``/``lax.while_loop``/``lax.cond`` paths.
``while_loop`` and ``cond`` read their conditions on the host
(``register.host_read``: a hybridized block that calls them warns once
and runs eagerly); ``mx.sym.contrib``'s loops read nothing.  Where a loop
runs no step, the output shapes come from one call of the function on
``meta`` tensors, which computes nothing.  The JAX module's DGL
re-exports belong to ``dgl.py``, which is not ported.
"""
from __future__ import annotations

import sys as _sys

import torch

from .register import _registry, make_frontend

_PREFIX = "_contrib_"
_mod = _sys.modules[__name__]

for _name, _op in list(_registry.items()):
    if _name.startswith(_PREFIX):
        setattr(_mod, _name[len(_PREFIX):], make_frontend(_op))


def _listed(x):
    from .ndarray import NDArray
    return ([x], True) if isinstance(x, NDArray) else (list(x), False)


def _probe(func, args):
    """``func``'s outputs on ``meta`` stand-ins of ``args`` (a list of
    ``NDArray``s): their shapes and dtypes, nothing computed, nothing
    recorded."""
    from .. import autograd
    from .ndarray import NDArray
    with autograd.pause(), torch.no_grad():
        return func(*[NDArray(torch.empty(a.shape, dtype=a._data.dtype,
                                          device="meta")) for a in args])


def _zeros_like_rows(n: int, like, dev):
    from .ndarray import NDArray
    return NDArray(torch.zeros((n,) + tuple(like.shape),
                               dtype=like._data.dtype, device=dev))


def foreach(body, data, init_states):
    """``body(x_t, states) -> (out_t, new_states)`` over axis 0 of
    ``data`` (an ``NDArray`` or a list of them); returns the step outputs
    stacked on a new axis 0 and the final states, nested as the
    caller's."""
    from .register import invoke_by_name
    data_list, data_single = _listed(data)
    steps = data_list[0].shape[0]
    states, rows, single = init_states, None, True
    if steps == 0:
        k = len(data_list)
        state_list, state_single = _listed(init_states)

        def first_step(*xs):
            return body(xs[0] if data_single else list(xs[:k]),
                        xs[k] if state_single else list(xs[k:]))[0]
        outs_list, single = _listed(_probe(
            first_step, [_row_like(d) for d in data_list] + state_list))
        dev = data_list[0]._data.device
        stacked = [_zeros_like_rows(0, o, dev) for o in outs_list]
        return (stacked[0] if single else stacked), init_states
    for t in range(steps):
        xt = data_list[0][t] if data_single else [d[t] for d in data_list]
        outs, states = body(xt, states)
        outs_list, single = _listed(outs)
        if rows is None:
            rows = [[] for _ in outs_list]
        for acc, o in zip(rows, outs_list):
            acc.append(o)
    stacked = [invoke_by_name("stack", acc, {"axis": 0}) for acc in rows]
    return (stacked[0] if single else stacked), states


def _row_like(d):
    """A stand-in for one row of ``d`` (shape and dtype only)."""
    from .ndarray import NDArray
    return NDArray(torch.empty(tuple(d.shape[1:]), dtype=d._data.dtype,
                               device="meta"))


def _truth(x, op: str) -> bool:
    from .register import host_read
    t = x._data if hasattr(x, "_data") else torch.as_tensor(x)
    host_read(op, t)
    return bool(t.reshape(()))


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``cond(*loop_vars)`` read on the host before each step, at most
    ``max_iterations`` steps of ``func(*loop_vars) -> (step_output,
    new_loop_vars)``; the step outputs stacked and padded with zeros to
    ``max_iterations`` rows, and the final loop variables (a list)."""
    from ..base import MXNetError
    from .register import invoke_by_name
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (static "
                         "shapes)")
    max_iterations = int(max_iterations)
    lv = list(loop_vars)
    rows, single, it = None, True, 0
    while it < max_iterations and _truth(cond(*lv), "while_loop"):
        outs, new_lv = func(*lv)
        lv = list(new_lv) if isinstance(new_lv, (list, tuple)) else [new_lv]
        outs_list, single = _listed(outs)
        if rows is None:
            rows = [[] for _ in outs_list]
        for acc, o in zip(rows, outs_list):
            acc.append(o)
        it += 1
    dev = lv[0]._data.device
    if rows is None:
        outs_list, single = _listed(_probe(lambda *v: func(*v)[0], lv))
        bufs = [_zeros_like_rows(max_iterations, o, dev) for o in outs_list]
        return (bufs[0] if single else bufs), lv
    bufs = []
    for acc in rows:
        stacked = invoke_by_name("stack", acc, {"axis": 0})
        if it < max_iterations:
            stacked = invoke_by_name("concat", [stacked, _zeros_like_rows(
                max_iterations - it, acc[0], dev)], {"dim": 0})
        bufs.append(stacked)
    return (bufs[0] if single else bufs), lv


def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` (read on the host) is true, else
    ``else_func()``: only the taken branch runs (and is recorded)."""
    return then_func() if _truth(pred, "cond") else else_func()


def rand_zipfian(true_classes, num_sampled, range_max):
    """The sampled-softmax candidate sampler: ``num_sampled`` distinct
    classes of Zipf(``range_max``) (``_sample_unique_zipfian``, on
    ``true_classes``' device), and the expected counts of the true and of
    the sampled classes, ``tries * log((c + 2) / (c + 1)) /
    log(range_max + 1)`` (float32, computed in float64 on the device)."""
    import math
    from .ndarray import NDArray
    from .register import invoke_by_name
    ctx = true_classes.context
    samples, tries = invoke_by_name(
        "_sample_unique_zipfian", [],
        {"range_max": int(range_max), "shape": (1, int(num_sampled)),
         "ctx": ctx})
    samples = samples.reshape((int(num_sampled),))
    n = tries._data[0].to(torch.float64)
    log_rm1 = math.log(float(range_max) + 1.0)

    def expected(c):
        c = c.to(torch.float64)
        return NDArray((torch.log((c + 2.0) / (c + 1.0)) / log_rm1 * n)
                       .to(torch.float32))
    return samples, expected(true_classes._data), expected(samples._data)
