"""Test utilities: ``check_numeric_gradient``, ``check_symbolic_forward``
and ``_backward``, ``check_consistency``, ``assert_almost_equal`` with
per-dtype tolerances, ``rand_ndarray`` and the shape helpers.

Counterpart of ``mxnet_tpu/test_utils.py`` (MXNet's
``python/mxnet/test_utils.py``), over the port's executor.
``default_context()`` is the port's current context (``gpu(0)`` unless a
``with mx.cpu():`` scope or ``MXNET_TEST_DEFAULT_CTX`` says otherwise),
so ``check_consistency`` holds the card against the CPU.  Only
``stype="default"`` arrays: the sparse storage types are not ported.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .base import MXNetError, get_env
from .context import Context, cpu, current_context
from .ndarray import NDArray, array as nd_array

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "same", "rand_ndarray", "rand_shape_2d",
           "rand_shape_3d", "rand_shape_nd", "random_arrays",
           "check_numeric_gradient", "check_symbolic_forward",
           "check_symbolic_backward", "check_consistency", "simple_forward",
           "default_rtols", "default_atols"]

_default_ctx: Optional[Context] = None

# per-dtype tolerances (reference: test_utils.default_tols)
default_rtols = {np.dtype(np.float16): 1e-2, np.dtype(np.float32): 1e-4,
                 np.dtype(np.float64): 1e-7, np.dtype(np.int32): 0,
                 np.dtype(np.int64): 0, np.dtype(np.uint8): 0}
default_atols = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-5,
                 np.dtype(np.float64): 1e-9, np.dtype(np.int32): 0,
                 np.dtype(np.int64): 0, np.dtype(np.uint8): 0}


def _tol(table, dt, fallback):
    """Tolerance lookup that treats bfloat16 like fp16."""
    if getattr(dt, "name", "") == "bfloat16":
        return 1e-1
    return table.get(dt, fallback)


def default_context() -> Context:
    """The context tests run in: ``set_default_context``'s, else
    ``MXNET_TEST_DEFAULT_CTX`` (``"cpu"``, ``"gpu(0)"``), else the current
    context."""
    if _default_ctx is not None:
        return _default_ctx
    name = get_env("MXNET_TEST_DEFAULT_CTX")
    if name:
        from . import context as ctx_mod
        dev, _, idx = name.partition("(")
        idx = int(idx.rstrip(")")) if idx else 0
        return getattr(ctx_mod, dev)(idx)
    return current_context()


def set_default_context(ctx: Context) -> None:
    global _default_ctx
    _default_ctx = ctx


def _set(arr: NDArray, value) -> None:
    """Write ``value`` into the bound array ``arr`` in place, in its
    dtype."""
    arr[:] = np.asarray(value).astype(arr.dtype)


def _as_numpy(x) -> np.ndarray:
    """THE host-export boundary of this module: every check here ends
    in a numpy comparison, and every device readback funnels through
    this one call so the sync is deliberate and greppable."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def _find_max_violation(a, b, rtol, atol):
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    violation = diff - tol
    idx = np.unravel_index(np.argmax(violation), violation.shape)
    return tuple(int(i) for i in idx), diff[idx]


def same(a, b) -> bool:
    return np.array_equal(_as_numpy(a), _as_numpy(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False) -> bool:
    a, b = _as_numpy(a), _as_numpy(b)
    rtol = rtol if rtol is not None else _tol(default_rtols, a.dtype, 1e-5)
    atol = atol if atol is not None else _tol(default_atols, a.dtype, 1e-8)
    return np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False) -> None:
    a, b = _as_numpy(a), _as_numpy(b)
    dt = a.dtype if a.dtype.kind == "f" else np.dtype(np.float32)
    rtol = rtol if rtol is not None else _tol(default_rtols, dt, 1e-5)
    atol = atol if atol is not None else _tol(default_atols, dt, 1e-8)
    if np.allclose(a.astype(np.float64, copy=False),
                   b.astype(np.float64, copy=False),
                   rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    idx, err = _find_max_violation(a.astype(np.float64),
                                   b.astype(np.float64), rtol, atol)
    raise AssertionError(
        f"{names[0]} and {names[1]} differ beyond rtol={rtol} atol={atol}: "
        f"max violation {err} at index {idx}; "
        f"{names[0]}[{idx}]={a[idx]}, {names[1]}[{idx}]={b[idx]}")


def rand_shape_2d(dim0: int = 10, dim1: int = 10):
    return tuple(np.random.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0: int = 10, dim1: int = 10, dim2: int = 10):
    return tuple(np.random.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_shape_nd(ndim: int, dim: int = 10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype: str = "default", density: float = 1.0,
                 dtype=np.float32, ctx: Optional[Context] = None,
                 scale: float = 1.0):
    """Random NDArray (``stype`` "default" only)."""
    ctx = ctx or default_context()
    arr = np.random.uniform(-scale, scale, size=shape).astype(dtype)
    if stype == "default":
        return nd_array(arr, ctx=ctx)
    raise MXNetError(f"rand_ndarray: stype {stype!r} is not ported (the "
                     f"sparse storage types are not)")


def random_arrays(*shapes, dtype=np.float64) -> List[np.ndarray]:
    arrays = [np.array(np.random.randn(), dtype=dtype) if len(s) == 0
              else np.random.randn(*s).astype(dtype) for s in shapes]
    return arrays if len(arrays) > 1 else arrays[0]


def simple_forward(sym, ctx=None, is_train: bool = False, **inputs):
    """Bind + forward a symbol with keyword numpy inputs; return numpy."""
    ctx = ctx or default_context()
    shapes = {k: v.shape for k, v in inputs.items()}
    exe = sym.simple_bind(ctx=ctx, **shapes)
    for k, v in inputs.items():
        _set(exe.arg_dict[k], np.asarray(v, dtype=np.float32))
    outs = [_as_numpy(o) for o in exe.forward(is_train=is_train)]
    return outs[0] if len(outs) == 1 else outs


def _parse_location(sym, location, ctx) -> Dict[str, np.ndarray]:
    if isinstance(location, dict):
        missing = set(location) - set(sym.list_arguments())
        if missing:
            raise MXNetError(f"location names {missing} not in arguments")
        return {k: _as_numpy(v) for k, v in location.items()}
    return {k: _as_numpy(v)
            for k, v in zip(sym.list_arguments(), location)}


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-6,
                           aux_states=None, ctx=None,
                           equal_nan=False) -> None:
    """Forward the graph and compare each output to a numpy expectation."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    exe = sym.simple_bind(
        ctx=ctx, grad_req="null",
        **{k: v.shape for k, v in location.items()})
    for k, v in location.items():
        _set(exe.arg_dict[k], v.astype(exe.arg_dict[k].dtype))
    if aux_states:
        for k, v in aux_states.items():
            _set(exe.aux_dict[k], _as_numpy(v))
    outputs = exe.forward(is_train=False)
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    for out, exp in zip(outputs, expected):
        assert_almost_equal(_as_numpy(out), exp, rtol, atol,
                            ("forward", "expected"), equal_nan=equal_nan)


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=1e-6, aux_states=None, grad_req="write",
                            ctx=None, equal_nan=False) -> None:
    """Backward the graph with given head gradients; compare input grads."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    exe = sym.simple_bind(
        ctx=ctx, grad_req=grad_req,
        **{k: v.shape for k, v in location.items()})
    for k, v in location.items():
        _set(exe.arg_dict[k], v.astype(np.float32))
    if aux_states:
        for k, v in aux_states.items():
            _set(exe.aux_dict[k], _as_numpy(v))
    exe.forward(is_train=True)
    grads = [nd_array(_as_numpy(g), ctx=ctx) for g in out_grads] \
        if not isinstance(out_grads, dict) else \
        [nd_array(_as_numpy(out_grads[k]), ctx=ctx)
         for k in sym.list_outputs()]
    exe.backward(grads)
    if isinstance(expected, dict):
        expected = {k: _as_numpy(v) for k, v in expected.items()}
    else:
        expected = dict(zip(sym.list_arguments(),
                            [_as_numpy(v) for v in expected]))
    for name, exp in expected.items():
        got = exe.grad_dict[name]
        assert_almost_equal(_as_numpy(got), exp, rtol, atol,
                            (f"grad({name})", "expected"),
                            equal_nan=equal_nan)


def check_numeric_gradient(sym, location, aux_states=None,
                           numeric_eps: float = 1e-3, rtol: float = 1e-2,
                           atol: Optional[float] = None,
                           grad_nodes: Optional[Sequence[str]] = None,
                           ctx=None, dtype=np.float64) -> None:
    """Compare autograd gradients against central finite differences —
    the reference's single most load-bearing numerical check."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    location = {k: v.astype(np.float64) for k, v in location.items()}
    grad_nodes = list(grad_nodes) if grad_nodes else list(location.keys())

    exe = sym.simple_bind(
        ctx=ctx, grad_req="write",
        **{k: v.shape for k, v in location.items()})

    def run_forward(loc: Dict[str, np.ndarray]) -> float:
        for k, v in loc.items():
            _set(exe.arg_dict[k], v.astype(np.float32))
        if aux_states:
            for k, v in aux_states.items():
                _set(exe.aux_dict[k], _as_numpy(v))
        outs = exe.forward(is_train=True)
        # reduce all outputs with a fixed random projection so a scalar
        # objective exists (reference uses sum via a random head grad of 1s)
        return float(sum(_as_numpy(o).astype(np.float64).sum()
                         for o in outs))

    # analytic grads: forward + backward with all-ones head gradients
    for k, v in location.items():
        _set(exe.arg_dict[k], v.astype(np.float32))
    if aux_states:
        for k, v in aux_states.items():
            _set(exe.aux_dict[k], _as_numpy(v))
    outs = exe.forward(is_train=True)
    exe.backward([nd_array(np.ones(o.shape, np.float32), ctx=ctx)
                  for o in outs])
    analytic = {k: _as_numpy(exe.grad_dict[k]).astype(np.float64)
                for k in grad_nodes}

    for name in grad_nodes:
        base = location[name]
        numeric = np.zeros_like(base, dtype=np.float64)
        flat = base.reshape(-1)
        num_flat = numeric.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + numeric_eps
            fp = run_forward(location)
            flat[i] = orig - numeric_eps
            fm = run_forward(location)
            flat[i] = orig
            num_flat[i] = (fp - fm) / (2 * numeric_eps)
        run_forward(location)  # restore
        assert_almost_equal(
            analytic[name], numeric, rtol, atol if atol is not None else 1e-4,
            (f"autograd({name})", f"finite_diff({name})"))


def check_consistency(sym, ctx_list, scale: float = 1.0,
                      grad_req: str = "write", arg_params=None,
                      rtol=None, atol=None) -> None:
    """Run the same symbol under every (ctx, type_dict) in ctx_list and
    assert outputs and gradients agree — the reference's backend-parity
    harness, the card against the CPU here)."""
    if not ctx_list:
        return
    specs = []
    for spec in ctx_list:
        ctx = spec["ctx"]
        shapes = {k: v for k, v in spec.items()
                  if k not in ("ctx", "type_dict")}
        dtypes = spec.get("type_dict", {})
        specs.append((ctx, shapes, dtypes))

    arg_names = sym.list_arguments()
    _, shapes0, dtypes0 = specs[0]
    if arg_params is None:
        arg_params = {}
        for n in arg_names:
            if n in shapes0:
                arg_params[n] = np.random.normal(
                    size=shapes0[n], scale=scale).astype(np.float64)

    results = []
    for ctx, shapes, dtypes in specs:
        exe = sym.simple_bind(ctx=ctx, grad_req=grad_req, **shapes)
        for n, v in arg_params.items():
            dt = dtypes.get(n, np.float32)
            _set(exe.arg_dict[n], v.astype(dt))
        outs = exe.forward(is_train=(grad_req != "null"))
        grads = None
        if grad_req != "null":
            exe.backward([nd_array(np.ones(o.shape, np.float32), ctx=ctx)
                          for o in outs])
            grads = {n: _as_numpy(exe.grad_dict[n]) for n in arg_params}
        results.append(([_as_numpy(o) for o in outs], grads,
                        list(dtypes.values()) or [np.float32]))

    ref_outs, ref_grads, _ = results[0]
    for (outs, grads, dts) in results[1:]:
        dt = np.dtype(dts[0]) if dts else np.dtype(np.float32)
        rt = rtol if rtol is not None else _tol(default_rtols, dt, 1e-4)
        at = atol if atol is not None else _tol(default_atols, dt, 1e-5)
        for o, r in zip(outs, ref_outs):
            assert_almost_equal(o.astype(np.float64), r.astype(np.float64),
                                rt, at, ("ctx_out", "ref_out"))
        if grads is not None and ref_grads is not None:
            for n in grads:
                assert_almost_equal(grads[n].astype(np.float64),
                                    ref_grads[n].astype(np.float64),
                                    rt, at, (f"ctx_grad({n})",
                                             f"ref_grad({n})"))
