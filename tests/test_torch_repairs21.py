"""Four repairs of the port held against the JAX package on the CPU:

- the fluent methods: ``Symbol`` has every fluent method of the JAX
  package's (``mxnet_tpu/ndarray/__init__.py:57-111``), ``NDArray`` the
  13 it lacked, so a ``hybrid_forward`` calling ``x.reshape(...)``
  exports and the files load in both packages;
- reductions of int8/int32 arrays answer the JAX package's dtype and
  value: int32 sums and products that wrap as int32, float32 means;
- the optimizer update frontends report through the engine's op hook as
  every other op does, so a listener (``mx.profiler``, ``Monitor``) sees
  them;
- ``RNNCell``, ``LSTMCell``, ``GRUCell``, ``CTCLoss``, ``KLDivLoss`` and
  ``SoftmaxCrossEntropyLoss`` build graphs on ``mx.sym.var``s that give
  the JAX package's outputs (fp32, 1e-5).
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ndarray import _CORE_SYM_METHODS, _FLUENT_METHODS

TOL = dict(rtol=1e-5, atol=1e-5)

JAX_SYMBOL_FLUENT = sorted({m for m in _FLUENT_METHODS + _CORE_SYM_METHODS
                            if hasattr(mx.sym.Symbol, m)})
NEW_NDARRAY_METHODS = ["argsort", "diag", "nanprod", "nansum", "norm", "pad",
                       "shape_array", "size_array", "slice_like", "softmin",
                       "sort", "split", "topk"]


@pytest.mark.parametrize("name", JAX_SYMBOL_FLUENT)
def test_symbol_has_each_fluent_method_of_the_jax_package(name):
    assert callable(getattr(mt.sym.Symbol, name, None)), name


@pytest.mark.parametrize("name", NEW_NDARRAY_METHODS)
def test_ndarray_fluent_methods_match_the_jax_package(name):
    x = np.random.default_rng(3).standard_normal((2, 3, 4)) \
        .astype(np.float32)
    args = {"pad": ((), dict(mode="constant", pad_width=(0, 0, 0, 0, 1, 1,
                                                         2, 2))),
            "slice_like": ((x[:, :2, :3],), {}),
            "split": ((), dict(num_outputs=2, axis=2)),
            "diag": ((), {})}.get(name, ((), {}))
    xin = x[0] if name == "diag" else x.reshape(1, 2, 3, 4) \
        if name == "pad" else x
    extra, kw = args
    a = getattr(mx.nd.array(xin), name)(*[mx.nd.array(e) for e in extra],
                                        **kw)
    with mt.cpu():
        b = getattr(mt.nd.array(xin), name)(
            *[mt.nd.array(e) for e in extra], **kw)
    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_allclose(v.asnumpy(), u.asnumpy(), **TOL)


def _fluent_net(lib):
    class Net(lib.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.d = lib.gluon.nn.Dense(5, in_units=12)

        def hybrid_forward(self, F, x):
            return self.d(x.reshape((0, -1))).exp()
    return Net(prefix="fluent_")


def test_fluent_hybrid_forward_exports_and_loads_in_both_packages(tmp_path):
    x = np.random.default_rng(0).standard_normal((2, 3, 4)) \
        .astype(np.float32)
    ref = _fluent_net(mx)
    ref.initialize(mx.init.Xavier())
    ref.hybridize()
    want = ref(mx.nd.array(x)).asnumpy()
    ref.export(str(tmp_path / "jax"))
    net = _fluent_net(mt)
    mt.load_reference_params(net, {k: p.data().asnumpy() for k, p in
                                   ref.collect_params().items()},
                             ctx=mt.cpu())
    net.hybridize()
    with mt.cpu():
        np.testing.assert_allclose(net(mt.nd.array(x)).asnumpy(), want,
                                   rtol=1e-6, atol=1e-6)
    net.export(str(tmp_path / "port"))
    for prefix in ("jax", "port"):
        files = (str(tmp_path / f"{prefix}-symbol.json"),
                 str(tmp_path / f"{prefix}-0000.params"))
        with mt.cpu():
            got = mt.gluon.SymbolBlock.imports(files[0], "data", files[1],
                                               ctx=mt.cpu())
            np.testing.assert_allclose(got(mt.nd.array(x)).asnumpy(), want,
                                       rtol=1e-6, atol=1e-6)
        theirs = mx.gluon.SymbolBlock.imports(files[0], "data", files[1])
        np.testing.assert_allclose(theirs(mx.nd.array(x)).asnumpy(), want,
                                   rtol=1e-6, atol=1e-6)
    assert os.path.getsize(tmp_path / "port-symbol.json") > 0


REDUCTIONS = ["sum", "prod", "nansum", "nanprod", "mean", "cumsum",
              "cumprod", "_square_sum", "moments", "trace"]


@pytest.mark.parametrize("dtype", ["int32", "int8"])
@pytest.mark.parametrize("op", REDUCTIONS)
def test_integer_reductions_answer_the_jax_dtype_and_value(op, dtype):
    a = np.arange(1, 25).reshape(2, 3, 4)

    def run(lib):
        x = lib.nd.array(a, dtype=dtype)
        f = getattr(lib.nd, op)
        r = f(x, axes=(0, 1, 2)) if op == "moments" else \
            f(x[0]) if op == "trace" else f(x, axis=1) \
            if op == "_square_sum" else f(x)
        return [(v.dtype, v.asnumpy()) for v in
                (r if isinstance(r, (list, tuple)) else [r])]
    want = run(mx)
    with mt.cpu():
        got = run(mt)
    for (dt_a, a_), (dt_b, b_) in zip(want, got):
        assert np.dtype(dt_b) == np.dtype(dt_a)
        np.testing.assert_allclose(b_, a_, rtol=1e-6)


def test_int32_product_wraps_as_int32():
    with mt.cpu():
        r = mt.nd.prod(mt.nd.array(np.arange(1, 25), dtype="int32"))
        assert r.dtype == np.int32 and int(r.asscalar()) == -775946240
        m = mt.nd.mean(mt.nd.array(np.arange(1, 25), dtype="int32"))
        assert m.dtype == np.float32 and float(m.asscalar()) == 12.5
        r64 = mt.nd.sum(mt.nd.array(np.arange(1, 25), dtype="int64"))
        assert r64.dtype == np.int64          # int64 keeps its dtype


def _listened(lib, ctx):
    seen = []

    def listener(name, outputs, us):
        seen.append(name)
    eng = lib.engine.engine()
    eng.add_listener(listener)
    try:
        with ctx:
            w = lib.nd.array(np.ones((3, 4), np.float32))
            g = lib.nd.array(np.full((3, 4), 0.5, np.float32))
            m = lib.nd.zeros((3, 4))
            lib.nd.relu(w)
            lib.nd.multi_sgd_mom_update(w, g, m, lib.nd.array([0.1]),
                                        lib.nd.array([0.0]), momentum=0.9,
                                        out=[w])
    finally:
        eng.remove_listener(listener)
    return seen, w.asnumpy()


def test_optimizer_frontends_report_through_the_op_hook():
    want, w_jax = _listened(mx, mx.cpu())
    got, w_port = _listened(mt, mt.cpu())
    assert want == ["relu", "multi_sgd_mom_update"]
    assert got == want
    np.testing.assert_array_equal(w_port, w_jax)


def test_optimizer_hook_reports_once_through_the_registry():
    seen = []

    def listener(name, outputs, us):
        seen.append(name)
    eng = mt.engine.engine()
    eng.add_listener(listener)
    try:
        with mt.cpu():
            w = mt.nd.array(np.ones(4, np.float32))
            g = mt.nd.array(np.ones(4, np.float32))
            mt.nd.get_op("sgd_update")
            from mxnet_tpu_torch.ndarray.register import invoke_by_name
            invoke_by_name("sgd_update", [w, g], {"lr": 0.1})
            mt.nd.adam_update(w, g, mt.nd.zeros(4), mt.nd.zeros(4), 0.1)
    finally:
        eng.remove_listener(listener)
    assert seen == ["sgd_update", "adam_update"]


CELLS_AND_LOSSES = ["RNNCell", "LSTMCell", "GRUCell", "CTCLoss", "KLDivLoss",
                    "SoftmaxCrossEntropyLoss"]


def _graph(lib, kind):
    g = lib.gluon
    if kind.endswith("Cell"):
        cell = getattr(g.rnn, kind)(8, input_size=5, prefix="c_")
        states = [lib.sym.var("h")] + (
            [lib.sym.var("c")] if kind == "LSTMCell" else [])
        out, new = cell(lib.sym.var("x"), states)
        return lib.sym.Group([out] + list(new))
    loss = getattr(g.loss, kind)()
    return loss(lib.sym.var("pred"), lib.sym.var("label"))


def _feeds(sym, kind, rng):
    if kind == "CTCLoss":
        return {"pred": rng.standard_normal((2, 6, 5)).astype(np.float32),
                "label": np.array([[1, 2, -1], [3, -1, -1]], np.float32)}
    gates = {"RNNCell": 1, "LSTMCell": 4, "GRUCell": 3}.get(kind, 1)
    shapes = {"x": (3, 5), "h": (3, 8), "c": (3, 8), "pred": (3, 4),
              "c_i2h_weight": (8 * gates, 5), "c_h2h_weight": (8 * gates, 8),
              "c_i2h_bias": (8 * gates,), "c_h2h_bias": (8 * gates,)}
    feeds = {n: rng.standard_normal(shapes[n]).astype(np.float32)
             for n in sym.list_arguments() if n != "label"}
    if kind == "SoftmaxCrossEntropyLoss":
        feeds["label"] = rng.integers(0, 4, 3).astype(np.float32)
    elif kind == "KLDivLoss":
        feeds["label"] = rng.random((3, 4)).astype(np.float32)
    return feeds


@pytest.mark.parametrize("kind", CELLS_AND_LOSSES)
def test_cells_and_losses_on_symbols_match_the_jax_graphs(kind):
    ref, port = _graph(mx, kind), _graph(mt, kind)
    assert port.list_arguments() == ref.list_arguments()
    feeds = _feeds(ref, kind, np.random.default_rng(1))
    want = ref.eval(ctx=mx.cpu(), **{k: mx.nd.array(v)
                                     for k, v in feeds.items()})
    # through a Module bound for inference, as a user would run it
    names = [n for n in port.list_arguments()]
    mod = mt.mod.Module(port, data_names=names, label_names=None,
                        context=mt.cpu())
    mod.bind(data_shapes=[(n, feeds[n].shape) for n in names],
             for_training=False)
    mod.init_params()
    mod.forward(mt.io.DataBatch(data=[mt.nd.array(feeds[n], ctx=mt.cpu())
                                      for n in names]), is_train=False)
    got = mod.get_outputs()
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), **TOL)
