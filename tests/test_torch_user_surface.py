"""The rest of the user surface's names, each answering as the JAX
package's on the CPU: ``mx.kv``, ``mx.cpu_pinned``, ``mx.waitall``,
``mx.get_env``/``list_env``/``register_env``, ``mx.viz``, ``mx.runtime``,
``mx.test_utils``; ``gluon.split_and_load``/``split_data``/
``DeferredInitializationError``, ``Block.summary``,
``ParameterDict.get_constant``; ``Module.iter_predict``,
``callback.ProgressBar``/``log_train_metric``, ``autograd.get_symbol``;
``nd.moveaxis``, ``nd.linalg_gemm2_batched``,
``Symbol.infer_shape_partial`` and ``Symbol.eval_dict``.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", [
    "kv", "cpu_pinned", "waitall", "get_env", "list_env", "register_env",
    "viz", "runtime", "test_utils"])
def test_top_level_name_exists_as_in_the_jax_package(name):
    assert hasattr(mx, name) and hasattr(mt, name)
    assert callable(getattr(mt, name)) == callable(getattr(mx, name))


def test_top_level_aliases_and_waits():
    assert mt.kv is mt.kvstore and mt.viz is mt.visualization
    assert mt.kv.create("local").type == mx.kv.create("local").type
    x = mt.nd.array(np.ones(3, np.float32), ctx=mt.cpu_pinned())
    assert x.context.device_type == "cpu"
    assert mt.waitall() is None and mx.waitall() is None


def test_env_registry_at_the_top_level():
    mt.register_env("MXNET_TEST_SURFACE_KNOB", 3, int, "a test knob")
    mx.register_env("MXNET_TEST_SURFACE_KNOB", 3, int, "a test knob")
    assert mt.get_env("MXNET_TEST_SURFACE_KNOB") == \
        mx.get_env("MXNET_TEST_SURFACE_KNOB") == 3
    assert mt.list_env()["MXNET_TEST_SURFACE_KNOB"] == 3
    assert mt.get_env is mt.base.get_env


def _mlp_sym(lib):
    data = lib.sym.var("data")
    h = lib.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = lib.sym.Activation(h, act_type="relu", name="relu1")
    return lib.sym.FullyConnected(h, num_hidden=3, name="fc2")


def test_viz_print_summary_and_plot_network(capsys):
    want = mx.viz.print_summary(_mlp_sym(mx), shape={"data": (2, 5)})
    jax_text = capsys.readouterr().out
    got = mt.viz.print_summary(_mlp_sym(mt), shape={"data": (2, 5)})
    port_text = capsys.readouterr().out
    assert got == want == 5 * 8 + 8 + 8 * 3 + 3
    assert port_text == jax_text
    dot = mt.viz.plot_network(_mlp_sym(mt), shape={"data": (2, 5)})
    ref = mx.viz.plot_network(_mlp_sym(mx), shape={"data": (2, 5)})
    # the node ids are object ids; the labels and the edge count agree
    assert dot.count("->") == ref.count("->")
    assert sorted(line.split("[label=")[1] for line in dot.splitlines()
                  if "[label=" in line) == \
        sorted(line.split("[label=")[1] for line in ref.splitlines()
               if "[label=" in line)


def test_runtime_features_have_the_jax_names():
    ours, theirs = mt.runtime.Features(), mx.runtime.Features()
    assert sorted(ours) == sorted(theirs)
    assert [f.name for f in mt.runtime.feature_list()] == list(ours)
    for name in ("TPU", "XLA", "PALLAS", "SPARSE"):
        assert not mt.runtime.is_enabled(name)
    assert mt.runtime.is_enabled("DIST_KVSTORE")
    assert mt.runtime.is_enabled("CUDA") == __import__("torch").cuda \
        .is_available()
    assert mt.runtime.is_enabled("CPU") and \
        mt.runtime.is_enabled("INT64_TENSOR_SIZE")
    assert not mt.runtime.is_enabled("NO_SUCH_FEATURE")


def test_test_utils_checks_a_graph():
    sym = mt.sym.FullyConnected(mt.sym.var("x"), num_hidden=3, name="fc")
    rng = np.random.default_rng(0)
    loc = {"x": rng.standard_normal((2, 4)),
           "fc_weight": rng.standard_normal((3, 4)),
           "fc_bias": rng.standard_normal(3)}
    want = loc["x"] @ loc["fc_weight"].T + loc["fc_bias"]
    mt.test_utils.set_default_context(mt.cpu())
    try:
        assert mt.test_utils.default_context() == mt.cpu()
        mt.test_utils.check_symbolic_forward(sym, loc, [want], rtol=1e-5)
        mt.test_utils.check_numeric_gradient(sym, loc, numeric_eps=1e-2,
                                             rtol=2e-2, atol=2e-2)
        mt.test_utils.check_symbolic_backward(
            sym, loc, [np.ones((2, 3))],
            {"fc_bias": np.full(3, 2.0), "x": np.tile(
                loc["fc_weight"].sum(0), (2, 1))}, rtol=1e-5)
        arr = mt.test_utils.rand_ndarray((3, 4))
        assert arr.shape == (3, 4) and arr.context == mt.cpu()
        with pytest.raises(mt.MXNetError):
            mt.test_utils.rand_ndarray((3, 4), stype="csr")
    finally:
        mt.test_utils.set_default_context(None)
    assert mt.test_utils.almost_equal(np.ones(3), np.ones(3) + 1e-7)
    with pytest.raises(AssertionError):
        mt.test_utils.assert_almost_equal(np.ones(3), np.zeros(3))
    assert mt.test_utils.default_rtols == mx.test_utils.default_rtols


def test_gluon_package_names():
    for name in ("split_and_load", "split_data"):
        assert getattr(mt.gluon, name) is getattr(mt.gluon.utils, name)
    assert mt.gluon.DeferredInitializationError is \
        mt.gluon.parameter.DeferredInitializationError
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    with mt.cpu():
        parts = mt.gluon.split_data(mt.nd.array(x), 2)
    want = mx.gluon.split_data(mx.nd.array(x), 2)
    for a, b in zip(want, parts):
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())


def _dense(lib):
    net = lib.gluon.nn.Dense(4, in_units=3, prefix="sum_")
    return net


def test_block_summary_prints_the_parameter_count(capsys):
    ref = _dense(mx)
    ref.initialize()
    ref.summary(mx.nd.ones((2, 3)))
    want = capsys.readouterr().out
    net = _dense(mt)
    net.initialize(ctx=mt.cpu())
    with mt.cpu():
        out = net.summary(mt.nd.ones((2, 3)))
    assert capsys.readouterr().out == want == "Dense: 16 parameters\n"
    assert out.shape == (2, 4)


def test_parameter_dict_get_constant():
    for lib in (mx, mt):
        pd = lib.gluon.ParameterDict("blk_")
        c = pd.get_constant("c", np.arange(3, dtype=np.float32))
        assert c.name == "blk_c" and pd.get_constant("c") is c
        assert isinstance(c, lib.gluon.Constant)
        with pytest.raises(lib.MXNetError):
            pd.get_constant("missing")


def _module(lib, ctx):
    mod = lib.mod.Module(_mlp_sym(lib), data_names=["data"],
                         label_names=None, context=ctx)
    mod.bind(data_shapes=[("data", (2, 5))], for_training=False)
    mod.init_params(initializer=lib.init.Constant(0.05))
    return mod


def test_module_iter_predict_yields_each_batch():
    x = np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32)
    ref = _module(mx, mx.cpu())
    want = [(o[0].asnumpy(), n) for o, n, _ in ref.iter_predict(
        mx.io.NDArrayIter(x, batch_size=2))]
    mod = _module(mt, mt.cpu())
    with mt.cpu():
        got = [(o[0].asnumpy(), n) for o, n, _ in mod.iter_predict(
            mt.io.NDArrayIter(x, batch_size=2), num_batch=3)]
    assert [n for _, n in got] == [n for _, n in want] == [0, 1, 2]
    for (a, _), (b, _) in zip(want, got):
        np.testing.assert_allclose(b, a, **TOL)


class _Param:
    def __init__(self, nbatch, metric):
        self.epoch, self.nbatch, self.eval_metric = 0, nbatch, metric


def test_callbacks_log_as_the_jax_package(caplog):
    def logs(lib):
        metric = lib.metric.Accuracy()
        metric.update([lib.nd.array([0, 1])], [lib.nd.array([[1, 0],
                                                             [0, 1]])])
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cb = lib.callback.log_train_metric(2, auto_reset=True)
            for n in range(4):
                cb(_Param(n, metric))
            bar = lib.callback.ProgressBar(total=4, length=8)
            bar(_Param(2, metric))
        return [r.getMessage() for r in caplog.records]
    want = logs(mx)
    with mt.cpu():
        got = logs(mt)
    assert got == want and len(got) == 3


def test_autograd_get_symbol_refuses_as_the_jax_package():
    with pytest.raises(mx.MXNetError):
        mx.autograd.get_symbol(mx.nd.ones(2))
    with pytest.raises(mt.MXNetError, match="get_symbol"):
        mt.autograd.get_symbol(mt.nd.ones(2, ctx=mt.cpu()))


def test_nd_moveaxis_and_linalg_gemm2_batched():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    a = rng.standard_normal((2, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 4, 5)).astype(np.float32)
    with mt.cpu():
        got = mt.nd.moveaxis(mt.nd.array(x), 0, 2).asnumpy()
        gemm = mt.nd.linalg_gemm2_batched(mt.nd.array(a),
                                          mt.nd.array(b)).asnumpy()
    np.testing.assert_array_equal(
        got, mx.nd.moveaxis(mx.nd.array(x), 0, 2).asnumpy())
    np.testing.assert_allclose(gemm, mx.nd.linalg_gemm2_batched(
        mx.nd.array(a), mx.nd.array(b)).asnumpy(), **TOL)
    assert mt.nd.get_op("linalg_gemm2_batched") is mt.nd.get_op("batch_dot")


def test_symbol_infer_shape_partial_and_eval_dict():
    for lib in (mx, mt):
        sym = _mlp_sym(lib)
        assert sym.infer_shape_partial() == (None, None, None)
        args, outs, _ = sym.infer_shape_partial(data=(2, 5))
        assert [tuple(s) for s in outs] == [(2, 3)]
    x = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)
    w1 = np.full((8, 5), 0.1, np.float32)
    feed = {"data": x, "fc1_weight": w1, "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": np.full((3, 8), 0.2, np.float32),
            "fc2_bias": np.ones(3, np.float32)}
    want = _mlp_sym(mx).eval_dict({k: mx.nd.array(v)
                                   for k, v in feed.items()})
    got = _mlp_sym(mt).eval_dict({k: mt.nd.array(v, ctx=mt.cpu())
                                  for k, v in feed.items()})
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
