"""The port's ``Parameter.data()``/``grad()`` as ``NDArray``s and its custom
ops on ``NDArray``s, held against the JAX package on the CPU
(``mxnet_tpu/gluon/parameter.py:137-213``, ``mxnet_tpu/operator.py:
92-128``): the types of ``data``, ``list_data``, ``grad``, ``list_grad``
and ``list_ctx``; writes through ``data()[:]`` and ``set_data`` that the
next forward reads; the gradient after a backward, read through an
``NDArray`` taken before it; ``grad_req="null"`` raising; ``var()``'s name
and shape; a custom op whose callbacks receive ``NDArray``s, with its
input gradients; and ``rtc`` launches taking ``NDArray`` arguments (their
checks, before any driver call: the sandbox has no card).

Tolerance: 1e-6 for one fp32 Dense forward, 1e-5 for gradients (fp32,
another summation order).
"""
import ctypes

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, cpu, load_reference_params, nd, rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import _nvrtc

TOL = dict(rtol=1e-5, atol=1e-5)


def _dense_pair(grad_req="write"):
    """A Dense(3, in_units=4) in each package with the JAX weights."""
    ref = mx.gluon.nn.Dense(3, in_units=4)
    ref.initialize(mx.init.Xavier())
    port = mt.gluon.nn.Dense(3, in_units=4)
    load_reference_params(port, {k: p.data().asnumpy()
                                 for k, p in ref.collect_params().items()},
                          ctx=cpu())
    for net in (ref, port):
        net.collect_params().setattr("grad_req", grad_req)
    return ref, port


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 4)) \
        .astype(np.float32)


def test_public_surface_types_match_jax():
    ref, port = _dense_pair()
    for lib, net in ((mx, ref), (mt, port)):
        p = net.weight
        for arr in (p.data(), p.grad(), *p.list_data(), *p.list_grad()):
            assert isinstance(arr, lib.nd.NDArray)
            assert arr.shape == (3, 4) and str(arr.dtype) == "float32"
        assert len(p.list_data()) == len(p.list_grad()) == 1
        assert len(p.list_ctx()) == 1
    assert port.weight.list_ctx() == [cpu()]
    assert port.weight.data().context == cpu()
    np.testing.assert_array_equal(port.weight.data().asnumpy(),
                                  ref.weight.data().asnumpy())
    assert not port.weight.grad().asnumpy().any()
    with pytest.raises(MXNetError, match="not initialized on"):
        port.weight.data(ctx=mt.gpu(0))


def test_data_writes_reach_the_next_forward_like_jax():
    ref, port = _dense_pair()
    x = _x()
    v = np.arange(12, dtype=np.float32).reshape(3, 4) / 10
    ref.weight.data()[:] = mx.nd.array(v)
    with mt.cpu():
        port.weight.data()[:] = nd.array(v)
        got = port(nd.array(x)).asnumpy()
    want = ref(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(port.weight._tensor().detach().numpy(), v)
    b = np.array([1.0, -2.0, 0.5], np.float32)
    ref.bias.set_data(mx.nd.array(b))
    port.bias.set_data(nd.array(b, ctx=cpu()))
    with mt.cpu():
        got = port(nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, ref(mx.nd.array(x)).asnumpy(),
                               rtol=1e-6, atol=1e-6)


def test_grad_after_backward_matches_jax_and_is_the_buffer():
    """One backward in each package; the port's ``grad()`` taken before
    it reads that backward's gradient, and the next one's after it."""
    ref, port = _dense_pair()
    x = _x(1)
    before = port.weight.grad()
    with mx.autograd.record():
        loss = (ref(mx.nd.array(x)) ** 2).sum()
    loss.backward()
    with mt.cpu(), autograd.record():
        out = port(nd.array(x))
        loss = (out * out).sum()
    loss.backward()
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(port, name).grad().asnumpy(),
                                   getattr(ref, name).grad().asnumpy(),
                                   **TOL)
    np.testing.assert_array_equal(before.asnumpy(),
                                  port.weight._grad_tensor().numpy())
    first = before.asnumpy().copy()
    with mt.cpu(), autograd.record():
        loss = (port(nd.array(x)) * 3.0).sum()
    loss.backward()
    np.testing.assert_array_equal(
        before.asnumpy(), np.repeat(3.0 * x.sum(0)[None], 3, 0))
    assert not np.array_equal(before.asnumpy(), first)


def test_grad_req_null_raises_like_jax():
    from mxnet_tpu.base import MXNetError as JaxError
    ref = mx.gluon.Parameter("frozen_w", grad_req="null", shape=(3,))
    ref.initialize()
    port = mt.gluon.Parameter("frozen_w", grad_req="null", shape=(3,))
    port.initialize(ctx=cpu())
    with pytest.raises(JaxError, match="grad_req='null'"):
        ref.grad()
    for read in (port.grad, port.list_grad):
        with pytest.raises(MXNetError, match="grad_req='null'"):
            read()
    assert isinstance(port.data(), nd.NDArray)


def test_var_name_and_shape_match_jax():
    ref, port = _dense_pair()
    theirs, ours = ref.weight.var(), port.weight.var()
    assert isinstance(ours, mt.sym.Symbol)
    assert ours.name == port.weight.name
    assert theirs.name[len(ref.prefix):] == ours.name[len(port.prefix):]
    assert tuple(ours.attr("__shape__")) == tuple(theirs.attr("__shape__")) \
        == (3, 4)
    assert ours.list_arguments() == [port.weight.name]


def test_deferred_parameter_data_raises_until_the_first_forward():
    net = mt.gluon.nn.Dense(3)
    net.initialize(ctx=cpu())
    with pytest.raises(mt.gluon.parameter.DeferredInitializationError):
        net.weight.data()
    assert net.weight.var().attr("__shape__") == (3, 0)
    with mt.cpu():
        net(nd.array(_x()))
    assert net.weight.data().shape == (3, 4)


def _custom_op(lib, name, seen):
    """``y = x * x * w`` (``w`` a second input); its callbacks record the
    types of what they receive."""
    @lib.operator.register(name)
    class Prop(lib.operator.CustomOpProp):
        def list_arguments(self):
            return ["data", "weight"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Op()

    class Op(lib.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append(("forward", [type(a) for a in in_data + out_data]))
            x, w = in_data
            self.assign(out_data[0], req[0], x * x * w)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            seen.append(("backward", [type(a) for a in
                                      out_grad + in_data + in_grad]))
            x, w = in_data
            self.assign(in_grad[0], req[0], out_grad[0] * 2.0 * x * w)
            self.assign(in_grad[1], req[1], out_grad[0] * x * x)
    return Prop


def test_custom_op_sees_ndarrays_and_its_gradients_match_jax():
    rng = np.random.default_rng(3)
    xs, ws, dy = (rng.standard_normal((3, 5)).astype(np.float32)
                  for _ in range(3))
    grads = {}
    for lib, tag in ((mx, "jax"), (mt, "port")):
        seen = []
        _custom_op(lib, f"nd_square_scale_{tag}", seen)
        ctx = cpu() if lib is mt else mx.cpu()
        x = lib.nd.array(xs.copy(), ctx=ctx)
        w = lib.nd.array(ws.copy(), ctx=ctx)
        x.attach_grad()
        w.attach_grad()
        with lib.autograd.record():
            y = lib.nd.Custom(x, w, op_type=f"nd_square_scale_{tag}")
        y.backward(lib.nd.array(dy.copy(), ctx=ctx))
        grads[tag] = (y.asnumpy(), x.grad.asnumpy(), w.grad.asnumpy())
        assert [s for s, _ in seen] == ["forward", "backward"]
        assert all(t is lib.nd.NDArray for _, ts in seen for t in ts)
    for ours, theirs in zip(grads["port"], grads["jax"]):
        np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_allclose(grads["port"][1], dy * 2 * xs * ws, **TOL)


def test_assign_takes_ndarray_and_tensor_destinations():
    op = mt.operator.CustomOp()
    dst = nd.zeros((2, 2), ctx=cpu())
    op.assign(dst, "write", nd.ones((2, 2), ctx=cpu()))
    op.assign(dst, "add", torch.ones(2, 2))
    op.assign(dst._data, "add", np.ones((2, 2), np.float32))
    op.assign(dst, "null", nd.ones((2, 2), ctx=cpu()) * 100)
    np.testing.assert_array_equal(dst.asnumpy(), np.full((2, 2), 3.0))


class _NoDriver:
    def _function(self, *args, **kwargs):
        raise AssertionError("a driver call in an argument check")


def test_rtc_launch_takes_ndarray_arguments(monkeypatch):
    """``CudaKernel`` checks an ``NDArray`` argument as its tensor (the
    device given here is the CPU: the check runs before any driver
    call) and passes the tensor's address; a wrong dtype is refused."""
    for name in ("launch", "get_function", "load_module",
                 "set_max_dynamic_shared"):
        monkeypatch.setattr(_nvrtc, name, _NoDriver()._function)
    kernel = rtc.CudaKernel(_NoDriver(), "k", "k", rtc.parse_signature(
        "const float *x, float *y, int n"))
    x, y = nd.zeros((4,), ctx=cpu()), nd.ones((4,), ctx=cpu())
    storage = kernel._check_args([x, y, 4], torch.device("cpu"))
    assert [s.value for s in storage[:2]] == [x._data.data_ptr(),
                                              y._data.data_ptr()]
    assert isinstance(storage[0], ctypes.c_void_p)
    with pytest.raises(MXNetError, match="takes torch.float32"):
        kernel._check_args([x.astype("float64"), y, 4],
                           torch.device("cpu"))
    with pytest.raises(MXNetError, match="is on"):
        kernel.launch([x, y, 4], mt.gpu(0), (1, 1, 1), (32, 1, 1))
    assert kernel.launches == 0
