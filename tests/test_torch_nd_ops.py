"""The port's ``mx.nd`` registry ops on ``NDArray``s held against the JAX
package's on the same numpy inputs: forward values over a table of (op,
parameters, inputs) covering the elementwise, matrix, reduction and
neural-network modules, then input gradients under ``autograd.record()``
with a random head gradient, against the JAX package's imperative
autograd.  Random ops are held by their moments and by reproducibility
under ``mx.random.seed``, never by value against ``jax.random``.

Tolerance: fp32, ``atol=1e-5, rtol=1e-5`` (one fp32 evaluation each;
orders of summation differ).  Comparisons, indices and gathers are
exact.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError

TOL = dict(atol=1e-5, rtol=1e-5)
_RS = np.random.RandomState(11)
ARRAYS = {
    "A": _RS.randn(3, 4).astype(np.float32),
    "B": _RS.randn(3, 4).astype(np.float32),
    "P": (_RS.rand(3, 4) + 0.5).astype(np.float32),
    "U": (_RS.rand(3, 4) * 1.6 - 0.8).astype(np.float32),
    "R": _RS.randn(1, 4).astype(np.float32),
    "C": _RS.randn(4, 5).astype(np.float32),
    "X3": _RS.randn(2, 3, 4).astype(np.float32),
    "Y3": _RS.randn(2, 4, 5).astype(np.float32),
    "W": _RS.randn(6, 4).astype(np.float32),
    "W12": _RS.randn(6, 12).astype(np.float32),
    "b6": _RS.randn(6).astype(np.float32),
    "IMG": _RS.randn(2, 3, 7, 7).astype(np.float32),
    "K": _RS.randn(4, 3, 3, 3).astype(np.float32),
    "b4": _RS.randn(4).astype(np.float32),
    "IDX": np.array([3, 0, 2], np.float32),
    "IDX4": np.array([1, 0, 2, 1], np.float32),
}

# (id, op, kwargs, inputs, check gradients)
CASES = [
    ("relu", "relu", {}, ["A"], True),
    ("sigmoid", "sigmoid", {}, ["A"], True),
    ("tanh", "tanh", {}, ["A"], True),
    ("softsign", "softsign", {}, ["A"], True),
    ("softrelu", "softrelu", {}, ["A"], True),
    ("exp", "exp", {}, ["A"], True),
    ("expm1", "expm1", {}, ["A"], False),
    ("log", "log", {}, ["P"], True),
    ("log1p", "log1p", {}, ["P"], False),
    ("sqrt", "sqrt", {}, ["P"], True),
    ("rsqrt", "rsqrt", {}, ["P"], False),
    ("cbrt", "cbrt", {}, ["A"], False),
    ("square", "square", {}, ["A"], True),
    ("abs", "abs", {}, ["A"], True),
    ("sign", "sign", {}, ["A"], False),
    ("floor", "floor", {}, ["A"], False),
    ("ceil", "ceil", {}, ["A"], False),
    ("trunc", "trunc", {}, ["A"], False),
    ("negative", "negative", {}, ["A"], False),
    ("reciprocal", "reciprocal", {}, ["P"], True),
    ("erf", "erf", {}, ["A"], False),
    ("erfinv", "erfinv", {}, ["U"], False),
    ("gammaln", "gammaln", {}, ["P"], False),
    ("sin", "sin", {}, ["A"], False),
    ("arctan", "arctan", {}, ["A"], False),
    ("arcsinh", "arcsinh", {}, ["A"], False),
    ("radians", "radians", {}, ["A"], False),
    ("clip", "clip", {"a_min": -0.5, "a_max": 0.5}, ["A"], True),
    ("add", "broadcast_add", {}, ["A", "B"], True),
    ("add_broadcast", "broadcast_add", {}, ["A", "R"], True),
    ("sub", "broadcast_sub", {}, ["A", "B"], False),
    ("mul", "broadcast_mul", {}, ["A", "B"], True),
    ("div", "broadcast_div", {}, ["A", "P"], True),
    ("power", "broadcast_power", {}, ["P", "B"], True),
    ("maximum", "broadcast_maximum", {}, ["A", "B"], True),
    ("minimum", "broadcast_minimum", {}, ["A", "B"], False),
    ("mod", "broadcast_mod", {}, ["A", "P"], False),
    ("greater", "broadcast_greater", {}, ["A", "B"], False),
    ("lesser_equal", "broadcast_lesser_equal", {}, ["A", "R"], False),
    ("logical_and", "broadcast_logical_and", {}, ["A", "B"], False),
    ("plus_scalar", "_plus_scalar", {"scalar": 1.5}, ["A"], False),
    ("rminus_scalar", "_rminus_scalar", {"scalar": 1.5}, ["A"], False),
    ("rdiv_scalar", "_rdiv_scalar", {"scalar": 2.0}, ["P"], True),
    ("power_scalar", "_power_scalar", {"scalar": 3.0}, ["A"], True),
    ("greater_scalar", "_greater_scalar", {"scalar": 0.1}, ["A"], False),
    ("dot", "dot", {}, ["A", "C"], True),
    ("dot_tb", "dot", {"transpose_b": True}, ["A", "B"], True),
    ("batch_dot", "batch_dot", {}, ["X3", "Y3"], True),
    ("reshape_0_m1", "reshape", {"shape": (0, -1)}, ["X3"], True),
    ("reshape_m3", "reshape", {"shape": (-3, 4)}, ["X3"], False),
    ("reshape_m4", "reshape", {"shape": (-4, 1, 2, -2)}, ["X3"], False),
    ("reshape_m2", "reshape", {"shape": (2, -2)}, ["X3"], False),
    ("transpose", "transpose", {"axes": (2, 0, 1)}, ["X3"], True),
    ("transpose_all", "transpose", {}, ["A"], False),
    ("expand_dims", "expand_dims", {"axis": 1}, ["A"], False),
    ("concat", "concat", {"dim": 0}, ["A", "B"], True),
    ("slice", "slice", {"begin": (0, 1, None), "end": (2, 3, None)},
     ["X3"], True),
    ("take", "take", {"axis": 1}, ["A", "IDX"], True),
    ("embedding", "Embedding", {"input_dim": 6, "output_dim": 4},
     ["IDX", "W"], True),
    ("embedding_clip", "Embedding", {"input_dim": 3, "output_dim": 4},
     ["IDX4", "A"], True),
    ("split_one", "split", {"num_outputs": 1, "axis": 1}, ["A"], True),
    ("slice_channel_one", "SliceChannel", {"num_outputs": 1, "axis": 0,
                                           "squeeze_axis": True},
     ["R"], False),
    ("swapaxes", "swapaxes", {"dim1": 0, "dim2": 2}, ["X3"], True),
    ("zeros_like", "zeros_like", {}, ["A"], False),
    ("one_hot", "one_hot", {"depth": 5}, ["IDX"], False),
    ("pick", "pick", {"axis": 0}, ["A", "IDX4"], True),
    ("broadcast_to", "broadcast_to", {"shape": (3, 0)}, ["R"], True),
    ("flatten", "Flatten", {}, ["X3"], False),
    ("sum_axis", "sum", {"axis": 1}, ["X3"], True),
    ("sum_exclude", "sum", {"axis": 1, "exclude": True}, ["X3"], False),
    ("mean_keepdims", "mean", {"axis": (0, 2), "keepdims": True}, ["X3"],
     True),
    ("max", "max", {"axis": 2}, ["X3"], True),
    ("min", "min", {"axis": 0}, ["X3"], False),
    ("prod", "prod", {"axis": 1}, ["A"], False),
    ("argmax", "argmax", {"axis": 1}, ["A"], False),
    ("argmin", "argmin", {"axis": 0}, ["A"], False),
    ("fc", "FullyConnected", {"num_hidden": 6}, ["A", "W", "b6"], True),
    ("fc_flatten", "FullyConnected", {"num_hidden": 6, "no_bias": True},
     ["X3", "W12"], True),
    ("conv", "Convolution", {"kernel": (3, 3), "num_filter": 4,
                             "pad": (1, 1), "stride": (2, 2)},
     ["IMG", "K", "b4"], True),
    ("pool_max", "Pooling", {"kernel": (2, 2), "stride": (2, 2)}, ["IMG"],
     True),
    ("pool_avg_full", "Pooling", {"kernel": (3, 3), "stride": (2, 2),
                                  "pad": (1, 1), "pool_type": "avg",
                                  "pooling_convention": "full"},
     ["IMG"], True),
    ("pool_sum", "Pooling", {"kernel": (2, 2), "pool_type": "sum"},
     ["IMG"], False),
    ("pool_global", "Pooling", {"global_pool": True, "pool_type": "avg",
                                "kernel": (1, 1)}, ["IMG"], False),
    ("act_tanh", "Activation", {"act_type": "tanh"}, ["A"], False),
    ("act_softrelu", "Activation", {"act_type": "softrelu"}, ["A"], True),
    ("softmax", "softmax", {"axis": 0}, ["A"], True),
    ("softmax_temp", "softmax", {"temperature": 2.0}, ["A"], False),
    ("log_softmax", "log_softmax", {}, ["A"], True),
]


def _jax_args(kwargs, names):
    """The JAX package's scalar ops take the scalar as a 0-d input."""
    kwargs = dict(kwargs)
    scalar = [np.array(kwargs.pop("scalar"), np.float32)] \
        if "scalar" in kwargs else []
    return [mx.nd.array(ARRAYS[n]) for n in names] + scalar, kwargs


def _jax(op, kwargs, names):
    args, kwargs = _jax_args(kwargs, names)
    return getattr(mx.nd, op)(*args, **kwargs)


def _port(op, kwargs, names):
    return getattr(nd, op)(*[nd.array(ARRAYS[n], ctx=mt.cpu())
                             for n in names], **kwargs)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(case):
    _, op, kwargs, names, _ = case
    want = _jax(op, kwargs, names).asnumpy()
    got = _port(op, kwargs, names)
    assert isinstance(got, nd.NDArray)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.asnumpy(), want, **TOL)


GRAD_CASES = [c for c in CASES if c[4]]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_jax(case):
    _, op, kwargs, names, _ = case
    floats = [n for n in names if not n.startswith("IDX")]
    jin, jkw = _jax_args(kwargs, names)
    pin = [nd.array(ARRAYS[n], ctx=mt.cpu()) for n in names]
    for n, j, p in zip(names, jin, pin):
        if n in floats:
            j.attach_grad()
            p.attach_grad()
    with mx.autograd.record():
        jy = getattr(mx.nd, op)(*jin, **jkw)
    head = np.random.RandomState(3).randn(*jy.shape).astype(np.float32)
    jy.backward(mx.nd.array(head))
    with autograd.record():
        py = getattr(nd, op)(*pin, **kwargs)
    py.backward(nd.array(head, ctx=mt.cpu()))
    for n, j, p in zip(names, jin, pin):
        if n in floats:
            np.testing.assert_allclose(p.grad.asnumpy(), j.grad.asnumpy(),
                                       err_msg=n, **TOL)


@pytest.mark.parametrize("op,kwargs", [
    ("split", {"num_outputs": 2, "axis": 1}),
    ("split", {"num_outputs": 4, "axis": -1, "squeeze_axis": True}),
    ("SliceChannel", {"num_outputs": 3, "axis": 0}),
    ("SliceChannel", {"num_outputs": 2, "axis": 2, "squeeze_axis": False}),
], ids=["split2", "split4_squeeze", "slice_channel3", "slice_channel_x3"])
def test_split_outputs_and_gradients_match_jax(op, kwargs):
    """``split``/``SliceChannel`` with several outputs: each output, and
    the input's gradient under a random head gradient on every output."""
    name = "X3" if kwargs["axis"] == 2 else "A"
    j = mx.nd.array(ARRAYS[name])
    p = nd.array(ARRAYS[name], ctx=mt.cpu())
    j.attach_grad()
    p.attach_grad()
    with mx.autograd.record():
        jy = getattr(mx.nd, op)(j, **kwargs)
    with autograd.record():
        py = getattr(nd, op)(p, **kwargs)
    assert len(py) == len(jy) == kwargs["num_outputs"]
    rs = np.random.RandomState(5)
    heads = [rs.randn(*y.shape).astype(np.float32) for y in jy]
    for a, b in zip(py, jy):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    mx.autograd.backward(list(jy), [mx.nd.array(h) for h in heads])
    autograd.backward(list(py), [nd.array(h, ctx=mt.cpu()) for h in heads])
    np.testing.assert_allclose(p.grad.asnumpy(), j.grad.asnumpy(), **TOL)


def test_softmax_output_gradient_matches_jax():
    """SoftmaxOutput's backward is (p - onehot) * scale whatever the head
    gradient, with ignore_label and the batch/valid normalisations."""
    x = _RS.randn(4, 5).astype(np.float32)
    label = np.array([1, 4, -1, 2], np.float32)
    for kw in ({}, {"normalization": "batch", "grad_scale": 2.0},
               {"use_ignore": True, "ignore_label": -1,
                "normalization": "valid"}):
        jx, px = mx.nd.array(x), nd.array(x, ctx=mt.cpu())
        jx.attach_grad()
        px.attach_grad()
        with mx.autograd.record():
            jy = mx.nd.SoftmaxOutput(jx, mx.nd.array(label), **kw)
        jy.backward(mx.nd.ones(jy.shape) * 3.0)
        with autograd.record():
            py = nd.SoftmaxOutput(px, nd.array(label, ctx=mt.cpu()), **kw)
        py.backward(nd.ones(py.shape, ctx=mt.cpu()) * 3.0)
        np.testing.assert_allclose(py.asnumpy(), jy.asnumpy(), **TOL)
        np.testing.assert_allclose(px.grad.asnumpy(), jx.grad.asnumpy(),
                                   **TOL)


def test_unknown_op_and_bad_parameters_raise():
    with pytest.raises(MXNetError, match="not registered"):
        nd.get_op("no_such_op")
    x = nd.array(ARRAYS["A"], ctx=mt.cpu())
    with pytest.raises(MXNetError, match="mode"):
        nd.pick(x, x, mode="raise")
    with pytest.raises(MXNetError, match="act_type"):
        nd.Activation(x, act_type="swish")


def test_positional_parameters_follow_the_maker():
    """``nd.sum(x, 1)`` is ``nd.sum(x, axis=1)``, as MXNet's generated
    frontends take them."""
    x = nd.array(ARRAYS["X3"], ctx=mt.cpu())
    np.testing.assert_array_equal(nd.sum(x, 1).asnumpy(),
                                  nd.sum(x, axis=1).asnumpy())
    np.testing.assert_array_equal(nd.one_hot(nd.array(ARRAYS["IDX"],
                                                      ctx=mt.cpu()), 5)
                                  .asnumpy(), np.eye(5)[[3, 0, 2]])


def test_tensors_in_give_tensors_out():
    a = torch.from_numpy(ARRAYS["A"])
    out = nd.relu(a)
    assert isinstance(out, torch.Tensor)
    assert isinstance(nd.relu(nd.array(ARRAYS["A"], ctx=mt.cpu())),
                      nd.NDArray)


# ------------------------------------------------------------------ random

def test_draws_follow_their_distribution():
    with mt.cpu():
        n = nd.random.normal(2.0, 3.0, shape=(40000,)).asnumpy()
        u = nd.random.uniform(-1.0, 3.0, shape=(40000,)).asnumpy()
        r = nd.random.randint(2, 7, shape=(40000,))
    assert abs(n.mean() - 2.0) < 0.1 and abs(n.std() - 3.0) < 0.1
    assert u.min() >= -1.0 and u.max() < 3.0 and abs(u.mean() - 1.0) < 0.05
    assert r.dtype == np.int32
    assert set(np.unique(r.asnumpy())) == {2, 3, 4, 5, 6}
    assert nd.random.randn(2, 3, ctx=mt.cpu()).shape == (2, 3)


def test_draws_are_reproducible_under_seed():
    with mt.cpu():
        mt.random.seed(7)
        a = nd.random.normal(shape=(5,)).asnumpy()
        b = mt.random.uniform(shape=(5,)).asnumpy()
        mt.random.seed(7)
        np.testing.assert_array_equal(nd.random.normal(shape=(5,))
                                      .asnumpy(), a)
        np.testing.assert_array_equal(nd.random.uniform(shape=(5,))
                                      .asnumpy(), b)
        mt.random.seed(8)
        assert not np.array_equal(nd.random.normal(shape=(5,)).asnumpy(), a)
        out = nd.zeros((3,))
        assert nd.random.uniform(out=out) is out
        assert out.asnumpy().min() > 0


def test_dropout_is_identity_outside_training():
    x = nd.ones((200, 50), ctx=mt.cpu())
    np.testing.assert_array_equal(nd.Dropout(x, p=0.5).asnumpy(),
                                  x.asnumpy())
    with autograd.train_mode():
        mt.random.seed(1)
        y = nd.Dropout(x, p=0.25).asnumpy()
        mt.random.seed(1)
        np.testing.assert_array_equal(nd.Dropout(x, p=0.25).asnumpy(), y)
    assert set(np.unique(y)) == {0.0, np.float32(1 / 0.75)}
    assert abs((y == 0).mean() - 0.25) < 0.02


def test_softmax_dtype_follows_mxnet():
    """MXNet's softmax returns its ``dtype``; the JAX op accepts the
    parameter and ignores it (a departure filed in ROADMAP)."""
    x = ARRAYS["A"]
    got = nd.softmax(nd.array(x, ctx=mt.cpu()), dtype="float64")
    want = mx.nd.softmax(mx.nd.array(x), dtype="float64")
    assert got.dtype == np.float64 and want.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


def test_hand_written_frontends_take_ndarrays():
    """``nd.flash_attention`` (the kernel wrapper itself) and the Gluon
    blocks answer NDArrays with NDArrays, keyword inputs included, and
    compute what they compute on the tensors."""
    rs = np.random.RandomState(2)
    q = rs.randn(2, 3, 8, 16).astype(np.float32)
    vl = np.array([8.0, 5.0], np.float32)
    got = nd.flash_attention(*[nd.array(q, ctx=mt.cpu())] * 3,
                             valid_len=nd.array(vl, ctx=mt.cpu()))
    want = nd.flash_attention(*[torch.from_numpy(q)] * 3,
                              valid_len=torch.from_numpy(vl))
    assert isinstance(got, nd.NDArray) and isinstance(want, torch.Tensor)
    np.testing.assert_array_equal(got.asnumpy(), want.numpy())
    loss = mt.gluon.loss.L2Loss()(nd.ones((3, 2), ctx=mt.cpu()),
                                  nd.zeros((3, 2), ctx=mt.cpu()),
                                  sample_weight=nd.array([[1.0], [2.0],
                                                          [0.0]],
                                                         ctx=mt.cpu()))
    assert isinstance(loss, nd.NDArray)
    np.testing.assert_array_equal(loss.asnumpy(), [0.5, 1.0, 0.0])
