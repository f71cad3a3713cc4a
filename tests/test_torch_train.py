"""The port's training path on the CPU, held against the JAX package with
the same numpy inputs and the JAX package's weights carried across by
``load_reference_params``: autograd scopes and ``backward``, ``grad_req``
semantics, initializers, the conv/pool/BatchNorm layers, the losses, and
a few ``gluon.Trainer`` steps of the MNIST MLP and of a small ResNet v1.

Tolerances, fp32 throughout: layers and losses 1e-5 (one op, summation
order differs); gradients 1e-4 relative; the trained small ResNet see
``test_small_resnet_trains_like_jax``.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu_torch import (autograd, cpu, gluon, initializer,
                             load_reference_params)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as port_resnet


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------- autograd

def test_record_pause_and_modes_nest():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not autograd.is_training()
            assert not torch.is_grad_enabled()
            with autograd.train_mode():
                assert autograd.is_training()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.record(train_mode=False):
        assert autograd.is_recording() and not autograd.is_training()
    assert not autograd.is_recording() and not autograd.is_training()


def test_backward_seeds_ones_and_takes_head_grads():
    p = gluon.Parameter("w", shape=(3,))
    p.set_data(np.array([1.0, 2.0, 3.0], np.float32), ctx=cpu())
    with autograd.record():
        y = p.data() * p.data()              # a per-element "loss" vector
    autograd.backward(y)
    np.testing.assert_allclose(_np(p.grad()), [2.0, 4.0, 6.0])
    with autograd.record():
        y = p.data() * 2.0
    autograd.backward([y], [torch.tensor([1.0, 0.0, -1.0])])
    np.testing.assert_allclose(_np(p.grad()), [2.0, 0.0, -2.0])
    with pytest.raises(MXNetError, match="not connected"):
        autograd.backward(torch.ones(3))


# --------------------------------------------------------------- grad_req

def _quad_param(req):
    p = gluon.Parameter("w", grad_req=req, shape=(2,))
    p.set_data(np.array([1.0, -2.0], np.float32), ctx=cpu())
    return p


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_over_two_backwards(req):
    """``write``: the second backward's gradient; ``add``: the sum."""
    p = _quad_param(req)
    for scale in (3.0, 5.0):
        with autograd.record():
            loss = (p.data() * p.data()).sum() * scale
        autograd.backward(loss)
    want = {"write": 10.0, "add": 16.0}[req] * np.array([1.0, -2.0])
    np.testing.assert_allclose(_np(p.grad()), want)
    p.zero_grad()
    np.testing.assert_allclose(_np(p.grad()), [0.0, 0.0])
    assert p.fresh


def test_grad_req_add_matches_jax():
    """Two backwards into an ``add`` parameter, against the JAX package."""
    x = np.array([[0.5, -1.0, 2.0]], np.float32)
    ref = mx.gluon.nn.Dense(2, in_units=3, prefix="dense99_")
    ref.initialize()
    port = nn.Dense(2, in_units=3)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    for net in (ref, port):
        for p in net.collect_params().values():
            p.grad_req = "add"
    for _ in range(2):
        with mx.autograd.record():
            jl = (ref(mx.nd.array(x)) ** 2).sum()
        jl.backward()
        with autograd.record():
            pl = (port(torch.from_numpy(x)) ** 2).sum()
        autograd.backward(pl)
    for p, q in zip(ref.collect_params().values(),
                    port.collect_params().values()):
        np.testing.assert_allclose(_np(q.grad()), p.grad().asnumpy(),
                                   rtol=1e-5)


def test_grad_req_null_has_no_gradient():
    p = _quad_param("null")
    assert not p.data().requires_grad
    with pytest.raises(MXNetError, match="null"):
        p.grad()
    p.grad_req = "write"
    assert p.data().requires_grad
    with pytest.raises(MXNetError, match="grad_req"):
        p.grad_req = "sometimes"


def test_trainer_refuses_a_stale_write_gradient():
    net = nn.Dense(2, in_units=3)
    net.initialize(ctx=cpu())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 1.0})
    with pytest.raises(MXNetError, match="has not been updated"):
        tr.step(1)
    x = torch.ones(1, 3)
    with autograd.record():
        loss = net(x).sum()
    autograd.backward(loss)
    tr.step(1)
    before = _np(net.weight.data()).copy()
    with pytest.raises(MXNetError, match="has not been updated"):
        tr.step(1)                      # the gradient was consumed
    tr.step(1, ignore_stale_grad=True)  # skips every parameter
    np.testing.assert_array_equal(_np(net.weight.data()), before)


def test_shared_parameter_gets_one_gradient():
    """Two blocks on one ParameterDict share the weight: one Parameter,
    one tensor, and its gradient is the sum over both uses."""
    a = nn.Dense(2, in_units=3, prefix="tied_")
    b = nn.Dense(2, in_units=3, prefix="tied_", params=a.params)
    assert b.weight is a.weight
    a.initialize(ctx=cpu(), seed=1)
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    with autograd.record():
        loss = (a(x) + b(x)).sum()
    autograd.backward(loss)
    twice = _np(a.weight.grad()).copy()
    with autograd.record():
        loss = a(x).sum()
    autograd.backward(loss)
    np.testing.assert_allclose(twice, 2 * _np(a.weight.grad()), rtol=1e-6)


def test_load_reference_params_resets_gradients():
    p = _quad_param("write")
    with autograd.record():
        loss = p.data().sum()
    autograd.backward(loss)
    assert not p.fresh
    p.set_data(np.zeros(2, np.float32))
    assert p.fresh and not _np(p.grad()).any()


# ------------------------------------------------------------ initializers

def test_xavier_and_normal_statistics():
    gen = torch.Generator().manual_seed(0)
    w = torch.empty(256, 64, 3, 3)
    initializer.Xavier("gaussian", "in", 2).init_weight("w", w, gen)
    assert abs(w.std().item() - (2.0 / (64 * 9)) ** 0.5) < 2e-3
    initializer.Xavier().init_weight("w", w, gen)      # uniform, avg, 3
    bound = (3.0 / ((64 * 9 + 256 * 9) / 2)) ** 0.5
    assert w.abs().max().item() <= bound
    assert w.abs().max().item() > 0.99 * bound
    initializer.Normal(0.5).init_weight("w", w, gen)
    assert abs(w.std().item() - 0.5) < 5e-3
    bn = nn.BatchNorm(in_channels=4)
    bn.initialize(initializer.Xavier(), ctx=cpu())
    assert (_np(bn.running_var.data()) == 1).all()
    assert not _np(bn.running_mean.data()).any()
    with pytest.raises(MXNetError):
        initializer.Xavier(factor_type="sideways")


# ------------------------------------------------------------------ layers

def _pair(jax_layer, port_layer, x):
    jax_layer.initialize()
    jax_layer(mx.nd.array(x))                  # deferred shapes
    load_reference_params(port_layer, _arrays(jax_layer), ctx=cpu())
    want = jax_layer(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = _np(port_layer(torch.from_numpy(x)))
    return got, want


@pytest.mark.parametrize("make", [
    lambda m, **kw: m.gluon.nn.Conv2D(6, 3, strides=2, padding=1, **kw),
    lambda m, **kw: m.gluon.nn.Conv2D(4, (1, 3), dilation=(1, 2),
                                      activation="relu", **kw),
    lambda m, **kw: m.gluon.nn.Conv2D(4, 3, groups=2, use_bias=False, **kw),
], ids=["stride-pad", "dilated-relu", "groups"])
def test_conv2d_matches_jax(make):
    x = np.random.default_rng(0).standard_normal((2, 4, 9, 11),
                                                 dtype=np.float32)
    got, want = _pair(make(mx, prefix="conv2_d99_"),
                      make(mt, in_channels=4), x)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kind,kw", [
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1)),
    ("MaxPool2D", dict(pool_size=2, strides=3)),
    ("AvgPool2D", dict(pool_size=3, strides=2, padding=1)),
    ("AvgPool2D", dict(pool_size=(2, 3), strides=(1, 2))),
    ("GlobalAvgPool2D", {}),
])
def test_pooling_matches_jax(kind, kw):
    x = np.random.default_rng(1).standard_normal((2, 3, 9, 7),
                                                 dtype=np.float32)
    want = getattr(mx.gluon.nn, kind)(**kw)(mx.nd.array(x)).asnumpy()
    got = _np(getattr(nn, kind)(**kw)(torch.from_numpy(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("kind,kw", [
    ("MaxPool2D", dict(ceil_mode=True, layout="NHWC")),
    ("AvgPool2D", dict(count_include_pad=False, layout="NHWC")),
    ("AvgPool2D", dict(ceil_mode=True, layout="NHWC")),
], ids=["max-ceil", "avg-exclude-pad", "avg-nhwc"])
def test_pooling_rejects_unported_options(kind, kw):
    """Channels-last layouts raise; ``ceil_mode`` and
    ``count_include_pad=False`` are ported (held against the JAX package
    in ``tests/test_torch_gluon_layers.py``)."""
    with pytest.raises(MXNetError):
        getattr(nn, kind)(**kw)


@pytest.mark.parametrize("kw", [
    {}, {"scale": False, "center": False}, {"momentum": 0.5},
    {"use_global_stats": True}, {"axis": -1},
], ids=["default", "no-affine", "momentum", "global-stats", "channels-last"])
def test_batchnorm_matches_jax_in_train_and_predict(kw):
    """Output, input gradient and running statistics (biased variance,
    MXNet's momentum) after two training forwards, then a predict
    forward on the updated statistics."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 5, 3, 3), dtype=np.float32) * 3 + 1)
    if kw.get("axis") == -1:
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ref = mx.gluon.nn.BatchNorm(in_channels=5, prefix="batch_norm99_", **kw)
    ref.initialize()
    port = nn.BatchNorm(in_channels=5, **kw)
    arrays = _arrays(ref)
    for k in arrays:                  # non-trivial affine and statistics
        arrays[k] = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    for k, p in ref.collect_params().items():
        p.set_data(mx.nd.array(arrays[k]))
    load_reference_params(port, arrays, ctx=cpu())
    for _ in range(2):
        jx = mx.nd.array(x)
        jx.attach_grad()
        with mx.autograd.record():
            jy = ref(jx)
            jl = jy * jy
        jl.backward()
        px = torch.from_numpy(x).requires_grad_()
        with autograd.record():
            py = port(px)
            pl = py * py
        autograd.backward(pl)
        np.testing.assert_allclose(_np(py), jy.asnumpy(), atol=1e-5)
        np.testing.assert_allclose(_np(px.grad), jx.grad.asnumpy(),
                                   rtol=1e-4, atol=1e-4)
    for (k, p), q in zip(ref.collect_params().items(),
                         port.collect_params().values()):
        np.testing.assert_allclose(_np(q.data()), p.data().asnumpy(),
                                   atol=1e-5, err_msg=k)
    want = ref(mx.nd.array(x)).asnumpy()           # predict mode
    with torch.no_grad():
        np.testing.assert_allclose(_np(port(torch.from_numpy(x))), want,
                                   atol=1e-5)


def test_dropout_follows_autograd_training_mode():
    drop = nn.Dropout(0.5)
    x = torch.ones(1000)
    drop.train()                      # nn.Module.training does not count
    assert torch.equal(drop(x), x)
    with autograd.train_mode():
        y = drop(x)
    assert (y == 0).any() and (y == 2).any()
    with autograd.record(train_mode=False):
        assert torch.equal(drop(x), x)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("kw,label_kind", [
    ({}, "sparse"),
    ({"weight": 0.5}, "sparse-weighted"),
    ({"sparse_label": False}, "dense"),
    ({"from_logits": True}, "sparse"),
    ({"axis": 1, "batch_axis": 0}, "sparse-3d"),
])
def test_softmax_ce_loss_and_gradient_match_jax(kw, label_kind):
    rng = np.random.default_rng(3)
    shape = (4, 5, 3) if label_kind == "sparse-3d" else (4, 5)
    pred = rng.standard_normal(shape, dtype=np.float32)
    if label_kind == "dense":
        label = rng.dirichlet(np.ones(5), 4).astype(np.float32)
    elif label_kind == "sparse-3d":
        label = rng.integers(0, 5, (4, 3)).astype(np.float32)
    else:
        label = rng.integers(0, 5, 4).astype(np.float32)
    sw = rng.uniform(0.5, 2, (4, 1)).astype(np.float32) \
        if label_kind == "sparse-weighted" else None
    ref = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    port = gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    jp = mx.nd.array(pred)
    jp.attach_grad()
    with mx.autograd.record():
        jl = ref(jp, mx.nd.array(label),
                 None if sw is None else mx.nd.array(sw))
    jl.backward()
    pp = torch.from_numpy(pred).requires_grad_()
    with autograd.record():
        pl = port(pp, torch.from_numpy(label),
                  None if sw is None else torch.from_numpy(sw))
    autograd.backward(pl)
    assert pl.shape == (4,)
    np.testing.assert_allclose(_np(pl), jl.asnumpy(), atol=1e-5)
    np.testing.assert_allclose(_np(pp.grad), jp.grad.asnumpy(), atol=1e-5)


def test_l2_loss_matches_jax():
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((3, 4, 2), dtype=np.float32)
    label = rng.standard_normal((3, 8), dtype=np.float32)
    want = mx.gluon.loss.L2Loss(weight=3.0)(mx.nd.array(pred),
                                            mx.nd.array(label)).asnumpy()
    got = gluon.loss.L2Loss(weight=3.0)(torch.from_numpy(pred),
                                        torch.from_numpy(label))
    np.testing.assert_allclose(_np(got), want, atol=1e-6)


# ------------------------------------------------------------------ models

def test_resnet50_parameter_names_and_counts_match_jax():
    ref = jax_resnet.resnet50_v1(prefix="res_net_v199_")
    port = port_resnet.resnet50_v1()
    strip = len(port.prefix)
    assert [k[strip:] for k in port.collect_params()] == \
        [k[len(ref.prefix):] for k in ref.collect_params()]
    trainable = [p for p in port.collect_params().values()
                 if p.grad_req != "null"]
    assert len(trainable) == 161
    assert sum(math.prod(p.shape) for p in trainable) == 25_557_032
    ref18 = jax_resnet.resnet18_v1(prefix="res_net_v199_")
    port18 = port_resnet.resnet18_v1()
    assert [k[len(port18.prefix):] for k in port18.collect_params()] == \
        [k[len(ref18.prefix):] for k in ref18.collect_params()]


def _mlp(lib, **kw):
    net = lib.gluon.nn.HybridSequential(**kw)
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(128, activation="relu", in_units=784),
                lib.gluon.nn.Dense(64, activation="relu", in_units=128),
                lib.gluon.nn.Dense(10, in_units=64))
    return net


def _train(ref, port, X, Y, steps, opt, hybridize=False, resync=False):
    """``steps`` Trainer steps of both packages on one batch; returns the
    per-step per-sample losses of each.  With ``resync`` the port starts
    every step from the JAX package's weights, running statistics and
    momenta, so each step is compared alone and rounding differences do
    not compound."""
    if hybridize:
        port.hybridize()
    jt = mx.gluon.Trainer(ref.collect_params(), "sgd", opt)
    pt = gluon.Trainer(port.collect_params(), "sgd", opt)
    jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ploss = gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for _ in range(steps):
        if resync:
            load_reference_params(port, _arrays(ref), ctx=cpu())
            for (i, _), state in jt._states.items():
                pt._states[i] = torch.tensor(state.asnumpy())
        with mx.autograd.record():
            jl = jloss(ref(mx.nd.array(X)), mx.nd.array(Y))
        jl.backward()
        jt.step(X.shape[0])
        with autograd.record():
            pl = ploss(port(torch.from_numpy(X)), torch.from_numpy(Y))
        autograd.backward(pl)
        pt.step(X.shape[0])
        out.append((jl.asnumpy(), _np(pl)))
    return out, jt, pt


def _check_params(ref, port, atol, rtol=0.0):
    pp = list(port.collect_params().items())
    for (k, p), (kq, q) in zip(ref.collect_params().items(), pp):
        assert k[len(ref.prefix):] == kq[len(port.prefix):]
        np.testing.assert_allclose(_np(q.data()), p.data().asnumpy(),
                                   atol=atol, rtol=rtol, err_msg=k)


def test_mnist_mlp_trains_like_jax():
    """Config #1 at full width (784-128-64-10), batch 8, Trainer("sgd",
    lr 0.1), 3 hybridized steps: losses and weights within 1e-5."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((8, 784), dtype=np.float32)
    Y = rng.integers(0, 10, 8).astype(np.float32)
    ref = _mlp(mx, prefix="hybrid_sequential99_")
    ref.initialize()
    port = _mlp(mt)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    losses, _, _ = _train(ref, port, X, Y, 3, {"learning_rate": 0.1},
                          hybridize=True)
    for jl, pl in losses:
        np.testing.assert_allclose(pl, jl, atol=1e-5)
    assert losses[-1][1].mean() < losses[0][1].mean()
    _check_params(ref, port, atol=1e-5)


@pytest.fixture(scope="module")
def small_resnets():
    """ResNetV1(BottleneckV1, [1,1,1,1], [8,16,32,64,128], classes=10) in
    both packages from the JAX package's Xavier("gaussian","in",2)
    weights, 32x32 inputs, batch 4, and 3 Trainer steps of SGD (lr 0.1,
    momentum 0.9, wd 1e-4).  Built once: the JAX package compiles every
    op of it on first use (~30 s on the CPU)."""
    rng = np.random.default_rng(6)
    X = rng.standard_normal((4, 3, 32, 32), dtype=np.float32)
    Y = rng.integers(0, 10, 4).astype(np.float32)
    spec = (jax_resnet.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128])
    ref = jax_resnet.ResNetV1(*spec, classes=10, prefix="res_net_v199_")
    ref.initialize(mx.init.Xavier("gaussian", "in", 2))
    ref(mx.nd.array(X))
    loaded = _arrays(ref)
    port = port_resnet.ResNetV1(port_resnet.BottleneckV1, *spec[1:],
                                classes=10)
    load_reference_params(port, loaded, ctx=cpu())
    losses, jt, pt = _train(
        ref, port, X, Y, 3,
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        hybridize=True, resync=True)
    return ref, port, loaded, losses, jt, pt


def test_small_resnet_loads_reference_weights_and_running_stats(
        small_resnets):
    ref, port, loaded = small_resnets[:3]
    fresh = port_resnet.ResNetV1(port_resnet.BottleneckV1, [1, 1, 1, 1],
                                 [8, 16, 32, 64, 128], classes=10)
    load_reference_params(fresh, loaded, ctx=cpu())
    stats = [k for k in loaded if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 17
    ours = fresh.collect_params()
    for k in loaded:
        name = fresh.prefix + k[len(ref.prefix):]
        np.testing.assert_array_equal(_np(ours[name].data()), loaded[k])


def test_small_resnet_trains_like_jax(small_resnets):
    """Three Trainer steps, each from the JAX package's state of the step
    before (weights, running statistics, momenta): losses within 1e-4,
    and every parameter, running statistic and momentum within 1e-4.

    The steps are compared one at a time because this model is
    ill-conditioned: BatchNorm over 4 samples of 1x1 maps in the last
    stage magnifies small weight differences in the loss, and the JAX
    package differentiates BatchNorm through E[x^2] - E[x]^2 in fp32,
    less accurately than ``F.batch_norm``; free-running, the two
    packages drift apart beyond 1e-3 within three steps of lr 0.1."""
    ref, port, _, losses, jt, pt = small_resnets
    for jl, pl in losses:
        assert np.isfinite(pl).all()
        np.testing.assert_allclose(pl, jl, atol=1e-4)
    _check_params(ref, port, atol=1e-4)
    assert len(pt._states) == len(jt._states) == 53
    for (i, _), state in jt._states.items():
        np.testing.assert_allclose(_np(pt._states[i]), state.asnumpy(),
                                   atol=1e-4)
