"""The port's ``contrib.amp`` held against the JAX package's: the cases of
``tests/test_amp.py`` that need neither Symbol nor ``multi_precision``
(its tests at lines 21, 32, 55 (eager only), 68, 133, 144 and 154), each
against the JAX package where a value is compared, plus the policy helper
itself.  AMP is process-wide in both packages: a fixture turns it off on
both sides after every test.

Tolerance for bf16 values: 2e-2 relative (bf16 GEMM operands and
results, 8 mantissa bits).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jax_autograd
from mxnet_tpu import gluon as jax_gluon
from mxnet_tpu.contrib import amp as jax_amp
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import nn


@pytest.fixture(autouse=True)
def _amp_off_after():
    try:
        yield
    finally:
        amp.disable()
        jax_amp.disable()


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.asnumpy(), np.float32)


def test_amp_casts_matmul_to_bf16():
    """(test_amp.py:21) FullyConnected (the port's Dense) runs in bf16;
    an FP32-list op (log_softmax; softmax is not ported) returns float32."""
    amp.init("bfloat16")
    jax_amp.init("bfloat16")
    rs = np.random.RandomState(0)
    x = rs.randn(4, 8).astype(np.float32)
    w = rs.randn(16, 8).astype(np.float32)
    jy = mx.nd.FullyConnected(mx.nd.array(x), mx.nd.array(w), num_hidden=16,
                              no_bias=True)
    dense = nn.Dense(16, use_bias=False, in_units=8)
    dense.weight.set_data(torch.from_numpy(w), ctx=cpu())
    y = dense(torch.from_numpy(x))
    assert y.dtype == torch.bfloat16 and str(jy.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(y), _np(jy), rtol=2e-2, atol=2e-2)
    s, js = nd.log_softmax(y), mx.nd.log_softmax(jy)
    assert s.dtype == torch.float32 and str(js.dtype) == "float32"
    np.testing.assert_allclose(_np(s), _np(js), rtol=2e-2, atol=2e-2)


def test_amp_training_converges_params_stay_fp32():
    """(test_amp.py:32) An MLP trained 10 SGD steps under AMP: the loss
    falls, the weights stay fp32, and the losses follow the JAX
    package's from the same weights."""
    amp.init("bfloat16")
    jax_amp.init("bfloat16")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 16)).astype(np.float32)
    y = (x[:, :4].sum(1) > 0).astype(np.float32)
    jnet = jax_gluon.nn.Sequential(prefix="mlp_")
    with jnet.name_scope():
        jnet.add(jax_gluon.nn.Dense(32, activation="relu"),
                 jax_gluon.nn.Dense(2))
    jnet.initialize()
    jnet(mx.nd.array(x))                       # deferred shapes
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu", in_units=16),
                nn.Dense(2, in_units=32))
    load_reference_params(net, _arrays(jnet), ctx=cpu())
    jtr = jax_gluon.Trainer(jnet.collect_params(), "sgd",
                            {"learning_rate": 0.5})
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    jloss = jax_gluon.loss.SoftmaxCrossEntropyLoss()
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    ours, theirs = [], []
    for _ in range(10):
        with jax_autograd.record():
            jl = jloss(jnet(mx.nd.array(x)), mx.nd.array(y))
        jl.backward()
        jtr.step(128)
        theirs.append(float(jl.mean().asnumpy()))
        with autograd.record():
            out = net(xs)
            lv = loss(out, ys)
        assert out.dtype == torch.bfloat16 and lv.dtype == torch.float32
        autograd.backward(lv)
        tr.step(128)
        ours.append(lv.mean().item())
    assert ours[-1] < ours[0]
    np.testing.assert_allclose(ours, theirs, rtol=2e-2)
    for p in net.collect_params().values():
        assert p._tensor().dtype == torch.float32       # masters stay fp32
        assert p._grad_tensor().dtype == torch.float32


def test_amp_dense_matches_reference_eager():
    """(test_amp.py:55, eager only: the port's hybridize freezes no
    graph) A Dense under AMP gives the JAX package's bf16 result, and
    the same after ``hybridize()``."""
    amp.init("bfloat16")
    jax_amp.init("bfloat16")
    x = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    jnet = jax_gluon.nn.Dense(8, in_units=16)
    jnet.initialize()
    want = jnet(mx.nd.array(x))
    net = nn.Dense(8, in_units=16)
    load_reference_params(net, _arrays(jnet), ctx=cpu())
    eager = net(torch.from_numpy(x))
    net.hybridize()
    hybrid = net(torch.from_numpy(x))
    assert eager.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(eager), _np(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(_np(eager), _np(hybrid))


def test_loss_scaling_skips_overflow_step():
    """(test_amp.py:68) An overflowing scaled loss: ``unscale`` reports
    it and halves the scale, as the JAX package's does; the caller skips
    the step, and a ``trainer.step`` there raises on the stale gradients
    in both packages, changing no weight; a clean pass after it steps."""
    from mxnet_tpu.base import MXNetError as JaxError
    scales = []
    for pkg, ag, gl, am in ((torch, autograd, gluon, amp),
                            (mx, jax_autograd, jax_gluon, jax_amp)):
        if pkg is torch:
            net = nn.Dense(4, in_units=8)
            net.initialize(ctx=cpu())

            def ones(n):
                return torch.ones(2, 8) * n
        else:
            net = gl.nn.Dense(4)
            net.initialize()

            def ones(n):
                return mx.nd.ones((2, 8)) * n
        tr = gl.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
        am.init_trainer(tr)
        scaler = tr._amp_loss_scaler
        s0 = scaler.loss_scale
        with ag.record():
            out = net(ones(1e30))             # inf in the fp32 loss
            L = (out * out).sum() * 1e30
        with am.scale_loss(L, tr) as scaled:
            scaled.backward()
        assert am.unscale(tr)
        scales.append((s0, scaler.loss_scale))
        w0 = _np(net.weight.data()).copy()
        with pytest.raises(MXNetError if pkg is torch else JaxError,
                           match="has not been updated"):
            tr.step(2)                         # what the caller skips
        np.testing.assert_array_equal(_np(net.weight.data()), w0)
        with ag.record():
            L = (net(ones(1.0)) ** 2.0).sum()
        with am.scale_loss(L, tr) as scaled:
            scaled.backward()
        assert not am.unscale(tr)
        tr.step(2)
        assert not np.array_equal(_np(net.weight.data()), w0)
    assert scales[0] == scales[1] == (2.0 ** 16, 2.0 ** 15)


def test_has_overflow_elementwise_not_sum():
    """(test_amp.py:133) Finite fp16 gradients that SUM to inf are not an
    overflow; one inf element is, in both packages."""
    from mxnet_tpu.contrib.amp.loss_scaler import LossScaler as JaxScaler
    big = np.full((10000,), 100.0, np.float16)
    bad = big.copy()
    bad[7] = np.inf

    class _P:
        def __init__(self, g):
            self.g = g

        def list_grad(self):
            return [self.g]

    for arr, want in ((big, False), (bad, True)):
        ours = amp.LossScaler().has_overflow([_P(torch.from_numpy(arr))])
        theirs = JaxScaler().has_overflow(
            [_P(mx.nd.array(arr, dtype="float16"))])
        assert ours == theirs == want


def test_out_keeps_its_dtype_under_amp():
    """(test_amp.py:144; the port has no ``dot``, so an FP32-list op
    writes into a bf16 ``out``) ``out`` keeps its own dtype in both."""
    amp.init("bfloat16")
    jax_amp.init("bfloat16")
    a = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    c = torch.zeros(4, dtype=torch.bfloat16)
    jc = mx.nd.zeros((4,), dtype="bfloat16")
    assert nd.mean(torch.from_numpy(a), axis=1, out=c) is c
    mx.nd.mean(mx.nd.array(a), axis=1, out=jc)
    assert c.dtype == torch.bfloat16 and str(jc.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(c), _np(jc), rtol=2e-2)


def test_convert_hybrid_block_is_scoped():
    """(test_amp.py:154) Only the converted block runs in bf16, and its
    result is the JAX package's."""
    jnet = jax_gluon.nn.Dense(8, in_units=4)
    jnet.initialize()
    net_a = nn.Dense(8, in_units=4)
    load_reference_params(net_a, _arrays(jnet), ctx=cpu())
    net_b = nn.Dense(8, in_units=4)
    net_b.initialize(ctx=cpu())
    jax_amp.convert_hybrid_block(jnet, "bfloat16")
    amp.convert_hybrid_block(net_a, "bfloat16")
    x = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    xs = torch.from_numpy(x)
    assert net_b(xs).dtype == torch.float32
    got = net_a(xs)
    assert got.dtype == torch.bfloat16
    assert net_b(xs).dtype == torch.float32
    assert not amp.active()
    want = jnet(mx.nd.array(x))
    assert str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_cast_policy_of_the_three_lists():
    """The one helper: LP16 ops to the target, FP32 ops to float32,
    WIDEST ops to float32 only when float32 meets another dtype; integer
    tensors and None pass through; nothing changes while AMP is off."""
    f32 = torch.ones(2)
    b16 = torch.ones(2, dtype=torch.bfloat16)
    ids = torch.ones(2, dtype=torch.int64)
    assert amp.cast("FullyConnected", f32)[0] is f32
    amp.init("bfloat16")
    x, i, none = amp.cast("FullyConnected", f32, ids, None)
    assert x.dtype == torch.bfloat16 and i is ids and none is None
    assert amp.cast("LayerNorm", b16)[0].dtype == torch.float32
    a, b = amp.cast("broadcast_add", b16, f32)
    assert a.dtype == b.dtype == torch.float32
    a, b = amp.cast("broadcast_add", b16, b16)
    assert a is b16 and b is b16
    assert amp.cast("Embedding", f32)[0] is f32
    amp.disable()
    amp.init("float16")
    assert amp.cast("Convolution", f32)[0].dtype == torch.float16
    with pytest.raises(MXNetError, match="target_dtype"):
        amp.init("float64")


def test_layers_cast_by_the_policy_and_gradients_stay_fp32():
    """Conv2D (Convolution, LP16) computes in bf16 and LayerNorm (FP32)
    in float32; the fp32 weights' gradients come back fp32 through the
    casts."""
    amp.init("bfloat16")
    conv = nn.Conv2D(4, 3, in_channels=2)
    conv.initialize(ctx=cpu())
    ln = nn.LayerNorm(in_channels=4)
    ln.initialize(ctx=cpu())
    with autograd.record():
        h = conv(torch.randn(1, 2, 5, 5))
        out = ln(h.permute(0, 2, 3, 1))
    assert h.dtype == torch.bfloat16 and out.dtype == torch.float32
    autograd.backward(out.sum())
    for p in list(conv.collect_params().values()) + \
            list(ln.collect_params().values()):
        assert p._tensor().dtype == p._grad_tensor().dtype == torch.float32
