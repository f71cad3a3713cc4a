"""Deferred shape inference in the port (``mxnet_tpu_torch.gluon``) held
against the JAX package's (``mxnet_tpu/gluon/parameter.py`` :50-125,
``block.py`` :315-350): ``Dense``/``Conv2D``/``Conv2DTranspose``/
``BatchNorm``/``LayerNorm`` built without their input widths settle them
at the first forward, from the same seeded numpy inputs and the JAX
package's weights carried across.  Also the port's own rules: the
``nn.Parameter`` keeps its identity (a ``Trainer`` built before the first
forward steps the resolved tensors, a tied weight resolves once,
``state_dict()`` shows the resolved shapes), one seed gives the same
weights twice, ``load_reference_params`` resolves deferred shapes, and a
block that cannot infer raises.

Tolerance: fp32, ``atol=1e-5`` (one fp32 evaluation each).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.parameter import (DeferredInitializationError,
                                             Parameter)

TOL = dict(atol=1e-5, rtol=1e-5)
_RS = np.random.RandomState(3)


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


# (id, layer builder taking the package's nn, input shape)
LAYERS = [
    ("dense", lambda n: n.Dense(5), (4, 3, 2)),
    ("dense_no_flatten", lambda n: n.Dense(5, flatten=False), (4, 3, 6)),
    ("dense_relu", lambda n: n.Dense(7, activation="relu"), (4, 6)),
    ("conv2d", lambda n: n.Conv2D(6, 3, 1, 1), (2, 3, 7, 7)),
    ("conv2d_groups", lambda n: n.Conv2D(6, 3, 2, 1, groups=2,
                                         use_bias=False), (2, 4, 8, 8)),
    ("conv2d_transpose", lambda n: n.Conv2DTranspose(5, 2, 2, 0),
     (2, 3, 5, 5)),
    ("conv2d_transpose_pad", lambda n: n.Conv2DTranspose(4, 3, 2, 1),
     (2, 3, 5, 5)),
    ("batchnorm", lambda n: n.BatchNorm(), (3, 5, 4, 4)),
    ("layernorm", lambda n: n.LayerNorm(), (3, 7)),
]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,build,shape", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_infers_its_shapes_like_jax(name, build, shape, train):
    x = _RS.randn(*shape).astype(np.float32)
    ref = build(jnn)
    ref.initialize()
    if train:
        with jag.record():
            want = ref(mx.nd.array(x))
    else:
        want = ref(mx.nd.array(x))
    port = build(nn)
    assert not all(p.shape_known() for p in port.collect_params().values())
    port.initialize(ctx=cpu())
    load_reference_params(port, _arrays(ref), ctx=cpu())
    xt = torch.tensor(x)
    if train:
        with autograd.record():
            got = port(xt)
    else:
        got = port(xt)
    for k, p in port.collect_params().items():
        assert p.shape == ref.collect_params()[
            ref.prefix + k[len(port.prefix):]].shape
    np.testing.assert_allclose(got.detach().numpy(), want.asnumpy(), **TOL)


def test_first_forward_settles_and_fills_every_shape():
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, 1, 1), nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2DTranspose(4, 2, 2), nn.Dense(10), nn.LayerNorm())
    net.initialize(ctx=cpu(), seed=1)
    params = list(net.collect_params().values())
    with pytest.raises(DeferredInitializationError):
        params[0]._tensor()
    out = net(torch.randn(2, 3, 6, 6))
    assert out.shape == (2, 10)
    assert [p.shape for p in params] == [
        (8, 3, 3, 3), (8,), (8,), (8,), (8,), (8,), (8, 4, 2, 2), (4,),
        (10, 4 * 12 * 12), (10,), (10,), (10,)]
    assert all(torch.isfinite(p._tensor()).all() for p in params)


def test_trainer_built_before_the_first_forward_steps_resolved_tensors():
    net = nn.HybridSequential()
    net.add(nn.Dense(6, activation="relu"), nn.Dense(3))
    net.initialize(ctx=cpu(), seed=2)
    tensors = [p._data for p in net.collect_params().values()]
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.5, "momentum": 0.9})
    x = torch.randn(4, 5)
    with autograd.record():
        loss = net(x).square().mean()
    autograd.backward(loss)
    before = {k: p._tensor().detach().clone()
              for k, p in net.collect_params().items()}
    trainer.step(1)
    for (k, p), t in zip(net.collect_params().items(), tensors):
        assert p._tensor() is t                     # the same nn.Parameter
        assert any(t is q for q in net.parameters())
        assert not torch.equal(p._tensor(), before[k])
        assert p._tensor().shape == before[k].shape


def test_tied_deferred_weight_resolves_once():
    first = nn.Dense(4, use_bias=False)
    second = nn.Dense(4, use_bias=False, prefix=first.prefix,
                      params=first.params)
    assert second.weight is first.weight
    first.initialize(ctx=cpu(), seed=0)
    x = torch.randn(2, 3)
    first(x)
    w = first.weight._tensor()
    assert tuple(w.shape) == (4, 3)
    second(x)
    assert second.weight._tensor() is w
    np.testing.assert_array_equal(first(x).detach(), second(x).detach())


def test_state_dict_shows_the_resolved_shapes():
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 1), nn.BatchNorm())
    net.initialize(ctx=cpu())
    net(torch.randn(1, 5, 3, 3))
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert (4, 5, 1, 1) in shapes.values()
    assert sorted(shapes.values()).count((4,)) == 5


def test_same_seed_same_weights_and_forward_order_does_not_matter():
    def build():
        a, b = nn.Dense(3), nn.Dense(2, in_units=3)
        net = nn.HybridSequential()
        net.add(a, b)
        return net, a, b

    def weights(net):
        return [p._tensor().detach().clone()
                for p in net.collect_params().values()]

    one, _, _ = build()
    one.initialize(ctx=cpu(), seed=7)
    one(torch.randn(2, 5))
    two, a, b = build()
    two.initialize(ctx=cpu(), seed=7)
    a(torch.randn(3, 5))                     # the deferred layer alone
    for u, v in zip(weights(one), weights(two)):
        assert torch.equal(u, v)
    three, _, _ = build()
    three.initialize(ctx=cpu(), seed=8)
    three(torch.randn(2, 5))
    assert not torch.equal(weights(one)[0], weights(three)[0])


def test_load_reference_params_resolves_deferred_shapes():
    ref = jnn.HybridSequential()
    ref.add(jnn.Conv2D(4, 3), jnn.BatchNorm(), jnn.Dense(3))
    ref.initialize()
    x = _RS.randn(2, 2, 5, 5).astype(np.float32)
    want = ref(mx.nd.array(x)).asnumpy()
    port = nn.HybridSequential()
    port.add(nn.Conv2D(4, 3), nn.BatchNorm(), nn.Dense(3))
    load_reference_params(port, _arrays(ref), ctx=cpu())   # never initialized
    assert all(p.shape_known() for p in port.collect_params().values())
    np.testing.assert_allclose(port(torch.tensor(x)).detach().numpy(), want,
                               **TOL)
    bad = nn.HybridSequential()
    bad.add(nn.Conv2D(5, 3), nn.BatchNorm(), nn.Dense(3))
    with pytest.raises(MXNetError, match="shape"):
        load_reference_params(bad, _arrays(ref), ctx=cpu())


def test_a_block_that_cannot_infer_raises():
    class Scale(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.w = self.params.get("w", shape=(0,),
                                         allow_deferred_init=True)

        def forward(self, x):
            return x * self.w._tensor()

    blk = Scale()
    blk.initialize(ctx=cpu())
    with pytest.raises(MXNetError, match="infer_shape"):
        blk(torch.ones(3))
    with pytest.raises(MXNetError, match="known shape"):
        Parameter("w", shape=(3, 0))
    p = Parameter("w", shape=(3, 0), allow_deferred_init=True)
    p._finish_deferred_init((3, 4))
    with pytest.raises(MXNetError, match="inferred shape"):
        p._finish_deferred_init((3, 5))
