"""The vision model zoo in the port, held against the JAX package's on the
CPU: all 34 constructors by name through ``get_model`` with the JAX
package's parameter names and shapes, each family's distinctive block at
a narrow width (forward and gradients in training mode, the JAX
package's weights carried across by ``load_reference_params``), and one
whole-net forward per family in predict mode at the smallest input it
accepts (here ResNet v2; the other families in
``tests/test_torch_vision_zoo_{nets,densenet,inception}.py``).

Tolerance: a block's output and input gradient 1e-4 (``atol`` and
``rtol``; BatchNorm in training mode, whose statistics the JAX package
takes as E[x^2] - E[x]^2 in fp32, ``ROADMAP.md``'s parity gotcha); a
whole net's logits 1e-4 (tens of layers of fp32).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu_torch import autograd, cpu, load_reference_params, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = sorted(jax_vision._models)


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def test_the_34_constructors_and_get_model():
    assert NAMES == sorted(vision._models) and len(NAMES) == 34
    assert mt.gluon.model_zoo.get_model is vision.get_model
    with pytest.raises(MXNetError):
        vision.get_model("resnet9_v1")
    for name in ("resnet18_v1", "alexnet", "densenet121", "inception_v3"):
        with pytest.raises(MXNetError):
            vision.get_model(name, pretrained=True)
    net = vision.get_model("squeezenet1_1", classes=7, ctx=cpu())
    assert all(p._initialized for p in net.collect_params().values()
               if p.shape_known())


@pytest.mark.parametrize("name", NAMES)
def test_constructor_names_and_shapes_match_jax(name):
    """The JAX package's names, in its order, and its shapes (a JAX
    dimension of 0 waits for the first input)."""
    ref = jax_vision.get_model(name, classes=10)
    port = vision.get_model(name.upper(), classes=10)
    theirs = [(k[len(ref.prefix):], tuple(p.shape))
              for k, p in ref.collect_params().items()]
    ours = [(k[len(port.prefix):], tuple(p.shape))
            for k, p in port.collect_params().items()]
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (k, a), (_, b) in zip(ours, theirs):
        assert len(a) == len(b), k
        assert all(j in (0, i) for i, j in zip(a, b)), (k, a, b)


# ---------------------------------------------------------------------------
# each family's distinctive block


def _resnet(lib, kind):
    r = (jax_vision if lib is mx else vision).resnet
    if kind == "bottleneck":
        return r.BottleneckV2(16, 2, True, in_channels=8)
    return r.BasicBlockV2(8, 1, False, in_channels=8)


def _fire(lib):
    return (jax_vision if lib is mx else vision).squeezenet._make_fire(
        4, 6, 6)


def _dense(lib):
    zoo = (jax_vision if lib is mx else vision).densenet
    net = lib.gluon.nn.HybridSequential()
    net.add(zoo._make_dense_block(2, 2, 4, 0, 1), zoo._make_transition(6))
    return net


def _mobile(lib, stride):
    return (jax_vision if lib is mx else vision).mobilenet.LinearBottleneck(
        8, 8 if stride == 1 else 12, 2, stride)


def _inception(lib, kind):
    inc = (jax_vision if lib is mx else vision).inception
    return {"A": lambda: inc._make_A(8, "A_"),
            "B": lambda: inc._make_B("B_"),
            "C": lambda: inc._make_C(8, "C_"),
            "D": lambda: inc._make_D("D_"),
            "E": lambda: inc._InceptionE(prefix="E_")}[kind]()


BLOCKS = [
    ("resnet_bottleneck_v2", lambda lib: _resnet(lib, "bottleneck"), 8, 8),
    ("resnet_basic_v2", lambda lib: _resnet(lib, "basic"), 8, 8),
    ("squeezenet_fire", _fire, 8, 7),
    ("densenet_block_transition", _dense, 4, 8),
    ("mobilenet_v2_shortcut", lambda lib: _mobile(lib, 1), 8, 6),
    ("mobilenet_v2_stride", lambda lib: _mobile(lib, 2), 8, 6),
]
# Inception's A-E blocks (widths of 64-448 fixed by the architecture)
# cost the JAX package ~55 s to compile: tests/test_torch_vision_zoo_blocks.py
INCEPTION_BLOCKS = [
    ("inception_a", lambda lib: _inception(lib, "A"), 8, 5),
    ("inception_b", lambda lib: _inception(lib, "B"), 8, 7),
    ("inception_c", lambda lib: _inception(lib, "C"), 8, 5),
    ("inception_d", lambda lib: _inception(lib, "D"), 8, 7),
    ("inception_e", lambda lib: _inception(lib, "E"), 8, 4),
]


@pytest.mark.parametrize("name,make,channels,size", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(name, make, channels, size):
    block_case(make, channels, size)


def block_case(make, channels, size):
    """Training mode (BatchNorm on the batch's statistics): the output and
    the input gradient against the JAX package's, on its weights."""
    x = np.random.default_rng(2).standard_normal(
        (2, channels, size, size)).astype(np.float32)
    head = np.random.default_rng(3)
    ref = make(mx)
    ref.initialize(mx.init.Xavier())
    with mx.autograd.predict_mode():
        ref(mx.nd.array(x))                      # deferred shapes
    port = make(mt)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    xr = mx.nd.array(x)
    xr.attach_grad()
    with mx.autograd.record():
        want = ref(xr)
    g = head.standard_normal(want.shape).astype(np.float32)
    want.backward(mx.nd.array(g))
    with mt.cpu():
        xp = nd.array(x)
        xp.attach_grad()
        with autograd.record():
            got = port(xp)
        got.backward(nd.array(g))
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
        np.testing.assert_allclose(xp.grad.asnumpy(), xr.grad.asnumpy(),
                                   **TOL)


# ---------------------------------------------------------------------------
# one whole net per family

def whole_net_forward(name, size):
    """Predict mode at the smallest input the family takes, 10 classes:
    the port's logits against the JAX package's on its weights."""
    x = np.random.default_rng(4).standard_normal(
        (1, 3, size, size)).astype(np.float32)
    ref = jax_vision.get_model(name, classes=10)
    ref.initialize(mx.init.Xavier())
    want = ref(mx.nd.array(x)).asnumpy()
    port = vision.get_model(name, classes=10)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    with mt.cpu():
        got = port(nd.array(x)).asnumpy()
    assert got.shape == want.shape == (1, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_whole_resnet_v2_forward_matches_jax():
    """The JAX package takes 10-45 s a net here (an op compiled at a time),
    so the families' whole nets are spread over
    ``tests/test_torch_vision_zoo_{nets,densenet,inception}.py``."""
    whole_net_forward("resnet18_v2", 32)
