"""int8 quantization of the port held against the JAX package on the CPU:
the seven ``_contrib_quantize*``/``quantized_*`` ops
(``mxnet_tpu/ndarray/ops_quantization.py``) and ``quantize_net`` with its
calibration (``mxnet_tpu/contrib/quantization.py``).

The int8 outputs and int32 accumulators must equal the JAX package's bit
for bit, including a product of K = 4608 (ResNet-50's widest 3x3
convolution) whose sums pass 2**24, past what a float32 sum keeps
exact; the ranges and dequantized values within an fp32 ulp.
``quantize_net`` picks the JAX package's thresholds (``minmax`` and
``entropy``) on a small CNN with a Dense head, and the quantized net's
outputs agree.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch.contrib import quantization as tq

MN, MX = np.array(-2.5, np.float32), np.array(2.5, np.float32)


def _both(name, arrays, **kw):
    want = getattr(mx.nd.contrib, name)(
        *[mx.nd.array(a, dtype=a.dtype) for a in arrays], **kw)
    with mt.cpu():
        got = getattr(mt.nd.contrib, name)(
            *[mt.nd.array(a, dtype=a.dtype) for a in arrays], **kw)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for a, b in zip(want, got):
        a, b = a.asnumpy(), b.asnumpy()
        assert b.dtype == a.dtype and b.shape == a.shape
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a)        # bit for bit
        else:
            np.testing.assert_allclose(b, a, rtol=1e-7, atol=0)
    return [g.asnumpy() for g in got]


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def test_quantize_rounds_half_to_even_as_the_jax_package():
    """Values on the half steps of a range of 127 (ties) round to even."""
    x = (np.arange(-20, 21, dtype=np.float32) + 0.5)
    rng = np.array(127.0, np.float32)
    q = _both("quantize", [x, -rng, rng])[0]
    np.testing.assert_array_equal(q, np.round(x).astype(np.int8))
    _both("quantize", [np.random.default_rng(0).standard_normal(
        (4, 8, 6, 6)).astype(np.float32), MN, MX])


@pytest.mark.parametrize("calib", [None, (-1.5, 1.5)])
def test_quantize_v2_matches(calib):
    x = np.random.default_rng(1).standard_normal((4, 8, 6, 6)) \
        .astype(np.float32)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    _both("quantize_v2", [x], **kw)


@pytest.mark.parametrize("k", [16, 2048, 4608])
@pytest.mark.parametrize("bias", [False, True])
def test_quantized_fully_connected_accumulates_bit_for_bit(k, bias):
    rng = np.random.default_rng(k)
    x, w = _int8(rng, (5, k)), _int8(rng, (24, k))
    x[0], w[0] = 127, 127                         # sum 127² · k, past 2**24
    if not bias:
        out = _both("quantized_fully_connected", [x, w, MN, MX, MN, MX],
                    num_hidden=24, no_bias=True)
    else:
        b = _int8(rng, (24,))
        out = _both("quantized_fully_connected",
                    [x, w, b, MN, MX, MN, MX, MN, MX], num_hidden=24,
                    no_bias=False)
    if k >= 2048:
        assert abs(int(out[0][0, 0])) > 2 ** 24


@pytest.mark.parametrize("shape,kernel,stride,pad,groups", [
    ((2, 512, 5, 5), (3, 3), (1, 1), (1, 1), 1),     # K = 4608
    ((2, 3, 11, 11), (7, 7), (2, 2), (3, 3), 1),     # ResNet's conv1
    ((2, 8, 6, 6), (3, 3), (1, 1), (0, 0), 2)])
def test_quantized_conv_accumulates_bit_for_bit(shape, kernel, stride, pad,
                                                groups):
    rng = np.random.default_rng(shape[1])
    x = _int8(rng, shape)
    w = _int8(rng, (8, shape[1] // groups) + kernel)
    x[:], w[0] = 127, 127
    out = _both("quantized_conv", [x, w, MN, MX, MN, MX], kernel=kernel,
                stride=stride, pad=pad, num_filter=8, num_group=groups,
                no_bias=True)
    if shape[1] == 512:
        assert int(out[0].max()) > 2 ** 24
    b = _int8(rng, (8,))
    _both("quantized_conv", [x, w, b, MN, MX, MN, MX, MN, MX],
          kernel=kernel, stride=stride, pad=pad, num_filter=8,
          num_group=groups, no_bias=False)


def test_dequantize_and_requantize_match():
    rng = np.random.default_rng(2)
    acc = rng.integers(-2 ** 28, 2 ** 28, (4, 16)).astype(np.int32)
    _both("dequantize", [acc, MN, MX])
    _both("dequantize", [_int8(rng, (4, 16)), MN, MX])
    _both("requantize", [acc, MN, MX])
    _both("requantize", [acc, MN, MX], min_calib_range=-0.5,
          max_calib_range=0.5)


@pytest.mark.parametrize("pool_type,kernel,stride,pad", [
    ("max", (2, 2), None, (0, 0)), ("max", (3, 3), (2, 2), (1, 1)),
    ("avg", (3, 3), (2, 2), (1, 1)), ("avg", (2, 2), None, (0, 0))])
def test_quantized_pooling_matches(pool_type, kernel, stride, pad):
    x = _int8(np.random.default_rng(3), (2, 6, 7, 7))
    kw = dict(kernel=kernel, pad=pad, pool_type=pool_type)
    if stride:
        kw["stride"] = stride
    _both("quantized_pooling", [x, MN, MX], **kw)


def test_only_int8_is_supported():
    with mt.cpu(), pytest.raises(mt.MXNetError):
        mt.nd.contrib.quantize(mt.nd.ones((2,)), mt.nd.array([-1.0]),
                               mt.nd.array([1.0]), out_type="uint8")


def _net(lib):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix="qnet_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.Conv2D(16, 3, strides=2, in_channels=8, use_bias=False),
                nn.Flatten(), nn.Dense(10, in_units=144, activation="relu"))
    return net


def _calib():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module", params=["minmax", "entropy"])
def quantized(request):
    mode = request.param
    ref = _net(mx)
    ref.initialize(mx.init.Xavier())
    init = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    batches = _calib()
    jq.quantize_net(ref, calib_data=[mx.nd.array(b) for b in batches],
                    calib_mode=mode)
    layers = list(ref._children.values())
    return dict(mode=mode, init=init, calib=[getattr(b, "_calib", None)
                                             for b in layers],
                kinds=[type(b).__name__ for b in layers],
                out=ref(mx.nd.array(batches[0])).asnumpy())


def _port_quantized(ref):
    net = _net(mt)
    mt.load_reference_params(net, ref["init"], ctx=mt.cpu())
    with mt.cpu():
        tq.quantize_net(net, calib_data=[mt.nd.array(b) for b in _calib()],
                        calib_mode=ref["mode"])
    return net


def test_quantize_net_swaps_the_layers_and_picks_the_jax_thresholds(
        quantized):
    net = _port_quantized(quantized)
    layers = list(net._modules.values())
    assert [type(b).__name__ for b in layers] == quantized["kinds"]
    assert quantized["kinds"].count("QuantizedConv2D") == 2
    for ours, theirs in zip([getattr(b, "_calib", None) for b in layers],
                            quantized["calib"]):
        if theirs is None:
            assert ours is None
            continue
        # the first layer sees the same input: the same threshold; later
        # layers' inputs differ from the JAX package's by fp32 rounding
        np.testing.assert_allclose(ours, theirs, rtol=1e-6)
    assert tuple(layers[0]._calib) == tuple(quantized["calib"][0])


def test_quantized_net_outputs_match(quantized):
    net = _port_quantized(quantized)
    with mt.cpu():
        out = net(mt.nd.array(_calib()[0])).asnumpy()
    np.testing.assert_allclose(out, quantized["out"], rtol=1e-5, atol=1e-5)


def test_quantized_layer_accumulator_is_the_ops_accumulator():
    """``accumulate`` gives the int32 sums ``forward`` dequantizes: the
    JAX package's quantized op's, bit for bit, on the block's own int8
    input and ranges."""
    net = _net(mt)
    net.initialize(ctx=mt.cpu(), seed=0)
    with mt.cpu():
        tq.quantize_net(net, calib_data=[mt.nd.array(b) for b in _calib()])
    conv = net._modules["0"]
    x = mt.nd.array(_calib()[1], ctx=mt.cpu())._data
    acc, ins = conv.accumulate(x)
    want = mx.nd.contrib.quantized_conv(
        *[mx.nd.array(t.numpy(), dtype=t.numpy().dtype) for t in ins],
        kernel=(3, 3), pad=(1, 1), num_filter=8, no_bias=True)[0]
    np.testing.assert_array_equal(acc.numpy(), want.asnumpy())
    assert ins[0].dtype == ins[1].dtype == torch.int8


def test_entropy_threshold_is_the_jax_packages():
    hist = np.random.default_rng(6).integers(0, 1000, 8001)
    hist[4000:] //= 50
    assert tq._entropy_threshold(hist, 0.01) == \
        jq._entropy_threshold(hist, 0.01)


def test_quantize_net_refuses_an_unknown_mode():
    with pytest.raises(mt.MXNetError):
        tq.quantize_net(_net(mt), calib_mode="kl")


def test_forward_hook_gets_ndarrays_and_is_removed():
    net = _net(mt)
    net.initialize(ctx=mt.cpu(), seed=0)
    seen = []
    handle = net._modules["5"].register_forward_hook(
        lambda blk, args, out: seen.append((type(args[0]).__name__,
                                            type(out).__name__)))
    with mt.cpu():
        net(mt.nd.array(_calib()[0]))
        handle.remove()
        net(mt.nd.array(_calib()[0]))
    assert seen == [("NDArray", "NDArray")]
