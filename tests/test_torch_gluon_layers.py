"""Gluon's model surface in the port, held against the JAX package on the
CPU with the same numpy inputs and the JAX package's weights carried
across by ``load_reference_params``: ``hybrid_forward`` blocks written
for the JAX package (eager and hybridized), the new ``nn`` layers, the
new ``nn`` and matrix ops, ``CTCLoss``, the new losses, and the
optimizer ops and ``Custom`` that now stand in the registry.

Every case compares the forward output and, under ``autograd.record()``
with a random head gradient, the input gradients (and the layer's
parameter gradients).  Tolerance, fp32: ``atol=1e-5, rtol=1e-5`` (one
evaluation each; orders of summation differ), 2e-5 for the 3-D layers
and CTC (longer sums).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, cpu, load_reference_params, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray.register import get_op, invoke_by_name

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_run(fn, arrays, diff, head_seed):
    xs = [mx.nd.array(a) for a in arrays]
    for i in diff:
        xs[i].attach_grad()
    with mx.autograd.record():
        y = fn(mx, *xs)
    y.backward(mx.nd.array(_rng(head_seed).standard_normal(
        y.shape).astype(np.float32)))
    return y.asnumpy(), [xs[i].grad.asnumpy() for i in diff]


def _port_run(fn, arrays, diff, head_seed):
    with mt.cpu():
        xs = [nd.array(a) for a in arrays]
        for i in diff:
            xs[i].attach_grad()
        with autograd.record():
            y = fn(mt, *xs)
        y.backward(nd.array(_rng(head_seed).standard_normal(
            y.shape).astype(np.float32)))
        return y.asnumpy(), [xs[i].grad.asnumpy() for i in diff]


def _compare(fn, arrays, diff=(0,), tol=TOL, seed=5):
    if diff is None:                  # the JAX op has no gradient
        want = fn(mx, *[mx.nd.array(a) for a in arrays]).asnumpy()
        with mt.cpu():
            got = fn(mt, *[nd.array(a) for a in arrays]).asnumpy()
        np.testing.assert_allclose(got, want, **tol)
        return
    want, want_g = _jax_run(fn, [a.copy() for a in arrays], diff, seed)
    got, got_g = _port_run(fn, arrays, diff, seed)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# the registry repair

def test_every_jax_op_the_port_exposes_is_a_registry_op():
    """Each op name of the JAX package's registry that is an attribute of
    ``mxnet_tpu_torch.nd`` is in the port's registry too: ``list_ops``,
    ``get_op`` and ``mx.sym`` reach it (the nine SGD-family, Adam and
    ``Custom`` frontends were attributes only)."""
    names = [n for n in mx.nd.list_ops() if hasattr(mt.nd, n)]
    ours = set(mt.nd.list_ops())
    missing = [n for n in names if n not in ours]
    assert not missing
    for n in names:
        get_op(n)
        assert hasattr(mt.sym, n), n
    for n in ("sgd_update", "sgd_mom_update", "mp_sgd_update",
              "mp_sgd_mom_update", "multi_sgd_update",
              "multi_sgd_mom_update", "multi_mp_sgd_mom_update",
              "adam_update", "Custom"):
        assert n in ours


def test_registry_sgd_ops_keep_mxnet_semantics():
    """Through the registry the SGD family keeps the ``NDArray`` form: the
    states in place, the new weights returned; ``nd.multi_sgd_mom_update``
    stays the hand-written frontend (one kernel call a group)."""
    rng = _rng(3)
    w, g, m = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    with mt.cpu():
        W, G, M = nd.array(w), nd.array(g), nd.array(m)
        new = invoke_by_name("sgd_mom_update", [W, G, M],
                             {"lr": 0.1, "momentum": 0.9, "wd": 0.01})
        mom = 0.9 * m - 0.1 * (g + 0.01 * w)
        np.testing.assert_allclose(M.asnumpy(), mom, **TOL)
        np.testing.assert_allclose(new.asnumpy(), w + mom, **TOL)
        np.testing.assert_array_equal(W.asnumpy(), w)
        W2, M2 = nd.array(w), nd.array(m)
        outs = invoke_by_name("multi_sgd_mom_update",
                              [W2, G, M2, nd.array([0.1]), nd.array([0.01])],
                              {"momentum": 0.9})
        np.testing.assert_allclose(outs[0].asnumpy(), w + mom, **TOL)
        np.testing.assert_allclose(M2.asnumpy(), mom, **TOL)
    assert nd.multi_sgd_mom_update.__module__.endswith("ops_optimizer")
    assert get_op("preloaded_multi_sgd_update") is \
        get_op("multi_sgd_update")


def test_sym_sgd_update_evaluates_and_custom_exists():
    """``mx.sym.sgd_update`` builds a node that evaluates to the new
    weight; ``mx.sym.Custom`` and the multi ops exist."""
    import mxnet_tpu_torch.symbol as sym
    w, g = sym.var("w"), sym.var("g")
    out = sym.sgd_update(w, g, lr=0.5)
    with mt.cpu():
        res = out.eval(ctx=cpu(), w=nd.array(np.ones(3, np.float32)),
                       g=nd.array(np.ones(3, np.float32)))
    np.testing.assert_allclose(res[0].asnumpy(), np.full(3, 0.5))
    for n in ("Custom", "multi_sgd_mom_update", "adam_update"):
        assert callable(getattr(sym, n))


# ---------------------------------------------------------------------------
# hybrid_forward blocks written for the JAX package


def _scale_blocks(lib):
    class Scale2(lib.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.tanh(x * 2.0) + 0.5

    class Scale3(lib.gluon.HybridBlock):
        """The 'green' weights for the blue/green swap demo."""

        def hybrid_forward(self, F, x):
            return F.tanh(x * 3.0) - 0.25
    return Scale2, Scale3


def _two_tower(lib):
    nn = lib.gluon.nn

    class TwoTower(lib.gluon.HybridBlock):
        def __init__(self, vocab, dim, sparse_grad, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.user = nn.Embedding(vocab, dim, sparse_grad=sparse_grad)
                self.item = nn.Embedding(vocab, dim, sparse_grad=sparse_grad)
                self.user_mlp = nn.Dense(64, activation="relu")
                self.item_mlp = nn.Dense(64, activation="relu")
                self.top = nn.Dense(2)

        def hybrid_forward(self, F, x):
            u = self.user_mlp(F.flatten(
                self.user(F.slice_axis(x, axis=1, begin=0, end=1))))
            i = self.item_mlp(F.flatten(
                self.item(F.slice_axis(x, axis=1, begin=1, end=2))))
            return self.top(F.concat(u, i, dim=1))
    return TwoTower


def _double(lib):
    class Double(lib.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x.astype("float32") * 2
    return Double


def _dense_params(lib):
    class FC(lib.gluon.HybridBlock):
        """Registered parameters reach ``hybrid_forward`` by name."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.weight = self.params.get("weight", shape=(5, 12))
                self.bias = self.params.get("bias", shape=(5,),
                                            init="zeros")

        def hybrid_forward(self, F, x, weight, bias):
            return F.FullyConnected(x.reshape((0, -1)), weight, bias,
                                    num_hidden=5)
    return FC


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


@pytest.mark.parametrize("make,shape,ints", [
    (lambda lib: _scale_blocks(lib)[0](), (3, 4), False),
    (lambda lib: _scale_blocks(lib)[1](), (3, 4), False),
    (lambda lib: _two_tower(lib)(20, 8, False), (6, 2), True),
    (lambda lib: _double(lib)(), (2, 3), True),
    (lambda lib: _dense_params(lib)(), (4, 3, 4), False),
], ids=["serve_http_scale2", "serve_http_scale3", "recommender_two_tower",
        "jax_double", "registered_params"])
def test_hybrid_forward_block_runs_unchanged(make, shape, ints):
    """The JAX package's block bodies, unchanged, eager and hybridized:
    outputs (and gradients where the block has parameters) within 1e-5 of
    the JAX package's; the port's hybridized call bit for bit its eager
    one."""
    rng = _rng(1)
    x = rng.integers(0, 20, shape).astype(np.float32) if ints else \
        rng.standard_normal(shape).astype(np.float32)
    ref = make(mx)
    ref.initialize(mx.init.Xavier())
    want = ref(mx.nd.array(x)).asnumpy()
    port = make(mt)
    with mt.cpu():
        port.initialize(ctx=cpu())
        port(nd.array(x))                    # settles deferred shapes
        load_reference_params(port, _arrays(ref), ctx=cpu())
        eager = port(nd.array(x))
        np.testing.assert_allclose(eager.asnumpy(), want, **TOL)
        assert torch.equal(port(torch.from_numpy(x)), eager._data)
        port.hybridize()
        for _ in range(2):
            assert torch.equal(port(nd.array(x))._data, eager._data)
        if port.collect_params():
            ref_p = list(ref.collect_params().values())
            with mx.autograd.record():
                ref(mx.nd.array(x)).sum().backward()
            with autograd.record():
                port(nd.array(x)).sum().backward()
            for p, q in zip(port.collect_params().values(), ref_p):
                np.testing.assert_allclose(p._grad_tensor().numpy(),
                                           q.grad().asnumpy(), **TOL)


def test_hybrid_forward_sees_views_and_settles_deferred_shapes():
    """The NDArrays a ``hybrid_forward`` receives are views of the
    caller's input and of the parameters' tensors (no copy); a block's own
    deferred parameter settles through its ``infer_shape`` before the
    first call, eager and hybridized alike."""
    seen = {}

    class Deferred(mt.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.weight = self.params.get(
                    "weight", shape=(3, 0), allow_deferred_init=True)

        def infer_shape(self, x, *args):
            self.weight._finish_deferred_init((3, x.shape[-1]))

        def hybrid_forward(self, F, x, weight):
            seen["x"], seen["w"] = x._data, weight._data
            return F.dot(x, weight, transpose_b=True)

    for hybrid in (False, True):
        net = Deferred()
        net.initialize(ctx=cpu())
        if hybrid:
            net.hybridize()
        x = torch.randn(2, 7)
        out = net(x)
        assert out.shape == (2, 3) and net.weight.shape == (3, 7)
        assert seen["x"] is x and seen["w"] is net.weight._tensor()
        torch.testing.assert_close(out, x @ net.weight._tensor().T)


def test_hybrid_forward_records_as_torch_grad_mode_says():
    """On tensors outside ``record()`` the block differentiates as a
    tensor forward would; on NDArrays outside ``record()`` nothing is
    recorded (MXNet's rule)."""
    FC = _dense_params(mt)
    net = FC()
    net.initialize(ctx=cpu())
    x = torch.randn(2, 12, requires_grad=True)
    net(x).sum().backward()
    assert x.grad is not None and net.weight._tensor().grad is not None
    with mt.cpu():
        out = net(nd.array(np.ones((2, 12), np.float32)))
    assert not out._data.requires_grad


# ---------------------------------------------------------------------------
# ops of ndarray/ops_nn.py, ops_matrix.py and ops_ctc.py

_RS = np.random.RandomState(17)
IMG = _RS.randn(2, 4, 6, 5).astype(np.float32)
SEQ = _RS.randn(5, 3, 4).astype(np.float32)          # (T, N, C)
LENS = np.array([5, 2, 3], np.float32)


def _op(name, **kw):
    return lambda lib, *xs: getattr(lib.nd, name)(*xs, **kw)


OP_CASES = [
    ("leaky", _op("LeakyReLU", act_type="leaky", slope=0.1), [IMG], (0,)),
    ("elu", _op("LeakyReLU", act_type="elu", slope=0.7), [IMG], (0,)),
    ("selu", _op("LeakyReLU", act_type="selu"), [IMG], (0,)),
    ("gelu", _op("LeakyReLU", act_type="gelu"), [IMG], (0,)),
    ("prelu", _op("LeakyReLU", act_type="prelu"),
     [IMG, _RS.rand(4).astype(np.float32)], (0, 1)),
    ("deconv2d", _op("Deconvolution", kernel=(3, 3), stride=(2, 2),
                     pad=(1, 1), adj=(1, 1), num_filter=3, no_bias=False),
     [IMG, _RS.randn(4, 3, 3, 3).astype(np.float32),
      _RS.randn(3).astype(np.float32)], (0, 1, 2)),
    ("deconv1d", _op("Deconvolution", kernel=(3,), stride=(2,),
                     num_filter=2),
     [SEQ.transpose(1, 2, 0).copy(), _RS.randn(4, 2, 3).astype(np.float32)],
     (0, 1)),
    ("layernorm_axis1", _op("LayerNorm", axis=1, eps=1e-5),
     [IMG, _RS.rand(4).astype(np.float32), _RS.randn(4).astype(np.float32)],
     (0, 1, 2)),
    ("layernorm_last", _op("LayerNorm"),
     [IMG, _RS.rand(5).astype(np.float32), _RS.randn(5).astype(np.float32)],
     (0, 1, 2)),
    ("groupnorm", _op("GroupNorm", num_groups=2),
     [IMG, _RS.rand(2).astype(np.float32), _RS.randn(2).astype(np.float32)],
     (0, 1, 2)),
    ("lrn", _op("LRN", nsize=3, alpha=1e-2), [IMG], None),
    ("instancenorm", _op("InstanceNorm"),
     [IMG, _RS.rand(4).astype(np.float32), _RS.randn(4).astype(np.float32)],
     (0, 1, 2)),
    ("l2norm_instance", _op("L2Normalization"), [IMG], (0,)),
    ("l2norm_channel", _op("L2Normalization", mode="channel"), [IMG], (0,)),
    ("l2norm_spatial", _op("L2Normalization", mode="spatial"), [IMG], (0,)),
    ("upsampling_nearest", _op("UpSampling", scale=2), [IMG], (0,)),
    ("upsampling_bilinear", _op("UpSampling", scale=2,
                                sample_type="bilinear"), [IMG], (0,)),
    ("bilinear_resize", _op("BilinearResize2D", height=9, width=4),
     [IMG], (0,)),
    ("bilinear_resize_half_pixel", _op("BilinearResize2D", height=12,
                                       width=10, align_corners=False),
     [IMG], (0,)),
    ("convolution_v1", _op("Convolution_v1", kernel=(3, 3), num_filter=2,
                           pad=(1, 1)),
     [IMG, _RS.randn(2, 4, 3, 3).astype(np.float32),
      _RS.randn(2).astype(np.float32)], (0, 1, 2)),
    ("pooling_v1", _op("Pooling_v1", kernel=(3, 3), stride=(2, 2),
                       pool_type="avg", pooling_convention="full"),
     [IMG], (0,)),
    ("pad_constant", _op("pad", mode="constant",
                         pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
                         constant_value=0.5), [IMG], (0,)),
    ("pad_edge", _op("pad", mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 1, 2)),
     [IMG], (0,)),
    ("pad_reflect", _op("pad", mode="reflect",
                        pad_width=(0, 0, 0, 0, 1, 2, 2, 1)), [IMG], (0,)),
    ("sequence_mask_t", _op("SequenceMask", use_sequence_length=True,
                            value=-1.0), [SEQ, LENS], (0,)),
    ("sequence_mask_n", _op("SequenceMask", use_sequence_length=True,
                            axis=1),
     [SEQ.transpose(1, 0, 2).copy(), LENS], (0,)),
    ("sequence_last", _op("SequenceLast", use_sequence_length=True),
     [SEQ, LENS], (0,)),
    ("sequence_last_all", _op("SequenceLast"), [SEQ], (0,)),
    ("sequence_reverse", _op("SequenceReverse", use_sequence_length=True),
     [SEQ, LENS], (0,)),
    ("sequence_reverse_all", _op("SequenceReverse"), [SEQ], (0,)),
]


@pytest.mark.parametrize("name,fn,arrays,diff", OP_CASES,
                         ids=[c[0] for c in OP_CASES])
def test_op_matches_jax(name, fn, arrays, diff):
    _compare(fn, arrays, diff)


def test_moments_and_batchnorm_v1_match_jax():
    for kw in ({"axes": (0, 2, 3)}, {"axes": (1,), "keepdims": True}):
        want = mx.nd.moments(mx.nd.array(IMG), **kw)
        with mt.cpu():
            got = nd.moments(nd.array(IMG), **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)
    gamma, beta = _RS.rand(4).astype(np.float32), \
        _RS.randn(4).astype(np.float32)
    mean, var = np.zeros(4, np.float32), np.ones(4, np.float32)
    want = mx.nd.BatchNorm_v1(*(mx.nd.array(a) for a in (
        IMG, gamma, beta, mean, var)), fix_gamma=False)[0].asnumpy()
    with mt.cpu(), autograd.train_mode():
        got = nd.BatchNorm_v1(*(nd.array(a) for a in (
            IMG, gamma, beta, mean, var)), fix_gamma=False).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rrelu_takes_the_mean_slope_in_predict_mode_and_draws_in_training():
    """``rrelu`` departs from the JAX op (which always takes the mean
    slope) in training mode, as MXNet: each negative unit's slope is drawn
    from U(lower_bound, upper_bound)."""
    want = mx.nd.LeakyReLU(mx.nd.array(IMG), act_type="rrelu").asnumpy()
    with mt.cpu():
        got = nd.LeakyReLU(nd.array(IMG), act_type="rrelu").asnumpy()
        np.testing.assert_allclose(got, want, **TOL)
        with autograd.train_mode():
            drawn = nd.LeakyReLU(nd.array(IMG), act_type="rrelu").asnumpy()
    neg = IMG < 0
    slopes = drawn[neg] / IMG[neg]
    assert slopes.min() >= 0.125 - 1e-6 and slopes.max() <= 0.334 + 1e-6
    assert np.ptp(slopes) > 0.05
    np.testing.assert_array_equal(drawn[~neg], IMG[~neg])


@pytest.mark.parametrize("blank,kw", [
    ("first", {}), ("last", {}),
    ("last", {"use_data_lengths": True, "use_label_lengths": True}),
], ids=["first", "last", "lengths"])
def test_ctc_loss_matches_jax(blank, kw):
    rng = _rng(9)
    data = rng.standard_normal((8, 3, 6)).astype(np.float32)
    if blank == "first":
        label = np.array([[1, 2, 0], [3, 3, 1], [5, 0, 0]], np.float32)
    else:
        label = np.array([[0, 1, -1], [2, 2, 0], [4, -1, -1]], np.float32)
    extra = [np.array([8, 6, 7], np.float32),
             np.array([2, 3, 1], np.float32)] if kw else []
    _compare(lambda lib, *xs: lib.nd.CTCLoss(*xs, blank_label=blank, **kw),
             [data, label] + extra, (0,), tol=dict(atol=2e-5, rtol=2e-5))


# ---------------------------------------------------------------------------
# layers of gluon/nn


def _layer_case(make, arrays, tol=TOL, infer=False):
    """Build the layer in both packages, carry the JAX weights across
    after one JAX forward (deferred shapes), then hold outputs, input
    gradients and parameter gradients."""
    ref = make(mx)
    ref.initialize(mx.init.Xavier())
    if ref.collect_params():
        ref(*[mx.nd.array(a) for a in arrays])
    port = make(mt)
    with mt.cpu():
        port.initialize(ctx=cpu())
        if port.collect_params():
            load_reference_params(port, _arrays(ref), ctx=cpu())
    head = 6

    def fn(lib, *xs):
        net = ref if lib is mx else port
        return net(*xs)
    if infer:
        want = ref(*[mx.nd.array(a) for a in arrays]).asnumpy()
        with mt.cpu():
            got = port(*[nd.array(a) for a in arrays]).asnumpy()
        np.testing.assert_allclose(got, want, **tol)
        return
    want, want_g = _jax_run(fn, [a.copy() for a in arrays], (0,), head)
    got, got_g = _port_run(fn, arrays, (0,), head)
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got_g[0], want_g[0], **tol)
    for p, q in zip(port.collect_params().values(),
                    ref.collect_params().values()):
        if q.grad_req != "null":
            np.testing.assert_allclose(p._grad_tensor().numpy(),
                                       q.grad().asnumpy(), **tol)


def _nn(name, *args, **kw):
    return lambda lib: getattr(lib.gluon.nn, name)(*args, **kw)


def _concurrent(lib):
    net = lib.gluon.nn.HybridConcurrent(axis=1)
    net.add(lib.gluon.nn.Dense(3, in_units=5), lib.gluon.nn.Dense(2,
                                                                  in_units=5))
    return net


def _sequential(lib):
    net = lib.gluon.nn.Sequential()
    net.add(lib.gluon.nn.Dense(3, in_units=5, activation="tanh"),
            lib.gluon.nn.Lambda("sigmoid"))
    return net


VEC = _RS.randn(4, 5).astype(np.float32)
VOL = _RS.randn(2, 3, 5, 6, 4).astype(np.float32)
LINE = _RS.randn(2, 3, 9).astype(np.float32)
IMG7 = _RS.randn(2, 3, 9, 7).astype(np.float32)

LAYER_CASES = [
    ("leaky_relu", _nn("LeakyReLU", 0.1), [IMG]),
    ("prelu", _nn("PReLU"), [IMG]),
    ("elu", _nn("ELU", 0.5), [IMG]),
    ("selu", _nn("SELU"), [IMG]),
    ("gelu", _nn("GELU"), [IMG]),
    ("swish", _nn("Swish", 1.5), [IMG]),
    ("instance_norm", _nn("InstanceNorm", in_channels=4), [IMG]),
    ("group_norm", _nn("GroupNorm", num_groups=2), [IMG]),
    ("layer_norm_axis1", _nn("LayerNorm", axis=1, in_channels=4), [IMG]),
    ("reflection_pad", _nn("ReflectionPad2D", (1, 2, 2, 1)), [IMG]),
    ("identity", _nn("Identity"), [IMG]),
    ("hybrid_concurrent", _concurrent, [VEC]),
    ("sequential_lambda_string", _sequential, [VEC]),
    ("lambda_function", lambda lib: lib.gluon.nn.Lambda(
        lambda x: x * x + 1), [VEC]),
    ("hybrid_lambda_function", lambda lib: lib.gluon.nn.HybridLambda(
        lambda F, x: F.clip(x, a_min=-0.5, a_max=0.7)), [IMG]),
    ("hybrid_lambda_string", _nn("HybridLambda", "tanh"), [IMG]),
    ("conv1d", _nn("Conv1D", 4, 3, strides=2, padding=1, in_channels=3),
     [LINE]),
    ("conv3d", _nn("Conv3D", 2, (3, 2, 3), padding=(1, 0, 1),
                   in_channels=3), [VOL]),
    ("conv1d_transpose", _nn("Conv1DTranspose", 2, 3, strides=2,
                             output_padding=1, in_channels=3), [LINE]),
    ("conv3d_transpose", _nn("Conv3DTranspose", 2, 2, strides=2,
                             in_channels=3), [VOL]),
    ("maxpool1d_ceil", _nn("MaxPool1D", 3, 2, ceil_mode=True), [LINE]),
    ("avgpool1d_exclude_pad", _nn("AvgPool1D", 3, 2, 1,
                                  count_include_pad=False), [LINE]),
    ("maxpool2d_ceil", _nn("MaxPool2D", 3, 2, ceil_mode=True), [IMG7]),
    ("avgpool2d_exclude_pad", _nn("AvgPool2D", 3, 2, 1,
                                  count_include_pad=False), [IMG7]),
    ("avgpool2d_ceil_exclude_pad", _nn("AvgPool2D", 3, 2, 1, ceil_mode=True,
                                       count_include_pad=False), [IMG7]),
    ("maxpool3d", _nn("MaxPool3D", 2), [VOL]),
    ("avgpool3d_ceil", _nn("AvgPool3D", 2, ceil_mode=True), [VOL]),
    ("global_max1d", _nn("GlobalMaxPool1D"), [LINE]),
    ("global_max2d", _nn("GlobalMaxPool2D"), [IMG7]),
    ("global_max3d", _nn("GlobalMaxPool3D"), [VOL]),
    ("global_avg1d", _nn("GlobalAvgPool1D"), [LINE]),
    ("global_avg3d", _nn("GlobalAvgPool3D"), [VOL]),
]


@pytest.mark.parametrize("name,make,arrays", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, make, arrays):
    tol = dict(atol=2e-5, rtol=2e-5) if "3d" in name else TOL
    _layer_case(make, arrays, tol)


def test_dropout_with_axes_shares_its_draw_and_is_identity_in_predict():
    with mt.cpu():
        drop = mt.gluon.nn.Dropout(0.5, axes=(2, 3))
        x = nd.array(np.ones((2, 3, 4, 5), np.float32))
        np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
        with autograd.train_mode():
            y = drop(x).asnumpy()
    assert set(np.unique(y)) <= {0.0, 2.0}
    assert (y == y[:, :, :1, :1]).all()


def test_channels_last_and_sparse_grad_raise():
    with pytest.raises(MXNetError):
        mt.gluon.nn.Conv1D(2, 3, layout="NWC")
    with pytest.raises(MXNetError):
        mt.gluon.nn.MaxPool3D(layout="NDHWC")
    with pytest.raises(MXNetError):
        mt.gluon.nn.Embedding(4, 2, sparse_grad=True)


# ---------------------------------------------------------------------------
# losses

PRED = _RS.randn(4, 6).astype(np.float32)
PROB = _RS.rand(4, 6).astype(np.float32) + 0.1
SIGNS = np.sign(_RS.randn(4, 6)).astype(np.float32)
DIST = (PROB / PROB.sum(axis=1, keepdims=True)).astype(np.float32)
COUNTS = _RS.poisson(2.0, (4, 6)).astype(np.float32)
EMB = _RS.randn(4, 5).astype(np.float32)


def _loss(name, **kw):
    return lambda lib, *xs: getattr(lib.gluon.loss, name)(**kw)(*xs)


LOSS_CASES = [
    ("l1", _loss("L1Loss"), [PRED, PROB], (0,)),
    ("l1_weighted", _loss("L1Loss", weight=0.5),
     [PRED, PROB, _RS.rand(4, 1).astype(np.float32)], (0,)),
    ("kldiv_log", _loss("KLDivLoss"), [np.log(DIST), DIST], (0,)),
    ("kldiv_logits", _loss("KLDivLoss", from_logits=False), [PRED, DIST],
     (0,)),
    ("huber", _loss("HuberLoss", rho=0.7), [PRED, PROB], (0,)),
    ("hinge", _loss("HingeLoss"), [PRED, SIGNS], (0,)),
    ("squared_hinge", _loss("SquaredHingeLoss", margin=1.5),
     [PRED, SIGNS], (0,)),
    ("logistic_signed", _loss("LogisticLoss"), [PRED, SIGNS], (0,)),
    ("logistic_binary", _loss("LogisticLoss", label_format="binary"),
     [PRED, (SIGNS > 0).astype(np.float32)], (0,)),
    ("triplet", _loss("TripletLoss", margin=0.5),
     [PRED, PRED + 0.3 * PROB, PRED - PROB], (0, 1, 2)),
    ("cosine_embedding", _loss("CosineEmbeddingLoss", margin=0.1),
     [EMB, EMB[::-1].copy() + 0.2, np.array([1, -1, 1, -1], np.float32)],
     (0, 1)),
    ("poisson_logits", _loss("PoissonNLLLoss"), [PRED, COUNTS], (0,)),
    ("poisson_full", _loss("PoissonNLLLoss", from_logits=False,
                           compute_full=True), [PROB * 3, COUNTS], (0,)),
    ("sdml", _loss("SDMLLoss"), [EMB, EMB + 0.1 * PRED[:, :5]], (0, 1)),
]


@pytest.mark.parametrize("name,fn,arrays,diff", LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_loss_matches_jax(name, fn, arrays, diff):
    _compare(fn, arrays, diff)


@pytest.mark.parametrize("layout,label_layout,lengths", [
    ("NTC", "NT", False), ("TNC", "TN", False), ("NTC", "NT", True)],
    ids=["ntc", "tnc", "lengths"])
def test_ctc_loss_layer_matches_jax(layout, label_layout, lengths):
    rng = _rng(13)
    pred = rng.standard_normal((3, 7, 5)).astype(np.float32)
    label = np.array([[0, 1, -1], [2, 2, 3], [1, -1, -1]], np.float32)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    extra = [np.array([7, 5, 6], np.float32),
             np.array([2, 3, 1], np.float32)] if lengths else []

    def fn(lib, *xs):
        return lib.gluon.loss.CTCLoss(layout, label_layout)(*xs)
    _compare(fn, [pred, label] + extra, (0,),
             tol=dict(atol=2e-5, rtol=2e-5))
