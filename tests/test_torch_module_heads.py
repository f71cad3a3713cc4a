"""The Module-era loss heads, the ``_contrib_flash_attention`` registry op
and ``mx.sym``'s variables, held against the JAX package's.

- The heads (``softmax_cross_entropy``, the four output layers,
  ``MakeLoss``, ``SoftmaxActivation``): forward and the gradient of the
  data on the CPU within ``TOL``, the output layers' and ``MakeLoss``'s
  gradient the same whatever head gradient is passed (it is ignored);
  config #1's MLP under each output layer through ``Module``
  (``forward_backward`` + ``update``) from one set of weights: outputs,
  gradients and updated weights within ``TOL``.
- ``_contrib_flash_attention``: the registry op (``nd``, with the
  optional ``valid_len`` and ``causal``), forward and gradients, against
  the JAX op in interpret mode; through ``mx.sym`` and ``Module`` in a
  2-layer encoder of ``chip_smoke.sym_encoder`` (width 64, 2 heads).
- The registry's update ops refuse a many-element ``lr`` (the JAX ops
  broadcast one); the ``mx.sym`` calls whose layers own weights create
  the JAX package's variables.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels.flash_attention import \
    flash_attention as flash_kernel

import chip_smoke

TOL = dict(rtol=1e-5, atol=1e-5)


def _f(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _head_cases():
    rs = np.random.default_rng(7)
    lab = rs.integers(0, 5, 4).astype(np.float32)
    return [
        ("softmax_cross_entropy", [_f(rs, 4, 5), lab], {}, False),
        ("LinearRegressionOutput", [_f(rs, 4, 5), _f(rs, 4, 5)],
         {"grad_scale": 2.0}, True),
        ("MAERegressionOutput", [_f(rs, 4, 5), _f(rs, 4, 5)], {}, True),
        ("LogisticRegressionOutput", [_f(rs, 4, 5), _f(rs, 4, 5)],
         {"grad_scale": 0.5}, True),
        ("SVMOutput", [_f(rs, 4, 5), lab], {"margin": 0.5}, True),
        ("SVMOutput", [_f(rs, 4, 5), lab],
         {"use_linear": True, "regularization_coefficient": 0.3}, True),
        ("MakeLoss", [_f(rs, 4, 5)], {"grad_scale": 3.0}, True),
        ("MakeLoss", [_f(rs, 4, 5)], {"normalization": "batch"}, True),
        ("MakeLoss", [_f(rs, 4, 5)],
         {"normalization": "valid", "valid_thresh": 0.2}, True),
        ("SoftmaxActivation", [_f(rs, 2, 3, 4)], {}, False),
        ("SoftmaxActivation", [_f(rs, 2, 3, 4)], {"mode": "channel"},
         False),
    ]


HEAD_CASES = _head_cases()


def _head_run(pkg, name, inputs, kwargs, head_grad):
    arrays = [pkg.nd.array(a.copy()) for a in inputs]
    arrays[0].attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, name)(*arrays, **kwargs)
    out.backward(None if head_grad is None else pkg.nd.array(head_grad))
    return out.asnumpy(), arrays[0].grad.asnumpy()


@pytest.mark.parametrize("name,inputs,kwargs,ignores", HEAD_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(HEAD_CASES)])
def test_head_matches_jax(name, inputs, kwargs, ignores):
    """Forward and the data's gradient as the JAX package's; where the
    op is a fused loss layer the gradient ignores the head gradient."""
    want = _head_run(mx, name, inputs, kwargs, None)
    with mt.cpu():
        got = _head_run(mt, name, inputs, kwargs, None)
        if ignores:
            scaled = _head_run(mt, name, inputs, kwargs,
                               np.full(want[0].shape, 7.0, np.float32))
            np.testing.assert_array_equal(scaled[1], got[1])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_label_takes_no_gradient():
    with mt.cpu():
        x = mt.nd.array(np.ones((2, 3), np.float32))
        t = mt.nd.array(np.zeros((2, 3), np.float32))
        x.attach_grad()
        t.attach_grad()
        with mt.autograd.record():
            y = mt.nd.LinearRegressionOutput(x, t)
        y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), np.ones((2, 3)))
        np.testing.assert_array_equal(t.grad.asnumpy(), np.zeros((2, 3)))


def _module_step(pkg, head, arg, x, y, ctx):
    sym = chip_smoke.sym_mlp(pkg.sym, head)
    mod = pkg.mod.Module(sym, data_names=("data",), label_names=("label",),
                         context=ctx)
    mod.bind(data_shapes=[("data", x.shape)], label_shapes=[("label",
                                                             y.shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v.copy(), ctx=ctx)
                                for k, v in arg.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    mod.forward_backward(pkg.io.DataBatch(
        data=[pkg.nd.array(x.copy(), ctx=ctx)],
        label=[pkg.nd.array(y.copy(), ctx=ctx)]))
    out = mod.get_outputs()[0].asnumpy()
    grads = {k: mod._exec_group.grad_arrays_of(k)[0].asnumpy()
             if pkg is mx else mod._grad_params[k].asnumpy() for k in arg}
    mod.update()
    weights = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return out, grads, weights


@pytest.mark.parametrize("head", chip_smoke.HEAD_OPS)
def test_head_through_module_matches_jax(head):
    """Config #1's MLP under ``head`` through ``Module`` (bind,
    ``forward_backward``, SGD momentum ``update``) in both packages from
    the same weights: outputs, gradients and updated weights."""
    rs = np.random.default_rng(11)
    x, y = chip_smoke.head_data(3, 8, head)
    shapes = {"fc1_weight": (128, 784), "fc1_bias": (128,),
              "fc2_weight": (64, 128), "fc2_bias": (64,),
              "fc3_weight": (10, 64), "fc3_bias": (10,)}
    arg = {k: (0.05 * rs.standard_normal(s)).astype(np.float32)
           for k, s in shapes.items()}
    want = _module_step(mx, head, arg, x, y, mx.cpu())
    got = _module_step(mt, head, arg, x, y, mt.cpu())
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for part in (1, 2):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k], **TOL,
                                       err_msg=k)


def _qkv(rs, bh, lq, lk, d):
    return _f(rs, bh, lq, d), _f(rs, bh, lk, d), _f(rs, bh, lk, d)


@pytest.mark.parametrize("causal,valid", [(False, None), (False, [9, 4]),
                                          (True, [12, 7])])
def test_flash_op_matches_jax(causal, valid):
    """``nd.flash_attention`` (the registry op) and its gradients in q, k
    and v against the JAX op (Pallas interpret mode on the CPU); the CPU
    path counts no kernel launch."""
    rs = np.random.default_rng(5)
    q, k, v = _qkv(rs, 4, 10, 12, 16)
    vl = None if valid is None else np.array(valid, np.float32)
    kw = {"causal": causal, "scale": 0.3}

    def run(pkg):
        arrays = [pkg.nd.array(a.copy()) for a in (q, k, v)]
        for a in arrays:
            a.attach_grad()
        extra = [] if vl is None else [pkg.nd.array(vl.copy())]
        with pkg.autograd.record():
            out = pkg.nd.contrib.flash_attention(*arrays, *extra, **kw) \
                if pkg is mt else pkg.nd._contrib_flash_attention(
                    *arrays, *extra, **kw)
            loss = pkg.nd.sum(out * out)
        loss.backward()
        return [out.asnumpy()] + [a.grad.asnumpy() for a in arrays]

    want = run(mx)
    before = flash_kernel.launches
    with mt.cpu():
        got = run(mt)
    assert flash_kernel.launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


def test_flash_frontend_takes_keywords_and_tensors():
    """``nd.flash_attention`` is the registry op: NDArrays in give an
    NDArray, tensors give a tensor, ``valid_len`` by keyword."""
    rs = np.random.default_rng(6)
    q = _f(rs, 2, 8, 16)
    vl = np.array([8.0, 3.0], np.float32)
    with mt.cpu():
        a = mt.nd.flash_attention(*[mt.nd.array(q)] * 3,
                                  valid_len=mt.nd.array(vl))
        b = mt.nd.flash_attention(*[torch.from_numpy(q)] * 3,
                                  valid_len=torch.from_numpy(vl))
        c = mt.nd.get_op("flash_attention")
    assert isinstance(a, mt.nd.NDArray) and isinstance(b, torch.Tensor)
    assert c.name == "_contrib_flash_attention"
    np.testing.assert_array_equal(a.asnumpy(), b.numpy())


ENC = dict(units=64, heads=2, ffn=128)


def _encoder_step(pkg, arg, arrays, ctx):
    sym = chip_smoke.sym_encoder(pkg.sym, 2, **ENC)
    (x, vl), (y,) = arrays
    mod = pkg.mod.Module(sym, data_names=("data", "valid_len"),
                         label_names=("label",), context=ctx)
    mod.bind(data_shapes=[("data", x.shape), ("valid_len", vl.shape)],
             label_shapes=[("label", y.shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v.copy(), ctx=ctx)
                                for k, v in arg.items()})
    mod.forward_backward(pkg.io.DataBatch(
        data=[pkg.nd.array(x.copy(), ctx=ctx),
              pkg.nd.array(vl.copy(), ctx=ctx)],
        label=[pkg.nd.array(y.copy(), ctx=ctx)]))
    out = mod.get_outputs()[0].asnumpy()
    grads = {k: mod._exec_group.grad_arrays_of(k)[0].asnumpy()
             if pkg is mx else mod._grad_params[k].asnumpy() for k in arg}
    return out, grads


def test_flash_op_gradient_through_sym_and_module_matches_jax():
    """A 2-layer encoder (``chip_smoke.sym_encoder``: flash attention with
    per-sequence lengths, LayerNorm, GELU FFN, the ``MakeLoss`` head)
    bound by ``Module`` in both packages from the same weights: the loss
    and every parameter's gradient."""
    arrays = chip_smoke.encoder_batch(4, 2, 16, ENC["units"])
    sym = chip_smoke.sym_encoder(mt.sym, 2, **ENC)
    shapes = sym.infer_shape(data=(2, 16, 64), valid_len=(2,),
                             label=(2,))[0]
    rs = np.random.default_rng(8)
    arg = {n: (0.1 * rs.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym.list_arguments(), shapes)
           if n not in ("data", "valid_len", "label")}
    want = _encoder_step(mx, arg, arrays, mx.cpu())
    got = _encoder_step(mt, arg, arrays, mt.cpu())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for k in arg:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_update_ops_refuse_a_many_element_lr():
    """The registry's per-tensor updates take ``lr`` as one number (MXNet's
    scalar attribute): a (2, 3) ``lr`` raises ``MXNetError`` where the
    JAX op broadcasts it (a departure), and a one-element array gives the
    JAX op's weights."""
    from mxnet_tpu.ndarray.register import get_op as jax_get_op
    from mxnet_tpu.ndarray.register import invoke as jax_invoke
    from mxnet_tpu_torch.ndarray.register import invoke
    rs = np.random.default_rng(2)
    w, g, m = _f(rs, 2, 3), _f(rs, 2, 3), _f(rs, 2, 3)
    many, one = np.abs(_f(rs, 2, 3)), np.array([0.1], np.float32)
    for name, states in (("sgd_update", []), ("sgd_mom_update", [m]),
                         ("mp_sgd_update", [w]),
                         ("adam_update", [m, np.abs(m)])):
        with mt.cpu(), pytest.raises(MXNetError,
                                     match="lr must be one number"):
            invoke(mt.nd.get_op(name), [mt.nd.array(a.copy()) for a in
                                        [w, g] + states + [many]], {})
    for name, states in (("sgd_update", []), ("sgd_mom_update", [m])):
        with mt.cpu():
            got = invoke(mt.nd.get_op(name), [
                mt.nd.array(a.copy()) for a in [w, g] + states + [one]],
                {"wd": 0.01})
        ref = jax_invoke(jax_get_op(name), [
            mx.nd.array(a.copy()) for a in [w, g] + states + [one]],
            {"wd": 0.01})
        got = got[0] if isinstance(got, (list, tuple)) else got
        ref = ref[0] if isinstance(ref, (list, tuple)) else ref
        np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **TOL)


SYM_CALLS = [
    ("Deconvolution", {"kernel": (3, 3), "num_filter": 4}),
    ("Deconvolution", {"kernel": (3, 3), "num_filter": 4, "no_bias": True}),
    ("InstanceNorm", {}),
    ("LeakyReLU", {"act_type": "prelu"}),
    ("LeakyReLU", {"act_type": "leaky"}),
    ("RNN", {"mode": "lstm", "state_size": 8, "num_layers": 1}),
    ("RNN", {"mode": "gru", "state_size": 8, "num_layers": 1}),
    ("BatchNorm_v1", {}),
]


@pytest.mark.parametrize("op,kw", SYM_CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(SYM_CALLS)])
def test_sym_creates_the_jax_variables(op, kw):
    """``mx.sym.<op>(mx.sym.var("data"), name="n", ...)`` lists the JAX
    package's arguments and auxiliary states."""
    want = getattr(mx.sym, op)(mx.sym.var("data"), name="n", **kw)
    got = getattr(mt.sym, op)(mt.sym.var("data"), name="n", **kw)
    assert got.list_arguments() == want.list_arguments()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()


def test_sym_layers_with_new_variables_bind_from_the_data_shape():
    """The new variables take their shapes from the data's, as in the JAX
    package: a Deconvolution's weight, an RNN's packed parameters and
    states; the graphs bind and run."""
    cases = [("Deconvolution", {"kernel": (3, 3), "num_filter": 4},
              (2, 3, 5, 5)),
             ("RNN", {"mode": "lstm", "state_size": 8, "num_layers": 2},
              (6, 2, 5)),
             ("RNN", {"mode": "gru", "state_size": 8}, (6, 2, 5))]
    for op, kw, shape in cases:
        want = getattr(mx.sym, op)(mx.sym.var("data"), name="n", **kw)
        got = getattr(mt.sym, op)(mt.sym.var("data"), name="n", **kw)
        assert got.infer_shape(data=shape)[0] == \
            want.infer_shape(data=shape)[0], op
        with mt.cpu():
            exe = got.simple_bind(data=shape)
        assert exe.forward()[0].shape[0] > 0


def test_instance_norm_parameters_are_per_channel_unlike_jax():
    """``InstanceNorm``'s gamma and beta take the channel axis (1), as
    MXNet's; the JAX package's shape rule reads the last axis, so its
    graph takes (W,) parameters and fails where W differs from C.  The port's
    binds and computes the JAX op's output from per-channel parameters."""
    shape = (2, 3, 4)
    got = mt.sym.InstanceNorm(mt.sym.var("data"), name="n")
    want = mx.sym.InstanceNorm(mx.sym.var("data"), name="n")
    assert got.infer_shape(data=shape)[0] == [shape, (3,), (3,)]
    with pytest.raises(TypeError):      # (4,) parameters on 3 channels
        want.infer_shape(data=shape)
    rs = np.random.default_rng(4)
    x, gamma, beta = _f(rs, *shape), _f(rs, 3), _f(rs, 3)
    with mt.cpu():
        exe = got.bind(args={"data": mt.nd.array(x),
                             "n_gamma": mt.nd.array(gamma),
                             "n_beta": mt.nd.array(beta)})
        out = exe.forward()[0].asnumpy()
    ref = mx.nd.InstanceNorm(mx.nd.array(x), mx.nd.array(gamma),
                             mx.nd.array(beta)).asnumpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_sym_num_outputs_of_topk_both_and_amp_multicast():
    x = mt.sym.var("x")
    assert len(mt.sym.topk(x, k=2, ret_typ="both")) == 2
    assert len(mt.sym.topk(x, k=2)) == 1
    assert len(mt.sym.amp_multicast(x, mt.sym.var("y"), mt.sym.var("z"),
                                    num_outputs=3)) == 3
    assert len(mx.sym.topk(mx.sym.var("x"), k=2, ret_typ="both")) == 2
