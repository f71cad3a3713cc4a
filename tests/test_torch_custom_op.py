"""The port's custom operators, ``autograd.Function``, Adam and
``metric.Accuracy`` held against the JAX package on the CPU, with the
same numpy inputs; and the slice as a whole: an MLP trained by
``gluon.Trainer("adam")`` with the ``softmax_rtc`` custom op of
``chip_smoke.py`` as its output layer (on the CPU the op takes its plain
versions).

Tolerances, fp32 throughout: one op or one update 1e-6 (the same
operations, rounding alike or within an ulp); the three-step slice test:
losses 1e-6 (the heads compute the same softmax, differing by an ulp),
weights 1e-5 (three Adam steps grow an ulp-sized gradient difference into
a few ulps of each weight's change; steps are ~lr = 1e-2 in size).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params
from mxnet_tpu_torch.base import MXNetError

import chip_smoke


def _register_both(name, make_prop):
    """Register one prop, written once against each package's API."""
    mx.operator.register(name)(make_prop(mx))
    mt.operator.register(name)(make_prop(mt))


def _scaled_square(lib):
    class Prop(lib.operator.CustomOpProp):
        def __init__(self, scale=2.0):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            scale = self.scale

            class Op(lib.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[0] * scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * 2.0 * scale * in_data[0])
            return Op()
    return Prop


def _jax_run(op_type, x_np, head=None, **kw):
    x = mx.nd.array(x_np)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type=op_type, **kw)
    y.backward(None if head is None else mx.nd.array(head))
    return y.asnumpy(), x.grad.asnumpy()


def _port_run(op_type, x_np, head=None, **kw):
    x = torch.tensor(x_np, requires_grad=True)
    with autograd.record():
        y = mt.nd.Custom(x, op_type=op_type, **kw)
    autograd.backward(y, None if head is None else torch.tensor(head))
    return y.detach().numpy(), x.grad.numpy()


def test_scaled_square_matches_jax():
    """tests/test_aux.py's scaled_square through both packages'
    nd.Custom."""
    _register_both("parity_scaled_square", _scaled_square)
    assert "parity_scaled_square" in mt.operator.get_all_registered()
    assert mt.operator.Custom is mt.nd.Custom
    x = np.random.default_rng(0).standard_normal(7).astype(np.float32)
    head = np.random.default_rng(1).standard_normal(7).astype(np.float32)
    for h in (None, head):
        jy, jg = _jax_run("parity_scaled_square", x, h, scale=3.0)
        py, pg = _port_run("parity_scaled_square", x, h, scale=3.0)
        np.testing.assert_allclose(py, jy, atol=1e-6)
        np.testing.assert_allclose(pg, jg, atol=1e-6)


def _const_source(lib):
    class Prop(lib.operator.CustomOpProp):
        def list_arguments(self):
            return []

        def infer_shape(self, in_shape):
            return [], [[2, 2]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(lib.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                np.full((2, 2), 7.0, np.float32))
            return Op()
    return Prop


def test_zero_input_source_op_is_float32():
    """test_aux.py's const_source: infer_type finds no input (IndexError),
    so the output is float32."""
    _register_both("parity_const_source", _const_source)
    from mxnet_tpu.ndarray.register import invoke_by_name
    ref = invoke_by_name("Custom", [], {"op_type": "parity_const_source"})
    out = mt.nd.Custom(op_type="parity_const_source", ctx=cpu())
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(out.numpy(), ref.asnumpy())


def _two_out(lib):
    class Prop(lib.operator.CustomOpProp):
        def list_outputs(self):
            return ["square", "triple"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(lib.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]
                    self.assign(out_data[0], req[0], x * x)
                    self.assign(out_data[1], req[1], x * 3.0)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * 2.0 * in_data[0]
                                + out_grad[1] * 3.0)
            return Op()
    return Prop


def test_two_output_op_matches_jax():
    """Two outputs come back as a tuple; an output no head reached gets a
    zero gradient."""
    _register_both("parity_two_out", _two_out)
    x_np = np.random.default_rng(2).standard_normal(5).astype(np.float32)
    x = mx.nd.array(x_np)
    x.attach_grad()
    with mx.autograd.record():
        a, b = mx.nd.Custom(x, op_type="parity_two_out")
        loss = mx.nd.sum(a) + 2.0 * mx.nd.sum(b)
    loss.backward()
    xt = torch.tensor(x_np, requires_grad=True)
    with autograd.record():
        pa, pb = mt.nd.Custom(xt, op_type="parity_two_out")
        ploss = pa.sum() + 2.0 * pb.sum()
    autograd.backward(ploss)
    np.testing.assert_allclose(pa.detach().numpy(), a.asnumpy(), atol=1e-6)
    np.testing.assert_allclose(pb.detach().numpy(), b.asnumpy(), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), x.grad.asnumpy(), atol=1e-6)
    xt.grad = None
    with autograd.record():
        pa, _ = mt.nd.Custom(xt, op_type="parity_two_out")
    autograd.backward(pa)                  # the second output unreached
    np.testing.assert_allclose(xt.grad.numpy(), 2.0 * x_np, atol=1e-6)


def _stateful(lib):
    class Prop(lib.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(lib.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.mask = in_data[0] > 0       # read in backward
                    self.assign(out_data[0], req[0], in_data[0] * self.mask)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * self.mask)
            return Op()
    return Prop


def test_state_from_forward_reaches_backward():
    """One operator instance per call, shared by forward and backward."""
    _register_both("parity_stateful_relu", _stateful)
    x = np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32)
    jy, jg = _jax_run("parity_stateful_relu", x)
    py, pg = _port_run("parity_stateful_relu", x)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(pg, jg)
    np.testing.assert_array_equal(pg, [0, 0, 0, 1, 1])


def _no_top_grad(lib):
    class Prop(lib.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(lib.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * 5.0)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    # a loss layer: the head gradient is not read
                    self.assign(in_grad[0], req[0], in_data[0] - 1.0)
            return Op()
    return Prop


def test_need_top_grad_false_ignores_the_head_gradient():
    _register_both("parity_no_top_grad", _no_top_grad)
    assert not mt.operator._registry["parity_no_top_grad"]().need_top_grad_
    x = np.random.default_rng(3).standard_normal(4).astype(np.float32)
    for head in (None, np.full(4, 9.0, np.float32)):
        jy, jg = _jax_run("parity_no_top_grad", x, head)
        py, pg = _port_run("parity_no_top_grad", x, head)
        np.testing.assert_allclose(py, jy, atol=1e-6)
        np.testing.assert_allclose(pg, jg, atol=1e-6)
        np.testing.assert_allclose(pg, x - 1.0, atol=1e-6)


def _add_req(lib):
    class Prop(lib.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class Op(lib.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], "add", in_data[0])
                    self.assign(out_data[0], "add", in_data[0])
                    self.assign(out_data[0], "null", in_data[0] * 100.0)
            return Op()
    return Prop


def test_assign_add_and_null_match_jax():
    """``assign`` with req "add" accumulates into the zeroed output, and
    "null" leaves it; an unknown req raises in the port."""
    _register_both("parity_add_req", _add_req)
    x = np.random.default_rng(4).standard_normal(6).astype(np.float32)
    ref = mx.nd.Custom(mx.nd.array(x), op_type="parity_add_req").asnumpy()
    out = mt.nd.Custom(torch.tensor(x), op_type="parity_add_req")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), 2 * x, atol=1e-6)
    with pytest.raises(MXNetError):
        mt.operator.CustomOp().assign(out, "overwrite", out)


def test_is_train_follows_the_recording_scope():
    """``is_train`` is ``autograd.is_training()`` at the call, as MXNet
    passes it (inside ``record()`` True, under ``record(train_mode=False)``
    and outside False).  The JAX package's eager ``nd.Custom`` runs the
    callback under its ``pause()`` and passes False in all three."""
    seen = []

    class Op(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append(is_train)
            self.assign(out_data[0], req[0], in_data[0])

    @mt.operator.register("port_train_flag")
    class Prop(mt.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Op()

    x = torch.ones(3)
    mt.nd.Custom(x, op_type="port_train_flag")
    with autograd.record():
        mt.nd.Custom(x, op_type="port_train_flag")
    with autograd.record(train_mode=False):
        mt.nd.Custom(x, op_type="port_train_flag")
    assert seen == [False, True, False]


def test_infer_type_sets_the_output_dtype():
    """``nd.Custom``'s semantics: the dtypes ``infer_type`` returns."""
    class Op(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)
            self.assign(out_data[1], req[1], in_data[0] > 0)

    @mt.operator.register("port_typed")
    class Prop(mt.operator.CustomOpProp):
        def list_outputs(self):
            return ["double", "positive"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def infer_type(self, in_type):
            return in_type, [np.float64, "int32"], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Op()

    x = torch.tensor([-1.5, 2.0])
    a, b = mt.nd.Custom(x, op_type="port_typed")
    assert a.dtype == torch.float64 and b.dtype == torch.int32
    assert a.tolist() == [-3.0, 4.0] and b.tolist() == [0, 1]
    with pytest.raises(MXNetError):
        mt.nd.Custom(x, op_type="no_such_op")


def test_custom_function_matches_jax():
    """tests/test_autograd.py's Square, and an integer input that takes no
    gradient."""
    class JSquare(mx.autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 2 * x * dy

    class Square(autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 2 * x * dy

    x_np = np.array([4.0, -1.5, 0.25], np.float32)
    jx = mx.nd.array(x_np)
    jx.attach_grad()
    with mx.autograd.record():
        jy = JSquare()(jx)
    jy.backward()
    px = torch.tensor(x_np, requires_grad=True)
    with autograd.record():
        py = Square()(px)
    autograd.backward(py)
    np.testing.assert_allclose(py.detach().numpy(), jy.asnumpy(), atol=1e-6)
    np.testing.assert_allclose(px.grad.numpy(), jx.grad.asnumpy(), atol=1e-6)

    class Pick(autograd.Function):
        def forward(self, x, idx):
            self.save_for_backward(idx)
            self.n = x.shape[0]
            return x[idx.long()]

        def backward(self, dy):
            (idx,) = self.saved_tensors
            return torch.zeros(self.n).index_add_(0, idx.long(), dy), None

    px.grad = None
    with autograd.record():
        out = Pick()(px, torch.tensor([2, 2, 0], dtype=torch.int32))
    autograd.backward(out)
    np.testing.assert_allclose(px.grad.numpy(), [1.0, 0.0, 2.0])


def test_creation_functions():
    """The constructors make NDArrays (MXNet's surface) over tensors of
    MXNet's default dtypes."""
    a = mt.nd.array([[1, 2], [3, 4]], ctx=cpu())
    assert isinstance(a, mt.nd.NDArray)
    assert a._data.dtype == torch.float32 and a.context == cpu()
    assert a.dtype == np.float32 and a._data.device.type == "cpu"
    assert mt.nd.array(np.arange(3), ctx=cpu())._data.dtype == torch.int64
    assert mt.nd.array(np.ones(2), ctx=cpu())._data.dtype == torch.float32
    assert mt.nd.array(np.ones(2), ctx=cpu(), dtype="int32")._data.dtype \
        == torch.int32
    src = torch.arange(3, dtype=torch.int32)
    copy = mt.nd.array(src, ctx=cpu())
    assert copy._data.dtype == torch.int32 and \
        copy._data.data_ptr() != src.data_ptr()
    for fn, fill in ((mt.nd.zeros, 0.0), (mt.nd.ones, 1.0)):
        t = fn((2, 3), ctx=cpu())
        assert t._data.dtype == torch.float32 and \
            t.asnumpy().tolist() == [[fill] * 3] * 2
    assert mt.nd.full(4, 2.5, ctx=cpu(), dtype="float64").asnumpy() \
        .tolist() == [2.5] * 4
    assert mt.nd.empty((5,), ctx=cpu()).shape == (5,)


# ------------------------------------------------------------- Adam, metric

def _adam_state(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) * 3
             for _ in range(3)]
    return w, grads


KW = {"wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.8}


def test_adam_update_op_matches_jax():
    w, grads = _adam_state(5)
    jw, jm, jv = mx.nd.array(w), mx.nd.zeros(w.shape), mx.nd.zeros(w.shape)
    pw, pm, pv = torch.tensor(w), torch.zeros(w.shape), torch.zeros(w.shape)
    for g in grads:
        mx.nd.adam_update(jw, mx.nd.array(g), jm, jv,
                          mx.nd.array(np.float32(0.05)), beta1=0.8,
                          beta2=0.99, epsilon=1e-6, out=[jw, jm, jv], **KW)
        mt.nd.adam_update(pw, torch.tensor(g), pm, pv, 0.05, beta1=0.8,
                          beta2=0.99, epsilon=1e-6, **KW)
    for p, j in ((pw, jw), (pm, jm), (pv, jv)):
        np.testing.assert_allclose(p.numpy(), j.asnumpy(), atol=1e-6)


def test_adam_optimizer_matches_jax():
    """Three steps with MXNet's bias-corrected rate, per-index counts."""
    w, grads = _adam_state(6)
    jopt = mx.optimizer.create("adam", learning_rate=0.02, **KW)
    popt = mt.optimizer.create("adam", learning_rate=0.02, **KW)
    jw, pw = mx.nd.array(w), torch.tensor(w)
    js, ps = jopt.create_state(0, jw), popt.create_state(0, pw)
    for g in grads:
        jopt.update(0, jw, mx.nd.array(g), js)
        popt.update(0, pw, torch.tensor(g), ps)
    np.testing.assert_allclose(pw.numpy(), jw.asnumpy(), atol=1e-6)
    for p, j in zip(ps, js):
        np.testing.assert_allclose(p.numpy(), j.asnumpy(), atol=1e-6)
    assert popt.num_update == jopt.num_update == 3
    with pytest.raises(MXNetError):
        popt.update(0, pw, torch.tensor(grads[0]).to_sparse(), ps)


def test_adam_multi_precision_updates_the_fp32_master():
    w, grads = _adam_state(7)
    mp = mt.optimizer.create("adam", learning_rate=0.02,
                             multi_precision=True)
    ref = mt.optimizer.create("adam", learning_rate=0.02)
    w16 = torch.tensor(w).bfloat16()
    w32 = w16.float()
    state = mp.create_state_multi_precision(0, w16)
    rstate = ref.create_state(0, w32)
    for g in grads:
        mp.update_multi_precision(0, w16, torch.tensor(g).bfloat16(), state)
        ref.update(0, w32, torch.tensor(g).bfloat16().float(), rstate)
    torch.testing.assert_close(state[1], w32, rtol=0, atol=0)
    torch.testing.assert_close(w16, w32.bfloat16(), rtol=0, atol=0)


def test_accuracy_matches_jax():
    rng = np.random.default_rng(9)
    labels = [rng.integers(0, 4, 10).astype(np.float32) for _ in range(3)]
    preds = [rng.standard_normal((10, 4)).astype(np.float32),
             rng.standard_normal((10, 4)).astype(np.float32),
             rng.integers(0, 4, 10).astype(np.float32)]
    jm, pm = mx.metric.create("acc"), mt.metric.create("acc")
    for lab, pred in zip(labels, preds):
        jm.update([mx.nd.array(lab)], [mx.nd.array(pred)])
        pm.update([torch.tensor(lab)], [torch.tensor(pred)])
    assert pm.get() == jm.get()
    assert pm.num_inst == 30
    pm.reset()
    assert np.isnan(pm.get()[1])
    with pytest.raises(MXNetError):
        mt.metric.create("no_such_metric")


# ------------------------------------------------- the slice as a whole

def _jax_softmax_head(lib):
    """The softmax output layer of chip_smoke.SoftmaxRtcProp, written as a
    JAX CustomOp with the JAX package's ops."""
    class Op(lib.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = mx.nd.exp(x - mx.nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / mx.nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0],
                        y - mx.nd.one_hot(in_data[1], y.shape[1]))

    class Prop(lib.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Op()
    return Prop


def _mlp(lib, **kw):
    net = lib.gluon.nn.HybridSequential(**kw)
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(16, activation="relu", in_units=32),
                lib.gluon.nn.Dense(10, in_units=16))
    return net


def test_softmax_rtc_head_trains_like_jax():
    """A 32-16-10 MLP at batch 8, the JAX package's weights carried
    across; three Adam steps with the softmax_rtc head (the plain versions
    on the CPU) against the JAX MLP with the same head as a JAX CustomOp:
    losses 1e-6, weights 1e-5."""
    mx.operator.register("parity_softmax_head")(_jax_softmax_head(mx))
    rng = np.random.default_rng(10)
    X = rng.standard_normal((8, 32)).astype(np.float32)
    Y = rng.integers(0, 10, 8).astype(np.float32)
    ref = _mlp(mx, prefix="hybrid_sequential98_")
    ref.initialize(mx.init.Xavier())
    port = _mlp(mt)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()}, ctx=cpu())
    opt = {"learning_rate": 0.01, "wd": 1e-3}
    jt = mx.gluon.Trainer(ref.collect_params(), "adam", opt)
    pt = gluon.Trainer(port.collect_params(), "adam", opt)
    jacc, pacc = mx.metric.Accuracy(), mt.metric.Accuracy()
    xj, yj = mx.nd.array(X), mx.nd.array(Y)
    xp, yp = torch.tensor(X), torch.tensor(Y)
    losses = []
    for _ in range(3):
        with mx.autograd.record():
            jout = mx.nd.Custom(ref(xj), yj, op_type="parity_softmax_head")
        jout.backward()
        jt.step(8)
        with autograd.record():
            pout = mt.nd.Custom(port(xp), yp, op_type="softmax_rtc")
        autograd.backward(pout)
        pt.step(8)
        jacc.update([yj], [jout])
        pacc.update([yp], [pout])
        jp = jout.asnumpy()[np.arange(8), Y.astype(int)]
        pp = pout.detach().numpy()[np.arange(8), Y.astype(int)]
        losses.append((-np.log(jp).mean(), -np.log(pp).mean()))
    for jl, pl in losses:
        np.testing.assert_allclose(pl, jl, atol=1e-6)
    assert losses[-1][1] < losses[0][1]
    assert pacc.get() == jacc.get()
    for (k, p), (kq, q) in zip(ref.collect_params().items(),
                               port.collect_params().items()):
        assert k[len(ref.prefix):] == kq[len(port.prefix):]
        np.testing.assert_allclose(q.data().detach().numpy(),
                                   p.data().asnumpy(), atol=1e-5, err_msg=k)


def test_softmax_rtc_plain_versions():
    """The op's plain versions against float64 numpy (1e-6): probabilities
    that sum to 1, and softmax - onehot as the gradient into ``data`` (the
    label takes none)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 13)).astype(np.float32) * 4
    lab = rng.integers(0, 13, 6).astype(np.float32)
    e = np.exp(x.astype(np.float64) - x.max(1, keepdims=True))
    ref = e / e.sum(1, keepdims=True)
    xt = torch.tensor(x, requires_grad=True)
    with autograd.record():
        y = mt.nd.Custom(xt, torch.tensor(lab), op_type="softmax_rtc")
    autograd.backward(y, torch.full_like(y, 3.0))    # not read
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(),
                               ref - np.eye(13)[lab.astype(int)], atol=1e-6)
    assert chip_smoke.softmax_threads(10) == 32
    assert chip_smoke.softmax_threads(30522) == 1024
