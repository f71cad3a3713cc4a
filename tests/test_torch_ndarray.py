"""The port's ``NDArray`` semantics: write-through views, indexing,
``out=``, MXNet's comparison and scalar-cast quirks, reshape codes,
``grad_req`` write/add, ``autograd.grad`` and ``mark_variables``, the
``with mx.cpu():`` scope, ``nd.save``/``nd.load`` across the two
packages, NaiveEngine, ``autograd.Function`` on arrays, and where the
port departs from the JAX package on purpose (MXNet's semantics: the
optimizer ops and BatchNorm's moving statistics), each against the JAX
package.  fp32 tolerance ``atol=1e-5, rtol=1e-5``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.engine import engine

TOL = dict(atol=1e-5, rtol=1e-5)
RS = np.random.RandomState(5)
X = RS.randn(4, 6).astype(np.float32)


def _a(v, **kw):
    return nd.array(v, ctx=mt.cpu(), **kw)


def test_views_write_through():
    x = _a(np.arange(24).reshape(4, 6))
    x.reshape((2, 12))[1, :] = 5.0
    assert (x.asnumpy()[2:] == 5.0).all() and x.asnumpy()[0, 0] == 0.0
    row = x[1]
    row[:] = -1.0
    assert (x.asnumpy()[1] == -1.0).all()
    part = x[0:2]
    part += 100.0
    assert x.asnumpy()[0, 1] == 101.0
    y = x.reshape((-1,))
    assert y.shape == (24,) and y.context == mt.cpu()
    # ops copy: a transposed or reshaped op result is not a view
    before = x.asnumpy().copy()
    t = nd.transpose(x)
    t[:] = 0.0
    r = nd.reshape(x, shape=(6, 4))
    r[:] = 0.0
    np.testing.assert_array_equal(x.asnumpy(), before)


def test_advanced_indexing_copies():
    x = _a(X)
    np.testing.assert_array_equal(x[[0, 2]].asnumpy(), X[[0, 2]])
    np.testing.assert_array_equal(x[_a([3, 1])].asnumpy(), X[[3, 1]])
    mask = np.array([True, False, True, False])
    np.testing.assert_array_equal(x[mask].asnumpy(), X[mask])
    picked = x[[0, 2]]
    picked[:] = 0.0
    np.testing.assert_array_equal(x.asnumpy(), X)
    x[mask] = 7.0
    assert (x.asnumpy()[[0, 2]] == 7.0).all()
    with pytest.raises(IndexError):
        x[np.array([True, False])]


def test_out_keeps_the_targets_dtype():
    out = nd.zeros((4,), ctx=mt.cpu(), dtype="float16")
    r = nd.sum(_a(X), axis=1, out=out)
    assert r is out and out.dtype == np.float16
    jout = mx.nd.zeros((4,), dtype="float16")
    mx.nd.sum(mx.nd.array(X), axis=1, out=jout)
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=1e-3)


def test_comparison_and_scalar_quirks_match_jax():
    """Comparisons return 0/1 in the input's dtype; a scalar is cast to
    the array's dtype first (an int array plus 2.7 adds 2)."""
    ints = np.array([[1, -2, 3], [4, 5, -6]], np.int32)
    for expr in (lambda a: a > 0.5, lambda a: a == 3, lambda a: a + 2.7,
                 lambda a: 10 - a, lambda a: a * 1.9, lambda a: a / 2,
                 lambda a: a <= a):
        want = expr(mx.nd.array(ints, dtype="int32"))
        got = expr(_a(ints, dtype="int32"))
        assert got.dtype == want.dtype, expr
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    for expr in (lambda a: a > 0.1, lambda a: 2.0 ** a, lambda a: a % 0.7,
                 lambda a: -a, lambda a: abs(a), lambda a: 3 / a):
        np.testing.assert_allclose(expr(_a(X)).asnumpy(),
                                   expr(mx.nd.array(X)).asnumpy(), **TOL)
    hx = X.astype(np.float32)
    got = (_a(hx).astype("bfloat16") * 0.1).astype("float32").asnumpy()
    want = (mx.nd.array(hx).astype("bfloat16") * 0.1).astype(
        "float32").asnumpy()
    np.testing.assert_array_equal(got, want)


def test_bfloat16_reads_back_as_float32(tmp_path):
    """numpy has no bfloat16: the port's ``asnumpy`` and ``nd.save`` give
    a bfloat16 array as float32 (its values exactly), where the JAX
    package gives ``ml_dtypes.bfloat16`` (a departure filed in
    ROADMAP)."""
    b = _a(X).astype("bfloat16")
    jb = mx.nd.array(X).astype("bfloat16")
    host = b.asnumpy()
    assert host.dtype == np.float32 and str(jb.asnumpy().dtype) == \
        "bfloat16"
    np.testing.assert_array_equal(host, jb.asnumpy().astype(np.float32))
    path = str(tmp_path / "bf16.params")
    nd.save(path, [b])
    np.testing.assert_array_equal(mx.nd.load(path)[0].asnumpy(), host)


@pytest.mark.parametrize("spec,reverse", [
    ((0, -1), False), ((-1, 0), True), ((-3, 0), False),
    ((-4, 1, -1, -2), False),
    ((2, -2), False), ((0, 0, -4, -1, 2), False)])
def test_reshape_codes_match_jax(spec, reverse):
    x3 = RS.randn(2, 3, 4).astype(np.float32)
    want = mx.nd.array(x3).reshape(spec, reverse=reverse)
    got = _a(x3).reshape(spec, reverse=reverse)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def _loss(lib, w, x):
    return lib.nd.sum(lib.nd.square(lib.nd.dot(x, w)))


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_over_two_backwards(req):
    """MXNet's semantics: ``write`` overwrites on each backward, ``add``
    accumulates.  The JAX package's ``write`` adds on a second backward
    without an update (its one-shot ``fresh`` flag), so the port is held
    to 1x and 2x the one-pass gradient."""
    w0 = RS.randn(6, 3).astype(np.float32)
    w = _a(w0)
    w.attach_grad(req)
    x = _a(X)
    for _ in range(2):
        with autograd.record():
            loss = _loss(mt, w, x)
        loss.backward()
    jw = mx.nd.array(w0)
    jw.attach_grad()
    with mx.autograd.record():
        jl = _loss(mx, jw, mx.nd.array(X))
    jl.backward()
    once = jw.grad.asnumpy()
    np.testing.assert_allclose(w.grad.asnumpy(),
                               once * (2 if req == "add" else 1), **TOL)
    assert w.grad_req == req


def test_autograd_grad_and_mark_variables():
    w0 = RS.randn(6, 3).astype(np.float32)
    jw = mx.nd.array(w0)
    jw.attach_grad()
    with mx.autograd.record():
        jl = _loss(mx, jw, mx.nd.array(X))
    want = mx.autograd.grad(jl, [jw])[0].asnumpy()
    w = _a(w0)
    w.attach_grad()
    with autograd.record():
        loss = _loss(mt, w, _a(X))
    g = autograd.grad(loss, [w], retain_graph=True)[0]
    np.testing.assert_allclose(g.asnumpy(), want, **TOL)
    assert not w.grad.asnumpy().any()        # the buffer is left alone
    loss.backward()
    np.testing.assert_allclose(w.grad.asnumpy(), want, **TOL)
    # mark_variables: the gradient lands in the caller's buffer
    v, buf = _a(w0), nd.zeros((6, 3), ctx=mt.cpu())
    autograd.mark_variables([v], [buf], "add")
    for _ in range(2):
        with autograd.record():
            loss = _loss(mt, v, _a(X))
        loss.backward()
    np.testing.assert_allclose(buf.asnumpy(), 2 * want, **TOL)
    with pytest.raises(MXNetError, match="create_graph"):
        autograd.grad(loss, [v], create_graph=True)


def test_updates_outside_record_on_an_attached_array():
    w = _a(X)
    w.attach_grad()
    with autograd.record():
        loss = nd.sum(w * w)
    loss.backward()
    w[:] = w - 0.1 * w.grad
    w -= 0.1 * w.grad
    nd.sgd_update(w, w.grad, 0.1, out=w)
    # three steps of 0.1 * (2 X): the gradient stays that of the backward
    np.testing.assert_allclose(w.asnumpy(), X * 0.4, **TOL)
    with autograd.record():
        with pytest.raises(RuntimeError):
            w += 1.0


def test_context_scope():
    assert mt.current_context() == mt.gpu(0)
    with mt.cpu():
        assert repr(mt.current_context()) == "cpu(0)"
        z = nd.zeros((2,))
        assert z.context == mt.cpu() and z._data.device.type == "cpu"
        assert nd.random.uniform(shape=(2,)).context == mt.cpu()
    assert mt.current_context() == mt.gpu(0)
    assert mt.gpu(0) == torch.device("cuda", 0) and mt.gpu(0).device_id == 0
    c = _a(X).as_in_context(mt.cpu())
    assert c.copyto(mt.cpu()).context.device_type == "cpu"


def test_save_load_across_packages(tmp_path):
    """A file written by either package loads in the other, bit for bit."""
    arrs = {"w": RS.randn(3, 4).astype(np.float32),
            "i": np.arange(5, dtype=np.int32)}
    p1 = str(tmp_path / "port.params")
    nd.save(p1, {k: _a(v, dtype=v.dtype) for k, v in arrs.items()})
    got = mx.nd.load(p1)
    for k, v in arrs.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
        assert got[k].asnumpy().dtype == v.dtype
    p2 = str(tmp_path / "jax.params")
    mx.nd.save(p2, [mx.nd.array(arrs["w"]), mx.nd.array(arrs["i"],
                                                        dtype="int32")])
    back = nd.load(p2, ctx=mt.cpu())
    assert isinstance(back, list) and len(back) == 2
    np.testing.assert_array_equal(back[0].asnumpy(), arrs["w"])
    np.testing.assert_array_equal(back[1].asnumpy(), arrs["i"])
    with pytest.raises(MXNetError, match="magic"):
        (tmp_path / "bad").write_bytes(b"nope")
        nd.load(str(tmp_path / "bad"))


def test_naive_engine_and_waits():
    eng = engine()
    eng.reset_stats()
    eng.set_engine_type("NaiveEngine")
    try:
        assert eng.is_naive
        y = nd.relu(_a(X))
        y.wait_to_read()
        nd.waitall()
        np.testing.assert_array_equal(y.asnumpy(), np.maximum(X, 0))
    finally:
        eng.set_engine_type("ThreadedEnginePerDevice")
    assert not eng.is_naive
    stats = eng.stats()
    assert stats["waits"] >= 2 and stats["host_reads"] == 0   # CPU arrays


def test_function_on_ndarrays_matches_jax():
    class Sigmoid:
        def __init__(self, lib):
            class F(lib.autograd.Function):
                def forward(self, x):
                    y = 1 / (1 + lib.nd.exp(-x))
                    self.save_for_backward(y)
                    return y

                def backward(self, dy):
                    y, = self.saved_tensors
                    return dy * y * (1 - y)
            self.F = F

    outs = []
    for lib, arr in ((mx, mx.nd.array), (mt, _a)):
        x = arr(X)
        x.attach_grad()
        with lib.autograd.record():
            y = Sigmoid(lib).F()(x)
        y.backward()
        outs.append((y.asnumpy(), x.grad.asnumpy()))
    assert isinstance(y, nd.NDArray)
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, **TOL)


# --------------------------------------- departures from the JAX package

def test_sgd_mom_update_follows_mxnet():
    """MXNet: ``sgd_mom_update`` updates ``mom`` in place and returns the
    new weight, which reaches ``weight`` only through ``out=``.  The JAX
    package returns ``(weight, mom)`` and mutates nothing; the values
    agree."""
    w0, g0 = RS.randn(5).astype(np.float32), RS.randn(5).astype(np.float32)
    m0 = RS.randn(5).astype(np.float32)
    kw = dict(momentum=0.9, wd=0.01)
    jw, jm = mx.nd.sgd_mom_update(mx.nd.array(w0), mx.nd.array(g0),
                                  mx.nd.array(m0), mx.nd.array(
                                      np.float32(0.1)), **kw)
    w, m = _a(w0), _a(m0)
    new = nd.sgd_mom_update(w, _a(g0), m, 0.1, **kw)
    np.testing.assert_array_equal(w.asnumpy(), w0)          # untouched
    np.testing.assert_allclose(new.asnumpy(), jw.asnumpy(), **TOL)
    np.testing.assert_allclose(m.asnumpy(), jm.asnumpy(), **TOL)
    w2, m2 = _a(w0), _a(m0)
    assert nd.sgd_mom_update(w2, _a(g0), m2, 0.1, out=w2, **kw) is w2
    np.testing.assert_allclose(w2.asnumpy(), jw.asnumpy(), **TOL)
    # adam: mean and var in place, the weight through out= only
    w3, mean, var = _a(w0), nd.zeros((5,), ctx=mt.cpu()), \
        nd.zeros((5,), ctx=mt.cpu())
    jw3, jmean, jvar = mx.nd.adam_update(
        mx.nd.array(w0), mx.nd.array(g0), mx.nd.zeros((5,)),
        mx.nd.zeros((5,)), mx.nd.array(np.float32(0.01)))
    new3 = nd.adam_update(w3, _a(g0), mean, var, 0.01)
    np.testing.assert_array_equal(w3.asnumpy(), w0)
    for a, b in ((new3, jw3), (mean, jmean), (var, jvar)):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    # the tensor form Trainer calls keeps its in-place update
    tw, tm = torch.tensor(w0), torch.tensor(m0)
    nd.sgd_mom_update(tw, torch.tensor(g0), tm, 0.1, **kw)
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), **TOL)


def test_batchnorm_moving_statistics_follow_mxnet():
    """MXNet: ``BatchNorm`` returns ``out`` and, in training, updates
    ``moving_mean``/``moving_var`` in place.  The JAX op returns ``(out,
    new_mean, new_var)`` and mutates nothing; the values agree."""
    x = RS.randn(4, 3, 5, 5).astype(np.float32) * 2 + 1
    gamma, beta = RS.rand(3).astype(np.float32) + 0.5, \
        RS.randn(3).astype(np.float32)
    mm, mv = RS.randn(3).astype(np.float32), RS.rand(3).astype(np.float32)
    kw = dict(fix_gamma=False, momentum=0.8, eps=1e-3)
    jout, jmean, jvar = mx.nd.BatchNorm(
        *[mx.nd.array(v) for v in (x, gamma, beta, mm, mv)], **kw)
    pm, pv = _a(mm), _a(mv)
    with autograd.train_mode():
        out = nd.BatchNorm(_a(x), _a(gamma), _a(beta), pm, pv, **kw)
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), **TOL)
    np.testing.assert_allclose(pm.asnumpy(), jmean.asnumpy(), **TOL)
    np.testing.assert_allclose(pv.asnumpy(), jvar.asnumpy(), **TOL)
    # predict mode: the moving statistics normalise and stay as they are
    before = pm.asnumpy().copy()
    inf = nd.BatchNorm(_a(x), _a(gamma), _a(beta), pm, pv, **kw)
    np.testing.assert_array_equal(pm.asnumpy(), before)
    want = (x - before[None, :, None, None]) / np.sqrt(
        pv.asnumpy()[None, :, None, None] + 1e-3) * \
        gamma[None, :, None, None] + beta[None, :, None, None]
    np.testing.assert_allclose(inf.asnumpy(), want, atol=1e-4, rtol=1e-4)
