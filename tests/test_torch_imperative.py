"""Config #1 written in ``nd`` ops against the port, on the CPU: the
verify recipe (``nd.random.normal``, ``attach_grad``,
``nd.FullyConnected``, ``nd.log_softmax``/``pick``/``mean``,
``L.backward()``) against the JAX package and central finite
differences; a small imperative MLP (64-32-10, batch 16) trained three
steps through ``nd.multi_sgd_mom_update`` in both packages from the same
weights; and ``examples/train_mnist_mlp.py``'s loop spelled against the
port (``nd.array`` inputs, ``net(x)`` an ``NDArray``, ``L.backward()``,
``trainer.step``, ``metric.update``, ``.asnumpy()``) beside the JAX
package's.  fp32 tolerance ``atol=1e-5, rtol=1e-5``.
"""
import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, gluon, load_reference_params, nd

TOL = dict(atol=1e-5, rtol=1e-5)


def _recipe_loss(lib, X, W, Y):
    return -lib.nd.mean(lib.nd.pick(lib.nd.log_softmax(lib.nd.FullyConnected(
        X, W, num_hidden=3, no_bias=True)), Y, axis=-1))


def _numpy_loss(x, w, y):
    z = x @ w.T
    z = z - z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return -logp[np.arange(len(y)), y].mean()


def test_verify_recipe_matches_jax_and_finite_differences():
    rs = np.random.RandomState(0)
    x = rs.randn(32, 5).astype(np.float32)
    y = rs.randint(0, 3, 32)
    with mt.cpu():
        X = nd.array(x)
        Y = nd.array(y, dtype="int32")
        W = nd.random.normal(0, 0.1, shape=(3, 5))
        W.attach_grad()
        with autograd.record():
            L = _recipe_loss(mt, X, W, Y)
        L.backward()
    w = W.asnumpy()
    jW = mx.nd.array(w)
    jW.attach_grad()
    with mx.autograd.record():
        jL = _recipe_loss(mx, mx.nd.array(x), jW, mx.nd.array(y,
                                                              dtype="int32"))
    jL.backward()
    assert isinstance(W.grad, nd.NDArray)
    np.testing.assert_allclose(W.grad.asnumpy(), jW.grad.asnumpy(), **TOL)
    np.testing.assert_allclose(L.asscalar(), jL.asscalar(), **TOL)
    eps = 1e-4
    fd = np.zeros(w.shape)
    for i in np.ndindex(*w.shape):
        hi, lo = w.astype(np.float64), w.astype(np.float64)
        hi[i] += eps
        lo[i] -= eps
        fd[i] = (_numpy_loss(x, hi, y) - _numpy_loss(x, lo, y)) / (2 * eps)
    np.testing.assert_allclose(W.grad.asnumpy(), fd, **TOL)


SIZES = [(32, 64), (32,), (10, 32), (10,)]


def _mlp_loss(lib, x, y, params):
    w0, b0, w1, b1 = params
    h = lib.nd.Activation(lib.nd.FullyConnected(x, w0, b0, num_hidden=32),
                          act_type="relu")
    z = lib.nd.FullyConnected(h, w1, b1, num_hidden=10)
    return -lib.nd.mean(lib.nd.pick(lib.nd.log_softmax(z), y, axis=-1))


def test_imperative_mlp_matches_jax():
    """Three steps of the MLP in nd ops, each a backward and one
    ``multi_sgd_mom_update`` over the 4 parameters (the port: ``out=`` the
    weights, MXNet's form; the JAX package: its ``[w, m, ...]`` form, and
    a fresh ``attach_grad`` each step, since its ``write`` gradient adds
    on a later backward)."""
    rs = np.random.RandomState(1)
    init = [(rs.randn(*s) * 0.3).astype(np.float32) for s in SIZES]
    x = rs.randn(16, 64).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.float32)
    lrs = np.full(4, 0.2, np.float32)
    wds = np.array([1e-3, 0, 1e-3, 0], np.float32)
    kw = dict(momentum=0.9, num_weights=4, rescale_grad=1.0)

    jp = [mx.nd.array(a) for a in init]
    jm = [mx.nd.zeros(a.shape) for a in init]
    jx, jy = mx.nd.array(x), mx.nd.array(y)
    jlosses = []
    for _ in range(3):
        for p in jp:
            p.attach_grad()
        with mx.autograd.record():
            loss = _mlp_loss(mx, jx, jy, jp)
        loss.backward()
        jlosses.append(loss.asscalar())
        mx.nd.multi_sgd_mom_update(
            *[t for p, m in zip(jp, jm) for t in (p, p.grad, m)],
            mx.nd.array(lrs), mx.nd.array(wds),
            out=[t for p, m in zip(jp, jm) for t in (p, m)], **kw)

    with mt.cpu():
        pp = [nd.array(a) for a in init]
        pm = [nd.zeros(a.shape) for a in init]
        px, py = nd.array(x), nd.array(y)
        for p in pp:
            p.attach_grad()
        plosses = []
        for _ in range(3):
            with autograd.record():
                loss = _mlp_loss(mt, px, py, pp)
            loss.backward()
            plosses.append(loss.asscalar())
            out = nd.multi_sgd_mom_update(
                *[t for p, m in zip(pp, pm) for t in (p, p.grad, m)],
                nd.array(lrs), nd.array(wds), out=pp, **kw)
            assert out is pp
    np.testing.assert_allclose(plosses, jlosses, **TOL)
    assert plosses[-1] < plosses[0]
    for a, b in zip(pp + pm, jp + jm):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)


def _example_net(lib, **kw):
    net = lib.gluon.nn.HybridSequential(**kw)
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(128, activation="relu", in_units=64),
                lib.gluon.nn.Dense(64, activation="relu", in_units=128),
                lib.gluon.nn.Dense(10, in_units=64))
    return net


def test_train_mnist_mlp_loop_runs_on_the_port():
    """The example's loop (its ``--synthetic`` data, batch 100, Adam
    2e-3), two steps in each package from the same weights: losses within
    1e-5, the same training accuracy, and the held-out forward through
    ``asnumpy``."""
    rng = np.random.RandomState(7)
    temp = rng.rand(10, 64).astype(np.float32)
    yall = rng.randint(0, 10, 300)
    xall = temp[yall] + 0.1 * rng.randn(300, 64).astype(np.float32) - 0.5
    ref = _example_net(mx, prefix="hybrid_sequential97_")
    ref.initialize(mx.init.Xavier())
    jt = mx.gluon.Trainer(ref.collect_params(), "adam",
                          {"learning_rate": 2e-3})
    jloss, jmetric = mx.gluon.loss.SoftmaxCrossEntropyLoss(), \
        mx.metric.Accuracy()
    with mt.cpu():
        net = _example_net(mt)
        net.initialize(mt.init.Xavier())
        load_reference_params(net, {k: p.data().asnumpy() for k, p in
                                    ref.collect_params().items()})
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 2e-3})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        metric = mt.metric.Accuracy()
        for i in range(0, 200, 100):
            x = mt.nd.array(xall[i:i + 100])
            y = mt.nd.array(yall[i:i + 100])
            with autograd.record():
                out = net(x)
                L = loss_fn(out, y)
            L.backward()
            trainer.step(x.shape[0])
            metric.update([y], [out])
            assert isinstance(out, nd.NDArray) and isinstance(L, nd.NDArray)
            jx, jy = mx.nd.array(xall[i:i + 100]), mx.nd.array(yall[i:i + 100])
            with mx.autograd.record():
                jout = ref(jx)
                jL = jloss(jout, jy)
            jL.backward()
            jt.step(100)
            jmetric.update([jy], [jout])
            np.testing.assert_allclose(L.asnumpy(), jL.asnumpy(), **TOL)
        test = net(mt.nd.array(xall[200:])).asnumpy()
    assert metric.get() == jmetric.get()
    np.testing.assert_allclose(test, ref(mx.nd.array(xall[200:])).asnumpy(),
                               **TOL)
