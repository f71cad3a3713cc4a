"""The 19 draws of ``ops_random`` the port took over with the rest of the
op files, their frontends (``nd.random``, ``mx.random``,
``mx.sym.random`` and the flat ``nd.random_*``/``nd.sample_*``), and the
registry's count against the JAX package's.

Draws are not equal across the packages (the port draws from torch
generators, the JAX package from ``jax.random`` keys), so each is held by
what both must share: the output's shape and dtype for the same
arguments (the per-element ``_sample_*`` broadcast with a trailing
``shape`` included), the sample mean and variance of 2**16 draws within
6 standard errors of the distribution's exact values in both packages,
and repeatability under ``mx.random.seed``.  ``multinomial``'s
frequencies match its probabilities and its ``get_prob`` gradient is the
REINFORCE rule; ``shuffle`` permutes.  The multi-output and random ops
go through ``mx.sym`` and a bound executor against the JAX package's.
"""
import inspect

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

N = 1 << 16
SIGMAS = 6.0

# the JAX package's last ten ops the port took, by file
LAST_PORTED = {
    "ops_quantization": {
        "_contrib_dequantize", "_contrib_quantize", "_contrib_quantize_v2",
        "_contrib_quantized_conv", "_contrib_quantized_fully_connected",
        "_contrib_quantized_pooling", "_contrib_requantize"},
    "ops_sldwin": {"_contrib_sldwin_atten_context",
                   "_contrib_sldwin_atten_mask_like",
                   "_contrib_sldwin_atten_score"},
}


def test_registry_has_377_jax_ops_and_lacks_exactly_28():
    """The registry's census (the name is the one it had at 377 ops):
    all 405 of the JAX package's ops; the last 10 are those of
    ``ops_quantization`` (7) and ``ops_sldwin`` (3), each from the file of
    that name in both packages."""
    from mxnet_tpu.ndarray.register import get_op as jax_op
    ours, theirs = set(mt.nd.list_ops()), set(mx.nd.list_ops())
    assert len(ours) == 405 and ours == theirs
    assert set().union(*LAST_PORTED.values()) <= ours
    assert {n: len(v) for n, v in LAST_PORTED.items()} == {
        "ops_quantization": 7, "ops_sldwin": 3}
    for name, ops in LAST_PORTED.items():
        for op in ops:
            assert jax_op(op).maker.__module__.endswith(name), op
            assert mt.nd.get_op(op).maker.__module__.endswith(name), op


def test_frontends_have_the_jax_signatures():
    """``nd.random``, ``mx.random`` and ``mx.sym.random`` offer the JAX
    package's functions with its signatures; the flat ``nd`` forms are
    the same functions."""
    for ours, theirs in ((mt.nd.random, mx.nd.random),
                         (mt.sym.random, mx.sym.random)):
        for name in theirs.__all__:
            assert inspect.signature(getattr(ours, name)) == \
                inspect.signature(getattr(theirs, name)), name
    for name in ("uniform", "normal", "randn", "randint", "exponential",
                 "gamma", "poisson", "negative_binomial",
                 "generalized_negative_binomial", "multinomial", "shuffle",
                 "bernoulli"):
        assert inspect.signature(getattr(mt.random, name)) == \
            inspect.signature(getattr(mx.random, name)), name
    assert mt.nd.random_gamma is mt.nd.random.gamma
    assert mt.nd.sample_normal is mt.nd.random.sample_normal
    assert mt.nd.shuffle is mt.nd.random.shuffle
    assert mt.nd.sample_multinomial is mt.nd.random.multinomial


def _shape_cases():
    p2 = np.array([[1.0, 2.0], [3.0, 0.5]], np.float32)
    p1 = np.array([0.5, 2.0], np.float32)
    probs = np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]], np.float32)
    data = np.zeros((2, 3), np.float16)
    # frontend, positional inputs (numpy, made NDArrays), kwargs
    return [
        ("gamma", [], {"alpha": 2.0, "beta": 1.5, "shape": (3, 4)}),
        ("exponential", [], {"scale": 2.0, "shape": 5}),
        ("poisson", [], {"lam": 3.0, "shape": (2, 2)}),
        ("negative_binomial", [], {"k": 3, "p": 0.4, "shape": (2, 3)}),
        ("generalized_negative_binomial", [], {"mu": 2.0, "alpha": 0.5}),
        ("gamma", [p2, p1], {"shape": (3,)}),
        ("normal", [p1, p1], {}),
        ("uniform", [p1, p2], {"shape": (2, 2)}),
        ("exponential", [p1], {"shape": (4,)}),
        ("poisson", [p2], {}),
        ("negative_binomial", [p1, np.array([0.3, 0.6], np.float32)],
         {"shape": (3,)}),
        ("generalized_negative_binomial", [p1, p1], {"shape": 2}),
        ("sample_gamma", [p2, p2], {"dtype": "float16"}),
        ("multinomial", [probs], {}),
        ("multinomial", [probs], {"shape": (3, 2), "get_prob": True}),
        ("shuffle", [np.arange(8, dtype=np.float32).reshape(4, 2)], {}),
        ("uniform_like", [data], {}),
        ("normal_like", [data], {"dtype": "float32"}),
        ("gamma_like", [data], {"alpha": 2.0}),
        ("exponential_like", [data], {}),
        ("poisson_like", [np.zeros((3,), np.float32)], {"lam": 2.0}),
        ("randint_like", [data], {"low": 0, "high": 5}),
        ("bernoulli", [], {"prob": 0.3, "shape": (4,)}),
    ]


SHAPES = _shape_cases()


def _call(pkg, name, inputs, kwargs):
    args = [pkg.nd.array(a, dtype=a.dtype) for a in inputs]
    out = getattr(pkg.nd.random, name)(*args, **kwargs)
    return [(o.shape, np.dtype(o.dtype)) for o in
            (out if isinstance(out, (list, tuple)) else [out])]


@pytest.mark.parametrize("name,inputs,kwargs", SHAPES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SHAPES)])
def test_draw_shapes_and_dtypes_match_jax(name, inputs, kwargs):
    want = _call(mx, name, inputs, kwargs)
    with mt.cpu():
        got = _call(mt, name, inputs, kwargs)
    assert got == want


def _moment_cases():
    # frontend, parameters, exact mean, exact variance
    return [
        ("uniform", (-1.0, 3.0), 1.0, 16 / 12),
        ("normal", (2.0, 3.0), 2.0, 9.0),
        ("gamma", (2.5, 1.5), 2.5 * 1.5, 2.5 * 1.5 ** 2),
        ("gamma", (0.5, 2.0), 1.0, 2.0),
        ("exponential", (2.0,), 2.0, 4.0),
        ("poisson", (3.5,), 3.5, 3.5),
        ("negative_binomial", (3, 0.4), 3 * 0.6 / 0.4, 3 * 0.6 / 0.16),
        ("generalized_negative_binomial", (2.0, 0.5), 2.0, 2.0 + 0.5 * 4),
    ]


def _within(x: np.ndarray, mean: float, var: float) -> dict:
    """The sample's mean and variance, each within ``SIGMAS`` standard
    errors of the exact values (the variance's error from the sample's
    fourth central moment)."""
    x = x.astype(np.float64).reshape(-1)
    m, v = x.mean(), x.var()
    m4 = ((x - m) ** 4).mean()
    se_m, se_v = np.sqrt(var / x.size), np.sqrt(max(m4 - v * v, 0) / x.size)
    return {"mean": abs(m - mean) <= SIGMAS * se_m,
            "var": abs(v - var) <= SIGMAS * se_v}


@pytest.mark.parametrize("name,params,mean,var", _moment_cases(),
                         ids=[c[0] for c in _moment_cases()])
def test_scalar_draw_moments_in_both_packages(name, params, mean, var):
    for pkg in (mx, mt):
        with pkg.cpu():
            x = getattr(pkg.nd.random, name)(*params, shape=(N,)).asnumpy()
        assert _within(x, mean, var) == {"mean": True, "var": True}, pkg


def test_per_element_draw_moments_in_both_packages():
    """``sample_gamma``/``sample_poisson``/``sample_normal`` with one
    parameter pair a row: each row's moments are its own."""
    alpha = np.array([1.0, 4.0], np.float32)
    beta = np.array([2.0, 0.5], np.float32)
    for pkg in (mx, mt):
        with pkg.cpu():
            a, b = pkg.nd.array(alpha), pkg.nd.array(beta)
            g = pkg.nd.random.sample_gamma(a, b, shape=(N // 2,)).asnumpy()
            p = pkg.nd.sample_poisson(b, shape=(N // 2,)).asnumpy()
            z = pkg.nd.sample_normal(a, b, shape=(N // 2,)).asnumpy()
        for i in range(2):
            assert all(_within(g[i], alpha[i] * beta[i],
                               alpha[i] * beta[i] ** 2).values())
            assert all(_within(p[i], beta[i], beta[i]).values())
            assert all(_within(z[i], alpha[i], beta[i] ** 2).values())


def test_draws_repeat_under_seed():
    """Every draw repeats bit for bit after ``mx.random.seed`` with the
    same seed, and differs with another."""
    probs = np.array([[0.2, 0.3, 0.5]], np.float32)

    def draws():
        p = mt.nd.array(probs)
        return [mt.nd.random.gamma(2.0, shape=(50,)),
                mt.nd.random.exponential(shape=(50,)),
                mt.nd.random.poisson(3.0, shape=(50,)),
                mt.nd.random.negative_binomial(2, 0.3, shape=(50,)),
                mt.nd.random.generalized_negative_binomial(shape=(50,)),
                mt.nd.random.sample_normal(p, p, shape=(8,)),
                mt.nd.random.multinomial(p, shape=(20,)),
                mt.nd.random.shuffle(mt.nd.array(np.arange(20.0))),
                mt.nd.random.gamma_like(mt.nd.zeros((20,))),
                mt.random.bernoulli(0.5, shape=(50,))]
    with mt.cpu():
        mt.random.seed(7)
        a = [x.asnumpy() for x in draws()]
        mt.random.seed(7)
        b = [x.asnumpy() for x in draws()]
        mt.random.seed(8)
        c = [x.asnumpy() for x in draws()]
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        assert not np.array_equal(x, z)


def test_multinomial_frequencies_and_reinforce_gradient():
    """Draw frequencies match the rows' probabilities (6 standard
    errors); with ``get_prob`` the log-probabilities' gradient in ``p``
    is ``1 / p`` at each drawn class, summed over the draws."""
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    with mt.cpu():
        p = mt.nd.array(probs)
        s = mt.nd.random.multinomial(p, shape=(N // 4,)).asnumpy()
        p.attach_grad()
        with mt.autograd.record():
            s2, lp = mt.nd.random.multinomial(p, shape=(5,), get_prob=True)
        lp.backward()
    for row in range(2):
        freq = np.bincount(s[row], minlength=3) / s.shape[1]
        se = np.sqrt(probs[row] * (1 - probs[row]) / s.shape[1])
        assert np.all(np.abs(freq - probs[row]) <= SIGMAS * se)
    want = np.zeros_like(probs)
    for row, draws in enumerate(s2.asnumpy()):
        for c in draws:
            want[row, c] += 1.0 / probs[row, c]
    np.testing.assert_allclose(p.grad.asnumpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        lp.asnumpy(), np.log(np.take_along_axis(probs, s2.asnumpy(), 1)),
        rtol=1e-6)


def test_shuffle_permutes_the_first_axis():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    with mt.cpu():
        y = mt.nd.random.shuffle(mt.nd.array(x)).asnumpy()
    assert sorted(y[:, 0].tolist()) == x[:, 0].tolist()
    np.testing.assert_array_equal(y[:, 1], y[:, 0] + 1)
    assert not np.array_equal(y, x)


def _bind(pkg, sym, feeds):
    with pkg.cpu():
        args = {k: pkg.nd.array(v) for k, v in feeds.items()}
        exe = sym.bind(args=args, grad_req="null")
        first = [o.asnumpy() for o in exe.forward()]
        second = [o.asnumpy() for o in exe.forward()]
    return sym.infer_shape(**{k: v.shape for k, v in feeds.items()}), \
        first, second


def test_sym_multi_output_and_random_ops_bind_as_jax():
    """``mx.sym.linalg_syevd``, ``mx.sym.split_v2`` and
    ``mx.sym.random.gamma`` (with ``Symbol`` parameters, the per-element
    form) bound against the JAX package's executor: the same output
    counts and inferred shapes; ``syevd`` and ``split_v2`` the same
    values (eigenvector rows up to their sign), the gamma node fresh
    draws at each forward with the JAX package's shape and dtype."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 4, 4)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) + 4 * np.eye(4, dtype=np.float32)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    alpha = np.array([1.0, 3.0], np.float32)
    res = {}
    for pkg in (mx, mt):
        eig = pkg.sym.linalg_syevd(pkg.sym.var("a"))
        parts = pkg.sym.split_v2(pkg.sym.var("x"), indices=(0, 2, 5),
                                 axis=0)
        draw = pkg.sym.random.gamma(pkg.sym.var("alpha"),
                                    pkg.sym.var("beta"), shape=(1000,))
        res[pkg] = [_bind(pkg, eig, {"a": spd}),
                    _bind(pkg, parts, {"x": x}),
                    _bind(pkg, draw, {"alpha": alpha, "beta": alpha})]
    for (shapes_t, first_t, second_t), (shapes_j, first_j, _) in zip(
            res[mt], res[mx]):
        assert shapes_t == shapes_j
        assert [(o.shape, o.dtype) for o in first_t] == \
            [(o.shape, o.dtype) for o in first_j]
    (_, (u_t, w_t), _), (_, (u_j, w_j), _) = res[mt][0], res[mx][0]
    np.testing.assert_allclose(w_t, w_j, rtol=1e-5, atol=1e-5)
    sign = np.sign(np.sum(u_t * u_j, axis=-1, keepdims=True))
    np.testing.assert_allclose(u_t * sign, u_j, rtol=1e-4, atol=1e-5)
    for p_t, p_j in zip(res[mt][1][1], res[mx][1][1]):
        np.testing.assert_array_equal(p_t, p_j)
    first, second = res[mt][2][1][0], res[mt][2][2][0]
    assert not np.array_equal(first, second)
    for row, a_ in enumerate(alpha):
        assert all(_within(first[row], a_ * a_, a_ * a_ ** 2).values())


def test_hybridized_draw_is_fresh_at_each_call():
    """A hybridized block that draws (``F.random.normal_like``) gives new
    values at each call, and repeats them after a reseed."""
    class Noise(mt.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x + F.random.normal_like(x)

    net = Noise()
    net.initialize(ctx=mt.cpu())
    net.hybridize()
    x = mt.nd.zeros((64,), ctx=mt.cpu())
    mt.random.seed(3)
    a, b = net(x).asnumpy(), net(x).asnumpy()
    mt.random.seed(3)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(net(x).asnumpy(), a)
