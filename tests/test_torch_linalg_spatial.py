"""The 17 ``linalg_*`` ops of ``ops_linalg`` and the 6 ops of
``ops_spatial`` held against the JAX package's.

The same seeded numpy inputs go through both packages' ``nd`` frontends on
the CPU; outputs and the gradient of their sum with respect to the first
input (or the input the case names) must match exactly where the op
copies or indexes, else within ``TOL`` in fp32 and ``TOL64`` in float64
(the JAX package under ``jax.enable_x64``; both packages call LAPACK).
``gelqf`` and ``syevd`` give factors whose rows' signs are the solver's
choice: the port's are compared after each row of ``U`` (of ``Q``, and
the column of ``L``) takes the JAX package's sign, and their gradient is
taken of ``sum(w * w) + sum(W * U**2)``, a function of the factors blind
to those signs.  The sampler's
gradient in the grid is held at grid points off the pixel centres.
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from tests import _op_parity as par

TOL = dict(rtol=1e-5, atol=1e-6)
TOL64 = dict(rtol=1e-10, atol=1e-10)


def _spd(rs, b, n, dtype):
    a = rs.standard_normal((b, n, n))
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype)


def _blind(pkg, outs):
    """``sum(w * w) + sum(W * U**2)`` of a ``(U, w)`` or ``(Q, L)`` pair:
    blind to the sign of each row of ``U`` (column of ``L``)."""
    u, w = outs
    n = int(np.prod(u.shape))
    weight = pkg.nd.array(np.linspace(0.5, 1.5, n).reshape(u.shape)
                          .astype(u.dtype), dtype=u.dtype)
    first = pkg.nd.sum(pkg.nd.cast(weight * u * u, dtype="float64"))
    second = pkg.nd.sum(pkg.nd.cast(w * w, dtype="float64"))
    return pkg.nd.cast(first + second, dtype="float32")


def _linalg_cases(dtype):
    rs = np.random.default_rng(181)
    f = lambda *s: rs.standard_normal(s).astype(dtype)  # noqa: E731
    spd = _spd(rs, 2, 4, dtype)
    low = np.linalg.cholesky(spd.astype(np.float64)).astype(dtype)
    tri = np.tril(f(2, 4, 4)) + 4 * np.eye(4, dtype=dtype)
    return [
        ("linalg_gemm", [f(2, 3, 4), f(2, 5, 4), f(2, 3, 5)],
         {"transpose_b": True, "alpha": 0.5, "beta": -1.5}, False, True),
        ("linalg_potrf", [spd], {}, False, True),
        ("linalg_potrf", [spd], {"lower": False}, False, True),
        ("linalg_potri", [low], {}, False, True),
        ("linalg_trsm", [tri, f(2, 4, 3)], {"alpha": 2.0}, False, True),
        ("linalg_trsm", [tri, f(2, 3, 4)],
         {"transpose": True, "rightside": True}, False, True),
        ("linalg_trsm", [tri.transpose(0, 2, 1).copy(), f(2, 4, 3)],
         {"lower": False}, False, 1),
        ("linalg_trmm", [tri, f(2, 4, 3)], {"transpose": True}, False, True),
        ("linalg_trmm", [f(2, 4, 4), f(2, 3, 4)],
         {"rightside": True, "lower": False, "alpha": 0.5}, False, True),
        ("linalg_syrk", [f(2, 3, 4)], {"alpha": 0.5}, False, True),
        ("linalg_syrk", [f(2, 3, 4)], {"transpose": True}, False, True),
        ("linalg_gelqf", [f(2, 3, 5)], {}, False, _blind),
        ("linalg_sumlogdiag", [spd], {}, False, True),
        ("linalg_extractdiag", [f(2, 4, 4)], {"offset": 1}, True, True),
        ("linalg_makediag", [f(2, 3)], {"offset": -1}, True, True),
        ("linalg_extracttrian", [f(2, 4, 4)], {}, True, True),
        ("linalg_extracttrian", [f(2, 4, 4)], {"offset": 1,
                                               "lower": False}, True, True),
        ("linalg_maketrian", [f(2, 10)], {}, True, True),
        ("linalg_maketrian", [f(2, 6)], {"offset": -1}, True, True),
        ("linalg_inverse", [spd], {}, False, True),
        ("linalg_det", [spd], {}, False, True),
        ("linalg_slogdet", [f(2, 4, 4)], {}, False, True),
        ("linalg_syevd", [spd], {}, False, _blind),
        ("khatri_rao", [f(3, 4), f(2, 4)], {}, False, True),
        ("_linalg_gemm2", [f(2, 3, 4), f(2, 4, 5)], {}, False, True),
    ]


def _spatial_cases():
    rs = np.random.default_rng(182)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    theta = (np.array([0.9, 0.1, 0.05, -0.1, 0.8, -0.03], np.float32)
             + 0.05 * f(2, 6))
    grid = rs.uniform(-1.2, 1.2, (2, 2, 4, 4)).astype(np.float32)
    idx = np.array([[0, 3, 1, 2, 3], [5, 0, 2, 1, 4]], np.float32)
    return [
        ("GridGenerator", [theta], {"target_shape": (4, 5)}, False, True),
        ("GridGenerator", [f(2, 2, 4, 5)], {"transform_type": "warp"},
         False, True),
        ("BilinearSampler", [f(2, 3, 5, 6), grid], {}, False, True),
        ("BilinearSampler", [f(2, 3, 5, 6), grid], {}, False, 1),
        ("SpatialTransformer", [f(2, 3, 6, 7), theta],
         {"target_shape": (4, 5)}, False, True),
        ("SpatialTransformer", [f(2, 3, 6, 7), theta],
         {"target_shape": (4, 5)}, False, 1),
        ("batch_take", [f(4, 5), np.array([4, 0, 2, 2], np.float32)], {},
         True, True),
        ("_ravel_multi_index", [idx], {"shape": (4, 6)}, True, False),
        ("_unravel_index", [np.array([0, 5, 13, 23], np.float32)],
         {"shape": (4, 6)}, True, False),
    ]


def _check(name, inputs, kwargs, exact, grad, tol, x64=False):
    if x64:
        with jax.enable_x64(True):
            want, want_g = par.run(mx, name, inputs, kwargs, grad)
    else:
        want, want_g = par.run(mx, name, inputs, kwargs, grad)
    with mt.cpu():
        got, got_g = par.run(mt, name, inputs, kwargs, grad)
    if name in ("linalg_syevd", "linalg_gelqf"):
        got = _align(got, want)
    par.assert_match(got, want, tol, exact)
    if grad:
        par.assert_match([got_g], [want_g], tol, False)


def _align(got, want):
    """The rows of ``got[0]`` (and, for ``gelqf``, the columns of
    ``got[1]``) flipped to the signs of ``want``'s."""
    sign = np.sign(np.sum(got[0] * want[0], axis=-1, keepdims=True))
    first = got[0] * sign
    second = got[1] if got[1].ndim < got[0].ndim else \
        got[1] * np.swapaxes(sign, -1, -2)
    return [first.astype(got[0].dtype), second.astype(got[1].dtype)]


LINALG = _linalg_cases(np.float32)
LINALG64 = _linalg_cases(np.float64)
SPATIAL = _spatial_cases()


@pytest.mark.parametrize("name,inputs,kwargs,exact,grad", LINALG,
                         ids=par.case_ids(LINALG))
def test_linalg_matches_jax(name, inputs, kwargs, exact, grad):
    _check(name, inputs, kwargs, exact, grad, TOL)


@pytest.mark.parametrize("name,inputs,kwargs,exact,grad", LINALG64,
                         ids=par.case_ids(LINALG64))
def test_linalg_float64_matches_jax(name, inputs, kwargs, exact, grad):
    """The same cases in float64, within ``TOL64``."""
    _check(name, inputs, kwargs, exact, grad, TOL64, x64=True)


@pytest.mark.parametrize("name,inputs,kwargs,exact,grad", SPATIAL,
                         ids=par.case_ids(SPATIAL))
def test_spatial_matches_jax(name, inputs, kwargs, exact, grad):
    _check(name, inputs, kwargs, exact, grad, TOL)


def test_identity_transform_samples_the_image():
    """The identity affine at the input's size reproduces the image (every
    point a pixel centre), and a point outside the image reads 0."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((1, 2, 5, 6)).astype(np.float32)
    ident = np.array([[1, 0, 0, 0, 1, 0]], np.float32)
    with mt.cpu():
        out = mt.nd.SpatialTransformer(mt.nd.array(img), mt.nd.array(ident),
                                       target_shape=(5, 6))
        far = mt.nd.BilinearSampler(mt.nd.array(img), mt.nd.array(
            np.full((1, 2, 1, 1), 3.0, np.float32)))
    np.testing.assert_allclose(out.asnumpy(), img, rtol=1e-6, atol=1e-6)
    assert far.asnumpy().tolist() == [[[[0.0]], [[0.0]]]]
