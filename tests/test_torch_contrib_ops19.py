"""The last 15 ops of ``ops_contrib`` held against the JAX package's: the
sampling ops of Deformable ConvNets, R-FCN and Fast R-CNN, FlowNet's
``Correlation``, SSD's ``bipartite_matching`` and the long tail.

The same seeded numpy inputs go through both packages' ``nd`` frontends on
the CPU; outputs and, where the op is differentiable, the gradient of the
sum of its outputs with respect to the named input must match exactly
where the op copies, indexes or takes a maximum, else within ``TOL``.
Sample points and offsets are drawn off the pixel grid, so no floor
falls within rounding of an integer.  ``_sample_unique_zipfian`` draws
from each package's own generator: it is held by what it must guarantee
(distinct classes in range, draws at least the classes, a reseed
repeats it) and ``rand_zipfian``'s expected counts by their formula.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from tests import _op_parity as par

TOL = dict(rtol=2e-5, atol=2e-6)


def _rois(rs, n, size, batch=1):
    """``n`` rois [b, x1, y1, x2, y2] inside a ``size`` x ``size`` image
    (in pixels), corners off the integers."""
    lo = rs.uniform(0, size * 0.5, (n, 2))
    hi = lo + rs.uniform(size * 0.2, size * 0.45, (n, 2))
    b = rs.integers(0, batch, (n, 1))
    return np.concatenate([b, lo, hi], 1).astype(np.float32)


def _offsets(rs, shape, scale=1.5):
    """Offsets whose fractional parts stay in [0.1, 0.9]."""
    whole = rs.integers(-2, 2, shape)
    return (whole + rs.uniform(0.1, 0.9, shape) * np.sign(
        rs.standard_normal(shape)) * 0 + rs.uniform(0.1, 0.9, shape)
            ).astype(np.float32) * (scale / 2)


def _cases():
    rs = np.random.default_rng(1901)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    ps, gs, d = 3, 3, 2
    score = f(2, d * gs * gs, 8, 8)
    rois = _rois(rs, 4, 8 * 4, batch=2)     # at spatial_scale 1/4
    trans = (rs.uniform(0.1, 0.4, (4, 4, 2, 2)) *
             rs.choice([-1, 1], (4, 4, 2, 2))).astype(np.float32)
    dpsroi = {"spatial_scale": 0.25, "output_dim": d, "group_size": gs,
              "pooled_size": ps, "part_size": 2, "sample_per_part": 2,
              "trans_std": 0.1}
    fmap = f(2, 4, 8, 10)
    deform_off = _offsets(rs, (2, 2 * 9 * 2, 8, 10))
    scores = f(2, 5, 7)
    perm = rs.permutation(12)[:5]
    return [
        ("DeformablePSROIPooling", [score, rois, trans], dpsroi, False, True),
        ("DeformablePSROIPooling", [score, rois, trans], dpsroi, False, 2),
        ("DeformablePSROIPooling", [score, rois],
         {**dpsroi, "no_trans": True}, False, True),
        ("ROIPooling", [fmap, _rois(rs, 3, 8 * 8, batch=2)],
         {"pooled_size": (2, 3), "spatial_scale": 0.125}, True, True),
        ("bipartite_matching", [scores], {"threshold": 0.1}, True, False),
        ("bipartite_matching", [scores],
         {"threshold": 0.5, "is_ascend": True, "topk": 3}, True, False),
        ("Correlation", [f(2, 3, 9, 10), f(2, 3, 9, 10)],
         {"kernel_size": 3, "max_displacement": 2, "stride1": 1,
          "stride2": 1, "pad_size": 2}, False, False),
        ("Correlation", [f(2, 4, 12, 12), f(2, 4, 12, 12)],
         {"kernel_size": 1, "max_displacement": 4, "stride1": 2,
          "stride2": 2, "pad_size": 4, "is_multiply": False}, False,
         False),
        ("index_copy", [f(12, 3), perm.astype(np.float32), f(5, 3)], {},
         True, True),
        ("index_copy", [f(12, 3), perm.astype(np.float32), f(5, 3)], {},
         True, 2),
        ("count_sketch", [f(4, 10), rs.integers(0, 6, (1, 10)).astype(
            np.float32), rs.choice([-1.0, 1.0], (1, 10)).astype(np.float32)],
         {"out_dim": 6}, False, False),
        ("AdaptiveAvgPooling2D", [f(2, 3, 7, 9)], {"output_size": 3},
         False, True),
        ("AdaptiveAvgPooling2D", [f(2, 3, 7, 9)], {"output_size": (2, 4)},
         False, True),
        ("PSROIPooling", [score, rois],
         {"spatial_scale": 0.25, "output_dim": d, "pooled_size": ps,
          "group_size": gs}, False, True),
        ("DeformableConvolution", [fmap, deform_off, f(6, 4, 3, 3), f(6)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
          "num_deformable_group": 2}, False, True),
        ("DeformableConvolution", [fmap, deform_off, f(6, 4, 3, 3), f(6)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
          "num_deformable_group": 2}, False, 1),
        ("DeformableConvolution", [fmap, deform_off, f(6, 2, 3, 3)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
          "num_group": 2, "num_deformable_group": 2, "no_bias": True},
         False, 2),
        ("DeformableConvolution", [fmap, _offsets(rs, (2, 18, 4, 5)),
                                   f(6, 4, 3, 3), f(6)],
         {"kernel": (3, 3), "stride": (2, 2), "dilate": (2, 2),
          "pad": (2, 2), "num_filter": 6}, False, True),
        ("index_array", [f(2, 3, 4)], {}, True, False),
        ("index_array", [f(2, 3, 4)], {"axes": (0, 2)}, True, False),
        ("allclose", [f(3, 4), f(3, 4)], {}, True, False),
        ("allclose", [np.ones((3, 4), np.float32),
                      np.ones((3, 4), np.float32) + 1e-7], {}, True, False),
        ("_contrib_getnnz", [np.where(f(4, 5) > 0, f(4, 5), 0).astype(np.float32)],
         {}, True, False),
        ("_contrib_getnnz", [np.where(f(4, 5) > 0, f(4, 5), 0).astype(np.float32)],
         {"axis": 1}, True, False),
        ("div_sqrt_dim", [f(2, 3, 16)], {}, False, True),
        ("_contrib_backward_gradientmultiplier", [f(3, 4)],
         {"scalar": -0.5}, False, True),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,inputs,kwargs,exact,grad", CASES,
                         ids=par.case_ids(CASES))
def test_op_matches_the_jax_package(name, inputs, kwargs, exact, grad):
    want, want_g = par.run(mx, name, inputs, kwargs, grad)
    with mt.cpu():
        got, got_g = par.run(mt, name, inputs, kwargs, grad)
    par.assert_match(got, want, TOL, exact)
    if grad is not False:
        par.assert_match([got_g], [want_g], TOL, False)


@pytest.mark.parametrize("kwargs", [
    {"kernel_size": 3, "max_displacement": 1, "pad_size": 1},
    {"kernel_size": 1, "max_displacement": 2, "stride1": 2, "stride2": 2,
     "pad_size": 2, "is_multiply": False}])
def test_correlation_gradient_matches_finite_differences(kwargs):
    """The JAX ``Correlation`` cannot be differentiated (its window sum
    has no reverse rule), so the port's gradient is held to central
    differences in float64 (``torch.autograd.gradcheck`` in its fast
    mode: random projections of the Jacobian)."""
    import torch
    fn = mt.nd.get_op("Correlation").get_fn(kwargs)
    g = torch.Generator().manual_seed(19)
    a, b = (torch.randn(1, 2, 5, 6, generator=g, dtype=torch.float64)
            .add_(0.3).requires_grad_() for _ in range(2))
    assert torch.autograd.gradcheck(fn, (a, b), eps=1e-6, atol=1e-7,
                                    fast_mode=True)


def test_contrib_frontends_reach_the_ops():
    """``nd.contrib.<short name>`` and the aliases are the registry's ops,
    each with the JAX package's differentiable flag (a non-differentiable
    op's output takes no gradient)."""
    for short in ("DeformablePSROIPooling", "PSROIPooling",
                  "DeformableConvolution", "bipartite_matching",
                  "index_copy", "count_sketch", "AdaptiveAvgPooling2D",
                  "index_array", "allclose", "getnnz", "div_sqrt_dim",
                  "backward_gradientmultiplier"):
        assert hasattr(mt.nd.contrib, short), short
    x = mt.nd.array(np.ones((2, 3), np.float32), ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        y = mt.nd.contrib.index_array(x)
    assert y.dtype == np.int32 and y.shape == (2, 3, 2)
    with mt.autograd.record():
        z = mt.nd.contrib.div_sqrt_dim(x)
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 1 / np.sqrt(3.0),
                               rtol=1e-6)


def test_unique_zipfian_draws_distinct_classes_and_reseeds():
    """Each row: ``n`` distinct classes in ``[0, range_max)``, at least
    ``n`` draws; a reseed repeats the draw bit for bit; ``rand_zipfian``'s
    expected counts are ``tries * log((c + 2) / (c + 1)) /
    log(range_max + 1)`` in float32 as the JAX package computes them."""
    with mt.cpu():
        mt.random.seed(7)
        s, tries = mt.nd._sample_unique_zipfian(range_max=500,
                                                shape=(3, 40))
        mt.random.seed(7)
        s2, tries2 = mt.nd._sample_unique_zipfian(range_max=500,
                                                  shape=(3, 40))
    a, t = s.asnumpy(), tries.asnumpy()
    assert a.dtype == np.int64 and a.shape == (3, 40) and t.shape == (3,)
    assert all(len(set(row)) == 40 for row in a)
    assert a.min() >= 0 and a.max() < 500 and (t >= 40).all()
    np.testing.assert_array_equal(a, s2.asnumpy())
    np.testing.assert_array_equal(t, tries2.asnumpy())
    true = mt.nd.array(np.array([0, 3, 99], np.float32), ctx=mt.cpu())
    mt.random.seed(3)
    samples, exp_true, exp_sampled = mt.nd.contrib.rand_zipfian(
        true, 16, 1000)
    mt.random.seed(3)
    _, tries = mt.nd._sample_unique_zipfian(range_max=1000, shape=(1, 16),
                                            ctx=mt.cpu())
    n = float(tries.asnumpy()[0])
    log_rm1 = np.log(1001.0)
    tv = np.array([0, 3, 99], np.float64)
    np.testing.assert_allclose(
        exp_true.asnumpy(),
        (np.log((tv + 2) / (tv + 1)) / log_rm1 * n).astype(np.float32),
        rtol=1e-6)
    sv = samples.asnumpy().astype(np.float64)
    np.testing.assert_allclose(
        exp_sampled.asnumpy(),
        (np.log((sv + 2) / (sv + 1)) / log_rm1 * n).astype(np.float32),
        rtol=1e-6)
    assert exp_true.dtype == np.float32 and samples.shape == (16,)
