"""The 46 ops of ``ops_misc`` the port took over with the rest of the op
files, held against the JAX package's: ``add_n``, the KL sparsity
regulariser, the eight pdfs, ``fft``/``ifft``, ``boolean_mask``,
``arange_like``, ``quadratic``, ``gradientmultiplier``, ``Crop``,
``im2col``/``col2im``, ``histogram``, the ``*_element_0index`` pair,
``split_v2``, ``hawkesll``, ``_square_sum``, ``_hypot``, the logical
binaries, the creation ops, the assignment ops, ``_rnn_param_concat`` and
the straight-through estimators.

As in ``test_torch_ops_tail18.py``: the same seeded numpy inputs through
both packages' ``nd`` frontends on the CPU, the outputs and, where the JAX
op is differentiable, the gradient of the outputs' sum with respect to
the first input (the case says another where the first takes none)
compared exactly where the op copies, indexes, counts or creates, else
within ``TOL`` (fp32; ``linspace`` and ``histogram``'s edges differ
from ``jnp.linspace``'s in the last bit).  ``_set_value`` fills ``out=``
(MXNet's C-API form).  ``histogram`` without a range and ``boolean_mask``
read the host: a hybridized block that calls them runs eagerly.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from tests import _op_parity as par

TOL = dict(rtol=1e-5, atol=1e-6)


def _cases():
    rs = np.random.default_rng(180)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    u = lambda lo, hi, *s: rs.uniform(lo, hi, s).astype(np.float32)  # noqa
    cnt = lambda *s: rs.integers(0, 8, s).astype(np.float32)  # noqa: E731
    simplex = rs.dirichlet(np.ones(4), size=(2, 3)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32)
    idx = np.array([4, 0, 2, 2], np.float32)
    halves = np.array([[-2.5, -0.5, 0.5, 1.5], [2.5, -1.2, 0.7, 3.0]],
                      np.float32)
    zeros = f(3, 4)
    zeros[0, :2] = 0.0
    hawkes = [u(0.2, 1.0, 2, 3), u(0.1, 0.5, 3), u(0.5, 2.0, 3),
              u(0.0, 0.5, 2, 3), u(0.1, 1.0, 2, 5),
              rs.integers(0, 3, (2, 5)).astype(np.float32),
              np.array([5, 3], np.float32), np.array([6.0, 4.0], np.float32)]
    k2 = dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 1))
    # name, inputs, kwargs, exact, gradient
    return [
        ("add_n", [f(3, 4), f(3, 4), f(3, 4)], {}, False, True),
        ("IdentityAttachKLSparseReg", [f(4, 3)],
         {"sparseness_target": 0.2, "penalty": 0.01}, False, True),
        ("_random_pdf_uniform", [u(-1, 1, 2, 5), np.array([-1.5, -1], np.float32),
                                 np.array([1, 2], np.float32)], {}, False, 1),
        ("_random_pdf_normal", [f(2, 5), f(2), u(0.5, 2, 2)],
         {"is_log": True}, False, True),
        ("_random_pdf_gamma", [u(0.1, 3, 2, 5), u(0.5, 3, 2), u(0.5, 2, 2)],
         {}, False, True),
        ("_random_pdf_exponential", [u(0.1, 3, 2, 5), u(0.5, 2, 2)], {},
         False, True),
        ("_random_pdf_poisson", [cnt(2, 5), u(0.5, 4, 2)], {"is_log": True},
         False, 1),
        ("_random_pdf_negative_binomial", [cnt(2, 5), u(1, 4, 2),
                                           u(0.2, 0.8, 2)], {}, False, 1),
        ("_random_pdf_generalized_negative_binomial",
         [cnt(2, 5), u(1, 4, 2), u(0.2, 1.5, 2)], {"is_log": True}, False,
         1),
        ("_random_pdf_dirichlet", [simplex, u(0.5, 3, 2, 4)], {}, False,
         True),
        ("_contrib_fft", [f(3, 8)], {}, False, True),
        ("_contrib_ifft", [f(3, 16)], {}, False, True),
        ("_contrib_boolean_mask", [f(5, 3), mask], {}, True, True),
        ("_contrib_arange_like", [f(3, 4)],
         {"start": 1.0, "step": 0.5, "repeat": 2}, True, False),
        ("_contrib_arange_like", [f(3, 4)], {"axis": 1}, True, False),
        ("_contrib_quadratic", [f(3, 4)], {"a": 0.5, "b": -1.0, "c": 2.0},
         False, True),
        ("_contrib_gradientmultiplier", [f(3, 4)], {"scalar": -0.5}, True,
         True),
        ("Crop", [f(2, 3, 8, 8)], {"h_w": (4, 5), "offset": (1, 2)}, True,
         True),
        ("Crop", [f(2, 3, 8, 8), f(2, 3, 3, 5)],
         {"num_args": 2, "center_crop": True}, True, True),
        ("im2col", [f(2, 3, 6, 7)], k2, True, True),
        ("im2col", [f(2, 2, 5, 5)], {"kernel": (2, 2)}, True, True),
        ("col2im", [f(2, 27, 15)], dict(k2, output_size=(6, 7)), False,
         True),
        ("histogram", [f(50)], {"bin_cnt": 5, "range": (-2.0, 2.0)}, False,
         False),
        ("histogram", [f(50)], {"bin_cnt": 4}, False, False),
        ("histogram", [f(50), np.array([-1, 0, 0.5, 2], np.float32)], {},
         True, False),
        ("choose_element_0index", [f(4, 5), idx], {}, True, True),
        ("fill_element_0index", [f(4, 5), f(4), idx], {}, True, True),
        ("split_v2", [f(6, 4)], {"sections": 3}, True, True),
        ("split_v2", [f(6, 4)], {"indices": (0, 2, 5)}, True, True),
        ("split_v2", [f(6, 4)], {"indices": (1,), "axis": 1}, True, True),
        ("split_v2", [f(6, 4)], {"sections": 4, "axis": 1,
                                 "squeeze_axis": True}, True, True),
        ("_contrib_hawkesll", hawkes, {}, False, True),
        ("_square_sum", [f(3, 4)], {"axis": 1}, False, True),
        ("_square_sum", [f(2, 3, 4)], {"axis": (0,), "exclude": True,
                                       "keepdims": True}, False, True),
        ("_hypot", [f(3, 4), f(3, 4)], {}, False, True),
        ("_hypot_scalar", [f(3, 4), np.array(1.5, np.float32)], {}, False,
         True),
        ("_logical_and", [zeros, zeros.T.copy().reshape(3, 4)], {}, True,
         False),
        ("_logical_or", [zeros, np.zeros((3, 4), np.float32)], {}, True,
         False),
        ("_logical_xor", [zeros, f(3, 4)], {}, True, False),
        ("_zeros", [], {"shape": (2, 3)}, True, False),
        ("_ones", [], {"shape": (2, 3), "dtype": "int32"}, True, False),
        ("_full", [], {"shape": (2, 3), "value": 2.5}, True, False),
        ("_arange", [], {"start": 1.0, "stop": 5.0, "step": 0.5,
                         "repeat": 2}, True, False),
        ("_linspace", [], {"start": -1.0, "stop": 2.0, "num": 7}, False,
         False),
        ("_linspace", [], {"start": 0.0, "stop": 1.0, "num": 5,
                           "endpoint": False}, True, False),
        ("_eye", [], {"N": 3, "M": 4, "k": 1}, True, False),
        ("_slice_assign", [f(4, 5), f(2, 5)], {"begin": (1,), "end": (3,)},
         True, True),
        ("_slice_assign", [f(4, 5), f(4, 2)],
         {"begin": (None, 4), "end": (None, 0), "step": (None, -2)}, True,
         True),
        ("_slice_assign_scalar", [f(4, 5)],
         {"begin": (0, 1), "end": (4, 5), "step": (2, 2), "scalar": 7.0},
         True, True),
        ("_onehot_encode", [idx, f(4, 6)], {}, True, False),
        ("_scatter_set_nd", [f(3, 4), f(2),
                             np.array([[0, 2], [1, 3]], np.float32)], {},
         True, False),
        ("_copyto", [f(3, 4)], {}, True, True),
        ("split_v2", [f(6, 4), (1, 4)], {"axis": 0}, True, True),
        ("_identity_with_attr_like_rhs", [f(3, 4), f(3, 4)], {}, True, True),
        ("_rnn_param_concat", [f(3, 4), f(5)], {"num_args": 2}, True, True),
        ("round_ste", [halves], {}, True, True),
        ("sign_ste", [zeros], {}, True, True),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,inputs,kwargs,exact,grad", CASES,
                         ids=par.case_ids(CASES))
def test_op_matches_jax(name, inputs, kwargs, exact, grad):
    """Outputs (and the gradient) as the JAX package's, exactly or within
    ``TOL``; the dtypes too."""
    want, want_g = par.run(mx, name, inputs, kwargs, grad)
    with mt.cpu():
        got, got_g = par.run(mt, name, inputs, kwargs, grad)
    par.assert_match(got, want, TOL, exact)
    if grad:
        par.assert_match([got_g], [want_g], TOL, False)


def test_set_value_fills_out_as_jax():
    """``nd._set_value(src, out=arr)`` fills ``arr``, in both packages."""
    want = mx.nd._set_value(2.5, out=mx.nd.zeros((2, 3))).asnumpy()
    with mt.cpu():
        arr = mt.nd.zeros((2, 3))
        got = mt.nd._set_value(2.5, out=arr)
    assert got is arr
    np.testing.assert_array_equal(arr.asnumpy(), want)
    with pytest.raises(MXNetError):
        mt.nd._set_value(1.0)


def test_fft_round_trip_scales_by_the_length():
    """``ifft(fft(x)) == d * x`` (the unnormalised inverse), and
    ``nd.contrib`` holds both under their short names."""
    x = np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32)
    with mt.cpu():
        back = mt.nd.contrib.ifft(mt.nd.contrib.fft(mt.nd.array(x)))
    np.testing.assert_allclose(back.asnumpy(), 8 * x, rtol=1e-5, atol=1e-5)
    for short in ("fft", "ifft", "boolean_mask", "arange_like", "quadratic",
                  "gradientmultiplier", "hawkesll"):
        assert callable(getattr(mt.nd.contrib, short))


class _Masked(mt.gluon.HybridBlock):
    """A block whose forward keeps the rows its mask selects and counts
    a histogram of them: both read the host."""

    def hybrid_forward(self, F, x, m):
        kept = F.contrib.boolean_mask(x, m)
        hist, _ = F.histogram(kept, bin_cnt=3)
        return kept * 2.0, F.bincount(F.cast(m, dtype="int32")), hist


def test_host_reading_block_runs_eagerly_when_hybridized():
    """A hybridized block that calls ``boolean_mask``, ``bincount`` and an
    unranged ``histogram`` warns once that it reads the host and then
    runs eagerly (counted in ``eager_calls``), as Mask-RCNN's
    ``reads_host`` does; every call's outputs are the eager block's."""
    rng = np.random.default_rng(5)
    net = _Masked()
    net.initialize(ctx=mt.cpu())
    x = torch.as_tensor(rng.standard_normal((6, 3)).astype(np.float32))
    masks = [torch.tensor([1, 0, 1, 1, 0, 1.0]),
             torch.tensor([0, 1, 1, 0, 0, 0.0])]
    eager = [net(x, m) for m in masks]
    net.hybridize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = [net(x, m) for m in masks + masks]
    assert net.reads_host and net.eager_calls == 3
    assert sum("reads the host" in str(w.message) for w in caught) == 1
    for got, want in zip(outs, eager + eager):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_value_dependent_shapes_refuse_shape_inference():
    """On ``meta`` tensors (``infer_shape``) ``boolean_mask`` and an
    unranged ``histogram`` raise ``MXNetError`` naming the op; a ranged
    histogram infers."""
    s = mt.sym._contrib_boolean_mask(mt.sym.var("x"), mt.sym.var("m"))
    with pytest.raises(MXNetError, match="boolean_mask"):
        s.infer_shape(x=(5, 3), m=(5,))
    h = mt.sym.histogram(mt.sym.var("x"), bin_cnt=4)
    with pytest.raises(MXNetError, match="histogram"):
        h.infer_shape(x=(10,))
    ranged = mt.sym.histogram(mt.sym.var("x"), bin_cnt=4, range=(0.0, 1.0))
    assert ranged.infer_shape(x=(10,))[1] == [(4,)]    # one output, as JAX
