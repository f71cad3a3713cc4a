"""The 44 ops of ``ops_tail`` the port took over with the rest of the op
files, held against the JAX package's: the special functions, the
activation tail, numpy's tail, the shape tail and masked softmax.

Every case feeds the same seeded numpy inputs through both packages'
``nd`` frontends on the CPU and compares the outputs and, where the JAX op
is differentiable, the gradient of the outputs' sum with respect to the
first input (the second for ``heaviside``, whose gradient in the first
is 0): exactly where the op copies, tests, indexes or counts, else
within ``TOL`` (fp32), the special functions too (``gammainc``'s and
``zeta``'s gradients in ``a`` and ``x``, which torch lacks, are the
port's own: ``ops_tail._gammainc_da``/``_zeta_dx``).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from tests import _op_parity as par

TOL = dict(rtol=1e-5, atol=1e-6)


def _cases():
    rs = np.random.default_rng(18)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    u = lambda lo, hi, *s: rs.uniform(lo, hi, s).astype(np.float32)  # noqa
    i32 = lambda lo, hi, *s: rs.integers(lo, hi, s).astype(np.int32)  # noqa
    odd = np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, -2.5]],
                   np.float32)
    mask = (rs.uniform(size=(3, 5)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    xp = np.sort(u(-2, 2, 7))
    zeros = f(3, 4)
    zeros[0, :2] = 0.0
    T = TOL
    # name, inputs, kwargs, exact, gradient, tolerance
    return [
        ("erfc", [f(3, 4)], {}, False, True, T),
        ("bessel_i0", [2 * f(3, 4)], {}, False, True, T),
        ("bessel_i1", [2 * f(3, 4)], {}, False, True, T),
        ("bessel_i0e", [2 * f(3, 4)], {}, False, True, T),
        ("bessel_i1e", [2 * f(3, 4)], {}, False, True, T),
        ("erfcinv", [u(0.05, 1.95, 3, 4)], {}, False, True, T),
        ("polygamma", [u(0.5, 3, 3, 4)], {"n": 1}, False, True, T),
        ("polygamma", [u(0.5, 3, 3, 4)], {}, False, True, T),
        ("gammainc", [u(0.5, 3, 3, 4), u(0.1, 5, 3, 4)], {}, False, True,
         T),
        ("gammaincc", [u(0.5, 3, 3, 4), u(0.1, 5, 3, 4)], {}, False, True,
         T),
        ("zeta", [u(1.5, 4, 3, 4), u(0.5, 3, 3, 4)], {}, False, True, T),
        ("gelu", [f(3, 4)], {}, False, True, T),
        ("gelu", [f(3, 4)], {"approximation": "tanh"}, False, True, T),
        ("log_sigmoid", [4 * f(3, 4)], {}, False, True, T),
        ("mish", [4 * f(3, 4)], {}, False, True, T),
        ("silu", [4 * f(3, 4)], {}, False, True, T),
        ("swish", [4 * f(3, 4)], {}, False, True, T),
        ("hard_swish", [4 * f(3, 4)], {}, False, True, T),
        ("isnan", [odd], {}, True, False, T),
        ("isinf", [odd], {}, True, False, T),
        ("isfinite", [odd], {}, True, False, T),
        ("isposinf", [odd], {}, True, False, T),
        ("isneginf", [odd], {}, True, False, T),
        ("copysign", [f(3, 4), f(3, 4)], {}, True, True, T),
        ("gcd", [i32(-30, 30, 3, 4), i32(1, 30, 3, 4)], {}, True, False, T),
        ("lcm", [i32(-30, 30, 3, 4), i32(1, 30, 3, 4)], {}, True, False, T),
        ("heaviside", [zeros, f(3, 4)], {}, True, 1, T),
        ("ldexp", [f(3, 4), u(-3, 3, 3, 4)], {}, False, True, T),
        ("logaddexp", [f(3, 4), f(3, 4)], {}, False, True, T),
        ("interp", [u(-2.5, 2.5, 10), xp, f(7)], {}, False, True, T),
        ("nan_to_num", [odd], {}, True, True, T),
        ("nan_to_num", [odd], {"nan": 1.5, "posinf": 9.0, "neginf": -9.0},
         True, True, T),
        ("cumprod", [u(0.5, 1.5, 3, 4)], {"axis": 1}, False, True, T),
        ("cumprod", [u(0.5, 1.5, 3, 4)], {}, False, True, T),
        ("logsumexp", [f(3, 4)], {"axis": 1, "keepdims": True}, False, True,
         T),
        ("logsumexp", [f(3, 4)], {}, False, True, T),
        ("bincount", [i32(0, 6, 20)], {}, True, False, T),
        ("bincount", [i32(0, 6, 20), f(20)], {"minlength": 9}, False, False,
         T),
        ("digitize", [u(-3, 3, 12), np.array([-1, 0, 1.5], np.float32)],
         {}, True, False, T),
        ("digitize", [np.array([-1, 0, 0.5, 1.5, 2], np.float32),
                      np.array([-1, 0, 1.5], np.float32)], {"right": True},
         True, False, T),
        ("digitize", [u(-3, 3, 12), np.array([1.5, 0, -1], np.float32)],
         {}, True, False, T),
        ("searchsorted", [np.array([-1, 0, 0, 1.5], np.float32),
                          np.array([-2, 0, 0.5, 1.5, 3], np.float32)], {},
         True, False, T),
        ("searchsorted", [np.array([-1, 0, 0, 1.5], np.float32),
                          np.array([-2, 0, 0.5, 1.5, 3], np.float32)],
         {"side": "right"}, True, False, T),
        ("ediff1d", [f(3, 4)], {}, False, True, T),
        ("trapz", [f(3, 5)], {"dx": 0.5}, False, True, T),
        ("trapz", [f(3, 5), np.sort(u(0, 2, 5))], {"axis": 1}, False, True,
         T),
        ("einsum", [f(3, 4), f(4, 5)], {"subscripts": "ij,jk->ik"}, False,
         True, T),
        ("einsum", [f(2, 3, 4)], {"subscripts": "bij->bji"}, True, True, T),
        ("roll", [f(3, 4)], {"shift": 2, "axis": 1}, True, True, T),
        ("roll", [f(3, 4)], {"shift": 5}, True, True, T),
        ("rot90", [f(3, 4, 2)], {}, True, True, T),
        ("rot90", [f(3, 4, 2)], {"k": 3, "axes": (1, 2)}, True, True, T),
        ("tensordot", [f(3, 4, 5), f(4, 5, 2)], {}, False, True, T),
        ("tensordot", [f(3, 4), f(4, 2)], {"axes": ((1,), (0,))}, False,
         True, T),
        ("vander", [f(4)], {"N": 3}, False, True, T),
        ("vander", [f(4)], {"increasing": True}, False, True, T),
        ("meshgrid", [f(3), f(4)], {}, True, True, T),
        ("meshgrid", [f(3), f(4), f(2)], {"indexing": "ij"}, True, True, T),
        ("meshgrid", [f(3), f(4)], {"sparse": True}, True, True, T),
        ("kron", [f(2, 3), f(3, 2)], {}, False, True, T),
        ("masked_softmax", [f(3, 5), mask], {}, False, True, T),
        ("masked_softmax", [f(3, 5), mask], {"axis": 0, "temperature": 2.0},
         False, True, T),
        ("masked_log_softmax", [f(3, 5), mask], {}, False, True, T),
    ]


CASES = _cases()


@pytest.mark.parametrize("name,inputs,kwargs,exact,grad,tol", CASES,
                         ids=par.case_ids(CASES))
def test_op_matches_jax(name, inputs, kwargs, exact, grad, tol):
    """Outputs (and the first input's gradient) as the JAX package's:
    exact, or within the case's tolerance; the dtypes too."""
    want, want_g = par.run(mx, name, inputs, kwargs, grad)
    with mt.cpu():
        got, got_g = par.run(mt, name, inputs, kwargs, grad)
    par.assert_match(got, want, tol, exact)
    if grad:
        par.assert_match([got_g], [want_g], tol, False)


def test_integer_ops_take_no_gradient():
    """``gcd``'s and ``digitize``'s outputs and the predicates' carry no
    gradient (the JAX package registers them not differentiable)."""
    with mt.cpu():
        x = mt.nd.array(np.array([0.5, np.nan, 2.0], np.float32))
        x.attach_grad()
        with mt.autograd.record():
            ys = [mt.nd.isnan(x), mt.nd.digitize(
                x, mt.nd.array(np.array([0.0, 1.0], np.float32)))]
        assert all(not y._data.requires_grad for y in ys)


def test_bincount_reads_the_host_and_refuses_shape_inference():
    """``bincount``'s length is its input's largest value + 1: the op
    counts a host read, and on ``meta`` tensors it raises naming
    itself."""
    from mxnet_tpu_torch.ndarray.register import host_reads
    before = host_reads()[0]
    with mt.cpu():
        out = mt.nd.bincount(mt.nd.array(np.array([3, 0, 3], np.int32),
                                         dtype="int32"))
    assert out.asnumpy().tolist() == [1, 0, 0, 2]
    assert host_reads() == (before + 1, "bincount")
    s = mt.sym.bincount(mt.sym.var("x"))
    with pytest.raises(MXNetError, match="bincount"):
        s.infer_shape(x=(4,))
