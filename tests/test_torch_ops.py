"""The port's ``nd`` ops of the pretraining loss (``log_softmax``, ``pick``,
``sum``, ``mean``) held against the JAX package's registry ops on the same
numpy inputs, over axis, keepdims, exclude and temperature.

Tolerance: fp32 1e-6 relative + 1e-6 (one fp32 reduction each, summation
orders differ); bf16 inputs reduce in fp32 in both and round once to bf16:
compared at 1e-2 relative.  ``pick`` is a gather: exact.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError

RS = np.random.RandomState(0)
X = RS.randn(3, 4, 5).astype(np.float32) * 3


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.asnumpy(), np.float32)


@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("temperature", [None, 2.5])
def test_log_softmax(axis, temperature):
    want = mx.nd.log_softmax(mx.nd.array(X), axis=axis,
                             temperature=temperature)
    got = nd.log_softmax(torch.from_numpy(X), axis=axis,
                         temperature=temperature)
    assert got.dtype == torch.float32 and got.shape == X.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_log_softmax_dtype_and_refusal():
    got = nd.log_softmax(torch.from_numpy(X), dtype="float64")
    assert got.dtype == torch.float64
    with pytest.raises(MXNetError, match="use_length"):
        nd.log_softmax(torch.from_numpy(X), use_length=True)


@pytest.mark.parametrize("axis", [-1, 0, 1, 2])
@pytest.mark.parametrize("keepdims", [False, True])
def test_pick(axis, keepdims):
    n = X.shape[axis]
    shape = list(X.shape)
    del shape[axis]
    idx = RS.randint(0, n, shape).astype(np.float32)
    want = mx.nd.pick(mx.nd.array(X), mx.nd.array(idx), axis=axis,
                      keepdims=keepdims)
    got = nd.pick(torch.from_numpy(X), torch.from_numpy(idx), axis=axis,
                  keepdims=keepdims)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_pick_modes():
    x = torch.arange(12.0).reshape(3, 4)
    idx = torch.tensor([-1, 4, 9])
    assert nd.pick(x, idx).tolist() == [0.0, 7.0, 11.0]           # clip
    assert nd.pick(x, idx, mode="wrap").tolist() == [3.0, 4.0, 9.0]
    with pytest.raises(MXNetError, match="mode"):
        nd.pick(x, idx, mode="raise")


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("axis,keepdims,exclude", [
    (None, False, False), (None, True, False), (1, False, False),
    ((0, 2), True, False), (-1, False, True), ((0, 1, 2), False, True),
    ((0, 2), True, True)])
def test_reductions(op, axis, keepdims, exclude):
    want = getattr(mx.nd, op)(mx.nd.array(X), axis=axis, keepdims=keepdims,
                              exclude=exclude)
    got = getattr(nd, op)(torch.from_numpy(X), axis=axis,
                          keepdims=keepdims, exclude=exclude)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_reductions_of_bf16_accumulate_in_fp32(op):
    """A bf16 input reduces in fp32 and returns bf16 in both packages."""
    big = RS.rand(4096).astype(np.float32) + 1.0
    jx = mx.nd.array(big).astype("bfloat16")
    want = getattr(mx.nd, op)(jx)
    got = getattr(nd, op)(torch.from_numpy(big).bfloat16())
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2)


def test_out_keeps_its_dtype():
    c = torch.zeros(4, dtype=torch.bfloat16)
    jc = mx.nd.zeros((4,), dtype="bfloat16")
    a = RS.randn(4, 6).astype(np.float32)
    r = nd.mean(torch.from_numpy(a), axis=1, out=c)
    jr = mx.nd.mean(mx.nd.array(a), axis=1, out=jc)
    assert r is c and jr is jc and c.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(c), _np(jc), rtol=1e-2)


def test_loss_ops_are_differentiable():
    """The pretraining loss runs through them under autograd; its gradient
    matches torch's own cross-entropy's."""
    logits = torch.from_numpy(X[0]).requires_grad_()
    labels = torch.tensor([0, 3, 1, 4])
    loss = -nd.mean(nd.pick(nd.log_softmax(logits), labels))
    loss.backward()
    ref = logits.detach().clone().requires_grad_()
    torch.nn.functional.cross_entropy(ref, labels).backward()
    torch.testing.assert_close(loss, torch.nn.functional.cross_entropy(
        ref.detach(), labels))
    torch.testing.assert_close(logits.grad, ref.grad)
