"""The port's flash attention (plain PyTorch version, the CPU path of the
wrapper) held against the JAX package's Pallas kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: 2e-5 in fp32 (two fp32 online softmaxes that differ only in
summation order); bf16 inputs are compared in fp32 at 2e-2 (bf16 output
rounding, 8 mantissa bits), fp16 inputs at 4e-3 (fp16 output rounding,
11 bits; the JAX kernel also rounds P to fp16 for the PV product, as the
card's kernel does).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import flash_attention as jax_flash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention, flash_attention_plain
from mxnet_tpu_torch.ndarray import flash_attention as op_flash


_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
           "float16": (jnp.float16, torch.float16)}


def _both(q, k, v, causal=False, valid_len=None, dtype=np.float32):
    jdt, tdt = _DTYPES.get(dtype, (jnp.float32, torch.float32))
    ref = jax_flash(jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
                    jnp.asarray(v).astype(jdt), causal=causal,
                    interpret=True,
                    valid_len=None if valid_len is None
                    else jnp.asarray(valid_len))
    out = flash_attention(torch.from_numpy(q).to(tdt),
                          torch.from_numpy(k).to(tdt),
                          torch.from_numpy(v).to(tdt), causal=causal,
                          valid_len=None if valid_len is None
                          else torch.from_numpy(valid_len))
    assert out.dtype == tdt
    return (out.float().numpy(),
            np.asarray(ref.astype(jnp.float32)))


def _qkv(rs, bh, lq, lk, d):
    return (rs.randn(bh, lq, d).astype(np.float32),
            rs.randn(bh, lk, d).astype(np.float32),
            rs.randn(bh, lk, d).astype(np.float32))


def test_ragged_cross_lengths_d64():
    rs = np.random.RandomState(0)
    q, k, v = _qkv(rs, 3, 100, 75, 64)
    vl = np.array([75, 40.0, 3], np.float32)
    out, ref = _both(q, k, v, valid_len=vl)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_causal_lq_longer_than_lk_dead_rows():
    """Queries 0..49 see no key under the bottom-right causal mask
    (k <= q + Lk - Lq): they take uniform weights over the valid keys."""
    rs = np.random.RandomState(1)
    q, k, v = _qkv(rs, 2, 90, 40, 32)
    vl = np.array([40, 25], np.float32)
    out, ref = _both(q, k, v, causal=True, valid_len=vl)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(out[1, 0], v[1, :25].mean(0), atol=2e-5)


def test_valid_len_zero_and_4d_input():
    """(B,) lengths repeat b-major over the heads; a length of 0 gives a
    zero row."""
    rs = np.random.RandomState(2)
    q = rs.randn(2, 3, 70, 32).astype(np.float32)
    k = rs.randn(2, 3, 70, 32).astype(np.float32)
    v = rs.randn(2, 3, 70, 32).astype(np.float32)
    vl = np.array([0, 45], np.float32)
    out, ref = _both(q, k, v, valid_len=vl)
    assert out.shape == (2, 3, 70, 32)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    assert not out[0].any()


def test_unmasked_matches_full_softmax():
    rs = np.random.RandomState(3)
    q, k, v = _qkv(rs, 2, 33, 130, 16)
    out, ref = _both(q, k, v)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    s = (q / 4.0) @ k.transpose(0, 2, 1)
    p = np.exp(s - s.max(-1, keepdims=True))
    full = (p / p.sum(-1, keepdims=True)) @ v
    np.testing.assert_allclose(out, full, atol=2e-5)


def test_bf16_input():
    rs = np.random.RandomState(4)
    q, k, v = _qkv(rs, 2, 64, 64, 64)
    vl = np.array([64, 30], np.float32)
    out, ref = _both(q, k, v, valid_len=vl, dtype="bfloat16")
    np.testing.assert_allclose(out, ref, atol=2e-2)


# the cases above, on fp16 inputs: (name, seed, (BH, Lq, Lk, D) or the
# 4-d shape, causal, valid_len)
FP16_CASES = [
    ("ragged_cross_lengths_d64", 0, (3, 100, 75, 64), False, [75, 40.0, 3]),
    ("causal_lq_longer_than_lk_dead_rows", 1, (2, 90, 40, 32), True,
     [40, 25]),
    ("valid_len_zero_4d", 2, (2, 3, 70, 32), False, [0, 45]),
    ("unmasked", 3, (2, 33, 130, 16), False, None),
    ("bert_shape_ragged", 4, (2, 64, 64, 64), False, [64, 30]),
]


@pytest.mark.parametrize("name,seed,shape,causal,vl", FP16_CASES,
                         ids=[c[0] for c in FP16_CASES])
def test_fp16_input(name, seed, shape, causal, vl):
    """The plain version on fp16 inputs (the kernel's fp16 path on the
    card) against the JAX kernel in interpret mode on the same fp16
    values: output fp16, within 4e-3."""
    rs = np.random.RandomState(seed)
    if len(shape) == 4 and name.endswith("4d"):
        q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    else:
        q, k, v = _qkv(rs, *shape)
    vl = None if vl is None else np.array(vl, np.float32)
    out, ref = _both(q, k, v, causal=causal, valid_len=vl, dtype="float16")
    np.testing.assert_allclose(out, ref, atol=4e-3)
    if name.endswith("4d"):
        assert not out[0].any()


def test_op_signature_and_launch_count_on_cpu():
    """``nd.flash_attention`` is the registry op ``_contrib_flash_attention``
    over the kernel wrapper, with the op's argument order (q, k, v,
    valid_len, causal, scale); the CPU path runs the plain version and
    never counts a kernel launch."""
    from mxnet_tpu_torch.ndarray import get_op
    assert op_flash is not flash_attention
    assert get_op("flash_attention").name == "_contrib_flash_attention"
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rs, 4, 10, 10, 8))
    vl = torch.tensor([10.0, 4.0])
    before = flash_attention.launches
    a = flash_attention(q, k, v, vl, True, 0.5)
    b = flash_attention_plain(q, k, v, vl.repeat_interleave(2), True, 0.5)
    c = op_flash(q, k, v, vl, True, 0.5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c, b, rtol=0, atol=0)
    assert flash_attention.launches == before


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(MXNetError, match="dtypes"):
        flash_attention(q, q.double(), q)
    with pytest.raises(MXNetError, match="contiguous"):
        flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                        q)
    with pytest.raises(MXNetError, match="divide"):
        flash_attention(q, q, q, valid_len=torch.ones(3))
    m = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(MXNetError, match="different devices"):
        flash_attention(q, m, m)
    with pytest.raises(MXNetError, match="no kernel"):
        flash_attention(m, m, m)


@pytest.mark.parametrize("grad_on", [True, False])
def test_card_path_refuses_inputs_that_require_grad(monkeypatch, grad_on):
    """The card path (forced here by patching the device check and the
    launch) no longer refuses inputs that require grad: it launches once
    either way; with grad on it returns a tensor with a ``grad_fn`` whose
    backward fills q's gradient, with grad off one without.  (Until the
    backward existed this test held the refusal, under the same name.)"""
    import importlib
    mod = importlib.import_module("mxnet_tpu_torch.kernels.flash_attention")
    launched = []
    monkeypatch.setattr(mod, "_on_card", lambda t: True)
    monkeypatch.setattr(mod, "_launch", lambda q, *a: launched.append(1)
                        or mod.flash_attention_plain(q, *a))
    q = torch.randn(2, 8, 32, requires_grad=True)
    with torch.set_grad_enabled(grad_on):
        out = flash_attention(q, q, q)
    assert out.shape == q.shape and launched == [1]
    if grad_on:
        assert out.grad_fn is not None
        out.sum().backward()
        assert q.grad is not None and q.grad.shape == q.shape
        assert q.grad.abs().sum() > 0
    else:
        assert out.grad_fn is None
    with torch.no_grad():
        flash_attention(q.detach(), q.detach(), q.detach())
    assert len(launched) == 2


@pytest.mark.parametrize("case,match", [
    ("head dim", "head dim 48"),
    ("dtype", "dtype torch.float64"),
    ("unaligned", "v starts 8 bytes past a 16-byte boundary"),
    ("batch*heads", r"batch\*heads 65536"),
    ("aligned offset", None),          # 16 bytes in: taken, reaches _kernel
])
def test_card_path_checks_raise_before_any_launch(monkeypatch, case, match):
    """On the card path (forced by patching the device check) the wrapper
    refuses what the kernel does not take with MXNetError before it builds
    or launches anything: ``_kernel`` is replaced by one that fails if
    reached.  A contiguous view 16 bytes into its storage is taken."""
    import importlib
    mod = importlib.import_module("mxnet_tpu_torch.kernels.flash_attention")
    monkeypatch.setattr(mod, "_on_card", lambda t: True)

    def unreachable():
        raise AssertionError("kernel reached")

    monkeypatch.setattr(mod, "_kernel", unreachable)
    q = torch.zeros(2, 8, 64)
    args = {
        "head dim": (torch.zeros(2, 8, 48),) * 3,
        "dtype": (torch.zeros(2, 8, 64, dtype=torch.float64),) * 3,
        "unaligned": (q, q, torch.zeros(2 * 8 * 64 + 2)[2:].view(2, 8, 64)),
        "batch*heads": (torch.zeros(65536, 1, 32),) * 3,
        "aligned offset": (q, q,
                           torch.zeros(2 * 8 * 64 + 4)[4:].view(2, 8, 64)),
    }[case]
    before = flash_attention.launches
    with pytest.raises(AssertionError if match is None else MXNetError,
                       match=match or "kernel reached"):
        flash_attention(*args)
    assert flash_attention.launches == before
