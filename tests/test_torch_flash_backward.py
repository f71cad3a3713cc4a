"""The port's flash-attention backward (``_FlashAttention``, whose backward
is ``flash_attention_backward``) held against ``jax.vjp`` of the JAX
package's ``flash_attention`` (Pallas kernel in interpret mode forward, a
custom VJP over ``_chunked_reference`` backward), from the same numpy
inputs and output gradient.

Tolerance: fp32 ``atol=5e-5, rtol=1e-4`` (two fp32 chunked backwards that
differ in summation order); bf16 ``atol=rtol=2e-2`` (bf16 inputs, output
gradient and result rounding, fp32 accumulation in both).  Each side is
also held against a float64 run of the port's backward on the same
(rounded) inputs, first, so that a miss names the side that moved.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import flash_attention as jax_flash
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.kernels import flash_attention, flash_attention_plain

TOL = {"float32": dict(atol=5e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}

# (name, shape of q (B, H, Lq, D) or (BH, Lq, D), Lk, causal, valid_len)
CASES = [
    ("ragged (B,) 4-D", (2, 3, 100, 64), 100, False, [100.0, 37.0]),
    ("ragged (BH,) Lk=150", (4, 70, 32), 150, False,
     [150.0, 129.0, 64.0, 1.0]),
    ("valid_len 0: dead rows, D=128", (3, 40, 128), 40, False,
     [0.0, 40.0, 17.0]),
    ("causal Lq > Lk: dead rows", (2, 90, 32), 40, True, [40.0, 25.0]),
    ("causal Lq < Lk", (2, 50, 64), 200, True, [200.0, 130.0]),
    ("unmasked Lk=130, D=128", (2, 33, 128), 130, False, None),
]


def _draw(seed, qshape, lk):
    rs = np.random.RandomState(seed)
    kshape = qshape[:-2] + (lk, qshape[-1])
    return (rs.randn(*qshape).astype(np.float32),
            rs.randn(*kshape).astype(np.float32),
            rs.randn(*kshape).astype(np.float32),
            rs.randn(*qshape).astype(np.float32))


def _round(a, dtype):
    """numpy fp32 values as the dtype holds them."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).double().numpy()


def _port_grads(q, k, v, g, causal, vl, dtype):
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*ts, None if vl is None
                          else torch.tensor(vl, dtype=torch.float32),
                          causal)
    assert out.dtype == tdt and out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(tdt))
    for t in ts:
        assert t.grad.dtype == tdt
    return [t.grad.double().numpy() for t in ts]


def _jax_grads(q, k, v, g, causal, vl, dtype):
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    vlj = None if vl is None else jnp.asarray(np.array(vl, np.float32))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(
        a, b, c, causal=causal, interpret=True, valid_len=vlj), *args)
    grads = vjp(jnp.asarray(g).astype(jdt))
    for x in grads:
        assert x.dtype == jdt
    return [np.asarray(x.astype(jnp.float32)).astype(np.float64)
            for x in grads]


def _f64_grads(q, k, v, g, causal, vl, dtype):
    """The port's backward in float64 on the inputs as ``dtype`` holds
    them."""
    ts = [torch.from_numpy(_round(a, dtype)).requires_grad_()
          for a in (q, k, v)]
    out = flash_attention(*ts, None if vl is None
                          else torch.tensor(vl, dtype=torch.float32),
                          causal)
    out.backward(torch.from_numpy(_round(g, dtype)))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,qshape,lk,causal,vl", CASES,
                         ids=[c[0] for c in CASES])
def test_gradients_match_jax_vjp(name, qshape, lk, causal, vl, dtype):
    q, k, v, g = _draw(len(name), qshape, lk)
    port = _port_grads(q, k, v, g, causal, vl, dtype)
    ref = _jax_grads(q, k, v, g, causal, vl, dtype)
    exact = _f64_grads(q, k, v, g, causal, vl, dtype)
    tol = TOL[dtype]
    for which, p, r, x in zip("qkv", port, ref, exact):
        np.testing.assert_allclose(p, x, err_msg=f"port d{which} vs "
                                   f"float64", **tol)
        np.testing.assert_allclose(r, x, err_msg=f"JAX d{which} vs "
                                   f"float64", **tol)
        np.testing.assert_allclose(p, r, err_msg=f"port d{which} vs JAX",
                                   **tol)
    if vl is not None and 0.0 in vl:
        # a length-0 row outputs 0 and passes no gradient to q
        dq = port[0].reshape(-1, qshape[-2], qshape[-1])
        assert not dq[vl.index(0.0)].any()


def test_dead_rows_pass_dv_but_no_dq():
    """Under the bottom-right causal mask with Lq > Lk, queries
    0..Lq-Lk-1 see no key: their weights are the key mask (uniform over
    the valid keys), so their dq is 0 while dv takes their gradient."""
    rs = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rs.randn(1, n, 16).astype(np.float64))
               .requires_grad_() for n in (12, 4, 4))
    g = torch.zeros(1, 12, 16, dtype=torch.float64)
    g[0, 0] = 1.0                     # only a dead row's output gradient
    out = flash_attention(q, k, v, torch.tensor([3.0]), True)
    out.backward(g)
    assert not q.grad.any() and not k.grad.any()
    want = torch.zeros(1, 4, 16, dtype=torch.float64)
    want[0, :3] = 1.0 / 3.0
    torch.testing.assert_close(v.grad, want)


@pytest.mark.parametrize("causal,vl", [(False, [37.0, 5.0]),
                                       (True, [30.0, 0.0])])
def test_gradcheck_float64(causal, vl):
    rs = np.random.RandomState(8)
    ts = [torch.from_numpy(rs.randn(2, n, 8)).requires_grad_()
          for n in (20, 37, 37)]
    vlt = torch.tensor(vl)
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention(a, b, c, vlt, causal), ts)


def _saved_elements_per_row_block(fn, bh):
    """Sum over every tensor autograd saves while ``fn`` runs, of its
    elements per (batch*head) row block."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return sum(sizes) / bh, out


def test_backward_keeps_no_lq_by_lk_matrix():
    """All that the node saves, together, is smaller than one (Lq, Lk)
    score matrix per row block; autograd through the plain version keeps
    every chunk's probabilities (at least Lq*Lk per row block), which
    shows the check can fail."""
    bh, lq, lk, d = 2, 256, 384, 16
    rs = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rs.randn(bh, n, d).astype(np.float32))
               .requires_grad_() for n in (lq, lk, lk))
    vl = torch.tensor([384.0, 200.0])
    ours, out = _saved_elements_per_row_block(
        lambda: flash_attention(q, k, v, vl), bh)
    assert ours < lq * lk, ours
    out.sum().backward()
    plain, _ = _saved_elements_per_row_block(
        lambda: flash_attention_plain(q, k, v, vl, False, 0.25), bh)
    assert plain >= lq * lk, plain


def test_node_records_under_record_and_not_under_pause():
    q = torch.randn(2, 10, 8, requires_grad=True)
    with autograd.record():
        out = flash_attention(q, q, q)
        with autograd.pause():
            paused = flash_attention(q, q, q)
    assert out.grad_fn is not None and out.requires_grad
    assert paused.grad_fn is None and not paused.requires_grad
    assert flash_attention(q.detach(), q.detach(), q.detach()).grad_fn is None
    autograd.backward(out)
    assert q.grad is not None and q.grad.abs().sum() > 0


def test_valid_len_takes_no_gradient():
    q = torch.randn(2, 10, 8, requires_grad=True)
    vl = torch.tensor([10.0, 4.0], requires_grad=True)
    flash_attention(q, q, q, vl).sum().backward()
    assert vl.grad is None and q.grad is not None


def test_card_path_backward_runs_the_torch_backward(monkeypatch):
    """On the card path (forced by patching the device check and the
    launch) the forward goes through ``_launch`` once and the backward is
    ``flash_attention_backward``, the same function as on the CPU."""
    import importlib
    mod = importlib.import_module("mxnet_tpu_torch.kernels.flash_attention")
    launched, backward = [], []
    monkeypatch.setattr(mod, "_on_card", lambda t: True)
    monkeypatch.setattr(mod, "_launch", lambda *a: launched.append(1)
                        or mod.flash_attention_plain(*a))
    real = mod.flash_attention_backward
    monkeypatch.setattr(mod, "flash_attention_backward",
                        lambda *a: backward.append(1) or real(*a))
    rs = np.random.RandomState(10)
    q = torch.from_numpy(rs.randn(2, 12, 16).astype(np.float32)) \
        .requires_grad_()
    out = flash_attention(q, q, q, torch.tensor([12.0, 7.0]))
    out.backward(torch.ones_like(out))
    assert launched == [1] and backward == [1]
    q2 = q.detach().clone().requires_grad_()
    out2 = flash_attention_plain(q2, q2, q2, torch.tensor([12.0, 7.0]),
                                 False, 0.25)
    out2.backward(torch.ones_like(out2))
    torch.testing.assert_close(q.grad, q2.grad, atol=1e-5, rtol=1e-5)
