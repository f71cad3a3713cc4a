"""The sliding-window attention ops and the Longformer encoder of the port,
held against the JAX package on the CPU (``mxnet_tpu/ndarray/
ops_sldwin.py``, ``mxnet_tpu/gluon/model_zoo/transformer.py:555-680``).

Small shapes: B=2, L=24, H=2 with dilations (1, 3), D=8, w=4, both the
symmetric and the one-sided band; the encoder at 2 layers, 64 units, 4
heads with dilations (1, 3, 1, 3).  fp32 within 1e-5 (the band's sums
run in another order than XLA's), gradients against the JAX package's
autodiff through its gather + einsum.  The score and context ops keep
no (B, H, L, W, D) band between forward and backward: the bytes saved
for the backward are counted.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.model_zoo import transformer as jt
from mxnet_tpu_torch.gluon.model_zoo import transformer as tt
from mxnet_tpu_torch.ndarray import ops_sldwin

TOL = dict(rtol=1e-5, atol=1e-5)
B, L, H, D, W1 = 2, 24, 2, 8, 4
DIL = np.array([1, 3], np.int32)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(3)]


def _width(symmetric):
    return 2 * W1 + 1 if symmetric else W1 + 1


def _jax_ops(q, k, v, s, g_s, g_c, symmetric):
    """The JAX package's score and context, and their gradients against
    the head gradients ``g_s`` and ``g_c``."""
    arrs = [mx.nd.array(a) for a in (q, k, v, s)]
    for a in arrs:
        a.attach_grad()
    dil = mx.nd.array(DIL, dtype="int32")
    with mx.autograd.record():
        score = mx.nd.contrib.sldwin_atten_score(
            arrs[0], arrs[1], dil, w=W1, symmetric=symmetric)
        ctx = mx.nd.contrib.sldwin_atten_context(
            arrs[3], arrs[2], dil, w=W1, symmetric=symmetric)
        loss = mx.nd.sum(score * mx.nd.array(g_s)) + \
            mx.nd.sum(ctx * mx.nd.array(g_c))
    loss.backward()
    return [score.asnumpy(), ctx.asnumpy()] + [a.grad.asnumpy()
                                                for a in arrs]


@pytest.fixture(scope="module", params=[True, False],
                ids=["symmetric", "one_sided"])
def case(request):
    symmetric = request.param
    q, k, v = _inputs()
    rng = np.random.default_rng(1)
    s = rng.standard_normal((B, L, H, _width(symmetric))).astype(np.float32)
    g_s = rng.standard_normal(s.shape).astype(np.float32)
    g_c = rng.standard_normal((B, L, H, D)).astype(np.float32)
    return dict(symmetric=symmetric, q=q, k=k, v=v, s=s, g_s=g_s, g_c=g_c,
                ref=_jax_ops(q, k, v, s, g_s, g_c, symmetric))


def _port_ops(c, score_fn, context_fn):
    q, k, v, s = (torch.tensor(c[n], requires_grad=True)
                  for n in ("q", "k", "v", "s"))
    dil = torch.tensor(DIL)
    score = score_fn(q, k, dil, W1, c["symmetric"])
    ctx = context_fn(s, v, dil, W1, c["symmetric"])
    loss = (score * torch.tensor(c["g_s"])).sum() + \
        (ctx * torch.tensor(c["g_c"])).sum()
    loss.backward()
    return [score.detach().numpy(), ctx.detach().numpy()] + \
        [t.grad.numpy() for t in (q, k, v, s)]


@pytest.mark.parametrize("form", ["ops", "plain"])
def test_score_context_and_gradients_match_the_jax_package(case, form):
    fns = (ops_sldwin.sldwin_score, ops_sldwin.sldwin_context) \
        if form == "ops" else (ops_sldwin.direct_score,
                               ops_sldwin.direct_context)
    got = _port_ops(case, *fns)
    names = ["score", "context", "dq", "dk", "dv", "ds"]
    for name, a, b in zip(names, case["ref"], got):
        np.testing.assert_allclose(b, a, err_msg=name, **TOL)


def test_chunked_ops_match_the_plain_version_across_chunks(case,
                                                           monkeypatch):
    """A chunk of 5 query rows (rows not a multiple of it) gives the
    whole-band plain version's values and gradients."""
    monkeypatch.setattr(ops_sldwin, "CHUNK_BYTES",
                        5 * B * H * _width(case["symmetric"]) * D * 4)
    got = _port_ops(case, ops_sldwin.sldwin_score, ops_sldwin.sldwin_context)
    want = _port_ops(case, ops_sldwin.direct_score,
                     ops_sldwin.direct_context)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, **TOL)


def test_registry_frontends_and_mask_with_padded_valid_length(case):
    """``nd``, ``nd.contrib`` and ``mx.sym`` reach the ops by both names;
    ``mask_like`` over a padded ``valid_length`` equals the JAX
    package's, exact zeros and ones."""
    sym = case["symmetric"]
    vl = np.array([24, 17], np.float32)
    want = mx.nd.contrib.sldwin_atten_mask_like(
        mx.nd.array(case["s"]), mx.nd.array(DIL, dtype="int32"),
        mx.nd.array(vl), w=W1, symmetric=sym).asnumpy()
    with mt.cpu():
        dil = mt.nd.array(DIL, dtype="int32")
        for fn in (mt.nd._contrib_sldwin_atten_mask_like,
                   mt.nd._sldwin_atten_mask_like,
                   mt.nd.contrib.sldwin_atten_mask_like):
            got = fn(mt.nd.array(case["s"]), dil, mt.nd.array(vl), w=W1,
                     symmetric=sym).asnumpy()
            np.testing.assert_array_equal(got, want)
        score = mt.nd._sldwin_atten_score(
            mt.nd.array(case["q"]), mt.nd.array(case["k"]), dil, w=W1,
            symmetric=sym).asnumpy()
    np.testing.assert_allclose(score, case["ref"][0], **TOL)
    sq, sk, sd = mt.sym.var("q"), mt.sym.var("k"), mt.sym.var("d")
    graph = mt.sym._sldwin_atten_score(sq, sk, sd, w=W1, symmetric=sym)
    out = graph.eval(ctx=mt.cpu(), q=mt.nd.array(case["q"], ctx=mt.cpu()),
                     k=mt.nd.array(case["k"], ctx=mt.cpu()),
                     d=mt.nd.array(DIL, ctx=mt.cpu(), dtype="int32"))[0]
    np.testing.assert_allclose(out.asnumpy(), case["ref"][0], **TOL)


def test_mask_like_is_not_differentiable():
    s = torch.zeros((1, 6, 1, 3), requires_grad=True)
    m = ops_sldwin.sldwin_mask_like(s, torch.tensor([1]),
                                    torch.tensor([4]), 1)
    assert not m.requires_grad
    assert m.dtype == s.dtype and m.shape == s.shape


def test_a_full_window_equals_dense_attention():
    """With ``w = L - 1`` and dilation 1 every key is in every band: the
    banded softmax attention equals dense softmax(QKᵀ)V."""
    q, k, v = (torch.tensor(a[:, :, :1]) for a in _inputs(2))
    w = L - 1
    dil = torch.tensor([1])
    s = ops_sldwin.sldwin_score(q, k, dil, w) / np.sqrt(D)
    m = ops_sldwin.sldwin_mask_like(s, dil, torch.full((B,), L), w)
    att = torch.softmax(s + (1.0 - m) * -1e9, dim=-1) * m
    banded = ops_sldwin.sldwin_context(att, v, dil, w)
    dense = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D),
                          dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", dense, v)
    np.testing.assert_allclose(banded.numpy(), want.numpy(), **TOL)


def _saved_bytes(score_fn, context_fn, q, k, v, dil, w):
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        s = score_fn(q, k, dil, w)
        context_fn(torch.softmax(s, dim=-1), v, dil, w)
    return saved


def test_score_and_context_save_no_band_for_backward():
    """The ops save their (B, L, H, D) inputs and the (B, L, H, W) scores;
    the plain version saves the (B, H, L, W, D) bands of K and V."""
    w = 8
    q, k, v = (torch.tensor(a).requires_grad_() for a in _inputs(3))
    dil = torch.tensor(DIL)
    band = B * H * L * (2 * w + 1) * D * 4
    ours = _saved_bytes(ops_sldwin.sldwin_score, ops_sldwin.sldwin_context,
                        q, k, v, dil, w)
    plain = _saved_bytes(ops_sldwin.direct_score, ops_sldwin.direct_context,
                         q, k, v, dil, w)
    assert max(ours) < band and max(plain) >= band
    scores = B * L * H * (2 * w + 1) * 4
    # q, k (score); the softmax's output and v (context); the softmax
    # saves its output once more
    assert sum(ours) <= 3 * q.numel() * 4 + 3 * scores


UNITS, HEADS, LAYERS, VOCAB, LMAX = 64, 4, 2, 50, 32
LF_DIL = (1, 3, 1, 3)


def _encoder(lib_mod):
    return lib_mod.LongformerEncoder(
        VOCAB, num_layers=LAYERS, units=UNITS, hidden_size=2 * UNITS,
        num_heads=HEADS, w=W1, dilation=LF_DIL, max_length=LMAX,
        prefix="lf_")


def _batch():
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, VOCAB, (B, L)).astype(np.float32)
    labels = rng.integers(0, VOCAB, (B, L)).astype(np.float32)
    return tokens, labels, np.array([L, 19], np.float32)


@pytest.fixture(scope="module")
def longformer():
    """The JAX encoder with a Dense head: its forward, and its weights
    after one SGD step (momentum 0.9) on a softmax cross-entropy."""
    tokens, labels, vl = _batch()
    enc = _encoder(jt)
    head = mx.gluon.nn.Dense(VOCAB, flatten=False, in_units=UNITS,
                             prefix="head_")
    enc.initialize(mx.init.Xavier())
    head.initialize(mx.init.Xavier())
    init = {k: p.data().asnumpy().copy() for blk in (enc, head)
            for k, p in blk.collect_params().items()}
    out = enc(mx.nd.array(tokens), mx.nd.array(vl)).asnumpy()
    params = mx.gluon.ParameterDict()
    params.update(enc.collect_params())
    params.update(head.collect_params())
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9})
    lossfn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = lossfn(head(enc(mx.nd.array(tokens), mx.nd.array(vl))),
                      mx.nd.array(labels))
    loss.backward()
    trainer.step(B)
    after = {k: p.data().asnumpy() for k, p in params.items()}
    return dict(init=init, out=out, loss=loss.asnumpy(), after=after)


def _port_model(ref):
    enc = _encoder(tt)
    head = mt.gluon.nn.Dense(VOCAB, flatten=False, in_units=UNITS,
                             prefix="head_")
    for blk in (enc, head):
        mt.load_reference_params(blk, {k: v for k, v in ref["init"].items()
                                       if k in blk.collect_params()},
                                 ctx=mt.cpu())
    return enc, head


def test_longformer_forward_matches_the_jax_package(longformer):
    enc, _ = _port_model(longformer)
    tokens, _, vl = _batch()
    with mt.cpu():
        out = enc(mt.nd.array(tokens), mt.nd.array(vl)).asnumpy()
    np.testing.assert_allclose(out, longformer["out"], **TOL)


def test_longformer_training_step_matches_the_jax_package(longformer):
    enc, head = _port_model(longformer)
    tokens, labels, vl = _batch()
    params = mt.gluon.ParameterDict()
    params.update(enc.collect_params())
    params.update(head.collect_params())
    trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9})
    lossfn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.cpu():
        with mt.autograd.record():
            loss = lossfn(head(enc(mt.nd.array(tokens), mt.nd.array(vl))),
                          mt.nd.array(labels))
        loss.backward()
        trainer.step(B)
    np.testing.assert_allclose(loss.asnumpy(), longformer["loss"], **TOL)
    for name, p in params.items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   longformer["after"][name], err_msg=name,
                                   **TOL)


def test_longformer_refuses_a_symbol_as_the_jax_package_does():
    enc = _encoder(tt)
    with pytest.raises(mt.MXNetError, match="imperative/hybridize"):
        enc.layers[0].attn(mt.sym.var("x"))


def test_longformer_step_copies_nothing_from_the_host(longformer):
    """The dilations are made once a device and the positions by
    ``arange`` on it: a second forward creates no tensor from host data
    (``torch.tensor``), so a capture holds it."""
    enc, _ = _port_model(longformer)
    tokens, _, vl = _batch()
    x = torch.tensor(tokens)
    enc(x, torch.tensor(vl))
    calls = []
    real = torch.tensor

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    torch.tensor = spy
    try:
        enc(x)
    finally:
        torch.tensor = real
    assert calls == []
