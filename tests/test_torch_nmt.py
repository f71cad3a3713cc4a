"""Config #4's model, the Transformer NMT, in the port held against the
JAX package at a small size (2 + 2 layers, width 64, 4 heads, FFN 128,
vocabulary 50), with the JAX package's initialised weights carried
across by ``load_reference_params``.

Both run on the CPU: the JAX side through its XLA attention path (its
own CPU policy), the port through the flash path's plain version where
attention has no mask (encoder self-attention, decoder cross-attention)
and the masked softmax where it has one (the decoder's causal
self-attention).  Bounds, fp32: logits within 1e-5; one Adam step's
gradients and weights leaf by leaf within ``1e-5 * max(1, max|g|)``;
``translate``'s greedy and beam tokens equal and scores within 1e-5.
Each JAX run sits in a module-scoped fixture.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import transformer as jax_tf
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import transformer as port_tf

VOCAB, LAYERS, UNITS, HIDDEN, HEADS, MAXLEN = 50, 2, 64, 128, 4, 32
B, LS, LT, LR = 2, 7, 5, 1e-4
REF_PREFIX = "transformer_nmt97_"
TOL = 1e-5
BOS, EOS, MAX_LEN = 1, 2, 6


def _small(mod, **kw):
    return mod.TransformerNMT(VOCAB, num_layers=LAYERS, units=UNITS,
                              hidden_size=HIDDEN, num_heads=HEADS,
                              max_length=MAXLEN, **kw)


def _data(seed=0):
    rs = np.random.RandomState(seed)
    src = rs.randint(3, VOCAB, (B, LS)).astype(np.float32)
    tgt = rs.randint(3, VOCAB, (B, LT)).astype(np.float32)
    lab = rs.randint(3, VOCAB, (B, LT)).astype(np.float32)
    mask = np.ones((B, LS), np.float32)
    mask[1, 4:] = 0.0
    return src, tgt, lab, mask


def _by_name(params, prefix, fn):
    return {k[len(prefix):]: fn(p) for k, p in params.items()}


@pytest.fixture(scope="module")
def ref_run():
    """The JAX model's weights, logits (with and without a source mask),
    one Adam step's gradients and weights, and its translations."""
    mx.random.seed(3)
    ref = _small(jax_tf, prefix=REF_PREFIX)
    ref.initialize()
    params = ref.collect_params()
    init = _by_name(params, REF_PREFIX, lambda p: p.data().asnumpy())
    src, tgt, lab, mask = _data()
    s, t, y, m = (mx.nd.array(a) for a in (src, tgt, lab, mask))
    logits = ref(s, t).asnumpy()
    logits_masked = ref(s, t, m).asnumpy()
    greedy = ref.translate(s, BOS, EOS, max_len=MAX_LEN)
    beam = ref.translate(s, BOS, EOS, max_len=MAX_LEN, beam_size=3)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = mx.gluon.Trainer(params, "adam", {"learning_rate": LR})
    with mx.autograd.record():
        loss = mx.nd.mean(loss_fn(ref(s, t), y))
    loss.backward()
    grads = _by_name(params, REF_PREFIX, lambda p: p.grad().asnumpy())
    tr.step(B)
    final = _by_name(params, REF_PREFIX, lambda p: p.data().asnumpy())
    return {"init": init, "logits": logits, "logits_masked": logits_masked,
            "greedy": greedy, "beam": beam, "loss": float(loss.asnumpy()),
            "grads": grads, "final": final}


def _port(init):
    net = _small(port_tf)
    load_reference_params(net, {REF_PREFIX + k: v for k, v in init.items()},
                          ctx=cpu())
    return net


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_param_names_mirror_reference_and_output_is_tied(ref_run):
    net = _port(ref_run["init"])
    ours = {k[len(net.prefix):] for k in net.collect_params()}
    assert ours == set(ref_run["init"])
    assert "dec_layers_transformer_decoder_cell1_crossattn_kv_weight" in ours
    assert "dec_layers_transformer_decoder_cell0_crossattn_q_weight" in ours
    assert "out_weight" not in ours
    assert net.out_proj.weight is net.word_embed.weight


@pytest.mark.parametrize("masked", [False, True])
def test_logits_match(ref_run, masked):
    net = _port(ref_run["init"])
    src, tgt, _, mask = (torch.from_numpy(a) for a in _data())
    with torch.no_grad():
        got = net(src, tgt, mask if masked else None).numpy()
    _close(got, ref_run["logits_masked" if masked else "logits"])


def test_logits_on_ndarrays(ref_run):
    net = _port(ref_run["init"])
    src, tgt, _, _ = _data()
    with cpu():
        out = net(nd.array(src), nd.array(tgt))
    assert isinstance(out, nd.NDArray)
    _close(out.asnumpy(), ref_run["logits"])


def test_one_adam_step_matches(ref_run):
    net = _port(ref_run["init"])
    params = net.collect_params()
    src, tgt, lab, _ = (torch.from_numpy(a) for a in _data())
    tr = gluon.Trainer(params, "adam", {"learning_rate": LR})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(net(src, tgt), lab).mean()
    autograd.backward(loss)
    grads = _by_name(params, net.prefix,
                     lambda p: p._grad_tensor().detach().clone().numpy())
    tr.step(B)
    final = _by_name(params, net.prefix,
                     lambda p: p._tensor().detach().numpy())
    assert abs(loss.item() - ref_run["loss"]) <= TOL * abs(ref_run["loss"])
    assert grads.keys() == ref_run["grads"].keys()
    for k, g in ref_run["grads"].items():
        limit = TOL * max(1.0, float(np.abs(g).max()))
        assert np.abs(grads[k] - g).max() <= limit, k
        assert np.abs(final[k] - ref_run["final"][k]).max() <= limit, k


@pytest.mark.parametrize("beam", [1, 3])
def test_translate_matches(ref_run, beam):
    net = _port(ref_run["init"])
    src = _data()[0]
    with cpu():
        toks, scores = net.translate(nd.array(src), BOS, EOS,
                                     max_len=MAX_LEN, beam_size=beam)
    want_toks, want_scores = ref_run["greedy" if beam == 1 else "beam"]
    assert toks == want_toks
    _close(np.array(scores), np.array(want_scores))


def test_translate_reads_one_step_per_decoder_call(ref_run):
    """Greedy decoding runs the decoder once a step for the whole batch
    (until every row has ended), each call one host read."""
    net = _port(ref_run["init"])
    calls = []
    decode = net._decode_logits

    def counted(*a):
        calls.append(a[0].shape)
        return decode(*a)
    net._decode_logits = counted
    toks, _ = net.translate(torch.from_numpy(_data()[0]), BOS, EOS,
                            max_len=MAX_LEN)
    assert [s[1] for s in calls] == list(range(1, len(calls) + 1))
    assert all(s[0] == B for s in calls)
    assert len(calls) <= MAX_LEN and all(len(t) <= MAX_LEN for t in toks)


def test_decoder_self_attention_takes_the_masked_path(monkeypatch):
    """The decoder's causal self-attention carries a (B*H, S, S) mask and
    takes the masked softmax; the encoder's self-attention and the
    cross-attention have none and take the flash path."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer as tf
    net = _small(port_tf)
    net.initialize(ctx="cpu", seed=0)
    seen = []
    flash = tf.flash_attention

    def spy(q, k, v, *a, **kw):
        seen.append((q.shape[1], k.shape[1]))
        return flash(q, k, v, *a, **kw)
    monkeypatch.setattr(tf, "flash_attention", spy)
    src, tgt = torch.zeros(B, LS), torch.zeros(B, LT)
    with torch.no_grad():
        net(src, tgt)
    assert seen == [(LS, LS)] * LAYERS + [(LT, LS)] * LAYERS


def test_cross_attention_needs_memory():
    mha = port_tf.MultiHeadAttention(UNITS, HEADS, self_attention=False)
    mha.initialize(ctx="cpu")
    with pytest.raises(MXNetError, match="memory"):
        mha(torch.zeros(1, 3, UNITS))


def test_relu_ffn_and_unknown_activation():
    ffn = port_tf.PositionwiseFFN(8, 16, activation="relu")
    ffn.initialize(ctx="cpu", seed=0)
    x = torch.randn(2, 3, 8)
    want = torch.nn.functional.linear(
        torch.relu(torch.nn.functional.linear(
            x, ffn.ffn1.weight._tensor(), ffn.ffn1.bias._tensor())),
        ffn.ffn2.weight._tensor(), ffn.ffn2.bias._tensor())
    torch.testing.assert_close(ffn(x), want)
    with pytest.raises(MXNetError):
        port_tf.PositionwiseFFN(8, 16, activation="swishy")


def test_transformer_nmt_base_widths():
    net = port_tf.transformer_nmt_base(vocab_size=32000, max_length=128)
    n = sum(int(np.prod(p.shape)) for p in net.collect_params().values())
    # the tied embedding counted once: 32000x512 + 2 x 128x512 positions,
    # 6 encoder layers of 3.15 M and 6 decoder layers of 4.20 M
    assert n == 32000 * 512 + 2 * 128 * 512 + 6 * 3152384 + 6 * 4204032
