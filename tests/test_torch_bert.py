"""The port's BERT blocks held against the JAX package's, with the JAX
package's initialized weights carried across by ``load_reference_params``.

Both run on the CPU: the JAX side on its CPU mesh through the additive-mask
softmax, the port through the flash path's plain version (its CPU path).
Tolerance 1e-4: fp32 end to end, summation orders differ.  A batch-pad row
with valid_len = 0 legitimately differs (the masked softmax spreads it
uniformly, the flash path outputs 0), so only real rows are compared.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import transformer as jax_tf
from mxnet_tpu_torch import cpu, load_reference_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import transformer as port_tf


# Explicit prefixes on the JAX side leave the JAX package's instance
# counters alone (tests/test_transformer.py looks its model up as
# bertmodel0_), and their counter digits differ from the port's, which
# exercises load_reference_params' prefix stripping.
REF_BERT = "bertmodel99_"
REF_ATTN = "multi_head_attention99_"


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _bert_pair(**kw):
    ref = jax_tf.bert_small(dropout=0.0, prefix=REF_BERT, **kw)
    ref.initialize()
    port = port_tf.bert_small(dropout=0.0, **kw)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    return ref, port


def _run_port(port, *arrays):
    with torch.inference_mode():
        out = port(*[torch.from_numpy(a) for a in arrays])
    return [o.numpy() for o in out]


def test_param_names_mirror_reference_and_decoder_is_tied():
    ref, port = _bert_pair()
    strip = len(port.prefix)
    ours = {k[strip:] for k in port.collect_params()}
    theirs = {k[len(ref.prefix):] for k in ref.collect_params()}
    assert ours == theirs
    assert "enc_layers_transformer_encoder_cell0_attn_qkv_weight" in ours
    assert "mlm_out_bias" in ours and "mlm_out_weight" not in ours
    assert port.mlm_decoder.weight is port.word_embed.weight
    np.testing.assert_array_equal(
        port.mlm_decoder.weight.data().detach().numpy(),
        ref.collect_params()[ref.prefix + "word_embed_weight"]
        .data().asnumpy())


def test_multi_head_attention_valid_len():
    rs = np.random.RandomState(0)
    ref = jax_tf.MultiHeadAttention(64, 4, prefix=REF_ATTN)
    ref.initialize()
    port = port_tf.MultiHeadAttention(64, 4)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    x = rs.randn(2, 20, 64).astype(np.float32)
    vl = np.array([20, 13], np.float32)
    # the JAX CPU path masks through the explicit (B*H, S, S) mask
    key = (np.arange(20)[None] < vl[:, None]).astype(np.float32)
    mask = np.broadcast_to(key[:, None, None], (2, 4, 20, 20)) \
        .reshape(8, 20, 20)
    want = ref(mx.nd.array(x), mx.nd.array(mask), None,
               mx.nd.array(vl)).asnumpy()
    with torch.inference_mode():
        got = port(torch.from_numpy(x), None, torch.from_numpy(vl)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_bert_small_matches_reference(kernel, monkeypatch):
    """MLM logits and NSP outputs of bert_small; ``xla`` forces the port's
    masked-softmax path, ``auto`` takes the flash path."""
    monkeypatch.setenv("MXNET_ATTENTION_KERNEL", kernel)
    rs = np.random.RandomState(1)
    ref, port = _bert_pair()
    toks = rs.randint(0, 1000, (3, 24)).astype(np.int32)
    types = rs.randint(0, 2, (3, 24)).astype(np.int32)
    vl = np.array([24, 10, 0], np.float32)
    want = [o.asnumpy() for o in ref(mx.nd.array(toks, dtype="int32"),
                                     mx.nd.array(types, dtype="int32"),
                                     mx.nd.array(vl))]
    got = _run_port(port, toks, types, vl)
    assert got[0].shape == (3, 24, 1000) and got[1].shape == (3, 2)
    real = vl > 0
    np.testing.assert_allclose(got[0][real], want[0][real], atol=1e-4)
    np.testing.assert_allclose(got[1][real], want[1][real], atol=1e-4)


def test_length_mask_built_only_off_the_flash_path(monkeypatch):
    """With (B,) lengths the flash path builds no key mask; ``xla`` builds
    one per layer from the lengths."""
    calls = []
    build = port_tf.MultiHeadAttention._length_mask
    monkeypatch.setattr(port_tf.MultiHeadAttention, "_length_mask",
                        lambda self, *a: calls.append(a) or build(self, *a))
    net = port_tf.bert_small(dropout=0.0)
    net.initialize(ctx=cpu(), seed=1)
    rs = np.random.RandomState(3)
    args = (rs.randint(0, 1000, (2, 9)).astype(np.int32),
            np.zeros((2, 9), np.int32), np.array([9, 4], np.float32))
    flash = _run_port(net, *args)
    assert calls == []
    monkeypatch.setenv("MXNET_ATTENTION_KERNEL", "xla")
    masked = _run_port(net, *args)
    assert len(calls) == 2
    for f, m in zip(flash, masked):
        np.testing.assert_allclose(f, m, atol=1e-4)


@pytest.mark.parametrize("value", ["flash", "off", "0"])
def test_attention_knob_accepts_only_auto_and_xla(value, monkeypatch):
    monkeypatch.setenv("MXNET_ATTENTION_KERNEL", value)
    mha = port_tf.MultiHeadAttention(64, 4)
    mha.initialize(ctx=cpu())
    with pytest.raises(MXNetError, match="MXNET_ATTENTION_KERNEL"):
        mha(torch.zeros(1, 3, 64))


def test_bert_small_two_d_mask_takes_masked_softmax():
    """A (B, S) 0/1 mask has no lengths: both packages take the
    masked-softmax path, every row compares."""
    rs = np.random.RandomState(2)
    ref, port = _bert_pair()
    toks = rs.randint(0, 1000, (2, 12)).astype(np.int32)
    types = np.zeros((2, 12), np.int32)
    mask = np.ones((2, 12), np.float32)
    mask[1, 7:] = 0
    want = [o.asnumpy() for o in ref(mx.nd.array(toks, dtype="int32"),
                                     mx.nd.array(types, dtype="int32"),
                                     mx.nd.array(mask))]
    got = _run_port(port, toks, types, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_load_reference_params_rejects_mismatch():
    ref, port = _bert_pair()
    arrays = _arrays(ref)
    missing = dict(arrays)
    missing.pop(ref.prefix + "nsp_bias")
    with pytest.raises(MXNetError, match="missing"):
        load_reference_params(port, missing, ctx=cpu())
    extra = dict(arrays)
    extra[ref.prefix + "bogus_weight"] = np.zeros(3, np.float32)
    with pytest.raises(MXNetError, match="extra"):
        load_reference_params(port, extra, ctx=cpu())
    bad = dict(arrays)
    bad[ref.prefix + "nsp_bias"] = np.zeros(3, np.float32)
    bad[ref.prefix + "word_embed_weight"] = np.ones_like(
        arrays[ref.prefix + "word_embed_weight"])
    with pytest.raises(MXNetError, match="shape"):
        load_reference_params(port, bad, ctx=cpu())
    # a mismatch anywhere loads nothing
    assert not (port.word_embed.weight.data() == 1).all()


def test_load_reference_params_places_on_ctx(monkeypatch):
    """The weights land on ``ctx``; without one, on the default context
    (``gpu(0)``), also for a net that was never initialized.  Here the
    default's resolution is recorded and answered with the CPU
    (``tests/test_torch_cuda.py`` loads onto the card itself)."""
    from mxnet_tpu_torch import context as port_ctx, convert
    ref = jax_tf.MultiHeadAttention(64, 4, prefix=REF_ATTN)
    ref.initialize()
    arrays = _arrays(ref)
    port = port_tf.MultiHeadAttention(64, 4)
    load_reference_params(port, arrays, ctx=cpu())
    assert port.device() == torch.device("cpu")
    assert port_ctx.as_device(None) == torch.device("cuda", 0)
    asked = []
    monkeypatch.setattr(convert, "as_device",
                        lambda ctx: asked.append(ctx) or cpu())
    fresh = port_tf.MultiHeadAttention(64, 4)
    load_reference_params(fresh, arrays)
    assert asked == [None]
    np.testing.assert_array_equal(
        fresh.qkv.weight.data().detach().numpy(),
        arrays[REF_ATTN + "qkv_weight"])


def test_seeded_init_is_reproducible_and_follows_reference_rules():
    """One seed gives the same weights (drawn on the CPU whatever the
    target device); weights follow the JAX default Uniform(0.07),
    biases/beta zeros, gamma ones."""
    a = port_tf.bert_small(dropout=0.0)
    a.initialize(ctx=cpu(), seed=7)
    b = port_tf.bert_small(dropout=0.0)
    b.initialize(ctx="cpu", seed=7)
    for pa, pb in zip(a.collect_params().values(),
                      b.collect_params().values()):
        torch.testing.assert_close(pa.data(), pb.data(), rtol=0, atol=0)
    params = a.collect_params()
    w = params[a.prefix + "word_embed_weight"].data()
    assert w.abs().max() <= 0.07 and w.std() > 0.03
    assert not params[a.prefix + "nsp_bias"].data().any()
    assert (params[a.prefix + "embed_ln_gamma"].data() == 1).all()
