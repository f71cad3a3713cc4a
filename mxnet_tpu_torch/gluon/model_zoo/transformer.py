"""BERT (GluonNLP-style) and Transformer NMT (Sockeye-style) models.

Counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py`` for the BERT
serving and pretraining paths and the NMT training and translation path:
``MultiHeadAttention`` (:61-184, self- and cross-attention),
``PositionwiseFFN`` (gelu or an ``Activation``), ``TransformerEncoderCell``,
``TransformerDecoderCell``, ``TransformerEncoder``, ``TransformerDecoder``,
``TransformerNMT`` with ``translate`` (:238-487), ``BERTEncoder``,
``BERTModel`` (with the tied MLM decoder) and the ``bert_base`` /
``bert_small`` / ``transformer_nmt_base`` configurations, and the
decoder-only ``CausalLM`` of generation serving (``CausalLMCell``,
``causal_lm_small``, :682-906) with its paged-KV entries
``hybrid_prefill`` and ``hybrid_decode``, and the Longformer encoder
(``SlidingWindowSelfAttention``, ``LongformerEncoderCell``,
``LongformerEncoder``, :555-680), with the same parameter names and the same attention-kernel policy: an attention
without an explicit mask takes the flash path (the NMT encoder's
self-attention and the decoder's cross-attention), a masked one the
masked-softmax path (the decoder's causal self-attention, whose
``(B*H, S, S)`` mask is built as the JAX package builds it, never
folded into the kernel's ``causal`` flag).  gelu is the exact (erf)
form.  Under ``contrib.amp`` the masked-softmax path's two products are
``batch_dot`` (LP16) and its softmax FP32; the flash path takes q/k/v in
the dtype the qkv Dense gives them (bf16 under AMP).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ... import autograd
from ... import ndarray as nd
from ...base import MXNetError, get_env
from ...contrib.amp import amp as _amp
from ...kernels.flash_attention import flash_attention
from ...ndarray.ndarray import NDArray
from ...ndarray.ops_sldwin import (sldwin_context, sldwin_mask_like,
                                   sldwin_score)
from ...ndarray.register import get_op
from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerDecoderCell", "TransformerEncoder",
           "TransformerDecoder", "TransformerNMT", "BERTEncoder",
           "BERTModel", "bert_base", "bert_small", "transformer_nmt_base",
           "CausalLMCell", "CausalLM", "causal_lm_small",
           "SlidingWindowSelfAttention", "LongformerEncoderCell",
           "LongformerEncoder"]


def _masked_softmax(scores, mask):
    """scores (B*H, Sq, Sk); mask broadcastable to it, 1 = keep."""
    if mask is not None:
        # additive -1e9 mask in float32, as the JAX package's XLA path
        scores = scores + (mask.float() - 1.0) * 1e9
    scores, = _amp.cast("softmax", scores)              # FP32 under AMP
    return torch.softmax(scores, dim=-1)


class MultiHeadAttention(HybridBlock):
    """Scaled dot-product attention.  Self-attention has one fused QKV
    projection; cross-attention (``self_attention=False``) takes queries
    from ``x`` through ``q_`` and keys and values from ``mem`` through one
    fused ``kv_`` projection."""

    def __init__(self, units, num_heads, dropout=0.0, self_attention=True,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        self._self = self_attention
        with self.name_scope():
            if self_attention:
                self.qkv = Dense(3 * units, flatten=False, in_units=units,
                                 prefix="qkv_")
            else:
                self.q_proj = Dense(units, flatten=False, in_units=units,
                                    prefix="q_")
                self.kv = Dense(2 * units, flatten=False, in_units=units,
                                prefix="kv_")
            self.proj = Dense(units, flatten=False, in_units=units,
                              prefix="proj_")
            self.drop = Dropout(dropout) if dropout else None

    def _split_heads(self, x, batch, seq):
        # (B, S, U) -> (B*H, S, d), contiguous for the kernel
        d = self._units // self._heads
        return x.reshape(batch, seq, self._heads, d).transpose(1, 2) \
            .reshape(batch * self._heads, seq, d).contiguous()

    def _merge_heads(self, x, batch, seq):
        d = self._units // self._heads
        return x.reshape(batch, self._heads, seq, d).transpose(1, 2) \
            .reshape(batch, seq, self._units)

    def forward(self, x, mask=None, valid_len=None, mem=None):
        """``mask``: attention mask broadcastable to (B*H, Sq, Sk), 1 =
        keep (the masked-softmax path).  ``valid_len``: per-sequence key
        lengths (B,) or (B*H,), which the flash path honours and from which
        the masked-softmax path builds its key mask when ``mask`` is None.
        Passing both is allowed when they express the same prefix mask.
        ``mem``: the keys' and values' source (B, Sk, U) of a
        cross-attention (the JAX package takes it third, before
        ``valid_len``)."""
        b, sq = x.shape[0], x.shape[1]
        if self._self:
            q, k, v = self.qkv(x).split(self._units, dim=-1)
            sk = sq
        else:
            if mem is None:
                raise MXNetError("cross-attention needs memory input")
            q = self.q_proj(x)
            k, v = self.kv(mem).split(self._units, dim=-1)
            sk = mem.shape[1]
        q = self._split_heads(q, b, sq)
        k = self._split_heads(k, b, sk)
        v = self._split_heads(v, b, sk)
        scale = 1.0 / math.sqrt(self._units // self._heads)
        if self._flash_eligible(mask, valid_len):
            out = flash_attention(q, k, v, valid_len, scale=scale)
        else:
            if mask is None and valid_len is not None:
                mask = self._length_mask(valid_len, b, sk)
            q, k = _amp.cast("batch_dot", q, k)           # LP16 under AMP
            att = _masked_softmax(torch.bmm(q, k.transpose(1, 2)) * scale,
                                  mask)
            if self.drop is not None:
                att = self.drop(att)
            out = torch.bmm(*_amp.cast("batch_dot", att, v))
        return self.proj(self._merge_heads(out, b, sq))

    def _length_mask(self, valid_len, batch, seq):
        """(B,) or (B*H,) key lengths -> (B*H, 1, S) key mask, 1 = keep,
        broadcast over queries (the JAX package materialises
        (B*H, S, S))."""
        vl = valid_len.float().reshape(-1)
        if vl.shape[0] == batch:
            vl = vl.repeat_interleave(self._heads)
        keys = torch.arange(seq, device=vl.device).float()
        return (keys[None, None, :] < vl[:, None, None]).float()

    def _flash_eligible(self, mask, valid_len) -> bool:
        # Kernel selection policy, MXNET_ATTENTION_KERNEL:
        #   auto (default)  the flash path: the CUDA kernel on a CUDA
        #                   tensor, its plain version on a CPU tensor
        #   xla             the masked-softmax path
        # Whatever the policy, a mask without lengths cannot be proven to
        # be a prefix mask and takes the masked-softmax path, and so does a
        # block with attention dropout while recording or in training
        # mode (flash has no probabilities tensor to drop): the JAX
        # package's condition, so record(train_mode=False) takes the
        # masked-softmax path in both.
        mode = get_env("MXNET_ATTENTION_KERNEL").lower()
        if mode not in ("auto", "xla"):
            raise MXNetError(f"MXNET_ATTENTION_KERNEL={mode!r}: expected "
                             f"'auto' or 'xla'")
        if mode == "xla":
            return False
        if mask is not None and valid_len is None:
            return False
        return not (self.drop is not None and (autograd.is_recording()
                                               or autograd.is_training()))


class PositionwiseFFN(HybridBlock):
    """``ffn2(act(ffn1(x)))``: the exact gelu, or an ``Activation`` type
    (``relu`` for the NMT model)."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ffn1 = Dense(hidden_size, flatten=False, in_units=units,
                              prefix="ffn1_")
            self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                              prefix="ffn2_")
            self.drop = Dropout(dropout) if dropout else None
        self._act = None if activation == "gelu" else \
            get_op("Activation").get_fn({"act_type": activation})

    def forward(self, x):
        h = self.ffn1(x)
        h = F.gelu(h, approximate="none") if self._act is None \
            else self._act(h)
        if self.drop is not None:
            h = self.drop(h)
        return self.ffn2(h)


class TransformerEncoderCell(HybridBlock):
    """Post-LN encoder layer (the BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="gelu", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attn = MultiHeadAttention(units, num_heads, dropout,
                                           prefix="attn_")
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       activation, prefix="ffn_")
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_")
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None, valid_len=None):
        a = self.attn(x, mask, valid_len)
        if self.drop is not None:
            a = self.drop(a)
        x = self.ln1(x + a)
        f = self.ffn(x)
        if self.drop is not None:
            f = self.drop(f)
        return self.ln2(x + f)


class TransformerDecoderCell(HybridBlock):
    """Decoder layer: causal self-attention + cross-attention + FFN, each
    followed by a residual add and LayerNorm (post-LN)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 activation="relu", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.self_attn = MultiHeadAttention(units, num_heads, dropout,
                                                prefix="selfattn_")
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_")
            self.cross_attn = MultiHeadAttention(
                units, num_heads, dropout, self_attention=False,
                prefix="crossattn_")
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       activation, prefix="ffn_")
            self.ln3 = LayerNorm(in_channels=units, prefix="ln3_")

    def forward(self, x, causal_mask=None, mem=None, mem_mask=None):
        x = self.ln1(x + self.self_attn(x, causal_mask))
        x = self.ln2(x + self.cross_attn(x, mem_mask, mem=mem))
        return self.ln3(x + self.ffn(x))


def _tie_weight(dense, embed):
    """Share an Embedding's (V, U) weight with a Dense output projection;
    the Dense's own weight parameter is dropped (its bias stays)."""
    del dense.params._params[dense.weight.name]
    dense.weight = embed.weight


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, max_length=512, dropout=0.0,
                 activation="gelu", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._heads = num_heads
        self._max_len = max_length
        with self.name_scope():
            self.pos_embed = Embedding(max_length, units,
                                       prefix="pos_embed_")
            self.cells = HybridSequential(prefix="layers_")
            with self.cells.name_scope():
                for _ in range(num_layers):
                    self.cells.add(TransformerEncoderCell(
                        units, hidden_size, num_heads, dropout, activation))

    def forward(self, x, mask=None):
        """x: (B, S, units) embedded input.  mask: (B, S) 1 = valid, or a
        (B,) vector of per-sequence valid lengths (the GluonNLP
        valid_length idiom), which lets the flash path mask by length."""
        b, s = x.shape[0], x.shape[1]
        if s > self._max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_length={self._max_len}")
        x = x + self.pos_embed(torch.arange(s, device=x.device))
        att_mask = valid_len = None
        if mask is not None and mask.dim() == 1:   # (B,) valid lengths:
            valid_len = mask                       # each MHA masks by them
        elif mask is not None:
            # (B, S) 0/1 mask -> (B*H, 1, S): one key mask per row,
            # broadcast over queries (the JAX package materialises
            # (B*H, S, S))
            att_mask = mask.reshape(b, 1, 1, s) \
                .expand(b, self._heads, 1, s).reshape(b * self._heads, 1, s)
        for cell in self.cells:
            x = cell(x, att_mask, valid_len)
        return x


class TransformerDecoder(HybridBlock):
    def __init__(self, num_layers=6, units=512, hidden_size=2048,
                 num_heads=8, max_length=512, dropout=0.0,
                 activation="relu", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._heads = num_heads
        self._max_len = max_length
        with self.name_scope():
            self.pos_embed = Embedding(max_length, units,
                                       prefix="pos_embed_")
            self.cells = HybridSequential(prefix="layers_")
            with self.cells.name_scope():
                for _ in range(num_layers):
                    self.cells.add(TransformerDecoderCell(
                        units, hidden_size, num_heads, dropout, activation))

    def forward(self, x, mem, mem_mask=None):
        """x: (B, S, units) embedded target prefix; mem: (B, Sm, units)
        the encoder's output; mem_mask: (B, Sm) 1 = valid source
        position, or None (every position valid: the flash path)."""
        b, s = x.shape[0], x.shape[1]
        if s > self._max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_length={self._max_len}")
        sm = mem.shape[1]
        x = x + self.pos_embed(torch.arange(s, device=x.device))
        # the causal mask (S, S) -> (B*H, S, S), as the JAX package builds
        # it (a broadcast view here): the masked-softmax path
        pos = torch.arange(s, device=x.device)
        causal = (pos[:, None] >= pos[None, :]).expand(b * self._heads, s, s)
        mmask = None
        if mem_mask is not None:
            mmask = mem_mask.reshape(b, 1, 1, sm) \
                .expand(b, self._heads, 1, sm).reshape(b * self._heads, 1, sm)
        for cell in self.cells:
            x = cell(x, causal, mem, mmask)
        return x


def _as_tensor(x):
    return x._data if isinstance(x, NDArray) else x


class TransformerNMT(HybridBlock):
    """Sockeye-style seq2seq transformer (BASELINE config #4): one
    source/target vocabulary embedding, encoder-decoder, the output
    projection tied to the embedding."""

    def __init__(self, vocab_size, num_layers=6, units=512,
                 hidden_size=2048, num_heads=8, max_length=512,
                 dropout=0.0, tie_weights=True, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        prefix="word_embed_")
            self.encoder = TransformerEncoder(
                num_layers, units, hidden_size, num_heads, max_length,
                dropout, activation="relu", prefix="enc_")
            self.decoder = TransformerDecoder(
                num_layers, units, hidden_size, num_heads, max_length,
                dropout, activation="relu", prefix="dec_")
            self.out_proj = Dense(vocab_size, flatten=False,
                                  in_units=units, use_bias=False,
                                  prefix="out_")
            if tie_weights:
                _tie_weight(self.out_proj, self.word_embed)

    def forward(self, src, tgt, src_mask=None):
        mem = self.encode(src, src_mask)
        return self._decode_logits(tgt, mem, src_mask)

    def encode(self, src, src_mask=None):
        return self.encoder(self.word_embed(src) * math.sqrt(self._units),
                            src_mask)

    def _decode_logits(self, tgt, mem, src_mask):
        dec = self.decoder(self.word_embed(tgt) * math.sqrt(self._units),
                           mem, src_mask)
        return self.out_proj(dec)

    def _step_logp(self, tgt, mem, src_mask) -> np.ndarray:
        """Log-probabilities of the next token after each row of ``tgt``,
        read to the host (one ``asnumpy``, a host read, per decoder
        call)."""
        logits = self._decode_logits(tgt, mem, src_mask)
        return nd.log_softmax(NDArray(logits[:, -1, :])).asnumpy()

    def translate(self, src, bos: int, eos: int, max_len: int = 50,
                  beam_size: int = 1, alpha: float = 0.6, src_mask=None):
        """Greedy (``beam_size=1``) or length-normalised beam-search
        decoding, as the JAX package's (:402-485, Sockeye's translate
        workflow; scores use the GNMT length penalty with ``alpha``).
        ``src`` is a (B, Ls) ``NDArray`` (or tensor) of token ids on the
        model's device.  The prefix grows by one token a step and the
        decoder runs again on all of it; each decoder call reads its
        last position's log-probabilities to the host.  Beam search runs
        one source row at a time, one decoder call per live beam.

        Returns (tokens, scores): a list per batch row (EOS stripped)."""
        src = _as_tensor(src)
        src_mask = None if src_mask is None else _as_tensor(src_mask)
        dev = src.device
        with torch.no_grad():
            mem = self.encode(src, src_mask)
            b = src.shape[0]
            if beam_size <= 1:
                return self._greedy(mem, src_mask, b, bos, eos, max_len,
                                    alpha, dev)
            return self._beam(mem, src_mask, b, bos, eos, max_len,
                              beam_size, alpha, dev)

    def _greedy(self, mem, src_mask, b, bos, eos, max_len, alpha, dev):
        tgt = torch.full((b, 1), float(bos), device=dev)
        finished = np.zeros((b,), bool)
        logprob = np.zeros((b,), np.float64)
        steps = np.zeros((b,), np.int64)
        for _ in range(max_len):
            logp = self._step_logp(tgt, mem, src_mask)
            nxt = logp.argmax(-1)
            nxt = np.where(finished, eos, nxt)
            logprob += np.where(finished, 0.0, logp[np.arange(b), nxt])
            steps += (~finished).astype(np.int64)
            finished |= (nxt == eos)
            tgt = torch.cat([tgt, torch.as_tensor(
                nxt.reshape(b, 1), dtype=tgt.dtype, device=dev)], dim=1)
            if finished.all():
                break
        out = []
        for row in tgt[:, 1:].cpu().numpy().astype(int).tolist():
            out.append(row[:row.index(eos)] if eos in row else row)
        # the beam path's GNMT length normalisation, so that greedy and
        # beam scores compare
        lens = np.maximum(steps, 1)
        scores = logprob / (((5 + lens) / 6.0) ** alpha)
        return out, [float(s) for s in scores]

    def _beam(self, mem, src_mask, b, bos, eos, max_len, beam_size, alpha,
              dev):
        def norm(entry):
            toks, lp, _ = entry
            length = max(len(toks) - 1, 1)
            return lp / (((5 + length) / 6.0) ** alpha)

        results, scores = [], []
        for i in range(b):
            mem_i = mem[i:i + 1]
            mask_i = None if src_mask is None else src_mask[i:i + 1]
            beams = [([bos], 0.0, False)]
            for _ in range(max_len):
                if all(f for _, _, f in beams):
                    break
                cand = []
                for toks, lp, fin in beams:
                    if fin:
                        cand.append((toks, lp, True))
                        continue
                    tgt = torch.as_tensor([toks], dtype=torch.float32,
                                          device=dev)
                    logp = self._step_logp(tgt, mem_i, mask_i)[0]
                    top = np.argsort(logp)[-beam_size:]
                    for t in top:
                        cand.append((toks + [int(t)], lp + float(logp[t]),
                                     int(t) == eos))
                cand.sort(key=norm, reverse=True)
                beams = cand[:beam_size]
            best, best_lp, _ = max(beams, key=norm)
            row = best[1:]
            results.append(row[:row.index(eos)] if eos in row else row)
            scores.append(norm((best, best_lp, True)))
        return results, scores


class BERTEncoder(TransformerEncoder):
    """BERT uses the (gelu, post-LN) encoder as-is."""


class BERTModel(HybridBlock):
    """BERT-base-style model (BASELINE config #3): token + segment +
    position embeddings -> encoder -> (MLM decoder over all positions, NSP
    head over [CLS])."""

    def __init__(self, vocab_size=30522, num_layers=12, units=768,
                 hidden_size=3072, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        prefix="word_embed_")
            self.token_type_embed = Embedding(type_vocab_size, units,
                                              prefix="type_embed_")
            self.embed_ln = LayerNorm(in_channels=units, prefix="embed_ln_")
            self.embed_drop = Dropout(dropout) if dropout else None
            self.encoder = BERTEncoder(
                num_layers, units, hidden_size, num_heads, max_length,
                dropout, activation="gelu", prefix="enc_")
            self.pooler = Dense(units, activation="tanh", flatten=False,
                                in_units=units, prefix="pooler_")
            # MLM: transform + decoder tied to the word embedding (the
            # BERT convention: the decoder keeps its own bias)
            self.mlm_dense = Dense(units, flatten=False, in_units=units,
                                   prefix="mlm_dense_")
            self.mlm_ln = LayerNorm(in_channels=units, prefix="mlm_ln_")
            self.mlm_decoder = Dense(vocab_size, flatten=False,
                                     in_units=units, prefix="mlm_out_")
            _tie_weight(self.mlm_decoder, self.word_embed)
            self.nsp = Dense(2, flatten=False, in_units=units,
                             prefix="nsp_")

    def forward(self, tokens, token_types, valid_mask=None):
        x = self.word_embed(tokens) + self.token_type_embed(token_types)
        x = self.embed_ln(x)
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        seq = self.encoder(x, valid_mask)                  # (B, S, U)
        h = F.gelu(self.mlm_dense(seq), approximate="none")
        mlm = self.mlm_decoder(self.mlm_ln(h))             # (B, S, V)
        nsp = self.nsp(self.pooler(seq[:, 0]))             # (B, 2)
        return mlm, nsp


def bert_base(vocab_size=30522, **kwargs):
    return BERTModel(vocab_size=vocab_size, num_layers=12, units=768,
                     hidden_size=3072, num_heads=12, **kwargs)


def bert_small(vocab_size=1000, **kwargs):
    """Tiny configuration for tests."""
    kwargs.setdefault("max_length", 128)
    return BERTModel(vocab_size=vocab_size, num_layers=2, units=64,
                     hidden_size=128, num_heads=4, **kwargs)


def transformer_nmt_base(vocab_size=32000, **kwargs):
    return TransformerNMT(vocab_size, num_layers=6, units=512,
                          hidden_size=2048, num_heads=8, **kwargs)


def _positions(batch: int, seq: int, device) -> torch.Tensor:
    """(batch, seq) position ids 0..seq-1 (a broadcast view)."""
    return torch.arange(seq, device=device).expand(batch, seq)


class SlidingWindowSelfAttention(HybridBlock):
    """Longformer's local self-attention (``mxnet_tpu/gluon/model_zoo/
    transformer.py:555-609``): each query attends to the ``2w+1`` keys of
    its band, per-head ``dilation``, over the ``_contrib_sldwin_atten_*``
    ops (``ndarray/ops_sldwin.py``), which keep (B, L, H, W) scores and
    never the (B, H, L, W, D) band between forward and backward.  The
    dilations are a device constant made once a device and the valid
    lengths a fill, so a step copies nothing from the host and
    ``hybridize()`` can capture it."""

    def __init__(self, units, num_heads, w, dilation=None, dropout=0.0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        self._w = int(w)
        self._dilation = tuple(dilation) if dilation is not None else \
            (1,) * num_heads
        if len(self._dilation) != num_heads:
            raise MXNetError("dilation needs one entry per head")
        self._dil = {}
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, in_units=units,
                             prefix="qkv_")
            self.proj = Dense(units, flatten=False, in_units=units,
                              prefix="proj_")
            self.drop = Dropout(dropout) if dropout else None

    def _dilations(self, device) -> torch.Tensor:
        dil = self._dil.get(device)
        if dil is None:
            dil = self._dil[device] = torch.tensor(
                self._dilation, dtype=torch.int32, device=device)
        return dil

    def forward(self, x, valid_len=None):
        b, l = x.shape[0], x.shape[1]
        d = self._units // self._heads
        q, k, v = (t.reshape(b, l, self._heads, d)
                   for t in self.qkv(x).split(self._units, dim=-1))
        dil = self._dilations(x.device)
        if valid_len is None:
            valid_len = torch.full((b,), l, dtype=torch.int32,
                                   device=x.device)
        s = sldwin_score(q, k, dil, self._w) * (1.0 / math.sqrt(d))
        m = sldwin_mask_like(s, dil, valid_len, self._w)
        att = torch.softmax(s + (1.0 - m) * -1e9, dim=-1) * m
        if self.drop is not None:
            att = self.drop(att)
        ctx = sldwin_context(att, v, dil, self._w)
        return self.proj(ctx.reshape(b, l, self._units))

    def hybrid_forward(self, F, x, valid_len=None, **params):
        raise MXNetError(
            "SlidingWindowSelfAttention supports the imperative/"
            "hybridize path; compose the _sldwin_atten_* ops "
            "directly for hand-built Symbol graphs")


class LongformerEncoderCell(HybridBlock):
    """Post-LN encoder layer with banded self-attention (:612-639)."""

    def __init__(self, units, hidden_size, num_heads, w, dilation=None,
                 dropout=0.0, activation="gelu", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attn = SlidingWindowSelfAttention(
                units, num_heads, w, dilation, dropout, prefix="attn_")
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                       activation, prefix="ffn_")
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_")
            self.drop = Dropout(dropout) if dropout else None

    def forward(self, x, valid_len=None):
        a = self.attn(x, valid_len)
        if self.drop is not None:
            a = self.drop(a)
        x = self.ln1(x + a)
        f = self.ffn(x)
        if self.drop is not None:
            f = self.drop(f)
        return self.ln2(x + f)


class LongformerEncoder(HybridBlock):
    """Token and position embeddings, LayerNorm, then ``num_layers``
    banded encoder layers (:642-680): the long-sequence encoder family,
    O(L·w) attention memory where BERT's is O(L²).  Only local attention:
    the JAX package has no global attention."""

    def __init__(self, vocab_size, num_layers=2, units=64,
                 hidden_size=128, num_heads=4, w=32, dilation=None,
                 max_length=4096, dropout=0.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        with self.name_scope():
            self.tok = Embedding(vocab_size, units, prefix="tok_")
            self.pos = Embedding(max_length, units, prefix="pos_")
            self.layers = HybridSequential(prefix="layers_")
            with self.layers.name_scope():
                for _ in range(num_layers):
                    self.layers.add(LongformerEncoderCell(
                        units, hidden_size, num_heads, w, dilation,
                        dropout))
            self.ln = LayerNorm(in_channels=units, prefix="ln_")

    def forward(self, tokens, valid_len=None):
        b, l = tokens.shape[0], tokens.shape[1]
        pos = self.pos(torch.arange(l, device=tokens.device))
        h = self.ln(self.tok(tokens) + pos.reshape(1, l, self._units))
        for cell in self.layers:
            h = cell(h, valid_len)
        return h


class CausalLMCell(HybridBlock):
    """Post-LN decoder-only layer.  The generation entries of
    :class:`CausalLM` reach its children (``qkv``/``proj``/``ln1``/``ffn``/
    ``ln2``) directly, so the cell is both a causal layer (``forward``)
    and the parameter container of the paged entries."""

    def __init__(self, units, hidden_size, num_heads, activation="gelu",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._heads = num_heads
        with self.name_scope():
            self.qkv = Dense(3 * units, flatten=False, in_units=units,
                             prefix="qkv_")
            self.proj = Dense(units, flatten=False, in_units=units,
                              prefix="proj_")
            self.ln1 = LayerNorm(in_channels=units, prefix="ln1_")
            self.ffn = PositionwiseFFN(units, hidden_size, 0.0,
                                       activation, prefix="ffn_")
            self.ln2 = LayerNorm(in_channels=units, prefix="ln2_")

    def attend(self, x, q, k, v, mask):
        """The layer body around explicit queries and keys/values: ``x``
        and ``q`` (B, Sq, U), ``k`` and ``v`` (B, Sk, U) (the pass's own
        projections, or K/V gathered from the block pool), ``mask``
        broadcastable to (B*H, Sq, Sk), 1 = keep.  The JAX package's
        ``attend`` takes no ``q`` and projects it from ``x`` again."""
        b, sq, sk = x.shape[0], x.shape[1], k.shape[1]
        h = self._heads
        d = self._units // h

        def heads(t, n):
            return t.reshape(b, n, h, d).transpose(1, 2).reshape(b * h, n, d)

        qh, kh = _amp.cast("batch_dot", heads(q, sq), heads(k, sk))
        att = _masked_softmax(torch.bmm(qh, kh.transpose(1, 2))
                              * (1.0 / math.sqrt(d)), mask)
        out = torch.bmm(*_amp.cast("batch_dot", att, heads(v, sk)))
        out = out.reshape(b, h, sq, d).transpose(1, 2) \
            .reshape(b, sq, self._units)
        x = self.ln1(x + self.proj(out))
        return self.ln2(x + self.ffn(x))

    def forward(self, x, mask=None):
        q, k, v = self.qkv(x).split(self._units, dim=-1)
        return self.attend(x, q, k, v, mask)


class CausalLM(HybridBlock):
    """Decoder-only LM with a paged-KV generation contract (the JAX
    package's, :739-898).  Three entries share one parameter set:

    - ``forward(tokens)``: the full causal pass, (B, S) -> (B, S, V)
      logits (the JAX package's ``hybrid_forward``);
    - ``hybrid_prefill(tokens, seq_len, table, pool)``: one prompt (batch
      1) padded to a length bucket: causal attention within the prompt,
      every position's K/V written into the request's KV blocks
      (``table`` maps position // block to a pool block id); returns
      (the last real position's (1, V) logits, the pool);
    - ``hybrid_decode(tokens, positions, tables, pool)``: one token per
      row: write the step's K/V at each row's position, gather each row's
      whole block list back, attend under a per-row length mask; returns
      ((rows, V) logits, the pool).

    The pool (:meth:`init_kv_pool`) is one ``(2*num_layers, n_blocks,
    block, units)`` fp32 tensor on the model's device (K rows even, V rows
    odd).  The entries write it in place (``index_put_`` at (layer row,
    block, offset), the JAX package's ``_scatter_set_nd``) and return the
    same tensor.  Block 0 is scratch (``serving.kv_cache``): empty rows
    and table tails point at it, and the additive -1e9 mask gives its keys
    an exact fp32 zero weight, so a row's output depends on its own token,
    position and table alone.  Token ids, positions and tables arrive as
    int32 and are widened on the device; out-of-range indices are clipped
    as the JAX package's ``take``/``pick`` clip them."""

    def __init__(self, vocab_size=257, num_layers=2, units=64,
                 hidden_size=128, num_heads=4, max_length=256,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._heads = num_heads
        self._layers = num_layers
        self._max_len = max_length
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units,
                                        prefix="word_embed_")
            self.pos_embed = Embedding(max_length, units,
                                       prefix="pos_embed_")
            self.layers = HybridSequential(prefix="layers_")
            with self.layers.name_scope():
                for _ in range(num_layers):
                    self.layers.add(CausalLMCell(units, hidden_size,
                                                 num_heads))
            self.out_proj = Dense(vocab_size, flatten=False,
                                  in_units=units, use_bias=False,
                                  prefix="out_")
            _tie_weight(self.out_proj, self.word_embed)

    def init_kv_pool(self, n_blocks, block_size) -> torch.Tensor:
        """A zeroed fp32 pool of this model's layout on its device (the JAX
        package returns a numpy array)."""
        return torch.zeros((2 * self._layers, int(n_blocks),
                            int(block_size), self._units),
                           dtype=torch.float32, device=self.device())

    def _causal(self, b, s, device):
        pos = torch.arange(s, device=device)
        return (pos[:, None] >= pos[None, :]).expand(b * self._heads, s, s)

    @staticmethod
    def _scatter_kv(pool, layer, blocks, offsets, k, v):
        """Write one layer's K and V rows at (block, offset) per entry, in
        place; positions past a request's allocation land in scratch block
        0 (masked, finite, ignored)."""
        pool[2 * layer].index_put_((blocks, offsets), k)
        pool[2 * layer + 1].index_put_((blocks, offsets), v)

    def forward(self, tokens):
        b, s = tokens.shape[0], tokens.shape[1]
        dev = tokens.device
        x = self.word_embed(tokens) + self.pos_embed(_positions(b, s, dev))
        mask = self._causal(b, s, dev)
        for cell in self.layers:
            x = cell(x, mask)
        return self.out_proj(x)

    def hybrid_prefill(self, tokens, seq_len, table, pool):
        """``tokens`` (1, L) int32 padded to a length bucket, ``seq_len``
        (1,) int32, ``table`` (1, W) int32 block ids (W = ceil(L/block),
        tail = scratch), ``pool`` as :meth:`init_kv_pool`.  Returns ((1, V)
        logits at the last real position, ``pool``)."""
        l, bs = tokens.shape[1], pool.shape[2]
        dev = tokens.device
        x = self.word_embed(tokens) + self.pos_embed(_positions(1, l, dev))
        mask = self._causal(1, l, dev)
        pos = torch.arange(l, device=dev)
        row = table.reshape(-1).long()
        blocks = row[(pos // bs).clamp_(max=row.shape[0] - 1)]
        rem = pos % bs
        for i, cell in enumerate(self.layers):
            q, k, v = cell.qkv(x).split(self._units, dim=-1)
            self._scatter_kv(pool, i, blocks, rem, k[0], v[0])
            x = cell.attend(x, q, k, v, mask)
        last = x[0].index_select(0, (seq_len.long() - 1).clamp(0, l - 1))
        return self.out_proj(last), pool

    def hybrid_decode(self, tokens, positions, tables, pool):
        """One decode step for every row: ``tokens`` (R,) int32,
        ``positions`` (R,) int32 (each token's position: the sequence
        length before it), ``tables`` (R, W) int32, ``pool`` as
        :meth:`init_kv_pool`.  Returns ((R, V) logits, ``pool``).  Every
        op is row-independent, so a row's logits depend only on its own
        token, position and table at a given R."""
        rows, w = tokens.shape[0], tables.shape[1]
        bs = pool.shape[2]
        keys = w * bs
        pos = positions.long()
        tab = tables.long()
        x = self.word_embed(tokens) + self.pos_embed(pos)
        blocks = tab.gather(1, (pos // bs).clamp(0, w - 1)[:, None])[:, 0]
        rem = pos % bs
        # per-row prefix mask over the gathered key window: key j visible
        # iff j <= position (the new token sees itself)
        keep = torch.arange(keys, device=pos.device)[None, :] \
            <= pos[:, None]
        mask = keep[:, None, None, :].expand(rows, self._heads, 1, keys) \
            .reshape(rows * self._heads, 1, keys)
        flat = tab.reshape(-1)
        for i, cell in enumerate(self.layers):
            q, k, v = cell.qkv(x).split(self._units, dim=-1)
            self._scatter_kv(pool, i, blocks, rem, k, v)
            kc = pool[2 * i].index_select(0, flat) \
                .reshape(rows, keys, self._units)
            vc = pool[2 * i + 1].index_select(0, flat) \
                .reshape(rows, keys, self._units)
            x = cell.attend(x[:, None], q[:, None], kc, vc, mask)[:, 0]
        return self.out_proj(x), pool


def causal_lm_small(vocab_size=257, **kwargs):
    """Tiny decoder-only LM for tests and the generation-serving rows of
    ``bench.py``: 2 layers, 64 wide, 4 heads, FFN 128."""
    kwargs.setdefault("max_length", 256)
    return CausalLM(vocab_size=vocab_size, num_layers=2, units=64,
                    hidden_size=128, num_heads=4, **kwargs)
