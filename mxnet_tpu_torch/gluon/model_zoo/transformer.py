"""BERT (GluonNLP-style) encoder family.

Counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py`` for the BERT
serving and pretraining paths: ``MultiHeadAttention`` (:61-184),
``PositionwiseFFN``, ``TransformerEncoderCell``, ``TransformerEncoder``,
``BERTEncoder``, ``BERTModel`` (with the tied MLM decoder) and the
``bert_base`` / ``bert_small`` configurations, with the same parameter
names and the same attention-kernel policy.  gelu is the exact (erf) form.  Under
``contrib.amp`` the masked-softmax path's two products are ``batch_dot``
(LP16) and its softmax FP32; the flash path takes q/k/v in the dtype the
qkv Dense gives them (bf16 under AMP).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ... import autograd
from ...base import MXNetError, get_env
from ...contrib.amp import amp as _amp
from ...ndarray import flash_attention
from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerEncoder", "BERTEncoder", "BERTModel", "bert_base",
           "bert_small"]


def _masked_softmax(scores, mask):
    """scores (B*H, Sq, Sk); mask broadcastable to it, 1 = keep."""
    if mask is not None:
        # additive -1e9 mask in float32, as the JAX package's XLA path
        scores = scores + (mask.float() - 1.0) * 1e9
    scores, = _amp.cast("softmax", scores)              # FP32 under AMP
    return torch.softmax(scores, dim=-1)


class MultiHeadAttention(HybridBlock):
    """Scaled dot-product self-attention with one fused QKV projection."""

    def __init__(self, units, num_heads, dropout=0.0, prefix=None,
                 params=None):
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

    def forward(self, x, mask=None, valid_len=None):
        """``mask``: attention mask broadcastable to (B*H, Sq, Sk), 1 =
        keep (the masked-softmax path).  ``valid_len``: per-sequence key
        lengths (B,) or (B*H,), which the flash path honours and from which
        the masked-softmax path builds its key mask when ``mask`` is None.
        Passing both is allowed when they express the same prefix mask."""
        b, sq = x.shape[0], x.shape[1]
        q, k, v = self.qkv(x).split(self._units, dim=-1)
        q = self._split_heads(q, b, sq)
        k = self._split_heads(k, b, sq)
        v = self._split_heads(v, b, sq)
        scale = 1.0 / math.sqrt(self._units // self._heads)
        if self._flash_eligible(mask, valid_len):
            out = flash_attention(q, k, v, valid_len, scale=scale)
        else:
            if mask is None and valid_len is not None:
                mask = self._length_mask(valid_len, b, sq)
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
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ffn1 = Dense(hidden_size, flatten=False, in_units=units,
                              prefix="ffn1_")
            self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                              prefix="ffn2_")
            self.drop = Dropout(dropout) if dropout else None
        if activation != "gelu":
            raise MXNetError(f"unsupported activation {activation!r}")

    def forward(self, x):
        h = F.gelu(self.ffn1(x), approximate="none")
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
