"""``CTCLoss``: Connectionist Temporal Classification.

Counterpart of ``mxnet_tpu/ndarray/ops_ctc.py`` (:112; MXNet's
``src/operator/nn/ctc_loss.cc``): data ``(T, N, C)`` of unnormalised
scores, labels ``(N, L)``, the optional ``data_lengths`` and
``label_lengths`` inputs, ``blank_label`` "first" (class 0 is the blank,
labels are 1-based and 0 pads) or "last" (class ``C - 1`` is the blank,
negative entries pad).  Returns each sample's negative log likelihood.
The JAX package runs the alpha recursion as a ``lax.scan``; here it is
``torch.nn.functional.ctc_loss`` on the log-softmax of the data (cuDNN
or torch's kernel on the card), with the same label rules: label
lengths from the padding unless given, classes clipped into range.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .register import register_op


def ctc_loss_maker(use_data_lengths=False, use_label_lengths=False,
                   blank_label="first"):
    if blank_label not in ("first", "last"):
        raise MXNetError(f"CTCLoss: blank_label {blank_label!r} not in "
                         f"first, last")

    def fn(data, label, *lengths):
        t, n, c = data.shape
        if data.is_meta:                 # shape inference: (N,) float32
            return data.new_empty((n,), dtype=torch.float32)
        lengths = list(lengths)
        data_len = lengths.pop(0).long() if use_data_lengths else \
            torch.full((n,), t, dtype=torch.long)
        lab = label.long()
        if use_label_lengths:
            label_len = lengths.pop(0).long()
        else:
            valid = lab >= 0 if blank_label == "last" else lab > 0
            label_len = valid.sum(dim=1)
        blank = 0 if blank_label == "first" else c - 1
        logp = torch.log_softmax(data.float(), dim=2)
        return F.ctc_loss(logp, lab.clamp(0, c - 1),
                          data_len.to(data.device), label_len.to(data.device),
                          blank=blank, reduction="none")
    return fn


register_op("CTCLoss", ctc_loss_maker,
            aliases=("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"))
