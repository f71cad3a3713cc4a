"""``mx.rnn`` data helpers: ``encode_sentences`` and
``BucketSentenceIter``.

Counterpart of ``mxnet_tpu/rnn/io.py``.  ``BucketSentenceIter`` pads id
sequences to the smallest bucket that holds them (longer ones are
discarded) and yields per-bucket ``DataBatch``es whose label is the data
shifted by one (``invalid_label`` at the end), each with its
``bucket_key`` for ``BucketingModule``.  Its shuffles draw from Python's
and numpy's global streams.
"""
from __future__ import annotations

import random as _pyrandom
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences: Sequence[Sequence[str]],
                     vocab: Optional[Dict[str, int]] = None,
                     invalid_label: int = -1, invalid_key: str = "\n",
                     start_label: int = 0,
                     unknown_token: Optional[str] = None):
    """Map token sequences to id sequences, growing ``vocab`` as needed."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
        idx = max([v for v in vocab.values() if v != invalid_label],
                  default=start_label - 1) + 1
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token is None:
                        raise MXNetError(f"unknown token {word!r}")
                    word = unknown_token
                    if word not in vocab:
                        vocab[word] = idx
                        idx += 1
                else:
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pad id sequences into per-bucket batches; each ``DataBatch``
    carries its ``bucket_key``."""

    def __init__(self, sentences: Sequence[Sequence[int]], batch_size: int,
                 buckets: Optional[Sequence[int]] = None,
                 invalid_label: int = -1, data_name: str = "data",
                 label_name: str = "softmax_label", dtype: str = "float32",
                 layout: str = "NT"):
        super().__init__(batch_size)
        if buckets is None:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(counts)
                       if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets = sorted(buckets)
        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]
        self.buckets = list(buckets)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        self.ndiscard = ndiscard

        shape = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else (self.default_bucket_key,
                                          batch_size)
        self.provide_data = [DataDesc(data_name, shape, dtype)]
        self.provide_label = [DataDesc(label_name, shape, dtype)]

        self.idx: List[Tuple[int, int]] = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self) -> None:
        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)

    def next(self) -> DataBatch:
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        buf = self.data[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data = nd.array(buf.T, ctx=cpu())
            label_np = np.full_like(buf, self.invalid_label)
            label_np[:, :-1] = buf[:, 1:]
            label = nd.array(label_np.T, ctx=cpu())
        else:
            data = nd.array(buf, ctx=cpu())
            label_np = np.full_like(buf, self.invalid_label)
            label_np[:, :-1] = buf[:, 1:]
            label = nd.array(label_np, ctx=cpu())
        shape = data.shape
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, shape,
                                                self.dtype)],
                         provide_label=[DataDesc(self.label_name, shape,
                                                 self.dtype)])
