"""Carry the JAX package's initialized weights into a port model.

``load_reference_params(net, arrays)`` takes the reference model's
``collect_params()`` values as numpy arrays, keyed by their full names, and
loads them into ``net``.  Names are matched with the top-level instance
prefix stripped on both sides (``bertmodel3_enc_...`` meets
``bertmodel0_enc_...``), so the instance counters of the process that built
either model do not matter.  A model may also hold blocks made outside its
own name scope (SSD's backbone ``resnetv12_...`` and extras
``conv2_d7_...``), whose names carry the process's global counters: those,
and any name left unmatched, are matched with every instance counter
blanked (``conv2_d#_weight``), in ``collect_params()`` order, which both
packages build alike.  A tied weight (BERT's MLM decoder
shares the word embedding) is one parameter on both sides and loads once.
A parameter whose shape is still deferred takes the array's shape (as the
JAX package's ``set_data``); a known dimension must agree.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict

import numpy as np

from .base import MXNetError
from .context import DeviceLike, as_device
from .gluon.block import Block

__all__ = ["load_reference_params"]

_COUNTER = re.compile(r"(?<=[a-z])\d+(?=_)")


def _instance_pattern(prefix: str) -> re.Pattern:
    """``bertmodel0_`` matches any ``bertmodel<N>_``; an explicit prefix
    without a counter matches itself."""
    m = re.fullmatch(r"(.*?)\d+_", prefix)
    body = re.escape(m.group(1)) + r"\d+_" if m else re.escape(prefix)
    return re.compile("^" + body)


def _blind(key) -> tuple:
    inside, name = key
    return inside, _COUNTER.sub("#", name)


def _match(ours: list, theirs: list) -> list:
    """(our value, their value) pairs from two ordered lists of ((inside
    the model's prefix, short name), value): equal names inside the
    prefix first, then the rest by counter-blind name in order; raises on
    names left over."""
    pairs, rest, used = [], [], set()
    exact = defaultdict(list)
    for i, (k, _) in enumerate(theirs):
        if k[0]:
            exact[k].append(i)
    for k, p in ours:
        if exact.get(k):
            i = exact[k].pop(0)
            used.add(i)
            pairs.append((p, theirs[i][1]))
        else:
            rest.append((k, p))
    blind = defaultdict(list)
    for i, (k, _) in enumerate(theirs):
        if i not in used:
            blind[_blind(k)].append(i)
    missing = []
    for k, p in rest:
        queue = blind.get(_blind(k))
        if queue:
            pairs.append((p, theirs[queue.pop(0)][1]))
        else:
            missing.append(k[1])
    extra = sorted(theirs[i][0][1] for q in blind.values() for i in q)
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing "
                         f"{sorted(missing)}, extra {extra}")
    return pairs


def load_reference_params(net: Block, arrays: Dict[str, np.ndarray],
                          ctx: DeviceLike = None) -> None:
    """Load ``arrays`` into ``net``'s parameters on ``ctx`` (default
    ``gpu(0)``, as ``initialize``); raises MXNetError on a missing key, an
    extra key or a shape mismatch, before it loads anything."""
    dev = as_device(ctx)
    pat = _instance_pattern(net.prefix)

    def key(name):
        short, inside = pat.subn("", name, count=1)
        return bool(inside), short

    pairs = _match([(key(k), p) for k, p in net.collect_params().items()],
                   [(key(k), arr) for k, arr in arrays.items()])
    for p, arr in pairs:
        if not p.accepts_shape(np.shape(arr)):
            raise MXNetError(f"shape mismatch for {p.name!r}: reference "
                             f"{tuple(np.shape(arr))}, port {p.shape}")
    for p, arr in pairs:
        p.set_data(arr, ctx=dev)
