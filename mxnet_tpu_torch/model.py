"""Checkpoints of the Module API: ``BatchEndParam``, ``save_checkpoint``,
``load_params`` and ``load_checkpoint``.

Counterpart of ``mxnet_tpu/model.py`` (the legacy ``FeedForward`` is not
ported), in its on-disk layout: ``prefix-symbol.json`` (``Symbol.save``)
and ``prefix-%04d.params``, an ``nd.save`` dict whose keys carry ``arg:``
and ``aux:`` prefixes.  Both files load in the JAX package and the other
way round.
"""
from __future__ import annotations

import collections
from typing import Dict, Tuple

from .context import DeviceLike
from .ndarray import NDArray
from .ndarray.utils import load as nd_load, save as nd_save

__all__ = ["BatchEndParam", "save_checkpoint", "load_params",
           "load_checkpoint"]

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix: str, epoch: int, symbol, arg_params: Dict,
                    aux_params: Dict, remove_amp_cast: bool = True) -> None:
    """Write ``prefix-symbol.json`` (unless ``symbol`` is None) and
    ``prefix-%04d.params``.  ``remove_amp_cast`` is taken and, as the JAX
    package does (``mxnet_tpu/model.py:25-31``), not acted on: a graph
    converted by ``amp.convert_model`` is written with its casts, so it
    loads back converted, in either package."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    nd_save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(fname: str, ctx: DeviceLike = None
                ) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
    """``(arg_params, aux_params)`` of a params file, by key prefix (a key
    without one is an argument), on ``ctx`` (the current context if
    None)."""
    arg_params, aux_params = {}, {}
    for k, v in nd_load(fname, ctx=ctx).items():
        tp, _, name = k.partition(":")
        if tp == "aux":
            aux_params[name] = v
        else:
            arg_params[name if tp == "arg" else k] = v
    return arg_params, aux_params


def load_checkpoint(prefix: str, epoch: int, ctx: DeviceLike = None):
    """``(symbol, arg_params, aux_params)`` as ``save_checkpoint`` wrote
    them."""
    from . import symbol as sym_mod
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(f"{prefix}-{epoch:04d}.params",
                                         ctx)
    return symbol, arg_params, aux_params
