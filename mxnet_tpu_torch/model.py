"""Checkpoints of the Module API (``BatchEndParam``, ``save_checkpoint``,
``load_params``, ``load_checkpoint``) and the legacy ``FeedForward``.

Counterpart of ``mxnet_tpu/model.py``, in its on-disk layout:
``prefix-symbol.json`` (``Symbol.save``)
and ``prefix-%04d.params``, an ``nd.save`` dict whose keys carry ``arg:``
and ``aux:`` prefixes.  Both files load in the JAX package and the other
way round.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

from .base import MXNetError
from .context import DeviceLike
from .ndarray import NDArray
from .ndarray.utils import load as nd_load, save as nd_save

__all__ = ["BatchEndParam", "FeedForward", "save_checkpoint", "load_params",
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


class FeedForward:
    """The pre-Module training API (JAX ``model.py:58-232``) over
    ``mx.mod.Module``: ``fit``, ``predict``, ``score``, ``save``, ``load``
    and ``create``.  Numpy inputs (arrays or dicts of them) are wrapped in
    an ``NDArrayIter`` of ``numpy_batch_size``; the data input is
    ``data`` (or the first input that is neither a parameter nor a
    ``*_label``), the labels the inputs named ``*_label``.  ``ctx`` is
    the current context if None (``gpu(0)`` unless a ``with cpu():``
    scope is open; the JAX package's default is its CPU)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, numpy_batch_size=128, arg_params=None,
                 aux_params=None, begin_epoch=0, **kwargs):
        from .context import current_context
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else current_context()
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self._opt_kwargs = kwargs
        self._module = None
        self._label_shapes = None

    def _names(self):
        inputs = self.symbol.list_inputs()
        label_names = tuple(n for n in inputs if n.endswith("_label"))
        if "data" in inputs:
            return ("data",), label_names
        params = {n for n in inputs
                  if n.endswith(("weight", "bias", "gamma", "beta"))}
        cands = [n for n in inputs
                 if n not in params and n not in label_names]
        return tuple(cands[:1]) or ("data",), label_names

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        dn, ln = self._names()
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle, data_name=dn[0],
                           label_name=ln[0] if ln else "softmax_label")

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None):
        import logging
        from .module import Module
        it = self._as_iter(X, y, shuffle=True)
        if eval_data is not None:
            # the legacy (val_x, val_y) pair is taken here only
            eval_data = self._as_iter(*eval_data) if isinstance(
                eval_data, tuple) and len(eval_data) == 2 else \
                self._as_iter(eval_data)
        dn, ln = self._names()
        self._module = Module(self.symbol, data_names=dn, label_names=ln,
                              context=self.ctx, logger=logger or logging)
        self._label_shapes = it.provide_label
        opt_params = dict(self._opt_kwargs)
        opt_params.setdefault("learning_rate", 0.01)
        self._module.fit(
            it, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer, optimizer_params=opt_params,
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params,
            allow_missing=self.arg_params is not None,
            begin_epoch=self.begin_epoch, num_epoch=self.num_epoch)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    @staticmethod
    def _num_examples(X):
        if isinstance(X, dict):
            X = next(iter(X.values()))
        elif isinstance(X, (list, tuple)):
            X = X[0]
        return len(X)

    def _lazy_bind(self, it, label_shapes=None) -> None:
        if self._module is not None:
            return
        if self.arg_params is None:
            raise MXNetError("FeedForward: the model has no parameters; "
                             "call fit() or load() before predict()/"
                             "score()")
        from .module import Module
        dn, ln = self._names()
        self._module = Module(self.symbol, data_names=dn, label_names=ln,
                              context=self.ctx)
        self._module.bind(data_shapes=it.provide_data,
                          label_shapes=label_shapes or it.provide_label,
                          for_training=False)
        self._module.init_params(arg_params=self.arg_params,
                                 aux_params=self.aux_params)

    def predict(self, X, num_batch=None, label_shapes=None):
        """Outputs over numpy, dict or ``DataIter`` input, as numpy; a
        loss head's label input is fed zeros (``label_shapes``, default
        those seen by ``fit``)."""
        import numpy as np
        from .io import DataIter
        if label_shapes is None:
            label_shapes = self._label_shapes
        _, label_names = self._names()
        if isinstance(X, DataIter):
            it = X
        elif not label_names:
            it = self._as_iter(X)
        else:
            n = self._num_examples(X)
            y = {d.name: np.zeros((n,) + tuple(d.shape[1:]), np.float32)
                 for d in label_shapes} if label_shapes else \
                np.zeros((n,), np.float32)
            it = self._as_iter(X, y)
        self._lazy_bind(it, label_shapes=label_shapes)
        out = self._module.predict(it, num_batch=num_batch)
        if isinstance(out, (list, tuple)):
            return [o.asnumpy() for o in out]
        return out.asnumpy()

    def score(self, X, y=None, eval_metric="acc"):
        """One metric's value, or every name -> value of a composite."""
        it = self._as_iter(X, y)
        self._lazy_bind(it)
        res = dict(self._module.score(it, eval_metric))
        return next(iter(res.values())) if len(res) == 1 else res

    def save(self, prefix: str, epoch: Optional[int] = None) -> None:
        e = epoch if epoch is not None else (self.num_epoch or 0)
        save_checkpoint(prefix, e, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @classmethod
    def load(cls, prefix: str, epoch: int, ctx=None, **kwargs):
        from .context import cpu
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=cpu())
        return cls(symbol, ctx=ctx, arg_params=arg_params,
                   aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @classmethod
    def create(cls, symbol, X, y=None, ctx=None, num_epoch=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               **kwargs):
        """A model made and fitted in one call."""
        model = cls(symbol, ctx=ctx, num_epoch=num_epoch,
                    optimizer=optimizer, initializer=initializer, **kwargs)
        return model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, logger=logger)
