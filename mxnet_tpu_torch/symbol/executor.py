"""Executor: a Symbol bound to arrays, with forward and backward.

Counterpart of ``mxnet_tpu/symbol/executor.py``.  The JAX package jits
the graph and keeps ``jax.vjp``'s residuals from a training forward; the
port evaluates the graph eagerly, node by node through the registry's op
functions (``Symbol.compile``), and lets torch autograd record it:

- ``forward(is_train=True)`` makes a leaf over each argument whose
  ``grad_req`` is not ``"null"`` (the argument's storage, no copy), runs
  the graph in MXNet's training mode (``autograd.train_mode``: Dropout
  drops, BatchNorm normalises by the batch and updates its moving
  statistics, the aux arrays, in place) and keeps the output tensors;
  ``forward(is_train=False)`` runs under ``torch.no_grad`` in predict
  mode;
- ``backward(out_grads)`` takes ``torch.autograd.grad`` of the outputs
  (head gradients of ones by default; ``SoftmaxOutput`` ignores its
  head) with respect to those leaves, once, and writes each gradient
  into its array by ``grad_req``: ``"write"`` copies, ``"add"`` adds,
  ``"null"`` leaves nothing.  An argument used many times (a weight of
  an unrolled RNN) is one leaf, so its gradient arrives summed and its
  array is written once per backward.

``outputs`` are ``NDArray``s over the output tensors, detached from the
graph.  The arrays are the executor's own or the caller's
(``bind``, ``simple_bind(shared_arrays=...)``): a bucketing module binds
every bucket over the same parameter and gradient arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from .. import autograd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["Executor", "grad_reqs"]

_REQS = ("write", "add", "null")


def grad_reqs(grad_req: Union[str, Sequence[str], Dict[str, str]],
              names: Sequence[str]) -> Dict[str, str]:
    """``grad_req`` as a name -> request dict: one request for every
    argument, a list in argument order, or a dict (missing names
    ``"null"``)."""
    if isinstance(grad_req, str):
        reqs = {n: grad_req for n in names}
    elif isinstance(grad_req, dict):
        reqs = {n: grad_req.get(n, "null") for n in names}
    else:
        reqs = dict(zip(names, grad_req))
    for n, r in reqs.items():
        if r not in _REQS:
            raise MXNetError(f"grad_req {r!r} of {n!r} not in {_REQS}")
    return reqs


class Executor:
    def __init__(self, symbol, ctx, arg_arrays: List[NDArray],
                 grad_arrays: List[Optional[NDArray]],
                 grad_req: Dict[str, str], aux_arrays: List[NDArray]):
        self._symbol = symbol
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        if len(arg_arrays) != len(self._arg_names):
            raise MXNetError(f"bind: {len(arg_arrays)} arrays for "
                             f"{len(self._arg_names)} arguments")
        if len(aux_arrays) != len(self._aux_names):
            raise MXNetError(f"bind: {len(aux_arrays)} aux arrays for "
                             f"{len(self._aux_names)} aux states")
        self.arg_arrays = list(arg_arrays)
        self.grad_arrays = list(grad_arrays)
        self.aux_arrays = list(aux_arrays)
        self._grad_req = dict(grad_req)
        self.outputs: List[NDArray] = []
        self._runs: Dict[bool, object] = {}
        self._heads: Optional[List[torch.Tensor]] = None
        self._leaves: List[tuple] = []

    # -- dict views --------------------------------------------------------
    @property
    def arg_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self) -> Dict[str, Optional[NDArray]]:
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def grad_req(self) -> Dict[str, str]:
        return dict(self._grad_req)

    # -- execution ---------------------------------------------------------
    def _run(self, training: bool):
        run = self._runs.get(training)
        if run is None:
            run = self._runs[training] = self._symbol.compile(training)
        return run

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Copy ``kwargs`` (name -> array) into the argument arrays and run
        the graph; returns ``outputs``."""
        args = self.arg_dict
        for k, v in kwargs.items():
            if k not in args:
                raise MXNetError(f"unknown input {k!r}")
            src = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            with torch.no_grad():
                args[k]._data.copy_(src)
        feed = {n: a._data for n, a in zip(self._aux_names,
                                           self.aux_arrays)}
        self._leaves = []
        self._heads = None
        record = is_train and any(
            r != "null" for r in self._grad_req.values())
        for i, (n, a) in enumerate(zip(self._arg_names, self.arg_arrays)):
            t = a._data
            if record and self._grad_req.get(n, "null") != "null":
                t = t.detach().requires_grad_()
                self._leaves.append((i, t))
            feed[n] = t
        mode = autograd.train_mode() if is_train else autograd.predict_mode()
        with torch.set_grad_enabled(record), mode:
            outs = self._run(is_train)(feed)
        if record:
            self._heads = outs
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, retain_graph: bool = False) -> None:
        """Gradients of the last training forward's outputs, written into
        the gradient arrays by ``grad_req`` (see the module docstring)."""
        if self._heads is None:
            raise MXNetError("backward requires a prior "
                             "forward(is_train=True)")
        if out_grads is None:
            out_grads = []
        elif isinstance(out_grads, (NDArray, torch.Tensor)):
            out_grads = [out_grads]
        heads = [h._data if isinstance(h, NDArray) else h
                 for h in out_grads]
        heads += [torch.ones_like(o) for o in self._heads[len(heads):]]
        pairs = [(o, g) for o, g in zip(self._heads, heads)
                 if o.requires_grad]
        leaves = [t for _, t in self._leaves]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], leaves, [g for _, g in pairs],
            retain_graph=retain_graph, allow_unused=True) if pairs \
            else [None] * len(leaves)
        if not retain_graph:
            self._heads = None
        with torch.no_grad():
            for (i, _), g in zip(self._leaves, grads):
                tgt = self.grad_arrays[i]
                if tgt is None:
                    continue
                req = self._grad_req[self._arg_names[i]]
                if g is None:
                    if req == "write":
                        tgt._data.zero_()
                elif req == "add":
                    tgt._data.add_(g)
                else:
                    tgt._data.copy_(g)
