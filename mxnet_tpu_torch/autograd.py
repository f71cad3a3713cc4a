"""Imperative autograd scopes and ``backward`` over ``torch.autograd``.

Counterpart of ``mxnet_tpu/autograd.py``.  Recording and training mode are
MXNet's thread-local state:

- ``record(train_mode=True)`` records operations for gradients (it enters
  ``torch.enable_grad``) and sets training mode; ``pause`` stops recording
  (``torch.no_grad``); ``train_mode``/``predict_mode`` set the mode alone;
- ``is_training()`` is what mode-dependent layers read (``Dropout``,
  ``BatchNorm``).  ``nn.Module.training`` is not consulted: as in MXNet,
  a layer is in training mode exactly inside ``record()``/``train_mode()``.

Outside ``record()`` recording is off.  Ops on ``NDArray``s then run under
``torch.no_grad()`` (``ndarray/register.py``); on tensors PyTorch's own
grad mode is left as the caller set it.

``backward(heads, head_grads=None)`` runs one backward pass from ``heads``
into the Parameters' gradients.  A head without a head gradient gets a
gradient of ones of its own shape, as in MXNet, so a per-sample loss
vector needs no ``.mean()`` first: ``autograd.backward(loss)`` is the
port's spelling of MXNet's ``loss.backward()`` (a plain torch tensor's
``backward()`` accepts only a scalar without an explicit gradient).  How a
Parameter stores what arrives (``grad_req`` write/add) is
``gluon.Parameter``'s business.

Heads and head gradients may be ``NDArray``s (``NDArray.backward()`` calls
``backward``).  ``grad(heads, variables)`` returns the gradients without
touching the variables' buffers; ``mark_variables(variables, gradients,
grad_reqs)`` makes arrays leaves whose gradients land in the given
buffers (``NDArray.attach_grad`` with buffers of the caller's).

``Function`` is MXNet's user-defined differentiable function
(``forward``/``backward``, ``save_for_backward``/``saved_tensors``), built
on ``torch.autograd.Function``; called on ``NDArray``s, its ``forward``
and ``backward`` see ``NDArray``s and its outputs are ``NDArray``s.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Union

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward", "grad", "mark_variables", "Function",
           "get_symbol"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


class _RecordingScope:
    """Sets (recording, training) for its extent and restores both on exit;
    a scope that changes recording also switches torch's grad mode."""

    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec = recording
        self._train = training
        self._prev = None
        self._grad = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
            self._grad = torch.set_grad_enabled(self._rec)
            self._grad.__enter__()
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        if self._grad is not None:
            self._grad.__exit__(*exc)
            self._grad = None
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode: bool = True) -> _RecordingScope:
    """Record operations for gradient computation; sets training mode."""
    return _RecordingScope(True, train_mode)


def pause(train_mode: bool = False) -> _RecordingScope:
    """Suspend recording (metric updates, running-statistic writes)."""
    return _RecordingScope(False, train_mode)


def train_mode() -> _RecordingScope:
    return _RecordingScope(None, True)


def predict_mode() -> _RecordingScope:
    return _RecordingScope(None, False)


Heads = Union[torch.Tensor, Sequence[torch.Tensor]]


def _nd():
    from .ndarray.ndarray import NDArray
    return NDArray


def _tensor(x):
    return x._data if isinstance(x, _nd()) else x


def _heads(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    heads = [_tensor(h) for h in heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    if len(head_grads) != len(heads):
        raise MXNetError(f"backward: {len(heads)} heads but "
                         f"{len(head_grads)} head gradients")
    return heads, [_tensor(g) for g in head_grads]


def backward(heads: Heads, head_grads: Optional[Heads] = None,
             retain_graph: bool = False, train_mode: bool = True) -> None:
    """Backward from ``heads`` (a tensor or an ``NDArray``, or a list)
    into the gradients of the Parameters and arrays they were recorded
    from.  ``head_grads`` defaults to ones for every head; a None entry in
    a list means ones too."""
    heads, head_grads = _heads(heads, head_grads)
    live = [(h, torch.ones_like(h) if g is None else g)
            for h, g in zip(heads, head_grads) if h.requires_grad]
    if not live:
        raise MXNetError("this array is not connected to the recorded "
                         "graph; call backward inside/after "
                         "autograd.record()")
    torch.autograd.backward([h for h, _ in live], [g for _, g in live],
                            retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """The gradients of ``heads`` with respect to ``variables`` (arrays
    with ``attach_grad``), as new arrays; the variables' own gradient
    buffers are left as they are.  ``create_graph`` is not supported, as
    in the JAX package."""
    from .ndarray.ndarray import _GradState
    if create_graph:
        raise MXNetError("create_graph=True not yet supported")
    hs, gs = _heads(heads, head_grads)
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    vs = [_tensor(v) for v in variables]
    if not all(v.requires_grad for v in vs):
        raise MXNetError("each variable must have attach_grad() called "
                         "before the computation was recorded")
    gs = [torch.ones_like(h) if g is None else g for h, g in zip(hs, gs)]
    _GradState.suppressed += 1
    try:
        res = torch.autograd.grad(hs, vs, gs, retain_graph=retain_graph,
                                  allow_unused=True)
    finally:
        _GradState.suppressed -= 1
    res = [torch.zeros_like(v) if r is None else r for r, v in zip(res, vs)]
    if any(isinstance(v, _nd()) for v in variables):
        res = [_nd()(r) for r in res]
    return res[0] if single else res


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make each array of ``variables`` a leaf whose gradient lands in the
    matching array of ``gradients`` by its ``grad_req`` (write, add or
    null)."""
    from .ndarray.ndarray import attach
    variables = variables if isinstance(variables, (list, tuple)) \
        else [variables]
    gradients = gradients if isinstance(gradients, (list, tuple)) \
        else [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._data = attach(v._data, req, _tensor(g))


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function`'s ``forward``/``backward`` as one node of
    torch's graph.  What the user saves moves into torch's saved tensors
    between the two (an output kept on the instance would make a cycle
    through the graph that the garbage collector cannot see)."""

    @staticmethod
    def forward(ctx, fn, wrapped, *inputs):
        with pause():
            outputs = fn.forward(*(map(_nd(), inputs) if wrapped
                                   else inputs))
        multi = isinstance(outputs, (list, tuple))
        outs = tuple(map(_tensor, outputs)) if multi else \
            (_tensor(outputs),)
        ctx.fn, ctx.n_in, ctx.wrapped = fn, len(inputs), wrapped
        ctx.save_for_backward(*map(_tensor, fn._saved))
        fn._saved = ()
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs if multi else outs[0]

    @staticmethod
    def backward(ctx, *output_grads):
        # torch hands over zeros for an output no head reached
        # (materialize_grads), as MXNet does
        fn = ctx.fn
        saved = ctx.saved_tensors
        fn._saved = tuple(map(_nd(), saved)) if ctx.wrapped else saved
        try:
            with pause():
                grads = fn.backward(*(map(_nd(), output_grads)
                                      if ctx.wrapped else output_grads))
        finally:
            fn._saved = ()
        if not isinstance(grads, (list, tuple)):
            grads = (grads,)
        if len(grads) != ctx.n_in:
            raise MXNetError(f"{type(fn).__name__}.backward returned "
                             f"{len(grads)} gradients for {ctx.n_in} inputs")
        return (None, None) + tuple(
            _tensor(g) if need else None
            for g, need in zip(grads, ctx.needs_input_grad[2:]))


def get_symbol(x):
    """MXNet's ``autograd.get_symbol``: the recorded computation is torch's
    graph, not a graph of ops, so this raises as the JAX package's does
    (:323); ``HybridBlock`` called on a ``Symbol`` gives the graph."""
    raise MXNetError("get_symbol is not supported on the imperative tape; "
                     "use HybridBlock.hybridize() or the Symbol API")


class Function:
    """A user-defined differentiable function (MXNet's
    ``autograd.Function``).

    Subclass it with ``forward(self, *inputs)`` and ``backward(self,
    *output_grads)`` on tensors (``NDArray``s when it is called on
    them); ``backward`` returns one gradient per
    input, None for an input that takes none (an integer tensor).  Both
    run under :func:`pause`.  What ``save_for_backward`` keeps belongs to
    the call; other state set on ``self`` is shared by every call of the
    instance, so make one instance per call, as MXNet does.
    """

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors) -> None:
        self._saved = tensors

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        if not any(isinstance(x, _nd()) for x in inputs):
            return _Bridge.apply(self, False, *inputs)
        tensors = [_tensor(x) for x in inputs]
        if is_recording():
            out = _Bridge.apply(self, True, *tensors)
        else:
            with torch.no_grad():
                out = _Bridge.apply(self, True, *tensors)
        if isinstance(out, tuple):
            return tuple(map(_nd(), out))
        return _nd()(out)
