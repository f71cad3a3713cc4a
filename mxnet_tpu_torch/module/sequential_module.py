"""``SequentialModule``, ``PythonModule`` and ``PythonLossModule``.

Counterpart of ``mxnet_tpu/module/sequential_module.py`` (:22-287).
``SequentialModule`` chains modules: each stage's outputs are the next
stage's data (by position, under the next module's data names), the
stage added with ``take_labels=True`` gets the batch's labels, and
``backward`` hands each stage's input gradients to the stage before as
its ``out_grads`` (every stage after the first is bound with
``inputs_need_grad``).  ``get_params`` merges the stages' parameters,
``update`` updates each stage in order, and ``update_metric`` scores the
labelled stage (the last if none is).  ``PythonModule`` is a module
written in Python (override ``forward``/``backward``), and
``PythonLossModule`` a loss head whose gradient ``grad_func(scores,
labels)`` gives (by default softmax cross-entropy's, ``softmax(scores) -
one_hot(labels)``).
"""
from __future__ import annotations

import logging
from typing import List

from ..base import MXNetError
from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule", "PythonModule", "PythonLossModule"]


class SequentialModule(BaseModule):
    """Modules run one after another (``add(module, take_labels=True)``
    marks the stage that takes the labels)."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules: List[BaseModule] = []
        self._metas: List[dict] = []
        self._label_shapes = None

    def add(self, module: BaseModule, **kwargs) -> "SequentialModule":
        self._modules.append(module)
        self._metas.append(kwargs)
        return self

    def _takes_labels(self, i: int) -> bool:
        return bool(self._metas[i].get(self.META_TAKE_LABELS, False))

    # -- shapes ------------------------------------------------------------
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    # -- lifecycle ---------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write") -> None:
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("SequentialModule.bind: no modules added")
        self._label_shapes = label_shapes
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        cur = [d if isinstance(d, DataDesc) else DataDesc(*d)
               for d in data_shapes]
        for i, mod in enumerate(self._modules):
            labels = label_shapes if self._takes_labels(i) else None
            mod.bind(cur, labels, for_training=for_training,
                     inputs_need_grad=inputs_need_grad if i == 0 else True,
                     force_rebind=force_rebind)
            if i == len(self._modules) - 1:
                break
            if hasattr(mod, "symbol"):
                feed = {d.name: d.shape for d in cur}
                feed.update({(d if isinstance(d, DataDesc) else
                              DataDesc(*d)).name:
                             (d if isinstance(d, DataDesc) else
                              DataDesc(*d)).shape for d in labels or []})
                _, out_shapes, _ = mod.symbol.infer_shape(**feed)
            else:
                out_shapes = [s.shape if hasattr(s, "shape") else s[1]
                              for s in mod.output_shapes]
            nxt = self._modules[i + 1]
            if len(nxt.data_names) != len(out_shapes):
                raise MXNetError(
                    f"SequentialModule: stage {i} gives {len(out_shapes)} "
                    f"outputs but stage {i + 1} takes "
                    f"{len(nxt.data_names)} data inputs")
            cur = [DataDesc(n, s) for n, s in zip(nxt.data_names,
                                                  out_shapes)]
        self.binded = True

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False) -> None:
        for mod in self._modules:
            mod.init_params(initializer=initializer, arg_params=arg_params,
                            aux_params=aux_params, allow_missing=True,
                            force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False) -> None:
        for mod in self._modules:
            mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        self.optimizer_initialized = True

    # -- execution ---------------------------------------------------------
    def forward(self, data_batch, is_train=None) -> None:
        batch = data_batch
        for i, mod in enumerate(self._modules):
            mod.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            outs = mod.get_outputs()
            nxt = self._modules[i + 1]
            batch = DataBatch(
                data=outs, label=data_batch.label,
                pad=getattr(data_batch, "pad", 0),
                provide_data=[DataDesc(n, o.shape)
                              for n, o in zip(nxt.data_names, outs)],
                provide_label=getattr(data_batch, "provide_label", None))

    def backward(self, out_grads=None) -> None:
        for i in reversed(range(len(self._modules))):
            mod = self._modules[i]
            mod.backward(out_grads=out_grads)
            if i == 0:
                break
            if not hasattr(mod, "get_input_grads"):
                raise MXNetError(
                    f"SequentialModule stage {i} ({type(mod).__name__}) "
                    f"has no get_input_grads; the backward chain cannot "
                    f"continue")
            out_grads = mod.get_input_grads()

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update(self) -> None:
        for mod in self._modules:
            mod.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_params(self):
        arg, aux = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def update_metric(self, eval_metric, labels) -> None:
        for i, mod in enumerate(self._modules):
            if self._takes_labels(i):
                mod.update_metric(eval_metric, labels)
                return
        self._modules[-1].update_metric(eval_metric, labels)

    def install_monitor(self, mon) -> None:
        for mod in self._modules:
            mod.install_monitor(mon)


class PythonModule(BaseModule):
    """A module computed in Python: subclass it and override
    ``forward``, ``get_outputs``, ``backward`` and
    ``_compute_output_shapes``; it has no parameters by default."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write") -> None:
        if self.binded and not force_rebind:
            return
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError

    def init_params(self, *args, **kwargs) -> None:
        self.params_initialized = True

    def init_optimizer(self, *args, **kwargs) -> None:
        self.optimizer_initialized = True

    def get_params(self):
        return {}, {}

    def update(self) -> None:
        pass

    def update_metric(self, eval_metric, labels) -> None:
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())


class PythonLossModule(PythonModule):
    """A loss head in Python: ``forward`` keeps the scores (its output)
    and labels, ``backward`` computes the scores' gradient with
    ``grad_func(scores, labels)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None) -> None:
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None) -> None:
        if self._grad_func is not None:
            self._scores_grad = self._grad_func(self._scores, self._labels)
            return
        from .. import ndarray as nd
        p = nd.softmax(self._scores)
        self._scores_grad = p - nd.one_hot(self._labels,
                                           depth=self._scores.shape[-1])

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
