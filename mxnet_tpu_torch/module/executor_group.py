"""DataParallelExecutorGroup on one context: the bound executor of a
Module.

Counterpart of ``mxnet_tpu/module/executor_group.py``.  The JAX package
binds one executor per context and slices the batch across them; the
port binds one, on one context, and raises for more (data parallelism
across cards is the distributed slice's).  Each argument's ``grad_req``
follows the Module's roles: a parameter takes ``grad_req`` (``"null"``
when fixed or not training), a data input ``"write"`` only with
``inputs_need_grad``, a label ``"null"``.  ``shared_arrays`` (name ->
``(array, gradient)``) binds a parameter over arrays it does not own: the
buckets of a ``BucketingModule`` share one set.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..base import MXNetError
from ..context import Context
from ..io import DataDesc
from ..ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts: Sequence[Context],
                 data_shapes: List[DataDesc],
                 label_shapes: Optional[List[DataDesc]],
                 param_names: List[str], for_training: bool,
                 inputs_need_grad: bool = False,
                 fixed_param_names: Sequence[str] = (),
                 grad_req: str = "write",
                 shared_arrays: Optional[Dict[str, tuple]] = None):
        if len(contexts) != 1:
            raise MXNetError(f"Module on {len(contexts)} contexts: the port "
                             f"binds one (multi-card data parallelism is "
                             f"not ported)")
        self.symbol = symbol
        self.contexts = list(contexts)
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes or [])
        arg_names = symbol.list_arguments()
        inputs = [d.name for d in self.data_shapes + self.label_shapes]
        for name in inputs:
            if name not in arg_names:
                raise MXNetError(f"input {name!r} not an argument of the "
                                 f"symbol (arguments: {arg_names})")
        fixed = set(fixed_param_names)
        data_names = {d.name for d in self.data_shapes}
        reqs = {}
        for name in arg_names:
            if name in self.param_names:
                reqs[name] = grad_req if for_training and name not in fixed \
                    else "null"
            elif name in data_names:
                reqs[name] = "write" if inputs_need_grad else "null"
            else:
                reqs[name] = "null"
        self.grad_req = reqs
        exe = symbol.simple_bind(
            ctx=self.contexts[0], grad_req=reqs,
            shared_arrays=shared_arrays,
            **{d.name: d.shape for d in self.data_shapes + self.label_shapes})
        self.execs = [exe]

    def forward(self, data_batch, is_train: Optional[bool] = None) -> None:
        if is_train is None:
            is_train = self.for_training
        feeds = {d.name: v for d, v in zip(self.data_shapes,
                                           data_batch.data)}
        if self.label_shapes and data_batch.label:
            feeds.update({d.name: v for d, v in zip(self.label_shapes,
                                                    data_batch.label)})
        self.execs[0].forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None) -> None:
        self.execs[0].backward(out_grads)

    def get_outputs(self, merge_multi_context: bool = True
                    ) -> List[NDArray]:
        return list(self.execs[0].outputs)

    def grad_arrays_of(self, name: str) -> List[NDArray]:
        g = self.execs[0].grad_dict.get(name)
        return [] if g is None else [g]

    def update_metric(self, eval_metric, labels) -> None:
        eval_metric.update(labels, self.get_outputs())
