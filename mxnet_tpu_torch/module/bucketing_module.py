"""BucketingModule: one Module per bucket key over one set of
parameters.

Counterpart of ``mxnet_tpu/module/bucketing_module.py``.  ``sym_gen(key)``
gives each bucket's symbol (an RNN unrolled to the bucket's length);
the default bucket's module is the master, bound and initialised first,
and every other bucket's module binds over the master's parameter,
gradient and aux arrays (``Module.bind(shared_module=...)``: the same
tensors, so an update through any bucket is every bucket's, and nothing
is copied when the bucket changes) and borrows its optimizer (one set of
states).  ``forward`` switches to the batch's ``bucket_key``, binding
that bucket's module the first time it is seen.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None,
                 group2ctxs=None, compression_params=None):
        super().__init__(logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._mod_kwargs = dict(context=context,
                                fixed_param_names=fixed_param_names,
                                logger=logger)
        self._buckets: Dict = {}
        self._curr_module: Optional[Module] = None
        self._curr_bucket_key = None
        self._opt_config = None

    # -- introspection -----------------------------------------------------
    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        return self._curr_module.output_shapes

    def _gen_module(self, bucket_key) -> Module:
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      **self._mod_kwargs)

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write") -> None:
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._buckets[self._default_bucket_key] = module
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes,
                      label_shapes=None) -> None:
        """Bind (or reuse) the module of this bucket, over the master's
        parameter arrays."""
        if not self.binded:
            raise MXNetError("switch_bucket requires bind()")
        if bucket_key not in self._buckets:
            master = self._buckets[self._default_bucket_key]
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, shared_module=master)
            if master.optimizer_initialized:
                # one set of optimizer states whichever bucket updates
                module.borrow_optimizer(master)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False) -> None:
        if self.params_initialized and not force_init:
            return
        master = self._buckets[self._default_bucket_key]
        master.init_params(initializer=initializer, arg_params=arg_params,
                           aux_params=aux_params,
                           allow_missing=allow_missing,
                           force_init=force_init, allow_extra=allow_extra)
        self.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    @property
    def buckets(self) -> Dict:
        """bucket key -> its Module."""
        return dict(self._buckets)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False) -> None:
        self._opt_config = dict(kvstore=kvstore, optimizer=optimizer,
                                optimizer_params=optimizer_params,
                                force_init=force_init)
        master = self._buckets[self._default_bucket_key]
        master.init_optimizer(**self._opt_config)
        for module in self._buckets.values():
            if module is not master:
                module.borrow_optimizer(master)
        self.optimizer_initialized = True

    # -- execution ---------------------------------------------------------
    def forward(self, data_batch, is_train=None) -> None:
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._curr_bucket_key
        self.switch_bucket(key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None) -> None:
        self._curr_module.backward(out_grads)

    def update(self) -> None:
        # the buckets share the parameters' arrays: one update is all
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels) -> None:
        self._curr_module.update_metric(eval_metric, labels)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def install_monitor(self, mon) -> None:
        """On the master's executor: every bucket binds its arrays."""
        self._buckets[self._default_bucket_key].install_monitor(mon)

    def save_checkpoint(self, prefix: str, epoch: int,
                        save_optimizer_states: bool = False) -> None:
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
