"""Operators as plain functions on tensors, and array creation."""
from .ndarray import array, empty, full, ones, zeros
from .ops_contrib import flash_attention
from .ops_custom import Custom
from .ops_matrix import pick
from .ops_nn import log_softmax
from .ops_optimizer import (adam_update, mp_sgd_mom_update, mp_sgd_update,
                            multi_mp_sgd_mom_update, multi_sgd_mom_update,
                            multi_sgd_update, sgd_mom_update, sgd_update)
from .ops_reduce import mean, sum

__all__ = ["Custom", "adam_update", "array", "empty", "flash_attention",
           "full", "log_softmax", "mean", "mp_sgd_mom_update", "mp_sgd_update",
           "multi_mp_sgd_mom_update", "multi_sgd_mom_update",
           "multi_sgd_update", "ones", "pick", "sgd_mom_update",
           "sgd_update", "sum", "zeros"]
