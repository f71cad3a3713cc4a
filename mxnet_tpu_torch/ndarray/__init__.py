"""Operators as plain functions on tensors."""
from .ops_contrib import flash_attention
from .ops_optimizer import (mp_sgd_mom_update, multi_mp_sgd_mom_update,
                            multi_sgd_mom_update, multi_sgd_update,
                            sgd_mom_update, sgd_update)

__all__ = ["flash_attention", "mp_sgd_mom_update", "multi_mp_sgd_mom_update",
           "multi_sgd_mom_update", "multi_sgd_update", "sgd_mom_update",
           "sgd_update"]
