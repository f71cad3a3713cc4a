"""``mx.contrib.amp``: automatic mixed precision, bf16 first.

Counterpart of ``mxnet_tpu/contrib/amp``.  ``cast`` is the port's own:
the policy helper each listed op calls.
"""
from . import lists
from .amp import (active, cast, convert_hybrid_block, convert_model,
                  convert_symbol, disable, init, init_trainer, scale_loss,
                  unscale)
from .loss_scaler import DynamicLossScaler, LossScaler, StaticLossScaler

__all__ = ["DynamicLossScaler", "LossScaler", "StaticLossScaler", "active",
           "cast", "convert_hybrid_block", "convert_model",
           "convert_symbol", "disable", "init", "init_trainer",
           "lists", "scale_loss", "unscale"]
