"""``gluon.contrib.nn``: ``SyncBatchNorm``, and ``HybridConcurrent`` and
``Identity`` under MXNet's import path.

Counterpart of ``mxnet_tpu/gluon/contrib/nn.py``.  ``SyncBatchNorm`` is
``BatchNorm`` over the channel axis: under ``parallel.ShardedTrainer``
every ``BatchNorm`` takes the statistics of the global batch over the
ranks (as the JAX package's one-jit step does), and on ``gluon.Trainer``'s
multi-process path each process keeps its own, as in MXNet without a
sync key.  ``num_devices`` and ``key`` configured MXNet's cross-device
reduction and are accepted and ignored, ``num_devices`` with the JAX
package's warning.
"""
from ..nn import BatchNorm as _BatchNorm
from ..nn import HybridConcurrent, Identity  # noqa: F401

__all__ = ["HybridConcurrent", "Identity", "SyncBatchNorm"]


class SyncBatchNorm(_BatchNorm):
    """MXNet's cross-device BatchNorm: ``BatchNorm``, global over the
    ranks under ``ShardedTrainer``."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", key=None, **kwargs):
        if num_devices is not None:
            import warnings
            warnings.warn(
                "SyncBatchNorm: cross-device stat sync holds under "
                "parallel.ShardedTrainer (every rank's rows); on the "
                "imperative multi-process path (gluon.Trainer over a "
                "dist kvstore) stats stay process-local — num_devices is "
                "ignored", stacklevel=2)
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
