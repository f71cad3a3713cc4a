"""``gluon.contrib``: ``cnn.DeformableConvolution``, ``nn`` (``SyncBatchNorm``
and MXNet's import path of ``HybridConcurrent``/``Identity``), ``rnn``
(the conv cells and ``VariationalDropoutCell``) and ``estimator``
(``Estimator`` and its handlers).

Counterpart of ``mxnet_tpu/gluon/contrib/``.
"""
from . import cnn  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import estimator  # noqa: F401

__all__ = ["cnn", "estimator", "nn", "rnn"]
