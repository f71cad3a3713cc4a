"""``gluon.contrib``: ``cnn.DeformableConvolution``.

Counterpart of ``mxnet_tpu/gluon/contrib/``; its ``nn``, ``rnn`` and
``estimator`` modules are not ported.
"""
from . import cnn  # noqa: F401

__all__ = ["cnn"]
