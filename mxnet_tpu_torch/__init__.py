"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

Mirrors the JAX package's layout and names.  It serves BERT-base through
``serving.ModelServer``, with attention in a hand-written Hopper
flash-attention kernel (``kernels/csrc/flash_attention.cu``), and trains
through ``autograd.record`` -> ``autograd.backward`` ->
``gluon.Trainer.step`` (ResNet-50 v1, the MNIST MLP), with the
multi-tensor SGD update in hand-written kernels
(``kernels/csrc/multi_sgd.cu``).  It imports ``torch`` and never ``jax``
or ``mxnet_tpu``.  Entry points run on ``gpu(0)`` unless the caller passes
``ctx=cpu()``.
"""
from . import autograd, base, context, gluon, initializer, kernels, \
    ndarray, observability, optimizer, serving
from .base import MXNetError
from .context import cpu, current_context, gpu
from .convert import load_reference_params

__all__ = ["MXNetError", "autograd", "base", "context", "cpu",
           "current_context", "gpu", "gluon", "initializer", "kernels",
           "load_reference_params", "ndarray", "observability", "optimizer",
           "serving"]
