"""Contrib operators on the BERT serving and training paths.

Counterpart of the ``flash_attention`` registration in
``mxnet_tpu/ndarray/ops_contrib.py`` (:964-1006).  The op is the kernel
wrapper itself, which takes the op's signature
``flash_attention(q, k, v, valid_len=None, causal=False, scale=None)``.
It is differentiable in q, k and v on both devices: the forward is the
CUDA kernel on the card (its plain version on the CPU), the backward a
chunked torch function (``kernels.flash_attention_backward``), as the JAX
package's is a custom VJP in jnp.  On ``NDArray``s it returns an
``NDArray``.
"""
from ..kernels.flash_attention import flash_attention

__all__ = ["flash_attention"]
