"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

Sources live in ``csrc/`` and are built by ``_build`` at first use (on a
machine with the CUDA toolkit).  ``_nvrtc`` binds NVRTC and the CUDA
driver API for ``mxnet_tpu_torch.rtc``, which compiles users' CUDA source
strings at run time.  Importing this package builds and loads nothing.
"""
from .flash_attention import (flash_attention, flash_attention_backward,
                              flash_attention_plain)
from .multi_sgd import (multi_mp_sgd, multi_mp_sgd_mom,
                        multi_mp_sgd_mom_plain, multi_mp_sgd_plain,
                        multi_sgd, multi_sgd_mom, multi_sgd_mom_plain,
                        multi_sgd_plain)

__all__ = ["flash_attention", "flash_attention_backward",
           "flash_attention_plain", "multi_mp_sgd", "multi_mp_sgd_mom",
           "multi_mp_sgd_mom_plain", "multi_mp_sgd_plain", "multi_sgd",
           "multi_sgd_mom", "multi_sgd_mom_plain", "multi_sgd_plain"]
