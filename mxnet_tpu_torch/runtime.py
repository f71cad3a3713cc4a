"""Runtime feature discovery: ``Features``, ``feature_list`` and
``is_enabled``.

Counterpart of ``mxnet_tpu/runtime.py`` (MXNet's ``mx.runtime``), with the
JAX package's feature names, each answering what holds for the port:
``CUDA`` is whether torch sees a card; ``TPU``, ``XLA`` and ``PALLAS``
are false (the port runs neither); ``DIST_KVSTORE`` is true (the
``dist_*`` stores over ``torch.distributed``); ``SPARSE`` is false until
the sparse arrays are ported;
``NATIVE_RUNTIME`` is whether the native io core builds and loads;
``INT64_TENSOR_SIZE`` is true (torch indexes with int64 always, so
``enable_large_tensor`` changes nothing).
"""
from __future__ import annotations

import functools
from typing import Dict, List

__all__ = ["Features", "feature_list", "is_enabled",
           "enable_large_tensor", "large_tensor_enabled"]


def enable_large_tensor(enabled: bool = True) -> None:
    """MXNet's large-tensor switch: int64 sizes and indices are torch's
    own, so there is nothing to switch."""
    del enabled


def large_tensor_enabled() -> bool:
    return True


class Feature:
    def __init__(self, name: str, enabled: bool):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


@functools.lru_cache(maxsize=1)
def _detect_cached():
    return tuple(sorted(_detect().items()))


def _detect() -> Dict[str, bool]:
    import torch
    from .native import io_available
    try:
        from PIL import Image  # noqa: F401
        image = True
    except ImportError:
        image = False
    return {"XLA": False, "TPU": False, "CPU": True,
            "CUDA": torch.cuda.is_available(), "PALLAS": False,
            "SPARSE": False, "IMAGE_DECODE": image, "BF16": True,
            "DIST_KVSTORE": True, "NATIVE_RUNTIME": io_available()}


class Features(dict):
    """Feature name -> ``Feature`` (MXNet's ``mx.runtime.Features``)."""

    def __init__(self):
        super().__init__({k: Feature(k, v) for k, v in _detect_cached()})
        self["INT64_TENSOR_SIZE"] = Feature("INT64_TENSOR_SIZE",
                                            large_tensor_enabled())

    def is_enabled(self, name: str) -> bool:
        f = self.get(name)
        return bool(f and f.enabled)

    def __repr__(self):
        return ", ".join(repr(v) for v in self.values())


def feature_list() -> List[Feature]:
    return list(Features().values())


def is_enabled(name: str) -> bool:
    return Features().is_enabled(name)
