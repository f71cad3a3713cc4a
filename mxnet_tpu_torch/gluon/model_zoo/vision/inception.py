"""Inception v3 (Szegedy et al. 2015), 299 x 299 input.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``: the
factorised A-E blocks as ``HybridConcurrent`` branches (E's nested splits
in a block of its own), BatchNorm with epsilon 0.001, the same creation
order and parameter names.
"""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock
from ._common import finish

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        kwargs = {k: v for k, v in zip(
            ("channels", "kernel_size", "strides", "padding"), setting)
            if v is not None}
        out.add(_make_basic_conv(**kwargs))
    return out


def _concurrent(prefix, *branches):
    out = nn.HybridConcurrent(axis=1, prefix=prefix)
    with out.name_scope():
        for make in branches:
            out.add(make())
    return out


def _make_A(pool_features, prefix):
    return _concurrent(
        prefix,
        lambda: _make_branch(None, (64, 1, None, None)),
        lambda: _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        lambda: _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1)),
        lambda: _make_branch("avg", (pool_features, 1, None, None)))


def _make_B(prefix):
    return _concurrent(
        prefix,
        lambda: _make_branch(None, (384, 3, 2, None)),
        lambda: _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None)),
        lambda: _make_branch("max"))


def _make_C(channels_7x7, prefix):
    c = channels_7x7
    return _concurrent(
        prefix,
        lambda: _make_branch(None, (192, 1, None, None)),
        lambda: _make_branch(None, (c, 1, None, None),
                             (c, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))),
        lambda: _make_branch(None, (c, 1, None, None),
                             (c, (7, 1), None, (3, 0)),
                             (c, (1, 7), None, (0, 3)),
                             (c, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))),
        lambda: _make_branch("avg", (192, 1, None, None)))


def _make_D(prefix):
    return _concurrent(
        prefix,
        lambda: _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        lambda: _make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)),
        lambda: _make_branch("max"))


class _InceptionE(HybridBlock):
    """Block E: its 3x3 branches fan out into a 1x3 and a 3x1 conv."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.b0 = _make_branch(None, (320, 1, None, None))
            self.b1_stem = _make_branch(None, (384, 1, None, None))
            self.b1_a = _make_branch(None, (384, (1, 3), None, (0, 1)))
            self.b1_b = _make_branch(None, (384, (3, 1), None, (1, 0)))
            self.b2_stem = _make_branch(None, (448, 1, None, None),
                                        (384, 3, None, 1))
            self.b2_a = _make_branch(None, (384, (1, 3), None, (0, 1)))
            self.b2_b = _make_branch(None, (384, (3, 1), None, (1, 0)))
            self.b3 = _make_branch("avg", (192, 1, None, None))

    def forward(self, x):
        y1 = self.b1_stem(x)
        y2 = self.b2_stem(x)
        return torch.cat([self.b0(x), self.b1_a(y1), self.b1_b(y1),
                          self.b2_a(y2), self.b2_b(y2), self.b3(x)], dim=1)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_InceptionE(prefix="E1_"))
            self.features.add(_InceptionE(prefix="E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, **kwargs):
    return finish(Inception3(**kwargs), pretrained, ctx)
