"""SSD single-shot detector (BASELINE config #5, first half).

Counterpart of ``mxnet_tpu/gluon/model_zoo/ssd.py``: multi-scale feature
stages, a ``MultiBoxPrior`` anchor generator and two 3x3 conv predictors
per scale, and ``SSDMultiBoxLoss`` (cross-entropy over ``MultiBoxTarget``'s
matches and mined hard negatives, plus smooth-L1 on the matched anchors'
offsets, over the number of positives).  Blocks, parameters and their
creation order are the JAX package's, so ``collect_params()`` names match
and ``load_reference_params`` carries weights across; as there, the
predictors and the extra down-sampling stages leave their input widths to
deferred shape inference (the first forward settles them).

``ssd_512_resnet50_v1`` splits the port's ``resnet50_v1`` features after
stage 3 (stride 16) and stage 4 (stride 32) and adds four extra stages:
six scales, 5,630 anchors at 512 x 512.  The detection ops are torch code
(``ndarray/ops_contrib.py``); the update goes through ``gluon.Trainer``.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ...base import MXNetError
from ...ndarray.ops_contrib import (multibox_prior_maker,
                                    multibox_target_maker)
from ...ndarray.ops_matrix import smooth_l1_maker
from .. import nn
from ..block import HybridBlock
from ..loss import Loss

__all__ = ["SSDAnchorGenerator", "ConvPredictor", "SSD", "SSDMultiBoxLoss",
           "ssd_512_resnet50_v1", "ssd_toy"]


class SSDAnchorGenerator(HybridBlock):
    """One scale's anchors, ``MultiBoxPrior`` of its feature map."""

    def __init__(self, sizes, ratios, clip=True, **kwargs):
        super().__init__(**kwargs)
        self._sizes = tuple(sizes)
        self._ratios = tuple(ratios)
        self._prior = multibox_prior_maker(self._sizes, self._ratios, clip)

    @property
    def num_anchors(self) -> int:
        return len(self._sizes) + len(self._ratios) - 1

    def forward(self, x):
        return self._prior(x)


class ConvPredictor(HybridBlock):
    """3x3 conv emitting ``num_outputs`` values per anchor position."""

    def __init__(self, num_outputs, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.predictor = nn.Conv2D(num_outputs, 3, 1, 1)

    def forward(self, x):
        return self.predictor(x)


class SSD(HybridBlock):
    """Multi-scale detector over ``stages`` (applied in turn; each
    stage's output is a prediction source).  Returns (anchors (1, N, 4),
    cls_preds (B, N, classes + 1), box_preds (B, N * 4))."""

    def __init__(self, stages: Sequence[HybridBlock], classes: int,
                 sizes: Sequence[Sequence[float]],
                 ratios: Sequence[Sequence[float]], **kwargs):
        super().__init__(**kwargs)
        if not len(stages) == len(sizes) == len(ratios):
            raise MXNetError("stages, sizes, ratios must align per scale")
        self._classes = classes
        with self.name_scope():
            self.stages = nn.HybridSequential(prefix="stages_")
            for s in stages:
                self.stages.add(s)
            self.anchor_generators = []
            self.class_predictors = nn.HybridSequential(prefix="cls_")
            self.box_predictors = nn.HybridSequential(prefix="box_")
            for i, (s, r) in enumerate(zip(sizes, ratios)):
                gen = SSDAnchorGenerator(s, r, prefix=f"anchor{i}_")
                self.anchor_generators.append(gen)
                self.register_child(gen)
                na = gen.num_anchors
                self.class_predictors.add(ConvPredictor(na * (classes + 1)))
                self.box_predictors.add(ConvPredictor(na * 4))

    @property
    def classes(self) -> int:
        return self._classes

    def forward(self, x):
        anchors, cls_preds, box_preds = [], [], []
        for stage, gen, cp, bp in zip(self.stages, self.anchor_generators,
                                      self.class_predictors,
                                      self.box_predictors):
            x = stage(x)
            anchors.append(gen(x))
            # (B, A * (C + 1), H, W) -> (B, H * W * A, C + 1)
            c = cp(x).permute(0, 2, 3, 1)
            cls_preds.append(c.reshape(c.shape[0], -1, self._classes + 1))
            b = bp(x).permute(0, 2, 3, 1)
            box_preds.append(b.reshape(b.shape[0], -1))
        return (torch.cat(anchors, dim=1), torch.cat(cls_preds, dim=1),
                torch.cat(box_preds, dim=1))


class SSDMultiBoxLoss(Loss):
    """Smooth-L1 on the matched anchors' offsets plus cross-entropy over
    the matched and mined anchors (``MultiBoxTarget``; target -1 is
    ignored), summed over the batch and divided by the number of positive
    anchors (at least 1).  The targets carry no gradient.  ``targets``
    computes them; a caller may replace it to hold a run to another
    run's matches."""

    def __init__(self, negative_mining_ratio=3.0, overlap_threshold=0.5,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._target = multibox_target_maker(
            overlap_threshold=overlap_threshold, ignore_label=-1.0,
            negative_mining_ratio=negative_mining_ratio)
        self._smooth_l1 = smooth_l1_maker(1.0)

    def targets(self, anchors, cls_preds, labels):
        """(loc_target, loc_mask, cls_target) of ``MultiBoxTarget``."""
        return self._target(anchors, labels, cls_preds.transpose(1, 2))

    def forward(self, anchors, cls_preds, box_preds, labels):
        loc_t, loc_m, cls_t = (t.detach() for t in
                               self.targets(anchors, cls_preds, labels))
        logp = torch.log_softmax(cls_preds, dim=-1)
        pick = cls_t.clamp(min=0).long().unsqueeze(-1)
        cls_loss = -torch.gather(logp, -1, pick).squeeze(-1)
        cls_loss = torch.where(cls_t >= 0, cls_loss,
                               torch.zeros_like(cls_loss))
        loc_loss = self._smooth_l1(box_preds - loc_t) * loc_m
        num_pos = (loc_m.sum() / 4.0).clamp(min=1.0)
        return (cls_loss.sum() + loc_loss.sum()) / num_pos


def _down_block(channels: int) -> nn.HybridSequential:
    """1x1 squeeze + 3x3 stride-2 expand (the standard SSD extra stage),
    its input width deferred."""
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels // 2, 1, 1, 0, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(channels, 3, 2, 1, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"))
    return blk


# per-scale anchors of the 512 variant (GluonCV's ssd_512 settings)
_SIZES_512 = [[0.07, 0.1025], [0.15, 0.2121], [0.3, 0.3674],
              [0.45, 0.5196], [0.6, 0.6708], [0.75, 0.8216]]
_RATIOS_512 = [[1, 2, 0.5]] * 2 + [[1, 2, 0.5, 3, 1.0 / 3]] * 4


def ssd_512_resnet50_v1(classes: int = 20, **kwargs) -> SSD:
    """SSD-512 on a ResNet-50 v1 backbone (BASELINE config #5)."""
    from .vision.resnet import resnet50_v1
    feats = list(resnet50_v1().features)  # conv bn relu pool stage1-4 gap
    stage1 = nn.HybridSequential(prefix="base3_")
    for f in feats[:7]:                   # through stage 3 (stride 16)
        stage1.add(f)
    stage2 = nn.HybridSequential(prefix="base4_")
    stage2.add(feats[7])                  # stage 4 (stride 32)
    stages: List[HybridBlock] = [stage1, stage2]
    stages += [_down_block(512) for _ in range(4)]
    return SSD(stages, classes, _SIZES_512, _RATIOS_512, **kwargs)


def ssd_toy(classes: int = 3, **kwargs) -> SSD:
    """A small 3-scale SSD for tests (thumbnail inputs)."""
    s1 = nn.HybridSequential()
    s1.add(nn.Conv2D(16, 3, 2, 1), nn.Activation("relu"),
           nn.Conv2D(32, 3, 2, 1), nn.Activation("relu"))
    return SSD([s1, _down_block(64), _down_block(64)], classes,
               sizes=[[0.2, 0.272], [0.37, 0.447], [0.54, 0.619]],
               ratios=[[1, 2, 0.5]] * 3, **kwargs)
