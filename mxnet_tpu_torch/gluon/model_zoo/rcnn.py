"""Faster-RCNN / Mask-RCNN (BASELINE config #5, second half).

Counterpart of ``mxnet_tpu/gluon/model_zoo/rcnn.py``, static-shaped end
to end as there: backbone features -> RPN head -> ``Proposal`` (greedy
NMS, a fixed ``rpn_post_nms`` rois per image, padding rois all zero) ->
``ROIAlign`` -> a Dense box head (class and box predictors) and, for
Mask-RCNN, a conv mask head (two 3x3 convs, a 2x2 stride-2
``Conv2DTranspose``, a 1x1 conv) on the same pooled features.  Blocks and
parameter names are the JAX package's; the heads leave their input widths
to deferred shape inference.

Gradients follow MXNet, not the JAX package: ``Proposal``'s rois carry no
gradient (MXNet's ``proposal.cc`` has none, and ``ROIAlign`` takes none
into its rois), so ``rpn_loc`` learns only from the RPN's own box loss.
In the JAX package the rois are differentiable, and the RPN and the
backbone also receive the gradient that flows back through ``ROIAlign``'s
sampling points and ``box_encode``'s targets.  Everything downstream of
the rois (the box head, the predictors, the mask head) gets the same
gradient in both.

``faster_rcnn_resnet18_v1``/``mask_rcnn_resnet18_v1`` take the port's
``resnet18_v1`` features without their last three children (stage 3,
stage 4 and the pooling), as the JAX package does: that trunk ends at
stride 8, while the RPN and ``ROIAlign`` use the default ``stride`` 16,
also as there.
"""
from __future__ import annotations

import torch

from ...ndarray.ops_contrib import (box_encode_maker, box_iou_maker,
                                    proposal_maker, roi_align_maker,
                                    rpn_anchors)
from ...ndarray.ops_matrix import smooth_l1_maker
from .. import nn
from ..block import HybridBlock
from ..loss import (Loss, SigmoidBinaryCrossEntropyLoss,
                    SoftmaxCrossEntropyLoss)

__all__ = ["RPNHead", "FasterRCNN", "MaskRCNN", "RCNNLoss",
           "faster_rcnn_resnet18_v1", "mask_rcnn_resnet18_v1",
           "faster_rcnn_toy", "mask_rcnn_toy"]


class RPNHead(HybridBlock):
    """3x3 conv trunk, then 1x1 objectness (a softmax over {bg, fg} per
    anchor) and box heads."""

    def __init__(self, channels: int, num_anchors: int, **kwargs):
        super().__init__(**kwargs)
        self._na = num_anchors
        with self.name_scope():
            self.conv = nn.Conv2D(channels, 3, 1, 1, activation="relu")
            self.score = nn.Conv2D(num_anchors * 2, 1)
            self.loc = nn.Conv2D(num_anchors * 4, 1)

    def forward(self, x):
        t = self.conv(x)
        raw = self.score(t)                          # (B, 2A, H, W)
        b, _, h, w = raw.shape
        pairs = raw.reshape(b, 2, self._na, h, w)
        prob = torch.softmax(pairs, dim=1).reshape(b, 2 * self._na, h, w)
        return prob, self.loc(t)


class FasterRCNN(HybridBlock):
    """Two-stage detector.  Forward returns (cls_pred (B, R, C + 1),
    box_pred (B, R, 4), rois (B * R, 5), rpn_score (B, 2A, H, W),
    rpn_loc (B, 4A, H, W)), everything the training loss needs.

    Its forward reads the host (``Proposal``'s greedy NMS takes its keep
    set with ``.tolist()``), so it cannot be captured into a CUDA graph:
    ``hybridize()`` warns once and runs it eagerly (``reads_host``); the
    JAX package's NMS is traceable and its ``hybridize`` jits the whole
    detector."""

    reads_host = True

    def __init__(self, features: HybridBlock, classes: int,
                 rpn_channels: int = 256, roi_size: int = 7,
                 stride: int = 16, scales=(4.0, 8.0, 16.0),
                 ratios=(0.5, 1.0, 2.0), rpn_post_nms: int = 64,
                 rpn_pre_nms: int = 256, head_hidden: int = 256,
                 img_size: int = 256, **kwargs):
        super().__init__(**kwargs)
        self._classes = classes
        self._stride = stride
        self._scales = tuple(scales)
        self._ratios = tuple(ratios)
        self._post = rpn_post_nms
        self._pre = rpn_pre_nms
        self._roi = roi_size
        self._img = img_size
        self._proposal = proposal_maker(
            rpn_pre_nms_top_n=rpn_pre_nms, rpn_post_nms_top_n=rpn_post_nms,
            feature_stride=stride, scales=self._scales, ratios=self._ratios,
            rpn_min_size=1)
        self._roi_align = roi_align_maker(
            pooled_size=(roi_size, roi_size), spatial_scale=1.0 / stride,
            sample_ratio=2)
        na = len(self._scales) * len(self._ratios)
        with self.name_scope():
            self.features = features
            self.rpn = RPNHead(rpn_channels, na)
            self.head = nn.HybridSequential()
            self.head.add(nn.Dense(head_hidden, activation="relu"),
                          nn.Dense(head_hidden, activation="relu"))
            self.cls_pred = nn.Dense(classes + 1)
            self.box_pred = nn.Dense(4)

    @property
    def classes(self) -> int:
        return self._classes

    def proposals(self, rpn_score, rpn_loc):
        """(B * R, 5) rois of ``Proposal`` over the image size; a caller
        may replace it to hold a run to another run's rois."""
        b, dev = rpn_score.shape[0], rpn_score.device
        im_info = torch.full((b, 3), float(self._img), device=dev) * \
            torch.tensor([[1.0, 1.0, 1.0 / self._img]], device=dev)
        return self._proposal(rpn_score, rpn_loc, im_info)

    def _trunk(self, x):
        """(cls, box, rois, rpn_score, rpn_loc, pooled)."""
        b = x.shape[0]
        feat = self.features(x)
        rpn_score, rpn_loc = self.rpn(feat)
        rois = self.proposals(rpn_score, rpn_loc)
        pooled = self._roi_align(feat, rois)
        h = self.head(pooled.reshape(b * self._post, -1))
        cls = self.cls_pred(h).reshape(b, self._post, self._classes + 1)
        box = self.box_pred(h).reshape(b, self._post, 4)
        return cls, box, rois, rpn_score, rpn_loc, pooled

    def forward(self, x):
        return self._trunk(x)[:5]


class MaskRCNN(FasterRCNN):
    """Faster-RCNN plus a per-roi conv mask head; mask channels are
    indexed by the 0-based foreground class."""

    def __init__(self, features: HybridBlock, classes: int,
                 mask_channels: int = 64, **kwargs):
        super().__init__(features, classes, **kwargs)
        with self.name_scope():
            self.mask_head = nn.HybridSequential()
            for _ in range(2):
                self.mask_head.add(
                    nn.Conv2D(mask_channels, 3, 1, 1, activation="relu"))
            self.mask_head.add(
                nn.Conv2DTranspose(mask_channels, 2, 2, 0,
                                   activation="relu"),
                nn.Conv2D(classes, 1))

    def forward(self, x):
        cls, box, rois, rpn_score, rpn_loc, pooled = self._trunk(x)
        masks = self.mask_head(pooled)          # (B * R, C, 2r, 2r)
        masks = masks.reshape(cls.shape[0], self._post, self._classes,
                              2 * self._roi, 2 * self._roi)
        return cls, box, rois, rpn_score, rpn_loc, masks


class RCNNLoss(Loss):
    """The multi-task loss of the fixed-size roi batch.

    - RPN: the anchors (``rpn_anchors``, ``Proposal``'s enumeration) are
      matched to the ground truth by IoU: objectness BCE on positives
      (IoU > ``rpn_pos_iou``) and negatives (< ``rpn_neg_iou``),
      smooth-L1 on the positives' deltas;
    - head: each roi is matched to its best ground truth; rois over
      ``fg_thresh`` are positives with ``box_encode`` targets; padding
      rois weigh 0; with mask logits, a sigmoid BCE on the matched
      class's mask channel of the positives.

    ``stride``/``scales``/``ratios`` must be the network's (``for_net``)."""

    def __init__(self, fg_thresh: float = 0.5, stride: int = 16,
                 scales=(4.0, 8.0, 16.0), ratios=(0.5, 1.0, 2.0),
                 rpn_pos_iou: float = 0.7, rpn_neg_iou: float = 0.3,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._fg = fg_thresh
        self._stride = stride
        self._scales = tuple(scales)
        self._ratios = tuple(ratios)
        self._rpn_pos = rpn_pos_iou
        self._rpn_neg = rpn_neg_iou
        self._sce = SoftmaxCrossEntropyLoss()
        self._bce = SigmoidBinaryCrossEntropyLoss(from_sigmoid=True)
        self._mask_bce = SigmoidBinaryCrossEntropyLoss()
        self._iou = box_iou_maker(format="corner")
        self._encode = box_encode_maker()
        self._smooth_l1 = smooth_l1_maker(1.0)

    @classmethod
    def for_net(cls, net: FasterRCNN, **kwargs):
        """A loss whose anchors are ``net``'s RPN's."""
        return cls(stride=net._stride, scales=net._scales,
                   ratios=net._ratios, **kwargs)

    def _encode_targets(self, pos, best_gt, boxes, gt_boxes):
        ones = torch.ones_like(pos, dtype=gt_boxes.dtype)
        samples = torch.where(pos, ones, -ones)
        means = torch.zeros(4, device=gt_boxes.device)
        stds = torch.ones(4, device=gt_boxes.device)
        return self._encode(samples, best_gt.to(gt_boxes.dtype), boxes,
                            gt_boxes, means, stds)

    def _rpn_losses(self, rpn_score, rpn_loc, gt_boxes):
        b, a2, h, w = rpn_score.shape
        na = a2 // 2
        n = h * w * na
        anchors = torch.as_tensor(
            rpn_anchors(h, w, self._stride, self._scales, self._ratios),
            device=rpn_score.device)
        fg = rpn_score[:, na:].permute(0, 2, 3, 1).reshape(b, n)
        loc = rpn_loc.reshape(b, na, 4, h, w).permute(0, 3, 4, 1, 2) \
            .reshape(b, n, 4)
        abox = anchors.reshape(1, n, 4).expand(b, n, 4)
        iou = self._iou(abox, gt_boxes)                      # (B, N, M)
        best_iou = iou.max(dim=-1).values
        best_gt = iou.argmax(dim=-1)
        pos = best_iou > self._rpn_pos
        care = pos | (best_iou < self._rpn_neg)
        cls_l = self._bce(fg, pos.to(fg.dtype), care.to(fg.dtype)).mean()
        targets, tmask = self._encode_targets(pos, best_gt, abox, gt_boxes)
        box_l = self._smooth_l1((loc - targets) * tmask).mean()
        return cls_l, box_l

    def forward(self, outs, gt_boxes, gt_classes, gt_masks=None):
        cls, box, rois, rpn_score, rpn_loc = outs[:5]
        masks = outs[5] if len(outs) > 5 else None
        b, r = cls.shape[0], cls.shape[1]
        roi_boxes = rois.reshape(b, r, 5)[:, :, 1:]          # corners
        rpn_cls_l, rpn_box_l = self._rpn_losses(rpn_score, rpn_loc,
                                                gt_boxes)
        iou = self._iou(roi_boxes, gt_boxes)
        best_iou = iou.max(dim=-1).values                    # (B, R)
        best_gt = iou.argmax(dim=-1)
        pos = best_iou > self._fg
        live = roi_boxes.sum(dim=-1) > 0                     # not padding
        m = gt_boxes.shape[1]
        sel = torch.nn.functional.one_hot(best_gt, m).to(gt_boxes.dtype)
        # class target: the matched class + 1 for positives, 0 background
        gtc = (sel * gt_classes.reshape(b, 1, m)).sum(dim=-1)
        cls_target = torch.where(pos, gtc + 1.0, torch.zeros_like(gtc)) \
            .to(torch.int32)
        cls_l = self._sce(cls.reshape(-1, cls.shape[-1]),
                          cls_target.reshape(-1),
                          live.to(cls.dtype).reshape(-1, 1))
        targets, tmask = self._encode_targets(pos & live, best_gt,
                                              roi_boxes, gt_boxes)
        box_l = self._smooth_l1((box - targets) * tmask).mean()
        total = cls_l.mean() + box_l + rpn_cls_l + rpn_box_l
        if masks is not None and gt_masks is not None:
            # the matched class's channel of each positive roi against its
            # ground truth's mask; background rois weigh 0
            ms = masks.shape
            fg_cls = (cls_target - 1).clamp(min=0).long()
            midx = torch.nn.functional.one_hot(fg_cls, ms[2]) \
                .to(masks.dtype)
            pred = (masks * midx.reshape(b, r, ms[2], 1, 1)).sum(dim=2)
            gm = (sel.reshape(b, r, m, 1, 1) * gt_masks.reshape(
                (b, 1, m) + tuple(gt_masks.shape[2:]))).sum(dim=2)
            wmask = (pos & live).to(masks.dtype)
            mask_bce = self._mask_bce(
                pred.reshape((b * r,) + tuple(pred.shape[2:])),
                gm.reshape((b * r,) + tuple(gm.shape[2:])),
                wmask.reshape(b * r, 1, 1))
            total = total + mask_bce.mean()
        return total


def _resnet18_features() -> nn.HybridSequential:
    from .vision import resnet18_v1
    feats = nn.HybridSequential()
    for layer in list(resnet18_v1().features)[:-3]:
        feats.add(layer)
    return feats


def faster_rcnn_resnet18_v1(classes: int = 20, **kwargs) -> FasterRCNN:
    return FasterRCNN(_resnet18_features(), classes, **kwargs)


def mask_rcnn_resnet18_v1(classes: int = 20, **kwargs) -> MaskRCNN:
    return MaskRCNN(_resnet18_features(), classes, **kwargs)


def _toy_features() -> nn.HybridSequential:
    f = nn.HybridSequential()
    for ch in (16, 32, 32, 64):                 # stride 16 at exit
        f.add(nn.Conv2D(ch, 3, 2, 1, activation="relu"))
    return f


def _toy_defaults(kwargs, **defaults):
    for k, v in defaults.items():
        kwargs.setdefault(k, v)
    return kwargs


def faster_rcnn_toy(classes: int = 3, **kwargs) -> FasterRCNN:
    return FasterRCNN(_toy_features(), classes, **_toy_defaults(
        kwargs, rpn_post_nms=16, rpn_pre_nms=64, img_size=64,
        rpn_channels=32, head_hidden=64))


def mask_rcnn_toy(classes: int = 3, **kwargs) -> MaskRCNN:
    return MaskRCNN(_toy_features(), classes, **_toy_defaults(
        kwargs, rpn_post_nms=16, rpn_pre_nms=64, img_size=64,
        rpn_channels=32, head_hidden=64, mask_channels=32))
