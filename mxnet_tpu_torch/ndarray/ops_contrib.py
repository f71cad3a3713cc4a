"""Contrib operators: flash attention and the detection ops of config #5.

Counterpart of ``mxnet_tpu/ndarray/ops_contrib.py``:

- ``_contrib_flash_attention`` (alias ``flash_attention``, :964-1006) is
  the registry op over the kernel wrapper
  (``kernels.flash_attention.flash_attention``): inputs q, k, v and an
  optional fourth ``valid_len``, parameters ``causal`` and ``scale``.
  On a CUDA tensor it launches the hand-written kernel (or raises), on a
  CPU tensor it runs the plain version.  It is differentiable in q, k
  and v on both devices through the wrapper's autograd Function: the
  kernel forward and a chunked torch backward
  (``kernels.flash_attention_backward``), as the JAX package's is a
  custom VJP in jnp; ``valid_len`` takes no gradient.  So ``mx.sym`` and
  ``Module`` reach the kernel through it.
- The detection ops, registered under their ``_contrib_`` names and
  MXNet's aliases (``nd.contrib.<name>``, ``nd.<alias>``):
  ``MultiBoxPrior`` (:25-60), ``box_iou`` (:63-94), ``box_nms``
  (:97-151), ``MultiBoxTarget`` (:154-233), ``MultiBoxDetection``
  (:236-282), ``ROIAlign`` (:285-337), ``Proposal`` (:496-582),
  ``box_decode`` (:585-607) and ``box_encode`` (:609-630), with the
  helpers ``base_anchors``/``rpn_anchors`` (:670-694).  The JAX package
  computes them in XLA outside any Pallas kernel, so here they are torch
  code: static shapes, suppressed or invalid entries marked (score -1,
  label -1) instead of dropped.

Greedy NMS (``box_nms``, ``MultiBoxDetection``, ``Proposal``).  The JAX
package walks the k score-sorted candidates in a ``lax.scan``; in eager
torch that would be k dependent launches.  Here the same keep set comes
from a fixed point (``greedy_keep``): greedy NMS is the unique solution of
``keep_i = valid_i and not any(keep_j and IoU(j, i) > t for j < i)``, and
the Jacobi iteration from ``keep = valid`` (one batched (k x k) product a
pass) fixes the first p entries after pass p.  The iteration stops at the
first pass that changes nothing (checked every ``NMS_CHECK_EVERY`` passes,
one host read each); ``nms_stats`` counts the passes.  Candidates are
ordered as ``jnp.argsort(scores)[::-1]``: a stable ascending sort
reversed, so equal scores come in descending index order.

Gradients: ``MultiBoxTarget``, ``MultiBoxDetection`` and ``Proposal`` give
none (MXNet's ``Proposal`` has no gradient; the JAX package registers it
differentiable, a departure the port does not follow), and ``ROIAlign``
takes none into its ``rois``, as MXNet's ``roi_align.cc``.
``MultiBoxTarget`` forces each valid ground truth onto its best anchor;
where two share one, the later ground truth wins (the JAX package's
scatter on the CPU), by a max over the ground-truth index.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError

from ..kernels.flash_attention import flash_attention
from .register import register_op

__all__ = ["flash_attention_maker", "base_anchors", "rpn_anchors", "greedy_keep",
           "nms_stats", "NMS_CHECK_EVERY"]

#: Jacobi passes between two convergence checks (each check is one host
#: read)
NMS_CHECK_EVERY = 4


class _NmsStats:
    """Passes of the fixed-point NMS since ``reset()``: ``calls``,
    ``passes`` (all calls); of the last call, ``last`` (passes run) and
    ``settled`` (passes that changed the keep set: after them it was
    the greedy one)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = self.passes = self.last = self.settled = 0


nms_stats = _NmsStats()


def _astuple(v):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    if isinstance(v, str):
        return tuple(float(x) for x in
                     v.strip("()[] ").split(",") if x.strip())
    return (v,)


def _desc_order(scores: torch.Tensor) -> torch.Tensor:
    """Indices sorting the last axis by descending score, equal scores in
    descending index order (``jnp.argsort(s)[::-1]``)."""
    return torch.argsort(scores, dim=-1, stable=True).flip(-1)


def _iou_corner(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """IoU of (..., 4) corner boxes broadcast over the leading dims, in
    the JAX op's arithmetic."""
    tl = torch.maximum(lhs[..., :2], rhs[..., :2])
    br = torch.minimum(lhs[..., 2:], rhs[..., 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = (lhs[..., 2] - lhs[..., 0]).clamp(min=0.0) * \
        (lhs[..., 3] - lhs[..., 1]).clamp(min=0.0)
    area_r = (rhs[..., 2] - rhs[..., 0]).clamp(min=0.0) * \
        (rhs[..., 3] - rhs[..., 1]).clamp(min=0.0)
    return inter / (area_l + area_r - inter).clamp(min=1e-12)


def _center_to_corner(b):
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _corner_to_center(b):
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def greedy_keep(valid: torch.Tensor, suppress: torch.Tensor) -> torch.Tensor:
    """Greedy NMS over score-sorted candidates as a fixed point.

    ``valid`` (B, k) bool; ``suppress`` (B, k, k) bool, ``[b, j, i]`` true
    where candidate j, if kept, removes candidate i (IoU over the
    threshold; the caller masks classes).  Only j < i counts.  Returns
    the (B, k) keep mask that walking the candidates in order gives, after
    at most k + 1 passes of ``keep = valid & ~any_j(keep_j & S[j, i])``."""
    k = valid.shape[-1]
    later = torch.ones(k, k, dtype=torch.bool, device=valid.device).triu(1)
    # 0/1 entries: a product's count is exact or rounds to a positive
    # number, so "> 0" is exact in bf16 too (the tensor cores' type)
    dt = torch.bfloat16 if valid.is_cuda else torch.float32
    sup = (suppress & later).to(dt)
    keep, passes, settled = valid, 0, 0
    while True:
        changed = []
        for _ in range(NMS_CHECK_EVERY):
            hit = torch.bmm(keep.to(dt).unsqueeze(1), sup)
            new = valid & ~(hit.squeeze(1) > 0)
            changed.append((new != keep).any())
            keep = new
        flags = torch.stack(changed).tolist()
        settled = max([settled] + [passes + i + 1
                                   for i, f in enumerate(flags) if f])
        passes += len(flags)
        if not flags[-1] or passes > k:
            break
    nms_stats.calls += 1
    nms_stats.passes += passes
    nms_stats.last, nms_stats.settled = passes, settled
    return keep


def _nms_keep(cand, valid, thresh, ids=None):
    """The keep mask (B, k) of score-sorted candidates ``cand`` (B, k, 4)
    with ``valid`` (B, k); with ``ids`` (B, k), a box only suppresses
    boxes of its own id."""
    # one image at a time: a (k, k, 2) temporary per image, not per batch
    sup = torch.stack([_iou_corner(c[:, None, :], c[None, :, :]) > thresh
                       for c in cand])
    if ids is not None:
        sup &= ids[:, :, None] == ids[:, None, :]
    return greedy_keep(valid, sup)


# ---- MultiBoxPrior -------------------------------------------------------
def multibox_prior_maker(sizes=(1.0,), ratios=(1.0,), clip=False,
                         steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    sizes = tuple(float(s) for s in _astuple(sizes))
    ratios = tuple(float(r) for r in _astuple(ratios))
    steps_ = tuple(float(s) for s in _astuple(steps))
    offs = tuple(float(o) for o in _astuple(offsets))
    # (s_i, r_0) for every size, then (s_0, r_j) for the other ratios
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]

    def fn(data):
        h, w = data.shape[2], data.shape[3]
        step_y = steps_[0] if steps_[0] > 0 else 1.0 / h
        step_x = steps_[1] if steps_[1] > 0 else 1.0 / w
        dev = data.device
        cy = (torch.arange(h, dtype=torch.float32, device=dev)
              + offs[0]) * step_y
        cx = (torch.arange(w, dtype=torch.float32, device=dev)
              + offs[1]) * step_x
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        boxes = [torch.stack([cxg - bw / 2, cyg - bh / 2, cxg + bw / 2,
                              cyg + bh / 2], dim=-1) for bw, bh in whs]
        out = torch.stack(boxes, dim=2).reshape(1, -1, 4)
        return out.clamp(0.0, 1.0) if clip else out
    return fn


# ---- box_iou -------------------------------------------------------------
def box_iou_maker(format="corner"):
    def fn(lhs, rhs):
        if format == "center":
            lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
        return _iou_corner(lhs[..., :, None, :], rhs[..., None, :, :])
    return fn


# ---- box_nms -------------------------------------------------------------
def box_nms_maker(overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
                  coord_start=2, score_index=1, id_index=-1,
                  background_id=-1, force_suppress=False,
                  in_format="corner", out_format="corner"):
    cs = coord_start

    def fn(data):
        # data (..., N, K); the same shape back, suppressed scores -1;
        # the gradient passes to the kept scores and to every coordinate
        shape = data.shape
        flat = data.reshape((-1,) + tuple(shape[-2:]))
        n = flat.shape[1]
        scores = flat[..., score_index]
        # a named range, so that a profile can tell the NMS apart
        with torch.no_grad(), torch.profiler.record_function("box_nms"):
            boxes = flat[..., cs:cs + 4]
            if in_format == "center":
                boxes = _center_to_corner(boxes)
            valid = scores > valid_thresh
            if background_id >= 0 and id_index >= 0:
                valid &= flat[..., id_index] != background_id
            k = n if topk <= 0 else min(int(topk), n)
            order = _desc_order(torch.where(
                valid, scores, torch.full_like(scores, -np.inf)))[:, :k]
            ids = torch.gather(flat[..., id_index], 1, order) \
                if not force_suppress and id_index >= 0 else None
            cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
            keep = _nms_keep(cand, torch.gather(valid, 1, order),
                             overlap_thresh, ids)
            kept = torch.zeros_like(valid).scatter(1, order, keep)
        out = flat.clone()
        out[..., score_index] = torch.where(kept, scores,
                                            torch.full_like(scores, -1.0))
        if out_format != in_format:
            conv = _center_to_corner if out_format == "corner" \
                else _corner_to_center
            out[..., cs:cs + 4] = conv(out[..., cs:cs + 4])
        return out.reshape(shape)
    return fn


# ---- MultiBoxTarget ------------------------------------------------------
def multibox_target_maker(overlap_threshold=0.5, ignore_label=-1.0,
                          negative_mining_ratio=-1.0,
                          negative_mining_thresh=0.5,
                          minimum_negative_samples=0,
                          variances=(0.1, 0.1, 0.2, 0.2)):
    var = [float(v) for v in _astuple(variances)]

    @torch.no_grad()
    def fn(anchor, label, cls_pred):
        # anchor (1, N, 4) corners; label (B, M, 5) [cls, x1, y1, x2, y2],
        # padding rows cls -1; cls_pred (B, classes + 1, N) for mining
        anchors = anchor.reshape(-1, 4)
        n = anchors.shape[0]
        b, m = label.shape[0], label.shape[1]
        gt_valid = label[..., 0] >= 0                          # (B, M)
        gt_boxes = label[..., 1:5]
        iou = _iou_corner(anchors[None, :, None, :],
                          gt_boxes[:, None, :, :])             # (B, N, M)
        iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))
        best_iou = iou.max(dim=2).values
        best_gt = iou.argmax(dim=2)                  # the first on ties
        matched = best_iou >= overlap_threshold
        # force-match: every valid ground truth claims its best anchor;
        # padding rows go to a spare slot n; of two claims on one anchor
        # the later ground truth wins
        best_anchor = iou.argmax(dim=1)                        # (B, M)
        slot = torch.where(gt_valid, best_anchor,
                           torch.full_like(best_anchor, n))
        gt_ids = torch.arange(m, device=label.device).expand(b, m)
        claim = torch.full((b, n + 1), -1, dtype=torch.long,
                           device=label.device).scatter_reduce(
            1, slot, gt_ids, "amax")[:, :n]
        forced = claim >= 0
        gt_idx = torch.where(forced, claim, best_gt)
        pos = matched | forced

        g = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
        acx = (anchors[:, 0] + anchors[:, 2]) / 2
        acy = (anchors[:, 1] + anchors[:, 3]) / 2
        aw = (anchors[:, 2] - anchors[:, 0]).clamp(min=1e-8)
        ah = (anchors[:, 3] - anchors[:, 1]).clamp(min=1e-8)
        gcx = (g[..., 0] + g[..., 2]) / 2
        gcy = (g[..., 1] + g[..., 3]) / 2
        gw = (g[..., 2] - g[..., 0]).clamp(min=1e-8)
        gh = (g[..., 3] - g[..., 1]).clamp(min=1e-8)
        loc = torch.stack([(gcx - acx) / aw / var[0],
                           (gcy - acy) / ah / var[1],
                           torch.log(gw / aw) / var[2],
                           torch.log(gh / ah) / var[3]], dim=-1)
        posf = pos[..., None]
        loc_target = torch.where(posf, loc, torch.zeros_like(loc))
        loc_mask = posf.expand(-1, -1, 4).to(loc.dtype)
        gt_cls = torch.gather(label[..., 0], 1, gt_idx)
        cls_target = torch.where(pos, gt_cls + 1.0, torch.zeros_like(gt_cls))
        if negative_mining_ratio > 0:
            # hard negatives: the highest background losses, up to ratio x
            # the positives; positives and near misses (IoU above the
            # mining threshold) rank last, ties by lower index
            bg_prob = torch.softmax(cls_pred, dim=1)[:, 0]
            inelig = pos | (best_iou >= negative_mining_thresh)
            neg_score = torch.where(
                inelig, torch.full_like(bg_prob, -np.inf),
                -torch.log(bg_prob.clamp(min=1e-12)))
            num_pos = pos.sum(dim=1)
            max_neg = torch.clamp(
                (negative_mining_ratio * num_pos.to(torch.float32)).to(
                    torch.int32), min=minimum_negative_samples)
            order = torch.argsort(-neg_score, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(n, device=order.device).expand(b, n))
            keep_neg = ~inelig & (rank < max_neg[:, None])
            cls_target = torch.where(pos | keep_neg, cls_target,
                                     torch.full_like(cls_target,
                                                     float(ignore_label)))
        return loc_target.reshape(b, -1), loc_mask.reshape(b, -1), \
            cls_target
    return fn


# ---- MultiBoxDetection ---------------------------------------------------
def multibox_detection_maker(clip=True, threshold=0.01, background_id=0,
                             nms_threshold=0.5, force_suppress=False,
                             variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    var = [float(v) for v in _astuple(variances)]
    nms = box_nms_maker(overlap_thresh=nms_threshold, valid_thresh=0.0,
                        topk=nms_topk, coord_start=2, score_index=1,
                        id_index=0, force_suppress=force_suppress)

    @torch.no_grad()
    def fn(cls_prob, loc_pred, anchor):
        # cls_prob (B, classes + 1, N); loc_pred (B, N * 4); anchor
        # (1, N, 4) -> (B, N, 6) [id, score, x1, y1, x2, y2]
        anchors = anchor.reshape(-1, 4)
        n = anchors.shape[0]
        acx = (anchors[:, 0] + anchors[:, 2]) / 2
        acy = (anchors[:, 1] + anchors[:, 3]) / 2
        aw = anchors[:, 2] - anchors[:, 0]
        ah = anchors[:, 3] - anchors[:, 1]
        loc = loc_pred.reshape(loc_pred.shape[0], n, 4)
        cx = loc[..., 0] * var[0] * aw + acx
        cy = loc[..., 1] * var[1] * ah + acy
        w = torch.exp(loc[..., 2] * var[2]) * aw
        h = torch.exp(loc[..., 3] * var[3]) * ah
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            dim=-1)
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        fg = torch.cat([cls_prob[:, :background_id],
                        cls_prob[:, background_id + 1:]], dim=1)
        score, _ = fg.max(dim=1)
        cls_id = fg.argmax(dim=1).to(torch.float32)
        keep = score > threshold
        neg = torch.full_like(score, -1.0)
        det = torch.cat([torch.where(keep, cls_id, neg)[..., None],
                         torch.where(keep, score, neg)[..., None], boxes],
                        dim=-1)
        return nms(det)
    return fn


# ---- ROIAlign ------------------------------------------------------------
def roi_align_maker(pooled_size=(7, 7), spatial_scale=1.0, sample_ratio=2,
                    position_sensitive=False, aligned=False):
    ph, pw = _astuple(pooled_size)
    sr = max(int(sample_ratio), 1)

    def fn(data, rois):
        # data (B, C, H, W); rois (R, 5) [batch index, x1, y1, x2, y2]
        _, c, h, w = data.shape
        rois = rois.detach()
        off = 0.5 if aligned else 0.0
        x1 = rois[:, 1] * spatial_scale - off
        y1 = rois[:, 2] * spatial_scale - off
        x2 = rois[:, 3] * spatial_scale - off
        y2 = rois[:, 4] * spatial_scale - off
        floor = 1e-6 if aligned else 1.0
        bin_w = (x2 - x1).clamp(min=floor) / pw
        bin_h = (y2 - y1).clamp(min=floor) / ph
        dev = data.device
        iy = torch.arange(ph * sr, dtype=torch.float32, device=dev)
        ix = torch.arange(pw * sr, dtype=torch.float32, device=dev)
        sy = y1[:, None] + (iy + 0.5) * bin_h[:, None] / sr   # (R, ph*sr)
        sx = x1[:, None] + (ix + 0.5) * bin_w[:, None] / sr
        y0 = torch.floor(sy).clamp(0, h - 1)
        x0 = torch.floor(sx).clamp(0, w - 1)
        y1i = (y0 + 1).clamp(0, h - 1).long()
        x1i = (x0 + 1).clamp(0, w - 1).long()
        ly = (sy - y0).clamp(0.0, 1.0)
        lx = (sx - x0).clamp(0.0, 1.0)
        y0i, x0i = y0.long(), x0.long()
        # rows of a (B * H * W, C) view: one index_select a corner, whose
        # backward is an index_add (not advanced indexing's sorted one)
        rows = data.permute(0, 2, 3, 1).reshape(-1, c)
        base = rois[:, 0].long()[:, None, None] * (h * w)

        def at(yi, xi):                           # (R, C, ph*sr, pw*sr)
            idx = base + yi[:, :, None] * w + xi[:, None, :]
            return rows.index_select(0, idx.reshape(-1)).reshape(
                idx.shape + (c,)).permute(0, 3, 1, 2)
        wy = ly[:, None, :, None]
        wx = lx[:, None, None, :]
        samples = (at(y0i, x0i) * (1 - wy) * (1 - wx)
                   + at(y0i, x1i) * (1 - wy) * wx
                   + at(y1i, x0i) * wy * (1 - wx)
                   + at(y1i, x1i) * wy * wx)
        return samples.reshape(-1, c, ph, sr, pw, sr).mean(dim=(3, 5))
    return fn


# ---- Proposal (src/operator/contrib/proposal.cc) -------------------------
def base_anchors(scales, ratios, base_size=16.0):
    """(A, 4) corner anchors centred on a ``base_size`` cell (numpy;
    ``proposal.cc`` GenerateAnchors): for each ratio, each scale."""
    out = []
    cx = cy = (base_size - 1.0) / 2.0
    area = base_size * base_size
    for r in ratios:
        w = np.round(np.sqrt(area / r))
        h = np.round(w * r)
        for s in scales:
            ws, hs = w * s, h * s
            out.append([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                        cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])
    return np.array(out, np.float32)


def rpn_anchors(height, width, stride, scales, ratios):
    """All (H * W * A, 4) corner anchors of a feature map, in (H, W, A)
    order: the enumeration ``Proposal`` uses (numpy)."""
    base = base_anchors(tuple(scales), tuple(ratios))
    sx = np.arange(width, dtype=np.float32) * stride
    sy = np.arange(height, dtype=np.float32) * stride
    gx, gy = np.meshgrid(sx, sy)
    shift = np.stack([gx, gy, gx, gy], axis=-1)
    return (shift[:, :, None, :] + base).reshape(-1, 4)


def _decode_deltas(anchors, deltas):
    """The RCNN box transform, anchors + (dx, dy, dw, dh) -> corners."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    ax = anchors[..., 0] + 0.5 * (aw - 1.0)
    ay = anchors[..., 1] + 0.5 * (ah - 1.0)
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(deltas[..., 2]) * aw
    h = torch.exp(deltas[..., 3]) * ah
    return torch.stack([cx - 0.5 * (w - 1.0), cy - 0.5 * (h - 1.0),
                        cx + 0.5 * (w - 1.0), cy + 0.5 * (h - 1.0)], dim=-1)


def proposal_maker(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                   threshold=0.7, rpn_min_size=16,
                   scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
                   feature_stride=16, output_score=False, iou_loss=False):
    scales, ratios = _astuple(scales), _astuple(ratios)
    base = base_anchors(scales, ratios)

    @torch.no_grad()
    def fn(cls_prob, bbox_pred, im_info):
        # cls_prob (B, 2A, H, W), foreground scores at [A:]; bbox_pred
        # (B, 4A, H, W); im_info (B, 3) = (height, width, scale)
        b, _, h, w = cls_prob.shape
        a = base.shape[0]
        anchors = torch.as_tensor(rpn_anchors(h, w, feature_stride, scales,
                                              ratios), device=cls_prob.device)
        scores = cls_prob[:, a:].permute(0, 2, 3, 1).reshape(b, -1)
        d = bbox_pred.reshape(b, a, 4, h, w).permute(0, 3, 4, 1, 2)
        boxes = _decode_deltas(anchors, d.reshape(b, -1, 4))
        info = im_info[:, None, :]
        zero = torch.zeros_like(boxes[..., 0])
        boxes = torch.stack([
            torch.minimum(torch.maximum(boxes[..., 0], zero),
                          info[..., 1] - 1.0),
            torch.minimum(torch.maximum(boxes[..., 1], zero),
                          info[..., 0] - 1.0),
            torch.minimum(torch.maximum(boxes[..., 2], zero),
                          info[..., 1] - 1.0),
            torch.minimum(torch.maximum(boxes[..., 3], zero),
                          info[..., 0] - 1.0)], dim=-1)
        ws = boxes[..., 2] - boxes[..., 0] + 1.0
        hs = boxes[..., 3] - boxes[..., 1] + 1.0
        min_sz = rpn_min_size * info[..., 2]
        valid = (ws >= min_sz) & (hs >= min_sz)
        scores = torch.where(valid, scores, torch.full_like(scores, -np.inf))
        k = min(int(rpn_pre_nms_top_n), h * w * a)
        order = _desc_order(scores)[:, :k]
        cboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        cscores = torch.gather(scores, 1, order)
        keep = _nms_keep(cboxes, cscores > -np.inf, threshold)
        fscores = torch.where(keep, cscores,
                              torch.full_like(cscores, -np.inf))
        p = min(int(rpn_post_nms_top_n), k)
        sel = _desc_order(fscores)[:, :p]
        out_boxes = torch.gather(cboxes, 1, sel[..., None].expand(-1, -1, 4))
        out_scores = torch.gather(fscores, 1, sel)
        finite = torch.isfinite(out_scores)
        out_boxes = torch.where(finite[..., None], out_boxes,
                                torch.zeros_like(out_boxes))
        out_scores = torch.where(finite, out_scores,
                                 torch.zeros_like(out_scores))
        bidx = torch.arange(b, dtype=out_boxes.dtype,
                            device=out_boxes.device).repeat_interleave(p)
        rois = torch.cat([bidx[:, None], out_boxes.reshape(-1, 4)], dim=1)
        if output_score:
            return rois, out_scores.reshape(-1, 1)
        return rois
    return fn


# ---- box_encode / box_decode (bounding_box.cc) ---------------------------
def box_decode_maker(std0=1.0, std1=1.0, std2=1.0, std3=1.0, clip=-1.0,
                     format="corner"):
    std = (std0, std1, std2, std3)

    def fn(data, anchors):
        # data (B, N, 4) deltas; anchors (1, N, 4) in ``format``
        if format == "corner":
            wh = anchors[..., 2:] - anchors[..., :2]
            ctr = anchors[..., :2] + 0.5 * wh
        else:
            ctr, wh = anchors[..., :2], anchors[..., 2:]
        d = data * torch.tensor(std, dtype=data.dtype, device=data.device)
        xy = d[..., :2] * wh + ctr
        dwh = d[..., 2:]
        if clip > 0:
            # the dw/dh delta is clipped before the exp (bounding_box.cc)
            dwh = dwh.clamp(max=clip)
        half = 0.5 * (torch.exp(dwh) * wh)
        return torch.cat([xy - half, xy + half], dim=-1)
    return fn


def box_encode_maker(**_ignored):
    def fn(samples, matches, anchors, refs, means, stds):
        # samples (B, N) +1 positive, else -1; matches (B, N) ground-truth
        # index; anchors (B, N, 4) and refs (B, M, 4) corners; means and
        # stds (4,) -> (targets (B, N, 4), masks (B, N, 4))
        idx = matches.long().clamp(0, refs.shape[1] - 1)
        gt = torch.gather(refs, 1, idx[..., None].expand(-1, -1, 4))
        awh = anchors[..., 2:] - anchors[..., :2]
        actr = anchors[..., :2] + 0.5 * awh
        gwh = gt[..., 2:] - gt[..., :2]
        gctr = gt[..., :2] + 0.5 * gwh
        eps = 1e-8
        t = torch.cat([(gctr - actr) / (awh + eps),
                       torch.log((gwh + eps) / (awh + eps))], dim=-1)
        t = (t - means.reshape(1, 1, 4)) / stds.reshape(1, 1, 4)
        mask = (samples > 0.5)[..., None].to(t.dtype)
        return t * mask, mask.expand(t.shape).clone()
    return fn


def flash_attention_maker(causal=False, scale=None):
    """On ``meta`` tensors (``Symbol.infer_shape``) the output's shape,
    without a computation."""
    def fn(q, k, v, valid_len=None):
        if q.is_meta:
            return torch.empty_like(q)
        return flash_attention(q, k, v, valid_len, causal, scale)
    return fn


# ---- the sampling ops of Deformable ConvNets and R-FCN -------------------
#
# Each gathers from ``data`` through a flat index (``index_select``, whose
# backward is an ``index_add``: atomic on the card) at sample points whose
# floors are ``torch.floor`` calls, so a run can be handed another's
# decisions.  ``rois`` take no gradient: the JAX ops reach them only
# through floors and clamps.  Divisions are by 0-d tensors (``_num``):
# CUDA divides by a Python number as a multiplication by its reciprocal,
# the CPU does not, and a sample point would then differ in its last bit
# between the two.  The 0-d tensors are made by a fill on the device,
# never copied from the host, so a CUDA graph can capture the ops.

def _num(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def _flat_gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``data.reshape(-1)[idx]`` as an ``index_select``."""
    return data.reshape(-1).index_select(0, idx.reshape(-1)).reshape(
        idx.shape)


def deformable_psroi_maker(spatial_scale=1.0, output_dim=1, group_size=1,
                           pooled_size=7, part_size=0, sample_per_part=1,
                           trans_std=0.0, no_trans=False):
    """JAX ``ops_contrib.py:346-455``: each roi's bins at ``sample_per_part``
    squared points (no half-sample centring), shifted by ``trans`` (per
    class, (x, y) pairs, scaled by ``trans_std`` and the roi's size),
    bilinear, averaged over the points inside the image."""
    ps, gs = int(pooled_size), int(group_size)
    pt = int(part_size) or ps
    sp = max(int(sample_per_part), 1)
    d_out = int(output_dim)

    def fn(data, rois, *trans_opt):
        b, c, h, w = data.shape
        dev, dt = data.device, data.dtype
        trans = trans_opt[0] if trans_opt and not no_trans else None
        rois = rois.detach().to(dt)
        r = rois.shape[0]
        gi = torch.clamp(torch.arange(ps, device=dev) * gs // ps, 0, gs - 1)
        pi = torch.clamp(torch.arange(ps, device=dev) * pt // ps, 0, pt - 1)

        def c_round(v):                   # C's round() for v >= 0
            return torch.floor(v + 0.5)
        x1 = c_round(rois[:, 1]) * spatial_scale - 0.5
        y1 = c_round(rois[:, 2]) * spatial_scale - 0.5
        x2 = (c_round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
        y2 = (c_round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
        rw = (x2 - x1).clamp(min=0.1)
        rh = (y2 - y1).clamp(min=0.1)
        bin_h, bin_w = rh / _num(ps, rh), rw / _num(ps, rw)
        sub_h, sub_w = bin_h / _num(sp, rh), bin_w / _num(sp, rw)
        if trans is not None:
            n_cls = trans.shape[1] // 2
            per_cls = max(d_out // max(n_cls, 1), 1)
            cls_of = torch.arange(d_out, device=dev) // per_cls
            part = trans[:, :, pi[:, None], pi[None, :]]   # (R, 2n, ps, ps)
            dx = (part[:, 0::2] * trans_std * rw[:, None, None, None]
                  )[:, cls_of]                             # (R, D, ps, ps)
            dy = (part[:, 1::2] * trans_std * rh[:, None, None, None]
                  )[:, cls_of]
        else:
            dx = dy = torch.zeros((r, 1, 1, 1), dtype=dt, device=dev)
        iy = torch.arange(ps, dtype=dt, device=dev)
        off = torch.arange(sp, dtype=dt, device=dev)
        col = (slice(None), None, None, None, None)
        # (R, D|1, ps, ps, sp) sample coordinates
        ys = (y1[col] + iy[:, None, None] * bin_h[col] + dy[..., None]
              + off * sub_h[col])
        xs = (x1[col] + iy[None, :, None] * bin_w[col] + dx[..., None]
              + off * sub_w[col])
        ysb, xsb = ys[..., :, None], xs[..., None, :]      # (.., sp, sp)
        valid = ((ysb > -0.5) & (ysb < h - 0.5) &
                 (xsb > -0.5) & (xsb < w - 0.5))
        yc = ysb.clamp(0.0, h - 1.0)
        xc = xsb.clamp(0.0, w - 1.0)
        y0, x0 = torch.floor(yc), torch.floor(xc)
        ly, lx = yc - y0, xc - x0
        y0i, x0i = y0.long(), x0.long()
        y1i = (y0i + 1).clamp(max=h - 1)
        x1i = (x0i + 1).clamp(max=w - 1)
        ch = (torch.arange(d_out, device=dev)[:, None, None] * gs
              + gi[:, None]) * gs + gi[None, :]            # (D, ps, ps)
        plane = ((rois[:, 0].long()[:, None, None, None] * c
                  + ch) * h)[..., None, None]              # (R,D,ps,ps,1,1)
        full = plane.shape[:4] + (sp, sp)

        def at(yi, xi):
            return _flat_gather(data, ((plane + yi) * w + xi).expand(full))
        vals = (at(y0i, x0i) * (1 - ly) * (1 - lx) + at(y0i, x1i) * (1 - ly)
                * lx + at(y1i, x0i) * ly * (1 - lx) + at(y1i, x1i) * ly * lx)
        vmask = valid.to(dt).expand(full)
        count = vmask.sum((-1, -2)).clamp(min=1.0)
        return (vals * vmask).sum((-1, -2)) / count
    return fn


def roi_pooling_maker(pooled_size=(7, 7), spatial_scale=1.0):
    """JAX :457-493: the max over each bin's pixels (``round`` to even
    corners, bins of at least one pixel; a bin outside the image is
    -inf); the gradient goes to the arg-max (split among equal maxima, as
    ``jnp.max``'s).  Separable: the max over each x-bin's columns, then
    over each y-bin's rows, ``ROI_POOL_CHUNK`` rois at a time."""
    ph, pw = (int(v) for v in _astuple(pooled_size))

    def bins(lo, size, n, pixels, dev, dt):
        p = torch.arange(n, dtype=dt, device=dev)
        b0 = lo[:, None] + torch.floor(p * size[:, None] / _num(n, size))
        b1 = lo[:, None] + torch.ceil((p + 1) * size[:, None]
                                      / _num(n, size))
        b1 = torch.maximum(b1, b0 + 1)
        pos = torch.arange(pixels, dtype=dt, device=dev)
        return (pos >= b0[..., None]) & (pos < b1[..., None])  # (R, n, P)

    def fn(data, rois):
        _, c, h, w = data.shape
        dev, dt = data.device, data.dtype
        rois = rois.detach().to(dt)
        x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                          for i in range(1, 5))
        rw = (x2 - x1 + 1).clamp(min=1.0)
        rh = (y2 - y1 + 1).clamp(min=1.0)
        my = bins(y1, rh, ph, h, dev, dt)
        mx = bins(x1, rw, pw, w, dev, dt)
        neg = _num(-math.inf, data)
        outs = []
        for s in range(0, rois.shape[0], ROI_POOL_CHUNK):
            img = data[rois[s:s + ROI_POOL_CHUNK, 0].long()]   # (r,C,H,W)
            cols = torch.where(mx[s:s + ROI_POOL_CHUNK, None, None],
                               img[:, :, :, None], neg).amax(-1)  # (r,C,H,pw)
            rows = torch.where(my[s:s + ROI_POOL_CHUNK, None, :, :, None],
                               cols[:, :, None], neg).amax(3)  # (r,C,ph,pw)
            outs.append(rows)
        return torch.cat(outs) if outs else data.new_zeros((0, c, ph, pw))
    return fn


#: rois a ``ROIPooling`` pass reduces at once (its masked copies are
#: chunk x C x H x W x bins)
ROI_POOL_CHUNK = 16


def bipartite_matching_maker(threshold=0.5, is_ascend=False, topk=-1):
    """JAX :632-668: greedy matching of (B, N, M) scores, ``min(N, M)``
    (or ``topk``) rounds of the global arg-max (first on ties); a pair at
    or above ``threshold`` is matched, and its row and column leave the
    game either way.  Returns the rows' columns (B, N) and the columns'
    rows (B, M), -1 where unmatched."""
    def fn(data):
        bsz, n, m = data.shape
        steps = min(n, m) if topk <= 0 else min(int(topk), n, m)
        sgn = -1.0 if is_ascend else 1.0
        s = (data * sgn).detach().clone()
        thr = threshold * sgn
        rows = torch.full((bsz, n), -1.0, dtype=data.dtype,
                          device=data.device)
        cols = torch.full((bsz, m), -1.0, dtype=data.dtype,
                          device=data.device)
        bi = torch.arange(bsz, device=data.device)
        for _ in range(steps):
            flat = s.reshape(bsz, -1).argmax(1)
            i, j = flat // m, flat % m
            ok = s[bi, i, j] >= thr
            rows[bi, i] = torch.where(ok, j.to(rows.dtype), rows[bi, i])
            cols[bi, j] = torch.where(ok, i.to(cols.dtype), cols[bi, j])
            s[bi, i, :] = -math.inf
            s[bi, :, j] = -math.inf
        return rows, cols
    return fn


# ---- the long tail (correlation.cc, index_copy.cc, count_sketch.cc, ...) --

def correlation_maker(kernel_size=1, max_displacement=1, stride1=1,
                      stride2=1, pad_size=0, is_multiply=True):
    """JAX :715-762: FlowNet's cost volume, (n, D*D, oh, ow) with ``D =
    2 * (max_displacement // stride2) + 1``: for each displacement the
    mean over the k x k window and the channels of ``p1 * p2`` shifted
    (or ``|p1 - p2|``), one displacement at a time."""
    k, md = int(kernel_size), int(max_displacement)
    s1, s2, pad = int(stride1), int(stride2), int(pad_size)
    rad = (k - 1) // 2
    border = md + rad
    grid = md // s2

    def fn(data1, data2):
        n, c, h, w = data1.shape
        p1 = F.pad(data1, (pad, pad, pad, pad))
        p2 = F.pad(data2, (pad, pad, pad, pad))
        out_h = math.ceil((h + 2 * pad - 2 * border) / s1)
        out_w = math.ceil((w + 2 * pad - 2 * border) / s1)
        eh, ew = (out_h - 1) * s1 + k, (out_w - 1) * s1 + k
        lo = border - rad
        a = p1[:, :, lo:lo + eh, lo:lo + ew]
        maps = []
        for dy in range(-grid, grid + 1):
            for dx in range(-grid, grid + 1):
                y0, x0 = lo + dy * s2, lo + dx * s2
                b = p2[:, :, y0:y0 + eh, x0:x0 + ew]
                q = a * b if is_multiply else (a - b).abs()
                if k > 1 or s1 > 1:
                    q = F.avg_pool2d(q, k, s1, divisor_override=1)
                maps.append(q.sum(1) / _num(k * k * c, q))
        return torch.stack(maps, 1)
    return fn


def index_copy_maker():
    """JAX :764-770: ``old.at[idx].set(new)``: rows of ``new`` over rows
    of ``old`` (negative indices from the end, the last of repeated
    indices wins, out-of-range rows are dropped)."""
    def fn(old, idx, new):
        n = old.shape[0]
        i = idx.reshape(-1).long()
        i = torch.where(i < 0, i + n, i)
        ok = (i >= 0) & (i < n)
        tgt = torch.where(ok, i, n)
        pos = torch.arange(i.numel(), device=old.device)
        last = torch.full((n + 1,), -1, dtype=torch.long, device=old.device)
        last.scatter_reduce_(0, tgt, pos, reduce="amax")
        tgt = torch.where(ok & (last[tgt] == pos), tgt, n)
        spare = torch.cat([old, old.new_zeros((1,) + old.shape[1:])])
        return spare.index_put((tgt,), new.to(old.dtype))[:n]
    return fn


def count_sketch_maker(out_dim=None, processing_batch_size=32):
    """JAX :772-788: ``out[:, h[j]] += s[j] * data[:, j]``."""
    if out_dim is None:
        raise MXNetError("count_sketch requires out_dim")
    od = int(out_dim)

    def fn(data, h, s):
        signed = data * s.reshape(-1).to(data.dtype)
        out = data.new_zeros((data.shape[0], od))
        return out.index_add_(1, h.reshape(-1).long(), signed)
    return fn


def adaptive_avg_pool_maker(output_size=1):
    """JAX :800-825: each output cell the mean of rows ``[i h / oh,
    ceil((i + 1) h / oh))`` and the like columns."""
    size = _astuple(output_size)
    oh, ow = (int(size[0]), int(size[-1]))

    def fn(data):
        return F.adaptive_avg_pool2d(data, (oh, ow))
    return fn


def psroi_pooling_maker(spatial_scale=1.0, output_dim=1, pooled_size=7,
                        group_size=0):
    """JAX :827-865: each bin the mean of a fixed 2 x 2 grid of nearest
    pixels (the JAX package's, not MXNet's whole-bin average) of its
    position-sensitive channel ``(d * gs + i') * gs + j'``.  Only the
    selected channels are gathered (JAX samples all C and then selects:
    the same values)."""
    ps = int(pooled_size)
    gs = int(group_size) if group_size else ps
    sr = 2

    def fn(data, rois):
        _, c, h, w = data.shape
        dev, dt = data.device, data.dtype
        rois = rois.detach().to(dt)
        x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
        rw = (x2 - x1).clamp(min=0.1)
        rh = (y2 - y1).clamp(min=0.1)
        i = torch.arange(ps * sr, dtype=dt, device=dev)
        sy = y1[:, None] + (i + 0.5) * rh[:, None] / _num(ps * sr, rh)
        sx = x1[:, None] + (i + 0.5) * rw[:, None] / _num(ps * sr, rw)
        yi = torch.floor(sy).clamp(0, h - 1).long().reshape(-1, ps, sr)
        xi = torch.floor(sx).clamp(0, w - 1).long().reshape(-1, ps, sr)
        g = torch.arange(ps, device=dev) * gs // ps
        ch = (torch.arange(output_dim, device=dev)[:, None, None] * gs
              + g[:, None]) * gs + g[None, :]              # (D, ps, ps)
        plane = (rois[:, 0].long()[:, None, None, None] * c + ch) * h
        idx = ((plane[..., None, None] + yi[:, None, :, None, :, None])
               * w + xi[:, None, None, :, None, :])       # (R,D,ps,ps,sr,sr)
        return _flat_gather(data, idx).mean((-1, -2))
    return fn


def deformable_conv_maker(kernel=(3, 3), stride=(1, 1), dilate=(1, 1),
                          pad=(0, 0), num_filter=1, num_group=1,
                          num_deformable_group=1, no_bias=False, workspace=0,
                          layout=None):
    """JAX :869-948: a bilinear im2col at the kernel taps moved by
    ``offset`` (laid out (dg, K, [y, x], OH, OW); a corner outside the
    image reads 0), then one matrix product with the weights."""
    kh, kw = (int(v) for v in _astuple(kernel))
    sh, sw = (int(v) for v in _astuple(stride))
    dh, dw = (int(v) for v in _astuple(dilate))
    ph, pw = (int(v) for v in _astuple(pad))
    dg, ng = int(num_deformable_group), int(num_group)

    def fn(data, offset, weight, *maybe_bias):
        n, c, h, w = data.shape
        dev, dt = data.device, data.dtype
        oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
        ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
        kk, cg = kh * kw, c // dg
        tap = torch.arange(kk, device=dev)
        base_y = ((torch.arange(oh, device=dev) * sh - ph)[None, :, None]
                  + (tap // kw * dh)[:, None, None]).to(dt)   # (K, OH, 1)
        base_x = ((torch.arange(ow, device=dev) * sw - pw)[None, None, :]
                  + (tap % kw * dw)[:, None, None]).to(dt)    # (K, 1, OW)
        off = offset.reshape(n, dg, kk, 2, oh, ow)
        # rows of a (N * H * W, C) view; a corner an index_select of them
        rows = data.permute(0, 2, 3, 1).reshape(n * h * w, c)
        img = (torch.arange(n, device=dev) * (h * w))[:, None, None, None]
        cols = []
        for g in range(dg):
            yy = base_y + off[:, g, :, 0]                 # (N, K, OH, OW)
            xx = base_x + off[:, g, :, 1]
            y0, x0 = torch.floor(yy), torch.floor(xx)
            ly, lx = (yy - y0)[..., None], (xx - x0)[..., None]
            rows_g = rows[:, g * cg:(g + 1) * cg]

            def at(yi, xi):
                valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                idx = img + yi.clamp(0, h - 1).long() * w \
                    + xi.clamp(0, w - 1).long()
                vals = rows_g.index_select(0, idx.reshape(-1)).reshape(
                    idx.shape + (cg,))
                return vals * valid[..., None].to(dt)
            cols.append(at(y0, x0) * (1 - ly) * (1 - lx)
                        + at(y0, x0 + 1) * (1 - ly) * lx
                        + at(y0 + 1, x0) * ly * (1 - lx)
                        + at(y0 + 1, x0 + 1) * ly * lx)   # (N,K,OH,OW,Cg)
        col = torch.cat(cols, -1).permute(0, 2, 3, 4, 1)  # (N,OH,OW,C,K)
        col = col.reshape(n, oh * ow, ng, c // ng * kk)
        wmat = weight.reshape(ng, num_filter // ng, c // ng * kk)
        out = torch.einsum("npgk,gok->ngop", col, wmat).reshape(
            n, num_filter, oh, ow)
        if maybe_bias and not no_bias:
            out = out + maybe_bias[0][None, :, None, None]
        return out
    return fn


def index_array_maker(axes=None):
    """JAX :950-963: each element's index along ``axes`` (all by default)
    in a last axis, int32 (MXNet's is int64; the JAX package's int32)."""
    def fn(data):
        sel = tuple(axes) if axes is not None else tuple(range(data.dim()))
        grids = torch.meshgrid(*[torch.arange(s, device=data.device)
                                 for s in data.shape], indexing="ij")
        return torch.stack([grids[a] for a in sel], -1).to(torch.int32)
    return fn


def allclose_maker(rtol=1e-5, atol=1e-8, equal_nan=False):
    """JAX :1009-1017: 1.0 if every pair is close, else 0.0, shape (1,),
    on the device (no host read)."""
    def fn(a, b):
        a, b = torch.broadcast_tensors(a, b.to(a.dtype))
        return torch.isclose(a, b, rtol=float(rtol), atol=float(atol),
                             equal_nan=bool(equal_nan)).all().to(
            torch.float32).reshape(1)
    return fn


def getnnz_maker(axis=None):
    """JAX :1020-1029: the count of non-zeros (int32, the JAX package's
    32-bit mode), over ``axis`` or all."""
    def fn(data):
        nz = (data != 0).to(torch.int32)
        return nz.sum(dtype=torch.int32) if axis is None else \
            nz.sum(int(axis), dtype=torch.int32)
    return fn


def div_sqrt_dim_maker():
    """JAX :1033-1040: ``data / sqrt(data.shape[-1])``."""
    def fn(data):
        return data / torch.sqrt(_num(data.shape[-1], data))
    return fn


def zipf_candidates(n: int, range_max: int, gen, dev) -> torch.Tensor:
    """``n`` draws with replacement of Zipf(``range_max``) by the inverse
    CDF ``floor(exp(u log(range_max + 1))) - 1``, ``u`` from ``gen``."""
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    c = torch.exp(u * math.log(range_max + 1.0)).long() - 1
    return c.clamp(0, range_max - 1)


def _first_unique(draws: torch.Tensor, want: int):
    """The first ``want`` distinct values of ``draws`` in order of first
    appearance, and how many draws it took; None if fewer appear."""
    order = torch.argsort(draws, stable=True)
    s = draws[order]
    first_sorted = torch.ones_like(s, dtype=torch.bool)
    first_sorted[1:] = s[1:] != s[:-1]
    first = torch.zeros_like(first_sorted).index_put_(
        (order,), first_sorted)
    seen = torch.cumsum(first.to(torch.long), 0)
    if int(seen[-1]) < want:
        return None
    tries = int(torch.searchsorted(seen, torch.tensor(
        [want], device=seen.device))[0]) + 1
    return draws[:tries][first[:tries]], tries


def sample_unique_zipfian_maker(range_max=None, shape=None, ctx=None):
    """JAX :1047-1093: per row of ``shape`` = (rows, n), ``n`` distinct
    classes of Zipf(``range_max``) in order of first draw, and the draws
    it took, both int64.  The draws come from the device's generator
    (``mx.random.seed`` covers them) in blocks of at least ``2 n``; whether
    a block sufficed is read on the host, as the JAX op's rejection loop
    runs there."""
    from ..context import as_device
    from .register import host_read
    rm = int(range_max)
    shp = tuple(int(s) for s in shape)
    if shp[1] > rm:
        raise MXNetError(f"_sample_unique_zipfian: cannot draw {shp[1]} "
                         f"unique candidates from range_max={rm}")

    def fn():
        from .. import random as _random
        dev = as_device(ctx)
        if dev.type == "meta":
            return (torch.empty(shp, dtype=torch.long, device=dev),
                    torch.empty(shp[:1], dtype=torch.long, device=dev))
        gen = _random.generator(dev)
        out, tries = [], []
        for _ in range(shp[0]):
            draws = zipf_candidates(2 * shp[1], rm, gen, dev)
            while True:
                host_read("_sample_unique_zipfian", draws)
                got = _first_unique(draws, shp[1])
                if got is not None:
                    break
                draws = torch.cat([draws, zipf_candidates(
                    draws.numel(), rm, gen, dev)])
            out.append(got[0])
            tries.append(got[1])
        return (torch.stack(out), torch.tensor(tries, dtype=torch.long,
                                               device=dev))
    return fn


def backward_gradmult_maker(scalar=1.0):
    """JAX :1096-1102: ``x * scalar``."""
    def fn(x):
        return x * _num(scalar, x)
    return fn


def _register():
    register_op("_contrib_flash_attention", flash_attention_maker,
                aliases=("flash_attention",))
    register_op("_contrib_MultiBoxPrior", multibox_prior_maker,
                aliases=("MultiBoxPrior", "multibox_prior"))
    register_op("_contrib_box_iou", box_iou_maker, aliases=("box_iou",))
    register_op("_contrib_box_nms", box_nms_maker, aliases=("box_nms",))
    register_op("_contrib_MultiBoxTarget", multibox_target_maker,
                aliases=("MultiBoxTarget", "multibox_target"))
    register_op("_contrib_MultiBoxDetection", multibox_detection_maker,
                aliases=("MultiBoxDetection", "multibox_detection"))
    register_op("_contrib_ROIAlign", roi_align_maker,
                aliases=("ROIAlign", "roi_align"))
    register_op("_contrib_Proposal", proposal_maker,
                aliases=("_contrib_MultiProposal", "Proposal"))
    register_op("_contrib_box_decode", box_decode_maker,
                aliases=("box_decode",))
    register_op("_contrib_box_encode", box_encode_maker,
                aliases=("box_encode",))

    register_op("_contrib_DeformablePSROIPooling", deformable_psroi_maker,
                aliases=("DeformablePSROIPooling",))
    register_op("ROIPooling", roi_pooling_maker)
    register_op("_contrib_bipartite_matching", bipartite_matching_maker,
                aliases=("bipartite_matching",))
    register_op("Correlation", correlation_maker, aliases=("correlation",))
    register_op("_contrib_index_copy", index_copy_maker,
                aliases=("index_copy",))
    register_op("_contrib_count_sketch", count_sketch_maker,
                aliases=("count_sketch",), differentiable=False)
    register_op("_contrib_AdaptiveAvgPooling2D", adaptive_avg_pool_maker,
                aliases=("AdaptiveAvgPooling2D",))
    register_op("_contrib_PSROIPooling", psroi_pooling_maker,
                aliases=("PSROIPooling",))
    register_op("_contrib_DeformableConvolution", deformable_conv_maker,
                aliases=("DeformableConvolution",))
    register_op("_contrib_index_array", index_array_maker,
                aliases=("index_array",), differentiable=False)
    register_op("_contrib_allclose", allclose_maker, aliases=("allclose",),
                differentiable=False)
    register_op("_contrib_getnnz", getnnz_maker, differentiable=False)
    register_op("_contrib_div_sqrt_dim", div_sqrt_dim_maker,
                aliases=("div_sqrt_dim",))
    register_op("_sample_unique_zipfian", sample_unique_zipfian_maker,
                differentiable=False)
    register_op("_contrib_backward_gradientmultiplier",
                backward_gradmult_maker)


_register()
