"""Config #5 in the port: the detection ops (``ndarray/ops_contrib.py``),
``smooth_l1``/``stop_gradient``, the losses and the SSD and RCNN models,
each held against the JAX package on the same seeded numpy inputs.

- every op's forward against the JAX op, and its input gradients where
  it is differentiable (a random head gradient, the JAX package's
  imperative autograd), including tied scores, two ground truths that
  share an anchor, padded label rows, all-invalid candidates and the
  ``in_format``/``out_format`` conversions;
- the fixed-point NMS against a plain greedy loop, in fewer passes than
  candidates;
- ``ssd_toy`` and ``mask_rcnn_toy`` from the JAX package's weights: the
  forward, the loss and one SGD-momentum step; for the RCNN the
  gradients both packages share (everything downstream of the rois: the
  JAX package differentiates through ``Proposal``, the port, as MXNet,
  does not), the rest against the port's own float64 autograd;
- ``ssd_512_resnet50_v1`` at 128 x 128: forward shapes and values.

Tolerance: fp32, ``atol=1e-5`` (relative 1e-5 for values far from 1;
one fp32 evaluation each); decisions (kept sets, matches, labels) exact.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import rcnn as jrcnn
from mxnet_tpu.gluon.model_zoo import ssd as jssd
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params, nd
from mxnet_tpu_torch.gluon.model_zoo import rcnn, ssd
from mxnet_tpu_torch.ndarray import ops_contrib

TOL = dict(atol=1e-5, rtol=1e-5)


def _boxes(rs, *shape, scale=1.0):
    """Corner boxes (..., 4) with x1 < x2, y1 < y2."""
    lo = rs.rand(*shape, 2) * 0.7 * scale
    wh = (rs.rand(*shape, 2) * 0.3 + 0.02) * scale
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def _nms_data(rs, b, n, tie=False):
    d = np.zeros((b, n, 6), np.float32)
    d[..., 0] = rs.randint(0, 3, (b, n))
    d[..., 1] = np.round(rs.rand(b, n), 1) if tie else rs.rand(b, n)
    d[..., 2:] = _boxes(rs, b, n)
    return d


def _inputs():
    rs = np.random.RandomState(5)
    anchors = _boxes(rs, 1, 24)
    labels = np.full((2, 4, 5), -1.0, np.float32)
    labels[0, :3, 0] = [1, 0, 2]
    labels[0, :3, 1:] = _boxes(rs, 3)
    labels[1, 0] = [2, *anchors[0, 5]]          # one exact match
    feat = rs.randn(2, 3, 9, 11).astype(np.float32)
    rois = np.array([[0, 1, 1, 6, 5], [1, -2, 0.5, 4, 12],
                     [1, 3.3, 2.2, 3.4, 2.5], [0, 0, 0, 20, 20]], np.float32)
    a = _boxes(rs, 2, 7)
    return {
        "X": rs.randn(2, 8, 5, 6).astype(np.float32),
        "BA": a, "BB": _boxes(rs, 2, 5), "BC": a[0],
        "NMS": _nms_data(rs, 2, 40), "NMS_TIE": _nms_data(rs, 2, 40, True),
        "NMS_CTR": np.concatenate([_nms_data(rs, 1, 30)[..., :4],
                                   rs.rand(1, 30, 2).astype(np.float32)
                                   * 0.3 + 0.05], -1),
        "ANC": anchors, "LAB": labels,
        "CP": rs.randn(2, 4, 24).astype(np.float32),
        "PROB": (lambda p: p / p.sum(1, keepdims=True))(
            rs.rand(2, 4, 24).astype(np.float32)),
        "LOC": (rs.randn(2, 24 * 4) * 0.5).astype(np.float32),
        "FEAT": feat, "ROIS": rois,
        "CLS": (lambda c: np.concatenate([c[:, :9], np.where(
            np.arange(9)[None, :, None, None] < 3, 0.5, c[:, 9:])], 1))(
            rs.rand(2, 18, 4, 5).astype(np.float32)),
        "BBOX": (rs.randn(2, 36, 4, 5) * 0.2).astype(np.float32),
        "INFO": np.array([[64, 80, 1], [64, 80, 1]], np.float32),
        "S": np.sign(rs.randn(2, 7)).astype(np.float32),
        "M": rs.randint(0, 5, (2, 7)).astype(np.float32),
        "MEANS": np.array([0.1, 0, -0.1, 0.2], np.float32),
        "STDS": np.array([1, 2, 0.5, 1], np.float32),
        "D": rs.randn(2, 7, 4).astype(np.float32),
        "A1": a[:1], "U": (rs.rand(3, 4) * 4 - 2).astype(np.float32),
    }


ARRAYS = _inputs()
PROPOSAL = dict(rpn_pre_nms_top_n=50, rpn_post_nms_top_n=20,
                feature_stride=16, scales=(1.0, 2.0, 4.0),
                ratios=(0.5, 1.0, 2.0), rpn_min_size=4, threshold=0.7)

# (id, op, kwargs, inputs, indices of the inputs to differentiate)
CASES = [
    ("prior", "MultiBoxPrior", dict(sizes=(0.3, 0.2), ratios=(1, 2, 0.5)),
     ["X"], ()),
    ("prior_clip_steps", "MultiBoxPrior", dict(
        sizes=(0.5,), ratios=(1, 3), clip=True, steps=(0.1, 0.2),
        offsets=(0.3, 0.6)), ["X"], ()),
    ("iou", "box_iou", {}, ["BA", "BB"], (0, 1)),
    ("iou_2d", "box_iou", {}, ["BC", "BC"], (0,)),
    ("iou_center", "box_iou", dict(format="center"), ["BA", "BB"], (0, 1)),
    ("nms", "box_nms", dict(overlap_thresh=0.3), ["NMS"], (0,)),
    ("nms_ids", "box_nms", dict(overlap_thresh=0.3, id_index=0), ["NMS"],
     (0,)),
    ("nms_tied_scores", "box_nms", dict(overlap_thresh=0.2, id_index=0),
     ["NMS_TIE"], (0,)),
    ("nms_force_topk", "box_nms", dict(overlap_thresh=0.3, id_index=0,
                                       force_suppress=True, topk=10),
     ["NMS"], ()),
    ("nms_background", "box_nms", dict(overlap_thresh=0.3, id_index=0,
                                       valid_thresh=0.35, background_id=1),
     ["NMS"], ()),
    ("nms_out_center", "box_nms", dict(overlap_thresh=0.3,
                                       out_format="center"), ["NMS"], (0,)),
    ("nms_in_center", "box_nms", dict(overlap_thresh=0.3,
                                      in_format="center"), ["NMS_CTR"], ()),
    ("nms_all_invalid", "box_nms", dict(valid_thresh=2.0), ["NMS"], ()),
    ("target", "MultiBoxTarget", {}, ["ANC", "LAB", "CP"], ()),
    ("target_mining", "MultiBoxTarget", dict(negative_mining_ratio=3.0,
                                             overlap_threshold=0.3),
     ["ANC", "LAB", "CP"], ()),
    ("target_min_neg", "MultiBoxTarget", dict(
        negative_mining_ratio=0.5, minimum_negative_samples=5,
        negative_mining_thresh=0.2, variances=(0.2, 0.2, 0.1, 0.1)),
     ["ANC", "LAB", "CP"], ()),
    ("detection", "MultiBoxDetection", {}, ["PROB", "LOC", "ANC"], ()),
    ("detection_topk", "MultiBoxDetection", dict(
        threshold=0.3, nms_threshold=0.3, nms_topk=10, clip=False),
     ["PROB", "LOC", "ANC"], ()),
    ("roi_align", "ROIAlign", dict(pooled_size=(3, 4)), ["FEAT", "ROIS"],
     (0,)),
    ("roi_align_aligned", "ROIAlign", dict(pooled_size=(2, 2),
                                           aligned=True, sample_ratio=3,
                                           spatial_scale=0.5),
     ["FEAT", "ROIS"], (0,)),
    ("proposal", "Proposal", PROPOSAL, ["CLS", "BBOX", "INFO"], ()),
    ("box_encode", "box_encode", {}, ["S", "M", "BA", "BB", "MEANS",
                                      "STDS"], (2, 3)),
    ("box_decode", "box_decode", dict(std0=0.1, clip=0.5), ["D", "A1"],
     (0, 1)),
    ("box_decode_center", "box_decode", dict(format="center"), ["D", "A1"],
     (0, 1)),
    ("smooth_l1", "smooth_l1", dict(scalar=2.0), ["U"], (0,)),
    ("block_grad", "BlockGrad", {}, ["U"], ()),
]


def _jax_op(op):
    return getattr(mx.nd.contrib, op, None) or getattr(mx.nd, op)


def _port_op(op):
    return getattr(nd.contrib, op, None) or getattr(nd, op)


def _listify(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("name,op,kwargs,inputs,grads", CASES,
                         ids=[c[0] for c in CASES])
def test_op_forward_matches_jax(name, op, kwargs, inputs, grads):
    arrays = [ARRAYS[k] for k in inputs]
    want = _listify(_jax_op(op)(*[mx.nd.array(a) for a in arrays],
                                **kwargs))
    with cpu():
        got = _listify(_port_op(op)(*[nd.array(a) for a in arrays],
                                    **kwargs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


GRAD_CASES = [c for c in CASES if c[4]]


@pytest.mark.parametrize("name,op,kwargs,inputs,grads", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_op_gradients_match_jax(name, op, kwargs, inputs, grads):
    arrays = [ARRAYS[k] for k in inputs]
    rs = np.random.RandomState(1)
    j_in = [mx.nd.array(a) for a in arrays]
    for i in grads:
        j_in[i].attach_grad()
    with jag.record():
        j_out = _listify(_jax_op(op)(*j_in, **kwargs))
    heads = [rs.randn(*o.shape).astype(np.float32) for o in j_out]
    jag.backward(j_out, [mx.nd.array(h) for h in heads])
    with cpu():
        t_in = [nd.array(a) for a in arrays]
        for i in grads:
            t_in[i].attach_grad()
        with autograd.record():
            t_out = _listify(_port_op(op)(*t_in, **kwargs))
        autograd.backward(t_out, [nd.array(h) for h in heads])
    for i in grads:
        np.testing.assert_allclose(t_in[i].grad.asnumpy(),
                                   j_in[i].grad.asnumpy(), **TOL)


def test_block_grad_and_smooth_l1_branch():
    x = torch.tensor([-2.0, -0.2, 0.0, 0.2, 0.3, 2.0], requires_grad=True)
    y = nd.smooth_l1(x, scalar=2.0)          # |x| < 1/4 is quadratic
    np.testing.assert_allclose(
        y.detach(), [1.875, 0.08, 0.0, 0.08, 0.175, 1.875], atol=1e-6)
    assert not nd.stop_gradient(x * 3).requires_grad
    assert not nd.BlockGrad(x * 3).requires_grad


def _greedy(boxes, valid, thresh):
    """The plain greedy walk over score-sorted candidates."""
    keep = list(valid)
    iou = ops_contrib._iou_corner(boxes[:, None], boxes[None])
    for i in range(len(keep)):
        if keep[i]:
            for j in range(i + 1, len(keep)):
                if iou[i, j] > thresh:
                    keep[j] = False
    return keep


@pytest.mark.parametrize("k", [1, 7, 200])
def test_fixed_point_nms_is_the_greedy_walk(k):
    rs = np.random.RandomState(k)
    boxes = torch.tensor(_boxes(rs, 2, k, scale=1.0))
    valid = torch.tensor(rs.rand(2, k) > 0.1)
    sup = torch.stack([ops_contrib._iou_corner(b[:, None], b[None]) > 0.3
                       for b in boxes])
    ops_contrib.nms_stats.reset()
    keep = ops_contrib.greedy_keep(valid, sup)
    for b in range(2):
        assert keep[b].tolist() == _greedy(boxes[b], valid[b].tolist(), 0.3)
    stats = ops_contrib.nms_stats
    assert stats.calls == 1 and stats.settled <= stats.last
    if k == 200:
        assert stats.last < k
    none = ops_contrib.greedy_keep(torch.zeros(2, k, dtype=torch.bool), sup)
    assert not none.any() and ops_contrib.nms_stats.last == \
        ops_contrib.NMS_CHECK_EVERY


def test_tied_scores_keep_the_later_index_first():
    """Two equal boxes with equal scores: the JAX order (a stable sort,
    reversed) walks the later one first, which suppresses the other."""
    d = np.array([[[0, 0.5, 0.1, 0.1, 0.4, 0.4],
                   [0, 0.5, 0.1, 0.1, 0.4, 0.4],
                   [0, 0.9, 0.6, 0.6, 0.9, 0.9]]], np.float32)
    want = mx.nd.contrib.box_nms(mx.nd.array(d)).asnumpy()
    got = nd.contrib.box_nms(torch.tensor(d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, :, 1].tolist() == [-1.0, 0.5, pytest.approx(0.9)]


def test_two_ground_truths_sharing_an_anchor_later_wins():
    anchors = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]],
                       np.float32)
    labels = np.array([[[1, .05, .05, .45, .45], [2, 0, 0, .4, .4],
                        [-1, 0, 0, 0, 0]]], np.float32)
    cp = np.zeros((1, 4, 3), np.float32)
    want = mx.nd.contrib.MultiBoxTarget(*[mx.nd.array(a) for a in (
        anchors, labels, cp)])
    got = nd.contrib.MultiBoxTarget(*[torch.tensor(a) for a in (
        anchors, labels, cp)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.asnumpy(), **TOL)
    assert got[2][0].tolist() == [3.0, 0.0, 0.0]   # class 2 + 1


def test_padded_rows_never_claim_an_anchor():
    anchors = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1]]], np.float32)
    labels = np.array([[[-1, 0, 0, .5, .5], [0, .55, .55, .95, .95]]],
                      np.float32)
    cp = np.zeros((1, 2, 2), np.float32)
    got = nd.contrib.MultiBoxTarget(*[torch.tensor(a) for a in (
        anchors, labels, cp)])
    assert got[2][0].tolist() == [0.0, 1.0]
    assert got[1][0].tolist() == [0.0] * 4 + [1.0] * 4


def test_detection_ops_carry_no_gradient():
    c = torch.tensor(ARRAYS["CLS"], requires_grad=True)
    b = torch.tensor(ARRAYS["BBOX"], requires_grad=True)
    with autograd.record():
        rois = nd.contrib.Proposal(c, b, torch.tensor(ARRAYS["INFO"]),
                                   **PROPOSAL)
        pooled = nd.contrib.ROIAlign(torch.randn(2, 3, 9, 11), rois,
                                     pooled_size=(2, 2))
        det = nd.contrib.MultiBoxDetection(
            torch.tensor(ARRAYS["PROB"], requires_grad=True),
            torch.tensor(ARRAYS["LOC"], requires_grad=True),
            torch.tensor(ARRAYS["ANC"]))
    assert not rois.requires_grad and not det.requires_grad
    assert not pooled.requires_grad


def test_losses_match_jax():
    rs = np.random.RandomState(2)
    pred = rs.randn(6, 5).astype(np.float32)
    prob = rs.rand(6, 5).astype(np.float32)
    label = (rs.rand(6, 5) > 0.5).astype(np.float32)
    sw = rs.rand(6, 1).astype(np.float32)
    pw = (rs.rand(5) + 0.5).astype(np.float32)
    cases = [(False, pred, None, None), (True, prob, None, None),
             (False, pred, None, pw), (True, prob, None, pw),
             (False, pred, sw, None), (False, pred, sw, pw)]
    for from_sigmoid, x, w, p in cases:
        extra = [w, p] if p is not None else [w] if w is not None else []
        want = jgluon.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid)(
            mx.nd.array(x), mx.nd.array(label),
            *[None if e is None else mx.nd.array(e) for e in extra])
        got = gluon.loss.SigmoidBCELoss(from_sigmoid)(
            torch.tensor(x), torch.tensor(label),
            *[None if e is None else torch.tensor(e) for e in extra])
        np.testing.assert_allclose(got.numpy(), want.asnumpy(), **TOL)
    cls = rs.randint(0, 5, 6).astype(np.float32)
    want = jgluon.loss.SoftmaxCrossEntropyLoss()(
        mx.nd.array(pred), mx.nd.array(cls), mx.nd.array(sw)).asnumpy()
    got = gluon.loss.SoftmaxCrossEntropyLoss()(
        torch.tensor(pred), torch.tensor(cls), torch.tensor(sw))
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---- the models ----------------------------------------------------------
def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _ssd_batch(b=2, size=64):
    rs = np.random.RandomState(7)
    x = rs.randn(b, 3, size, size).astype(np.float32)
    labels = np.full((b, 4, 5), -1.0, np.float32)
    for i in range(b):
        labels[i, 0] = [i % 3, 0.1, 0.1, 0.55, 0.6]
        labels[i, 1] = [(i + 1) % 3, 0.45, 0.4, 0.9, 0.95]
    return x, labels


OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def test_ssd_toy_forward_loss_and_step_match_jax():
    x, labels = _ssd_batch()
    ref = jssd.ssd_toy(classes=3)
    ref.initialize()
    ref(mx.nd.array(x))                       # settles the deferred shapes
    init = _arrays(ref)
    port = ssd.ssd_toy(classes=3)
    port.initialize(ctx=cpu())
    trainer = gluon.Trainer(port.collect_params(), "sgd", OPT)
    load_reference_params(port, init, ctx=cpu())
    jtr = jgluon.Trainer(ref.collect_params(), "sgd", OPT)
    with jag.record():
        jl = jssd.SSDMultiBoxLoss()(*ref(mx.nd.array(x)),
                                    mx.nd.array(labels))
    jl.backward()
    with autograd.record():
        tl = ssd.SSDMultiBoxLoss()(*port(torch.tensor(x)),
                                   torch.tensor(labels))
    autograd.backward(tl)
    np.testing.assert_allclose(tl.item(), jl.asscalar(), **TOL)
    for p, q in zip(ref.collect_params().values(),
                    port.collect_params().values()):
        if p.grad_req != "null":
            np.testing.assert_allclose(q.grad().numpy(),
                                       p.grad().asnumpy(), **TOL)
    jtr.step(x.shape[0])
    trainer.step(x.shape[0])
    for p, q in zip(ref.collect_params().values(),
                    port.collect_params().values()):
        np.testing.assert_allclose(q.data().detach().numpy(),
                                   p.data().asnumpy(), **TOL)
    with autograd.predict_mode():
        anchors, cls, box = port(torch.tensor(x))
    janchors, jcls, jbox = ref(mx.nd.array(x))
    for g, w in ((anchors, janchors), (cls, jcls), (box, jbox)):
        np.testing.assert_allclose(g.detach().numpy(), w.asnumpy(), **TOL)


def _rcnn_batch(b=2):
    rs = np.random.RandomState(9)
    x = rs.randn(b, 3, 64, 64).astype(np.float32)
    gtb = np.array([[[4, 4, 30, 40], [20, 10, 60, 50]],
                    [[10, 12, 50, 44], [0, 30, 25, 63]]], np.float32)[:b]
    gtc = np.array([[0, 2], [1, 1]], np.float32)[:b]
    gtm = (rs.rand(b, 2, 14, 14) > 0.5).astype(np.float32)
    return x, gtb, gtc, gtm


def _downstream(name, net_prefix):
    """A parameter downstream of the rois (the heads): its gradient is
    the same in both packages, which differ upstream (the JAX package
    also differentiates through ``Proposal``)."""
    short = name[len(net_prefix):] if name.startswith(net_prefix) else ""
    return short.startswith(("dense", "conv2_d", "conv2_dtranspose")) \
        and "rpnhead" not in short


def test_mask_rcnn_toy_matches_jax_and_float64():
    x, gtb, gtc, gtm = _rcnn_batch()
    ref = jrcnn.mask_rcnn_toy(classes=3)
    ref.initialize()
    ref(mx.nd.array(x))
    init = _arrays(ref)
    port = rcnn.mask_rcnn_toy(classes=3)
    port.initialize(ctx=cpu())
    trainer = gluon.Trainer(port.collect_params(), "sgd", OPT)
    load_reference_params(port, init, ctx=cpu())
    jtr = jgluon.Trainer(ref.collect_params(), "sgd", OPT)
    with jag.record():
        jout = ref(mx.nd.array(x))
        jl = jrcnn.RCNNLoss.for_net(ref)(
            jout, *[mx.nd.array(a) for a in (gtb, gtc, gtm)])
    jl.backward()
    with autograd.record():
        tout = port(torch.tensor(x))
        tl = rcnn.RCNNLoss.for_net(port)(
            tout, *[torch.tensor(a) for a in (gtb, gtc, gtm)])
    autograd.backward(tl)
    for g, w in zip(tout, jout):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w.asnumpy(), **TOL)
    np.testing.assert_allclose(tl.item(), jl.asscalar(), **TOL)
    assert not tout[2].requires_grad
    shared = [(p, q) for (k, p), q in zip(ref.collect_params().items(),
                                          port.collect_params().values())
              if _downstream(k, ref.prefix)]
    assert len(shared) == 16        # 4 Dense, 3 convs, 1 transposed conv
    for p, q in shared:
        np.testing.assert_allclose(q.grad().numpy(), p.grad().asnumpy(),
                                   **TOL)
    # every gradient against the port's own float64 autograd
    port64 = rcnn.mask_rcnn_toy(classes=3)
    load_reference_params(port64, init, ctx=cpu())
    port64 = port64.to(torch.float64)
    with autograd.record():
        l64 = rcnn.RCNNLoss.for_net(port64)(
            port64(torch.tensor(x, dtype=torch.float64)),
            *[torch.tensor(a, dtype=torch.float64) for a in (gtb, gtc,
                                                             gtm)])
    autograd.backward(l64)
    for q, q64 in zip(port.collect_params().values(),
                      port64.collect_params().values()):
        g, g64 = q.grad().double(), q64.grad()
        assert (g - g64).abs().max() <= 1e-5 * max(1.0, g64.abs().max())
    # one step: the downstream weights as the JAX package's
    jtr.step(x.shape[0])
    trainer.step(x.shape[0])
    for p, q in shared:
        np.testing.assert_allclose(q.data().detach().numpy(),
                                   p.data().asnumpy(), **TOL)


def test_faster_rcnn_toy_forward_matches_jax():
    x = _rcnn_batch()[0]
    ref = jrcnn.faster_rcnn_toy(classes=3)
    ref.initialize()
    want = ref(mx.nd.array(x))
    port = rcnn.faster_rcnn_toy(classes=3)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    got = port(torch.tensor(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.asnumpy(), **TOL)


@pytest.fixture(scope="module")
def ssd512():
    rs = np.random.RandomState(4)
    x = rs.randn(1, 3, 128, 128).astype(np.float32)
    ref = jssd.ssd_512_resnet50_v1(classes=20)
    ref.initialize()
    out = [o.asnumpy() for o in ref(mx.nd.array(x))]
    return x, _arrays(ref), out


def test_ssd_512_resnet50_v1_forward_at_128(ssd512):
    x, init, want = ssd512
    port = ssd.ssd_512_resnet50_v1(classes=20)
    names = list(port.collect_params())
    assert len(names) == len(init)
    assert sum(p.shape_known() for p in port.collect_params().values()) \
        < len(names)                       # the extras are deferred
    load_reference_params(port, init, ctx=cpu())
    got = port(torch.tensor(x))
    assert [tuple(g.shape) for g in got] == [(1, 362, 4), (1, 362, 21),
                                            (1, 362 * 4)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)
