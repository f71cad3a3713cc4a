"""The port's CUDA kernels held against their plain PyTorch versions on
the card: flash attention, the two multi-tensor SGD kernels alone and
through gluon.Trainer, and kernels compiled at run time by ``rtc`` (the
user kernels of ``chip_smoke.py``, alone and inside a custom op's
backward).  Marked ``cuda``; every test skips (inside the ``card``
fixture) where no CUDA device is present.  Run on a machine with an
H100:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: flash fp32 max-abs 1e-4 (fp32 accumulation in both, summation
order differs; the kernel's products are 3xTF32, as accurate as fp32);
bf16 2e-2 and fp16 4e-3 against the plain version run in fp32 on the
same bf16/fp16 inputs (output rounding, and P rounded to the input type
for the PV product: 8 and 11 significant bits).  Multi-tensor SGD 1e-6
in fp32 (the kernels round each operation as the plain version does: 0
expected), bit for bit in bf16/fp16 and on the mixed path.
A training step on the card against the CPU: 1e-4 (cuDNN and the CPU's
convolutions sum in different orders).  rtc: exact for add_one, twice,
the reversal through shared memory and the fp16 product (one rounding in
both); axpy fp32 1e-6 (NVRTC may contract to an FMA); softmax 1e-6
(probabilities; the same expf per element, row sums in another order).
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import (flash_attention, flash_attention_plain,
                                     multi_mp_sgd, multi_mp_sgd_mom,
                                     multi_mp_sgd_mom_plain,
                                     multi_mp_sgd_plain, multi_sgd,
                                     multi_sgd_mom, multi_sgd_mom_plain,
                                     multi_sgd_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
FLASH_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(seed, bh, lq, lk, d, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(bh, n, d, generator=g).to(dev, dtype)
            for n in (lq, lk, lk)]


FLASH_CASES = [
    (8, 12, 128, 128, 64, False, None, None),   # BERT-base, bucket 128
    (8, 12, 512, 512, 64, False, None, None),   # BERT-base, bucket 512
    (1, 12, 37, 37, 64, False, None, None),     # a direct forward, ragged
    (2, 12, 160, 96, 64, True, None, None),     # causal, Lq > Lk: dead rows
    (2, 4, 200, 131, 128, False, None, None),   # D = 128
    (2, 4, 77, 90, 32, True, None, None),       # D = 32
    # tile edges (64-row query and key tiles), cross-paired; fractional
    # and zero lengths; a non-default scale
    (2, 2, 1, 512, 32, False, [0.0, 300.5], None),
    (2, 2, 63, 1, 64, False, [1.0, 0.5], None),
    (2, 2, 64, 127, 128, True, [127.0, 63.5], None),   # causal, Lq < Lk
    (2, 2, 65, 129, 32, False, [129.0, 64.5], 0.5),
    (2, 2, 127, 64, 64, True, [64.0, 0.0], None),      # causal, Lq > Lk
    (2, 2, 129, 65, 128, False, [65.0, 63.5], 2.0),
    (2, 2, 512, 63, 64, True, [63.0, 62.5], None),     # causal, Lq > Lk
]


@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("b,h,lq,lk,d,causal,vl,scale", FLASH_CASES)
def test_kernel_matches_plain(card, dtype, b, h, lq, lk, d, causal, vl,
                              scale):
    q, k, v = _inputs(b * lq + d, b * h, lq, lk, d, dtype, card)
    if vl is None:
        vl = torch.randint(1, lk + 1, (b,),
                           generator=torch.Generator().manual_seed(d))
        vl = vl.float()
        vl[0] = 0.0
    vl = torch.as_tensor(vl, dtype=torch.float32).to(card)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    before = flash_attention.launches
    out = flash_attention(q, k, v, vl, causal, scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    vl_bh = vl.repeat_interleave(h)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), vl_bh,
                                causal, scale)
    err = (out.float() - ref).abs().max().item()
    assert err <= TOL[dtype], err
    assert not out[vl_bh == 0].any()  # valid_len 0: the zero rows



def _lengths(vl, b, lk, d, card):
    if vl is None:
        vl = torch.randint(1, lk + 1, (b,),
                           generator=torch.Generator().manual_seed(d))
        vl = vl.float()
        vl[0] = 0.0
    return torch.as_tensor(vl, dtype=torch.float32).to(card)


@pytest.mark.parametrize("dtype", FLASH_DTYPES)
@pytest.mark.parametrize("b,h,lq,lk,d,causal,vl,scale", FLASH_CASES)
def test_backward_matches_plain_autograd(card, dtype, b, h, lq, lk, d,
                                         causal, vl, scale):
    """q/k/v gradients through the kernel's autograd node (kernel
    forward, chunked torch backward) against torch autograd through the
    plain version in fp32 on the same values, at the forward's tile-edge
    cases: max-abs <= TOL[dtype] * max(1, max|g|)."""
    q, k, v = _inputs(b * lq + d, b * h, lq, lk, d, dtype, card)
    dout = _inputs(d, b * h, lq, lq, d, dtype, card)[0]
    vl = _lengths(vl, b, lk, d, card)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention(q, k, v, vl, causal, scale)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    ref = torch.autograd.grad(
        flash_attention_plain(*ref_leaves, vl.repeat_interleave(h), causal,
                              scale), ref_leaves, dout.float())
    for g, r in zip(grads, ref):
        assert g.dtype == dtype and g.shape == r.shape
        err = (g.float() - r).abs().max().item()
        assert err <= TOL[dtype] * max(1.0, r.abs().max().item()), err


def test_backward_peak_memory_below_a_score_matrix(card):
    """At L=2048 the backward's peak memory (gradients included) stays
    below one (B*H, L, L) fp32 score matrix: it works one 128-key chunk
    at a time."""
    bh, length, d = 4, 2048, 64
    q, k, v = (t.requires_grad_() for t in
               _inputs(3, bh, length, length, d, torch.float32, card))
    out = flash_attention(q, k, v, torch.full((bh,), 1500.0, device=card))
    dout = torch.randn_like(out)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < bh * length * length * 4, peak


def _bert_step(dev, bf16):
    """One Adam step of a 2-layer BERT (head dim 64, so the kernel takes
    it) on ``chip_smoke.bert_batch``: the loss and each leaf's
    gradient."""
    import chip_smoke
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon.model_zoo.transformer import BERTModel
    net = BERTModel(vocab_size=1000, num_layers=2, units=128,
                    hidden_size=256, num_heads=2, max_length=64,
                    dropout=0.0)
    net.initialize(ctx=dev, seed=5)
    batch = [torch.as_tensor(a, device=dev)
             for a in chip_smoke.bert_batch(0, 2, 40, 1000)]
    if bf16:
        amp.init("bfloat16")
    try:
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-4})
        with autograd.record():
            loss = chip_smoke.mlm_nsp_loss(*net(*batch[:3]), *batch[3:])
        autograd.backward(loss)
        grads = {k: p._grad_tensor().detach().cpu().clone()
                 for k, p in net.collect_params().items()}
        tr.step(1)
    finally:
        amp.disable()
    return loss.item(), grads


@pytest.mark.parametrize("bf16", [False, True])
def test_bert_train_step_on_card_matches_cpu(card, bf16):
    """One training step (MLM + NSP loss, Adam) of a small BERT on the
    card (flash kernel, chunked backward) against the same step on the
    CPU (plain version): fp32 loss to 1e-5 relative and each leaf's
    gradient to 1e-4 * max|g| + 1e-6; under AMP the losses to 2e-2
    relative, the gradients fp32."""
    before = flash_attention.launches_by_dtype.copy()
    loss_card, g_card = _bert_step(card, bf16)
    key = "torch.bfloat16" if bf16 else "torch.float32"
    assert flash_attention.launches_by_dtype[key] == before[key] + 2
    loss_cpu, g_cpu = _bert_step(torch.device("cpu"), bf16)
    if bf16:
        assert abs(loss_card - loss_cpu) <= 2e-2 * abs(loss_cpu)
        assert {g.dtype for g in g_card.values()} == {torch.float32}
        return
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for (k, g), gc in zip(g_cpu.items(), g_card.values()):  # in order
        err = (gc - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-6, (k, err)

def test_load_reference_params_defaults_to_the_card(card):
    from mxnet_tpu_torch import load_reference_params
    from mxnet_tpu_torch.gluon.model_zoo.transformer import \
        MultiHeadAttention
    src = MultiHeadAttention(64, 4)
    src.initialize(ctx="cpu", seed=2)
    arrays = {k: p._tensor().detach().numpy()
              for k, p in src.collect_params().items()}
    net = MultiHeadAttention(64, 4)
    load_reference_params(net, arrays)
    assert net.device() == card


def test_kernel_4d_and_no_valid_len(card):
    q, k, v = (t.view(2, 3, -1, 64)
               for t in _inputs(1, 6, 50, 70, 64, torch.float32, card))
    out = flash_attention(q, k, v)
    ref = flash_attention_plain(*(t.reshape(6, -1, 64) for t in (q, k, v)),
                                torch.full((6,), 70.0, device=card), False,
                                1 / 8)
    assert out.shape == (2, 3, 50, 64)
    assert (out.reshape(6, 50, 64) - ref).abs().max().item() <= 1e-4


def test_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros(2, 16, 48, device=card)
    with pytest.raises(MXNetError, match="head dim"):
        flash_attention(q, q, q)
    h = torch.zeros(2, 16, 64, device=card, dtype=torch.float64)
    before = flash_attention.launches
    with pytest.raises(MXNetError, match="dtype"):
        flash_attention(h, h, h)
    assert flash_attention.launches == before
    x = torch.zeros(2, 16, 64, device=card)
    with pytest.raises(MXNetError, match="devices"):
        flash_attention(x, x.cpu(), x)
    with pytest.raises(MXNetError, match="contiguous"):
        flash_attention(x, x.transpose(0, 1).contiguous().transpose(0, 1),
                        x)
    # a contiguous view 4 bytes into its storage: refused, not launched
    odd = torch.zeros(2 * 16 * 64 + 1, device=card)[1:].view(2, 16, 64)
    before = flash_attention.launches
    with pytest.raises(MXNetError, match="4 bytes past a 16-byte boundary"):
        flash_attention(x, odd, x)
    assert flash_attention.launches == before


def test_readback_is_one_batched_copy(card):
    """The serving readback returns every output on the host, equal to a
    plain copy, and leaves nothing pending on the stream."""
    from mxnet_tpu_torch.serving.server import readback
    outs = [torch.randn(8, 40, 1000, device=card),
            torch.arange(16, device=card, dtype=torch.int32).view(8, 2)]
    host = readback(outs)
    assert torch.cuda.current_stream(card).query()
    for h, t in zip(host, outs):
        assert isinstance(h, np.ndarray) and h.dtype == t.cpu().numpy().dtype
        np.testing.assert_array_equal(h, t.cpu().numpy())


def test_bert_forward_on_card_matches_cpu(card):
    """A 2-layer BERT (head dim 64) through the kernel on the card against
    the same weights on the CPU through the plain version (max-abs 1e-4)."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import BERTModel
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 1000, (3, 40)).astype(np.int32)
    types = np.zeros((3, 40), np.int32)
    vl = np.array([40, 17, 0], np.float32)
    outs = []
    for dev in (torch.device("cpu"), card):
        net = BERTModel(vocab_size=1000, num_layers=2, units=128,
                        hidden_size=256, num_heads=2, max_length=64,
                        dropout=0.0)
        net.initialize(ctx=dev, seed=5)
        before = flash_attention.launches
        with torch.inference_mode():
            outs.append([o.cpu().numpy() for o in net(
                *(torch.as_tensor(a, device=dev) for a in (toks, types, vl)))])
        assert flash_attention.launches - before == (2 if dev == card else 0)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, atol=1e-4)


ODD_SHAPES = [(1,), (3,), (7, 5), (1023,), (4097,), (8193,), (3, 33333),
              (64, 3, 3, 3)] * 9                           # 72 tensors


def _sgd_set(card, shapes, offset, seed):
    """w, g, m of ``shapes`` on the card, each ``offset`` elements into its
    own buffer (offset 1 misaligns every pointer)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def make():
        out = []
        for s in shapes:
            n = int(np.prod(s))
            out.append(torch.randn(n + offset, device=card,
                                   generator=g)[offset:].view(s))
        return out
    return make(), make(), make()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("clip", [-1.0, 0.5])
@pytest.mark.parametrize("momentum", [False, True])
def test_multi_sgd_kernels_match_plain(card, momentum, clip, offset):
    """72 odd-sized tensors (vector body and scalar tails; scalar only when
    misaligned): one group splits into 2 launches of the 64-entry table."""
    w, g, m = _sgd_set(card, ODD_SHAPES, offset, 7 + offset)
    lrs = np.linspace(0.01, 0.3, len(w)).tolist()
    wds = np.linspace(0.0, 1e-2, len(w)).tolist()
    wk, mk = [t.clone() for t in w], [t.clone() for t in m]
    wp, mp = [t.clone() for t in w], [t.clone() for t in m]
    counter = multi_sgd_mom if momentum else multi_sgd
    before = counter.launches
    if momentum:
        multi_sgd_mom(wk, g, mk, lrs, wds, 0.9, 1 / 128, clip)
        multi_sgd_mom_plain(wp, g, mp, lrs, wds, 0.9, 1 / 128, clip)
    else:
        multi_sgd(wk, g, lrs, wds, 1 / 128, clip)
        multi_sgd_plain(wp, g, lrs, wds, 1 / 128, clip)
    torch.cuda.synchronize()
    assert counter.launches - before == 2
    for a, b in zip(wk + mk, wp + mp):
        assert (a - b).abs().max().item() <= 1e-6


def test_multi_sgd_kernel_rejects_what_it_does_not_take(card):
    """A dtype without a kernel raises and launches nothing (float64; a
    mixed group of fp32 weights, of bf16 masters, of bf16 weights with
    fp16 gradients); so do other layouts, sizes and devices."""
    w = [torch.zeros(4, 4, device=card)]
    d, b = [w[0].double()], [w[0].bfloat16()]
    before = multi_sgd.launches + multi_mp_sgd_mom.launches
    with pytest.raises(MXNetError, match="dtype"):
        multi_sgd(d, d, [0.1], [0.0])
    with pytest.raises(MXNetError, match="dtype"):
        multi_mp_sgd_mom(w, w, w, w, [0.1], [0.0], 0.9)
    with pytest.raises(MXNetError, match="dtype"):
        multi_mp_sgd_mom(b, b, w, b, [0.1], [0.0], 0.9)
    with pytest.raises(MXNetError, match="dtype"):
        multi_mp_sgd_mom(b, [w[0].half()], w, w, [0.1], [0.0], 0.9)
    assert multi_sgd.launches + multi_mp_sgd_mom.launches == before
    with pytest.raises(MXNetError, match="contiguous"):
        multi_sgd([w[0].t()], [w[0].t()], [0.1], [0.0])
    with pytest.raises(MXNetError, match="match"):
        multi_sgd(w, [torch.zeros(5, device=card)], [0.1], [0.0])
    with pytest.raises(MXNetError, match="tensors on"):
        multi_sgd(w, [torch.zeros(4, 4)], [0.1], [0.0])


def test_multi_sgd_kernel_skips_empty_tensors(card):
    """Empty tensors take no block; a group of only empty tensors makes no
    launch and counts none."""
    empty, w = torch.zeros(0, device=card), torch.ones(5, device=card)
    before = multi_sgd.launches
    multi_sgd([empty], [empty], [0.1], [0.0])
    assert multi_sgd.launches == before
    multi_sgd([empty, w, empty], [empty, torch.ones_like(w), empty],
              [0.1] * 3, [0.0] * 3)
    torch.cuda.synchronize()
    assert multi_sgd.launches == before + 1
    assert torch.allclose(w, torch.full_like(w, 0.9))


# the edges of the launch plan and of the staged loads, as (name, shapes
# for an SM count): each group is one launch of one kernel
TILE_CASES = [
    # one element past a tile: 512-element tiles, and 8192-element tiles
    # (a group of 2 * SMs * 8192 + 1 elements)
    ("one_past_a_512_tile", lambda sms: [(513,)]),
    ("one_past_an_8192_tile", lambda sms: [(2 * sms * 8192 + 1,)]),
    # 16-byte aligned, length not a multiple of 4: 1-3 scalar elements
    ("aligned_length_not_a_multiple_of_4",
     lambda sms: [(1027,), (4097,), (6,), (3, 5)]),
    # 4 trips of the staged loads a tile, and more tiles than blocks
    ("a_block_walks_several_tiles",
     lambda sms: [((3 * sms + 7) * 8192 + 3,)]),
    ("an_empty_tensor_between_two_full_ones",
     lambda sms: [(5000,), (0,), (7000,)]),
    ("a_group_of_64_tensors",
     lambda sms: [(37 * (i + 1) + i % 5,) for i in range(64)]),
]


@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("name,shapes", TILE_CASES,
                         ids=[c[0] for c in TILE_CASES])
def test_multi_sgd_tile_edges_match_plain_bitwise(card, momentum, name,
                                                  shapes):
    """The edges of the launch plan and of the staged loads, bit for bit
    against the plain version, in one launch."""
    import importlib
    ms = importlib.import_module("mxnet_tpu_torch.kernels.multi_sgd")
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    shapes = shapes(sms)
    (plan,) = ms._launch_plans(tuple(int(np.prod(s)) for s in shapes), sms)
    if name == "one_past_a_512_tile":
        assert plan.tile == 512 and plan.starts[-1] == 2
    if name == "one_past_an_8192_tile":
        assert plan.tile == 8192 and plan.starts[-1] == 2 * sms + 1
    if name == "a_block_walks_several_tiles":
        assert plan.tile == 8192 and plan.starts[-1] > plan.grid
    w, g, m = _sgd_set(card, shapes, 0, 11)
    lrs = np.linspace(0.01, 0.3, len(w)).tolist()
    wds = np.linspace(0.0, 1e-2, len(w)).tolist()
    wk, mk = [t.clone() for t in w], [t.clone() for t in m]
    wp, mp = [t.clone() for t in w], [t.clone() for t in m]
    counter = multi_sgd_mom if momentum else multi_sgd
    before = counter.launches
    if momentum:
        multi_sgd_mom(wk, g, mk, lrs, wds, 0.9, 1 / 128, 0.5)
        multi_sgd_mom_plain(wp, g, mp, lrs, wds, 0.9, 1 / 128, 0.5)
    else:
        multi_sgd(wk, g, lrs, wds, 1 / 128, 0.5)
        multi_sgd_plain(wp, g, lrs, wds, 1 / 128, 0.5)
    torch.cuda.synchronize()
    assert counter.launches - before == 1
    for a, b in zip(wk + mk, wp + mp):
        assert torch.equal(a, b)


LP_MODES = ["sgd", "sgd_mom", "mp_sgd", "mp_sgd_mom"]


def _lp_sgd(card, mode, dtype, shapes, offset, seed):
    """Run ``mode`` (a plain update on ``dtype`` tensors, or the mixed one
    on ``dtype`` weights with fp32 momenta and masters) through the
    kernel and through the plain version on copies of the same tensors,
    each ``offset`` elements into its own buffer; returns the launches
    and the pairs (kernel, plain) of every updated tensor."""
    gen = torch.Generator(device=card).manual_seed(seed)
    mixed = mode.startswith("mp")

    def make(dt, scale):
        out = []
        for s in shapes:
            n = int(np.prod(s))
            buf = torch.randn(n + offset, device=card, generator=gen) * scale
            out.append(buf.to(dt)[offset:].view(s))
        return out
    w, g = make(dtype, 1.0), make(dtype, 2.0)
    m = make(torch.float32 if mixed else dtype, 0.1)
    w32 = [t.float() + 1e-3 for t in w]
    lrs = np.linspace(0.01, 0.3, len(w)).tolist()
    wds = np.linspace(0.0, 1e-2, len(w)).tolist()
    runs = []
    for fns in ((multi_sgd, multi_sgd_mom, multi_mp_sgd, multi_mp_sgd_mom),
                (multi_sgd_plain, multi_sgd_mom_plain, multi_mp_sgd_plain,
                 multi_mp_sgd_mom_plain)):
        fn = fns[LP_MODES.index(mode)]
        wk, mk, w32k = ([t.clone() for t in ts] for ts in (w, m, w32))
        args = {"sgd": (wk, g), "sgd_mom": (wk, g, mk),
                "mp_sgd": (wk, g, w32k), "mp_sgd_mom": (wk, g, mk, w32k)}
        momentum = (0.9,) if mode.endswith("mom") else ()
        before = fn.launches if hasattr(fn, "launches") else 0
        fn(*args[mode], lrs, wds, *momentum, 1 / 128, 0.5)
        runs.append((getattr(fn, "launches", 0) - before,
                     [t for grp in args[mode][:1] + args[mode][2:]
                      for t in grp]))
    torch.cuda.synchronize()
    return runs[0][0], list(zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", LP_MODES)
def test_low_precision_sgd_kernels_match_plain_bitwise(card, mode, dtype,
                                                       offset):
    """bf16/fp16 weights, plain and mixed, on 72 odd-sized tensors (16-byte
    vectors of 8 elements and scalar tails; at an odd element offset
    every pointer is misaligned and the scalar path takes all): bit for
    bit against the plain version, 2 launches; on the mixed path each
    weight is its master rounded."""
    launches, pairs = _lp_sgd(card, mode, dtype, ODD_SHAPES, offset,
                              3 + offset)
    assert launches == 2
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)
    if mode.startswith("mp"):
        n = len(ODD_SHAPES)
        for w, w32 in zip([a for a, _ in pairs[:n]],
                          [a for a, _ in pairs[-n:]]):
            assert torch.equal(w, w32.to(w.dtype))


@pytest.mark.parametrize("mode", LP_MODES)
@pytest.mark.parametrize("name,shapes", TILE_CASES,
                         ids=[c[0] for c in TILE_CASES])
def test_low_precision_sgd_tile_edges_match_plain_bitwise(card, name,
                                                          shapes, mode):
    """The launch plan's edges in bf16 (tiles of 1024 to 16384 elements,
    8 to a vector), one launch each, bit for bit."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    launches, pairs = _lp_sgd(card, mode, torch.bfloat16, shapes(sms), 0,
                              13)
    assert launches == 1
    for a, b in pairs:
        assert torch.equal(a, b)


def _small_resnet():
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    return resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                           [8, 16, 32, 64, 128], classes=10)


def test_trainer_launches_one_kernel_per_group(card):
    """53 trainable parameters of a small ResNet in groups of 4: 14
    momentum launches per step; the 6 of the MLP: 2 plain launches."""
    from mxnet_tpu_torch import autograd, gluon, initializer
    from mxnet_tpu_torch.gluon import nn
    net = _small_resnet()
    net.initialize(initializer.Xavier("gaussian", "in", 2), ctx=card)
    mlp = nn.HybridSequential()
    mlp.add(nn.Dense(128, activation="relu", in_units=784),
            nn.Dense(64, activation="relu", in_units=128),
            nn.Dense(10, in_units=64))
    mlp.initialize(ctx=card)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    for model, opt, x, counter, per_step in (
            (net, {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
             torch.randn(4, 3, 32, 32, device=card), multi_sgd_mom, 14),
            (mlp, {"learning_rate": 0.1}, torch.randn(8, 784, device=card),
             multi_sgd, 2)):
        tr = gluon.Trainer(model.collect_params(), "sgd", opt)
        y = torch.arange(x.shape[0], device=card).float() % 10
        before = counter.launches
        for _ in range(3):
            with autograd.record():
                loss = lossfn(model(x), y)
            autograd.backward(loss)
            tr.step(x.shape[0])
        torch.cuda.synchronize()
        assert counter.launches - before == 3 * per_step
        assert torch.isfinite(loss).all()


def test_train_step_on_card_matches_cpu(card):
    """One SGD-momentum step of a small ResNet from the same weights and
    data on the card and on the CPU: loss, weights and running statistics
    within 1e-4."""
    from mxnet_tpu_torch import autograd, gluon, initializer
    from mxnet_tpu_torch import load_reference_params
    src = _small_resnet()
    src.initialize(initializer.Xavier("gaussian", "in", 2), ctx="cpu",
                   seed=3)
    arrays = {k: p._tensor().detach().numpy()
              for k, p in src.collect_params().items()}
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), card):
        net = _small_resnet()
        load_reference_params(net, arrays, ctx=dev)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9,
                            "wd": 1e-4})
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(torch.as_tensor(x, device=dev)),
                torch.as_tensor(y, device=dev))
        autograd.backward(loss)
        tr.step(4)
        out.append([loss.detach().cpu().numpy()] +
                   [p._tensor().detach().cpu().numpy()
                    for p in net.collect_params().values()])
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_flash_kernel_records_and_backpropagates(card):
    """The kernel records under autograd.record(): one launch, an output
    with a ``grad_fn``, and a backward that fills q's gradient with the
    plain version's; under pause() it records nothing."""
    from mxnet_tpu_torch import autograd
    q = torch.randn(2, 16, 64, device=card, requires_grad=True)
    before = flash_attention.launches
    with autograd.record():
        out = flash_attention(q, q, q)
    assert flash_attention.launches == before + 1
    assert out.grad_fn is not None
    autograd.backward(out)
    qr = q.detach().clone().requires_grad_()
    flash_attention_plain(qr, qr, qr, torch.full((2,), 16.0, device=card),
                          False, 1 / 8).sum().backward()
    assert (q.grad - qr.grad).abs().max().item() <= 1e-4
    with autograd.pause():
        assert flash_attention(q, q, q).grad_fn is None


# ---------------------------------------------------------------- rtc

def _rtc(card):
    import chip_smoke
    return chip_smoke, chip_smoke.rtc_modules()


def test_rtc_user_kernels_match_plain(card):
    """add_one (fp32) and twice (int32, exact, stays int32), in place;
    axpy<float>/<double> reached through ``exports``."""
    cs, mods = _rtc(card)
    xf = torch.randn(1000, device=card)
    yf = torch.empty_like(xf)
    mods["elementwise"].get_kernel("add_one", "const float *x, float *y, "
                                   "int n").launch(
        [xf, yf, 1000], card, (4, 1, 1), (256, 1, 1))
    xi = torch.randint(-2 ** 20, 2 ** 20, (999,), device=card,
                       dtype=torch.int32)
    yi = torch.empty_like(xi)
    mods["elementwise"].get_kernel("twice", "const int *x, int *y, int n") \
        .launch([xi, yi, 999], card, (4, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    assert torch.equal(yf, cs.add_one_plain(xf))
    assert yi.dtype == torch.int32 and torch.equal(yi, cs.twice_plain(xi))
    for dtype, name, tol in ((torch.float32, "axpy<float>", 1e-6),
                             (torch.float64, "axpy<double>", 1e-12)):
        ct = "float" if dtype == torch.float32 else "double"
        k = mods["axpy"].get_kernel(name, f"const {ct} *x, {ct} *y, "
                                          f"{ct} alpha, int n")
        x = torch.randn(5000, device=card, dtype=dtype)
        y = torch.randn(5000, device=card, dtype=dtype)
        ref = cs.axpy_plain(-1.25, x, y)
        k.launch([x, y, -1.25, 5000], card, (20, 1, 1), (256, 1, 1))
        torch.cuda.synchronize()
        assert (y - ref).abs().max().item() <= tol
        assert k.launches == 1


@pytest.mark.parametrize("n,c", [(100, 10), (7, 1500), (3, 30522),
                                 (5, 1)])
def test_rtc_softmax_kernels_match_plain(card, n, c):
    cs, mods = _rtc(card)
    g = torch.Generator(device=card).manual_seed(n * c)
    x = torch.randn(n, c, device=card, generator=g) * 4
    label = torch.randint(0, c, (n,), device=card, generator=g).float()
    y, dx = torch.empty_like(x), torch.full_like(x, 0.5)
    threads = (cs.softmax_threads(c), 1, 1)
    mods["softmax_fwd"].launch([x, y, c, 1], card, (n, 1, 1), threads)
    mods["softmax_bwd"].launch([label, y, dx, c, 3], card, (n, 1, 1),
                               threads)                        # req add
    torch.cuda.synchronize()
    ref = cs.softmax_plain(x)
    assert (y - ref).abs().max().item() <= cs.SOFTMAX_TOL
    want = 0.5 + cs.softmax_bwd_plain(y, label)
    assert (dx - want).abs().max().item() <= cs.SOFTMAX_TOL


def test_rtc_half_and_int64_signatures(card):
    from mxnet_tpu_torch import rtc
    src = r"""
    #include <cuda_fp16.h>
    extern "C" __global__ void hscale(const __half* x, __half* y, __half a,
                                      int n) {
      const int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] = __hmul(x[i], a);
    }
    extern "C" __global__ void iota64(long long* out, long long base,
                                      int n) {
      const int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) out[i] = base + i;
    }
    """
    mod = rtc.CudaModule(src)
    x = torch.randn(300, device=card).half()
    y = torch.empty_like(x)
    mod.get_kernel("hscale", "const __half *x, __half *y, __half a, int n") \
        .launch([x, y, 0.75, 300], card, (2, 1, 1), (256, 1, 1))
    out = torch.empty(300, device=card, dtype=torch.int64)
    mod.get_kernel("iota64", "int64_t *out, int64_t base, int n").launch(
        [out, 2 ** 40, 300], card, (2, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    assert torch.equal(y, x * 0.75)
    assert torch.equal(out, torch.arange(300, device=card) + 2 ** 40)


def test_rtc_dynamic_shared_memory_above_48kb(card):
    cs, mods = _rtc(card)
    k = mods["smem"].get_kernel("smem_reverse",
                                "const float *x, float *y, int n")
    n = cs.SMEM_FLOATS
    x = torch.randn(3 * n, device=card)
    y = torch.empty_like(x)
    k.launch([x, y, n], card, (3, 1, 1), (1024, 1, 1), shared_mem=4 * n)
    torch.cuda.synchronize()
    assert torch.equal(y, cs.smem_reverse_plain(x, n))


def test_rtc_launch_from_a_custom_op_backward(card):
    """softmax_rtc inside autograd.record(): torch runs the backward on its
    own thread for the card, where the driver needs the primary context
    made current; the gradient equals the plain version's."""
    import threading
    from mxnet_tpu_torch import autograd, nd
    cs, mods = _rtc(card)
    threads = []
    bwd = cs.SoftmaxRtc.backward

    def spy(self, *args, **kwargs):
        threads.append(threading.get_ident())
        return bwd(self, *args, **kwargs)

    cs.SoftmaxRtc.backward = spy
    try:
        x = torch.randn(64, 10, device=card, requires_grad=True)
        label = torch.randint(0, 10, (64,), device=card).float()
        before = (mods["softmax_fwd"].launches, mods["softmax_bwd"].launches)
        with autograd.record():
            y = nd.Custom(x * 2.0, label, op_type="softmax_rtc")
        autograd.backward(y)
        torch.cuda.synchronize()
    finally:
        cs.SoftmaxRtc.backward = bwd
    assert (mods["softmax_fwd"].launches - before[0],
            mods["softmax_bwd"].launches - before[1]) == (1, 1)
    assert threads and threads[0] != threading.get_ident()
    ref = 2.0 * cs.softmax_bwd_plain(cs.softmax_plain(x.detach() * 2.0),
                                     label)
    assert (x.grad - ref).abs().max().item() <= 2 * cs.SOFTMAX_TOL


def test_rtc_refusals_launch_nothing(card):
    from mxnet_tpu_torch import rtc
    cs, mods = _rtc(card)
    k = mods["elementwise"].get_kernel("add_one",
                                       "const float *x, float *y, int n")
    x = torch.zeros(8, device=card)
    before = rtc.launches
    for args, ctx in (([x.double(), x, 8], card), ([x.cpu(), x, 8], card),
                      ([x, x, 8], "cpu"), ([x[::2], x, 4], card)):
        with pytest.raises(MXNetError):
            k.launch(args, ctx, (1, 1, 1), (32, 1, 1))
    assert rtc.launches == before
    with pytest.raises(MXNetError, match="exports"):
        mods["axpy"].get_kernel("axpy", "const float *x, float *y, "
                                        "float alpha, int n")
    with pytest.raises(MXNetError, match="undefined_name"):
        rtc.CudaModule('extern "C" __global__ void bad(float* y) '
                       '{ y[0] = undefined_name; }')


# ------------------------------------------- NDArrays and the nd registry

def _nd_inputs(seed):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(8, 20).astype(np.float32),
            "w": rs.randn(16, 20).astype(np.float32),
            "b": rs.randn(16).astype(np.float32),
            "img": rs.randn(2, 3, 9, 9).astype(np.float32),
            "k": rs.randn(4, 3, 3, 3).astype(np.float32),
            "y": rs.randint(0, 16, 8).astype(np.float32)}


ND_CARD_CASES = [
    ("FullyConnected", ["x", "w", "b"], {"num_hidden": 16}),
    ("Convolution", ["img", "k"], {"kernel": (3, 3), "num_filter": 4,
                                   "no_bias": True, "pad": (1, 1)}),
    ("Pooling", ["img"], {"kernel": (3, 3), "stride": (2, 2),
                          "pooling_convention": "full"}),
    ("softmax", ["x"], {}),
    ("log_softmax", ["x"], {}),
    ("sum", ["img"], {"axis": (0, 2)}),
    ("dot", ["x", "w"], {"transpose_b": True}),
    ("relu", ["x"], {}),
    ("transpose", ["img"], {"axes": (0, 2, 3, 1)}),
]


@pytest.mark.parametrize("op,names,kw", ND_CARD_CASES,
                         ids=[c[0] for c in ND_CARD_CASES])
def test_ndarray_ops_on_card_match_cpu(card, op, names, kw):
    """An nd op on NDArrays on the card, forward and input gradients,
    against the same op on the CPU (1e-4: cuDNN and cuBLAS sum in other
    orders)."""
    from mxnet_tpu_torch import autograd, cpu, gpu, nd
    arrays = _nd_inputs(3)
    res = []
    for ctx in (gpu(0), cpu()):
        ins = [nd.array(arrays[n], ctx=ctx) for n in names]
        for a in ins:
            a.attach_grad()
        with autograd.record():
            out = getattr(nd, op)(*ins, **kw)
        assert out.context == ctx
        out.backward(nd.ones(out.shape, ctx=ctx) * 0.5)
        res.append([out.asnumpy()] + [a.grad.asnumpy() for a in ins])
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_nd_multi_sgd_mom_update_launches_the_kernel(card):
    """``nd.multi_sgd_mom_update`` on NDArrays on the card: one launch of
    the momentum kernel for the group, into the weights (``out=``) in
    place, the momenta in place, equal to the plain version on the CPU;
    ``lrs``/``wds`` arrays on the card cost one host read each."""
    from mxnet_tpu_torch import cpu, gpu, nd
    from mxnet_tpu_torch.engine import engine
    rs = np.random.RandomState(4)
    shapes = [(128, 784), (128,), (64, 128), (64,), (10, 64), (10,)]
    arrays = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [rs.randn(*s).astype(np.float32) for s in shapes]
    lrs = np.full(6, 0.1, np.float32)
    wds = np.array([1e-4, 0] * 3, np.float32)
    res = []
    for ctx in (gpu(0), cpu()):
        ws = [nd.array(a, ctx=ctx) for a in arrays]
        ms = [nd.zeros(a.shape, ctx=ctx) for a in arrays]
        ptrs = [w._data.data_ptr() for w in ws]
        before, reads = multi_sgd_mom.launches, engine().host_reads
        for _ in range(2):
            out = nd.multi_sgd_mom_update(
                *[t for w, g, m in zip(ws, grads, ms)
                  for t in (w, nd.array(g, ctx=ctx), m)],
                nd.array(lrs, ctx=ctx), nd.array(wds, ctx=ctx),
                momentum=0.9, num_weights=6, out=ws)
        assert out is ws and [w._data.data_ptr() for w in ws] == ptrs
        if ctx == gpu(0):
            assert multi_sgd_mom.launches - before == 2
            assert engine().host_reads - reads == 4
        res.append([w.asnumpy() for w in ws] + [m.asnumpy() for m in ms])
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


# ------------------------------------------------- config #4 (NMT, Module)

NMT_CASES = [                     # (B, H, Lq, Lk): H=8, D=64 throughout
    (16, 8, 64, 64),              # training self-attention, bucket 64
    (16, 8, 48, 64),              # cross-attention, Lq != Lk
    (8, 8, 1, 64),                # translate's first decoder call
    (8, 8, 7, 32),                # a later one, source 32
    (1, 8, 35, 32),               # beam search's last, one row
]


@pytest.mark.parametrize("b,h,lq,lk", NMT_CASES)
def test_nmt_shapes_forward_and_backward(card, b, h, lq, lk):
    """The kernel at config #4's shapes, every key valid (no mask), and
    its backward: output and q/k/v gradients against the plain version
    and autograd through it in fp32 (1e-4, x max(1, max|g|) for the
    gradients)."""
    q, k, v = _inputs(lq * lk + b, b * h, lq, lk, 64, torch.float32, card)
    dout = _inputs(b, b * h, lq, lq, 64, torch.float32, card)[0]
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    ref_out = flash_attention_plain(*ref_leaves,
                                    torch.full((b * h,), float(lk),
                                               device=card), False, 1 / 8)
    ref = torch.autograd.grad(ref_out, ref_leaves, dout)
    assert (out.detach() - ref_out.detach()).abs().max().item() <= 1e-4
    for g, r in zip(grads, ref):
        err = (g - r).abs().max().item()
        assert err <= 1e-4 * max(1.0, r.abs().max().item()), err


def _small_nmt(dev, arrays=None):
    from mxnet_tpu_torch import load_reference_params
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerNMT
    net = TransformerNMT(500, num_layers=2, units=128, hidden_size=256,
                         num_heads=2, max_length=64)     # head dim 64
    if arrays is None:
        net.initialize(ctx=dev, seed=4)
    else:
        load_reference_params(net, arrays, ctx=dev)
    return net


def test_nmt_train_step_on_card_matches_cpu(card):
    """One Adam step (bench_nmt's loss) of a small NMT from the same
    weights on the card (flash kernel in the encoder's self-attention and
    the decoder's cross-attention, 4 launches) and on the CPU, which
    takes the card's ReLU decisions (``chip_smoke.Decisions``): the
    loss to 1e-5 relative, each leaf's gradient to 1e-4 * max|g| +
    1e-6."""
    import chip_smoke
    src = _small_nmt(torch.device("cpu"))
    arrays = {k: p._tensor().detach().numpy()
              for k, p in src.collect_params().items()}
    batch = chip_smoke.nmt_data(0, 2, (24,), 500)[24]
    res, masks = [], None
    for dev in (card, torch.device("cpu")):
        net = _small_nmt(dev, arrays)
        before = flash_attention.launches
        with chip_smoke.Decisions(masks) as relu:
            loss, grads, _ = chip_smoke.nmt_check_step(
                net, [t.to(dev) for t in batch])
        masks = relu.masks
        if dev == card:
            assert flash_attention.launches - before == 4
        res.append((loss.item(), {k: g.cpu() for k, g in grads.items()}))
    (l_card, g_card), (l_cpu, g_cpu) = res
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for (k, g), gc in zip(g_cpu.items(), g_card.values()):
        err = (gc - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item() + 1e-6, (k, err)


def test_nmt_translate_on_card_matches_cpu(card):
    """Greedy and beam ``translate`` of a small NMT on the card decode the
    CPU's tokens, scores within 1e-4; the flash kernel runs 2 times for
    the encoder and 2 per decoder call."""
    import chip_smoke
    from mxnet_tpu_torch import nd
    src = _small_nmt(torch.device("cpu"))
    arrays = {k: p._tensor().detach().numpy()
              for k, p in src.collect_params().items()}
    x = np.random.RandomState(1).randint(3, 500, (3, 9))
    for beam in (1, 2):
        out = []
        for dev in (card, torch.device("cpu")):
            net = _small_nmt(dev, arrays)
            before = flash_attention.launches
            with chip_smoke.DecoderCalls(net) as calls:
                out.append(net.translate(nd.array(x, ctx=dev), 1, 2,
                                         max_len=8, beam_size=beam))
            if dev == card:
                assert flash_attention.launches - before == \
                    chip_smoke.translate_flash_launches(2, calls.calls)
        assert out[0][0] == out[1][0]
        np.testing.assert_allclose(out[0][1], out[1][1], atol=1e-4,
                                   rtol=1e-4)


def test_bucketing_module_step_on_card_matches_cpu(card):
    """One ``forward_backward`` + ``update`` of the LSTM bucketing model
    (vocabulary 50, hidden 32) from the same weights on the card and on
    the CPU: gradients and updated weights within 1e-5 * max(1, max|x|),
    the card module's arrays on the card."""
    import chip_smoke
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch import random as mx_random
    mp = pytest.MonkeyPatch()
    for name, value in (("LM_VOCAB", 50), ("LM_EMB", 16), ("LM_HIDDEN", 32),
                        ("LM_BATCH", 4)):
        mp.setattr(chip_smoke, name, value)
    try:
        mx_random.seed(0)
        init = chip_smoke.lm_module(cpu(), 10)
        init.init_params()
        arg, _ = init.get_params()
        batch = next(b for b in chip_smoke.lm_iter(1, 60)
                     if b.bucket_key == 10)
        card_run = chip_smoke.lm_check_step(gpu(0), torch.float32, arg,
                                            batch)
        cpu_run = chip_smoke.lm_check_step(cpu(), torch.float32, arg, batch)
    finally:
        mp.undo()
    for a, b in zip(card_run, cpu_run):
        assert a.keys() == b.keys()
        for k in a:
            err = (a[k] - b[k]).abs().max().item()
            assert err <= 1e-5 * max(1.0, b[k].abs().max().item()), (k, err)


# ---- config #5: the detection ops, deferred shapes, SSD's update -------
def _det_boxes(rs, b, n):
    lo = rs.rand(b, n, 2) * 0.8
    wh = rs.rand(b, n, 2) * 0.3 + 0.02
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def _greedy_loop(boxes, valid, thresh):
    """The plain greedy walk, one candidate at a time over the batch."""
    from mxnet_tpu_torch.ndarray.ops_contrib import _iou_corner
    keep = valid.clone()
    later = torch.arange(boxes.shape[1], device=boxes.device)
    for i in range(boxes.shape[1]):
        iou = _iou_corner(boxes[:, i:i + 1], boxes)
        keep &= ~((iou > thresh) & keep[:, i:i + 1] & (later > i))
    return keep


def test_fixed_point_nms_is_the_greedy_walk_at_ssd512_size(card):
    """5,630 score-sorted candidates (SSD-512's anchors) a batch of 2:
    the fixed point keeps exactly the greedy walk's set, in fewer passes
    than candidates."""
    from mxnet_tpu_torch.ndarray import ops_contrib
    rs = np.random.RandomState(0)
    boxes = torch.tensor(_det_boxes(rs, 2, 5630), device=card)
    valid = torch.tensor(rs.rand(2, 5630) > 0.05, device=card)
    sup = torch.stack([ops_contrib._iou_corner(b[:, None], b[None]) > 0.5
                       for b in boxes])
    ops_contrib.nms_stats.reset()
    keep = ops_contrib.greedy_keep(valid, sup)
    assert torch.equal(keep, _greedy_loop(boxes, valid, 0.5))
    assert ops_contrib.nms_stats.last < 5630


def _det_arrays():
    rs = np.random.RandomState(1)
    n = 300
    det = np.zeros((2, n, 6), np.float32)
    det[..., 0] = rs.randint(0, 4, (2, n))
    det[..., 1] = np.round(rs.rand(2, n), 2)         # ties
    det[..., 2:] = _det_boxes(rs, 2, n)
    labels = np.full((2, 4, 5), -1.0, np.float32)
    labels[:, :2, 0] = [[1, 3], [0, 2]]
    labels[:, :2, 1:] = _det_boxes(rs, 2, 2)
    prob = rs.rand(2, 5, n).astype(np.float32)
    return {
        "det": det, "anchors": _det_boxes(rs, 1, n), "labels": labels,
        "cls": rs.randn(2, 5, n).astype(np.float32),
        "prob": prob / prob.sum(1, keepdims=True),
        "loc": (rs.randn(2, n * 4) * 0.3).astype(np.float32),
        "feat": rs.randn(2, 8, 16, 16).astype(np.float32),
        "rois": np.concatenate([rs.randint(0, 2, (20, 1)),
                                _det_boxes(rs, 1, 20)[0] * 16], 1)
        .astype(np.float32),
        "score": rs.rand(2, 18, 8, 8).astype(np.float32),
        "bbox": (rs.randn(2, 36, 8, 8) * 0.2).astype(np.float32),
        "info": np.array([[128, 128, 1]] * 2, np.float32),
        "a": _det_boxes(rs, 2, 30), "b": _det_boxes(rs, 2, 6)}


DET_CARD_CASES = [
    ("MultiBoxPrior", ["feat"], {"sizes": (0.3, 0.2),
                                 "ratios": (1, 2, 0.5)}, ()),
    ("box_iou", ["a", "b"], {}, (0, 1)),
    ("box_nms", ["det"], {"overlap_thresh": 0.4, "id_index": 0}, (0,)),
    ("MultiBoxTarget", ["anchors", "labels", "cls"],
     {"negative_mining_ratio": 3.0}, ()),
    ("MultiBoxDetection", ["prob", "loc", "anchors"], {}, ()),
    ("ROIAlign", ["feat", "rois"], {"pooled_size": (7, 7),
                                    "spatial_scale": 1.0,
                                    "sample_ratio": 2}, (0,)),
    ("Proposal", ["score", "bbox", "info"], {
        "rpn_pre_nms_top_n": 200, "rpn_post_nms_top_n": 50,
        "scales": (2.0, 4.0, 8.0), "rpn_min_size": 1}, ()),
    ("box_decode", ["b", "a"], {"std0": 0.1, "clip": 1.0}, (0,)),
]


@pytest.mark.parametrize("op,names,kw,grads", DET_CARD_CASES,
                         ids=[c[0] for c in DET_CARD_CASES])
def test_detection_ops_on_card_match_cpu(card, op, names, kw, grads):
    """Each detection op on the card against the same op on the CPU:
    outputs (and input gradients where it is differentiable) within
    1e-5, relative for values far from 1 (``Proposal``'s pixel
    coordinates: the card's and the CPU's ``exp`` differ by an ulp); the
    kept sets, matches and labels equal."""
    from mxnet_tpu_torch import autograd, nd
    arrays = _det_arrays()
    if op == "box_decode":
        arrays["a"] = arrays["a"][:1, :6]
    res = []
    for dev in (card, torch.device("cpu")):
        ins = [torch.tensor(arrays[n], device=dev) for n in names]
        for i in grads:
            ins[i].requires_grad_()
        with autograd.record():
            out = getattr(nd.contrib, op)(*ins, **kw)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        if grads:
            autograd.backward(outs, [torch.full_like(o, 0.5) for o in outs])
        res.append([o.detach().cpu() for o in outs]
                   + [ins[i].grad.cpu() for i in grads])
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_deferred_initialization_on_the_card(card):
    """Widths left to the first forward on ``gpu(0)``: the weights land on
    the card, equal to a CPU twin's from the same seed, inside the
    ``nn.Parameter`` a Trainer built before the forward holds."""
    from mxnet_tpu_torch import autograd, cpu, gluon, gpu
    from mxnet_tpu_torch.gluon import nn

    def build():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, 1, 1), nn.BatchNorm(),
                nn.Conv2DTranspose(4, 2, 2), nn.Dense(5))
        return net
    net, twin = build(), build()
    net.initialize(ctx=gpu(0), seed=3)
    twin.initialize(ctx=cpu(), seed=3)
    tensors = [p._data for p in net.collect_params().values()]
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    x = torch.randn(2, 3, 6, 6)
    net(x.to(card))
    twin(x)
    for p, q, t in zip(net.collect_params().values(),
                       twin.collect_params().values(), tensors):
        assert p._tensor() is t and p._tensor().device == card
        assert torch.equal(p._tensor().cpu(), q._tensor())
    before = multi_sgd_mom.launches
    with autograd.record():
        loss = net(x.to(card)).square().mean()
    autograd.backward(loss)
    tr.step(2)
    torch.cuda.synchronize()
    assert multi_sgd_mom.launches - before == 2          # 7 tensors


def test_momentum_kernel_at_ssd512_groups_bitwise(card):
    """The momentum kernel over SSD-512's trainable shapes in the
    Trainer's groups of 4, bit for bit against its plain version."""
    from mxnet_tpu_torch.gluon.model_zoo.ssd import ssd_512_resnet50_v1
    net = ssd_512_resnet50_v1(classes=20)
    net.initialize(ctx=torch.device("cpu"))
    net(torch.zeros(1, 3, 64, 64))
    shapes = [p.shape for p in net.collect_params().values()
              if p.grad_req != "null"]
    w, g, m = _sgd_set(card, shapes, 0, 11)
    lrs = [1e-3] * len(w)
    wds = [0.0] * len(w)
    wk, mk = [t.clone() for t in w], [t.clone() for t in m]
    before = multi_sgd_mom.launches
    for lo in range(0, len(w), 4):
        sl = slice(lo, lo + 4)
        multi_sgd_mom(wk[sl], g[sl], mk[sl], lrs[sl], wds[sl], 0.9, 1 / 8)
    multi_sgd_mom_plain(w, g, m, lrs, wds, 0.9, 1 / 8)
    torch.cuda.synchronize()
    assert multi_sgd_mom.launches - before == -(-len(w) // 4)
    for a, b in zip(wk + mk, w + m):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------- hybridize() on CUDA graphs
#
# Each case runs a hybridized block (one warm eager call per signature
# and mode, then a captured graph replayed) against an eager twin with the
# same weights, on the same inputs: bit for bit, since the graph replays
# the kernels the eager call launches.

def _hyb_mlp(card, seed=3):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu", in_units=784),
            nn.Dense(64, activation="relu", in_units=128),
            nn.Dense(10, in_units=64))
    net.initialize(ctx=card, seed=seed)
    return net


def _twins(make, card):
    """(hybridized, eager) copies of ``make(card)`` with equal weights."""
    hyb, eager = make(card), make(card)
    for p, q in zip(hyb.collect_params().values(),
                    eager.collect_params().values()):
        q.set_data(p._tensor().detach().clone())
    hyb.hybridize()
    return hyb, eager


def _step(net, x, y):
    from mxnet_tpu_torch import autograd, gluon
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    autograd.backward(loss)
    return loss.detach(), {k: p._grad_tensor().detach().clone()
                           for k, p in net.collect_params().items()
                           if p.grad_req != "null"}


def _bitwise(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_hybridized_mlp_replays_bitwise(card):
    """Inference and training calls of the 784-128-64-10 MLP: three
    calls per mode (warm, capture + replay, replay), each bit for bit
    the eager twin's output, loss and gradients; one entry, two graphs,
    four replays, two eager calls."""
    from mxnet_tpu_torch import autograd
    hyb, eager = _twins(_hyb_mlp, card)
    g = torch.Generator(device=card).manual_seed(0)
    for i in range(3):
        x = torch.randn(64, 784, device=card, generator=g)
        y = torch.randint(0, 10, (64,), device=card, generator=g).float()
        with autograd.predict_mode(), torch.no_grad():
            assert _bitwise(hyb(x), eager(x))
        (lh, gh), (le, ge) = _step(hyb, x, y), _step(eager, x, y)
        assert _bitwise(lh, le)
        for (k, a), b in zip(gh.items(), ge.values()):
            assert _bitwise(a, b), k
    stats = hyb.graph_stats()
    assert (stats["entries"], stats["graphs"], stats["replays"],
            stats["warm_calls"]) == (1 + 1, 2, 4, 2)


def test_deferred_first_step_records_then_captures(card):
    """A hybridized net with deferred widths whose first call is a
    training step: the call settles the widths and records, the second
    is the warm call, the third captures and replays; each step's loss
    and gradients are bit for bit those of an eager twin with the same
    seeded weights."""
    from mxnet_tpu_torch.gluon import nn

    def make():
        net = nn.HybridSequential()
        net.add(nn.Dense(64, activation="relu"), nn.Dense(10))
        net.initialize(ctx=card, seed=6)
        return net
    hyb, eager = make(), make()
    hyb.hybridize()
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(16, 32, device=card, generator=g)
    y = torch.randint(0, 10, (16,), device=card, generator=g).float()
    for _ in range(3):
        (lh, gh), (le, ge) = _step(hyb, x, y), _step(eager, x, y)
        assert _bitwise(lh, le)
        for (k, a), b in zip(gh.items(), ge.values()):
            assert _bitwise(a, b), k
    stats = hyb.graph_stats()
    assert (stats["deferred_calls"], stats["warm_calls"],
            stats["replays"]) == (1, 1, 1)


def test_capture_while_the_warm_calls_graph_is_alive(card):
    """A training loop keeps the previous step's loss (and with it the
    autograd graph of the warm eager call, the parameters' gradient
    accumulators included) alive while the next call captures: the
    capture takes leaves of its own, so it neither reaches those nor
    fails, and every step's gradients equal the eager twin's."""
    from mxnet_tpu_torch import autograd, gluon
    hyb, eager = _twins(_hyb_mlp, card)
    x = torch.randn(32, 784, device=card)
    y = torch.randint(0, 10, (32,), device=card).float()
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        with autograd.record():
            loss = lossfn(hyb(x), y)
            want = lossfn(eager(x), y)
        autograd.backward(loss)
        autograd.backward(want)
        assert _bitwise(loss.detach(), want.detach())
        for p, q in zip(hyb.collect_params().values(),
                        eager.collect_params().values()):
            assert _bitwise(p._grad_tensor(), q._grad_tensor()), p.name
    assert hyb.graph_stats()["replays"] == 2


def test_hybridized_batchnorm_writes_running_stats_bitwise(card):
    """Conv2D + BatchNorm + relu: three recording calls write the same
    running statistics and gradients as the eager twin, bit for bit; in
    predict mode the replay reads them."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    def make(dev):
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"))
        net.initialize(ctx=dev, seed=4)
        return net
    hyb, eager = _twins(make, card)
    g = torch.Generator(device=card).manual_seed(1)
    for _ in range(3):
        x = torch.randn(4, 3, 8, 8, device=card, generator=g) * 3 + 1
        outs = []
        for net in (hyb, eager):
            with autograd.record():
                out = net(x)
            autograd.backward(out.square().mean())
            outs.append(out.detach())
        assert _bitwise(*outs)
        for p, q in zip(hyb.collect_params().values(),
                        eager.collect_params().values()):
            assert _bitwise(p._tensor().detach(), q._tensor().detach()), p.name
            if p.grad_req != "null":
                assert _bitwise(p._grad_tensor(), q._grad_tensor()), p.name
    with autograd.predict_mode(), torch.no_grad():
        for _ in range(2):
            assert _bitwise(hyb(x), eager(x))
    assert hyb.graph_stats()["replays"] == 2 + 1


def _small_bert(dev, dropout=0.0):
    from mxnet_tpu_torch.gluon.model_zoo.transformer import BERTModel
    net = BERTModel(vocab_size=1000, num_layers=2, units=128,
                    hidden_size=256, num_heads=2, max_length=64,
                    dropout=dropout)
    net.initialize(ctx=dev, seed=5)
    return net


def test_hybridized_flash_block_replays_bitwise_and_counts(card):
    """A 2-layer BERT (head dim 64: the flash kernel's path): under
    replay the kernel's outputs, the MLM/NSP loss and every gradient are
    bit for bit the eager twin's; the launch counters read 2 launches a
    call (one per layer) under replay as in eager calls, and a capture
    adds none."""
    import chip_smoke
    from mxnet_tpu_torch import autograd
    hyb, eager = _twins(_small_bert, card)
    batch = [torch.as_tensor(a, device=card)
             for a in chip_smoke.bert_batch(0, 2, 40, 1000)]
    for i in range(3):
        before = flash_attention.launches
        by = flash_attention.launches_by_dtype["torch.float32"]
        res = []
        for net in (hyb, eager):
            with autograd.record():
                loss = chip_smoke.mlm_nsp_loss(*net(*batch[:3]), *batch[3:])
            autograd.backward(loss)
            res.append((loss.detach(), [p._grad_tensor().clone() for p in
                                        net.collect_params().values()]))
        torch.cuda.synchronize()
        assert flash_attention.launches - before == 2 * 2
        assert flash_attention.launches_by_dtype["torch.float32"] - by == 4
        assert _bitwise(res[0][0], res[1][0])
        for a, b in zip(res[0][1], res[1][1]):
            assert _bitwise(a, b)
    stats = hyb.graph_stats()
    assert stats["replays"] == 2 and stats["warm_calls"] == 1


def test_hybridized_outputs_and_gradients_are_fresh(card):
    """An output held from one replay, and a gradient held from one
    replayed backward, keep their values through later replays (no
    aliasing of the graph's buffers); ``grad_req="add"`` over hybridized
    backwards equals the eager sum, ``"write"`` overwrites."""
    from mxnet_tpu_torch import autograd
    hyb, eager = _twins(_hyb_mlp, card)
    for net in (hyb, eager):
        first = next(iter(net.collect_params().values()))
        first.grad_req = "add"
        first.zero_grad()
    g = torch.Generator(device=card).manual_seed(2)
    xs = [torch.randn(16, 784, device=card, generator=g) for _ in range(4)]
    ys = [torch.randint(0, 10, (16,), device=card, generator=g).float()
          for _ in range(4)]
    last = list(hyb.collect_params().values())[-1]
    held = {}
    for i in range(4):              # warm, capture + replay, 2 replays
        with autograd.predict_mode(), torch.no_grad():
            out = hyb(xs[i])
        _step(hyb, xs[i], ys[i])
        _step(eager, xs[i], ys[i])
        if i == 1:
            held = {"out": (out, out.clone()),
                    "grad": (last._grad_tensor(), last._grad_tensor().clone())}
    for held_tensor, value in held.values():
        assert torch.equal(held_tensor, value)
    for p, q in zip(hyb.collect_params().values(),
                    eager.collect_params().values()):
        assert _bitwise(p._grad_tensor(), q._grad_tensor()), p.name
    assert hyb.graph_stats()["replays"] == 3 + 3


def test_capture_leaves_grad_bookkeeping_alone(card):
    """A capture's backward reaches no parameter hook: after
    ``zero_grad`` a capturing forward leaves ``fresh`` set and ``.grad``
    untouched until the caller's backward."""
    from mxnet_tpu_torch import autograd, gluon
    net = _hyb_mlp(card)
    net.hybridize()
    x = torch.randn(8, 784, device=card)
    y = torch.zeros(8, device=card)
    _step(net, x, y)                               # warm
    params = list(net.collect_params().values())
    for p in params:
        p.zero_grad()
    before = [p._grad_tensor().clone() for p in params]
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)  # captures
    assert all(p.fresh for p in params)
    assert all(torch.equal(p._grad_tensor(), b)
               for p, b in zip(params, before))
    autograd.backward(loss)
    assert not any(p.fresh for p in params)


def test_hybridized_dropout_is_fresh_per_replay_and_seeded(card):
    """Dropout (torch's default generator, ``gluon.nn.Dropout``) and
    ``nd.Dropout`` (the port's per-device generator) draw new masks at
    every replay, and a reseeded run repeats the same outputs."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.gluon import HybridBlock, nn

    class NdDrop(HybridBlock):
        def forward(self, x):
            return nd.Dropout(x, p=0.5)

    def run():
        net = nn.HybridSequential()
        net.add(nn.Dense(64, in_units=32), nn.Dropout(0.5), NdDrop())
        net.initialize(ctx=card, seed=0)
        net.hybridize()
        x = torch.ones(8, 32, device=card)
        outs = []
        for _ in range(4):
            with autograd.record():
                outs.append(net(x).detach())
        return outs, net.graph_stats()["replays"]

    torch.manual_seed(7)
    mx_random.seed(7)
    a, replays = run()
    assert replays == 3
    for i in range(1, 4):
        assert not torch.equal(a[i], a[i - 1])
    torch.manual_seed(7)
    mx_random.seed(7)
    b, _ = run()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_set_data_and_cast_recapture(card):
    """``set_data`` after the captured calls changes the next output to
    the eager result on the new weights (the entry is captured anew);
    ``cast`` drops the cache and the bf16 call follows."""
    from mxnet_tpu_torch import autograd
    hyb, eager = _twins(_hyb_mlp, card)
    x = torch.randn(8, 784, device=card)
    with autograd.predict_mode(), torch.no_grad():
        for _ in range(3):
            first = hyb(x)
        for p, q in zip(hyb.collect_params().values(),
                        eager.collect_params().values()):
            w = p._tensor().detach() * 0.5
            p.set_data(w.clone())
            q.set_data(w.clone())
        again = hyb(x)
        assert _bitwise(again, eager(x)) and not torch.equal(again, first)
        stats = hyb.graph_stats()       # the new entry replays at once
        assert (stats["entries"], stats["replays"],
                stats["warm_calls"]) == (1, 1, 0)
        hyb.cast("bfloat16")
        eager.cast("bfloat16")
        assert hyb.graph_stats()["entries"] == 0
        xb = x.bfloat16()
        for _ in range(2):
            out = hyb(xb)
        assert out.dtype == torch.bfloat16 and _bitwise(out, eager(xb))


def test_backward_after_a_later_forward_of_the_signature_raises(card):
    """The graph keeps one call's activations: a second forward of the
    signature before the first one's backward makes that backward raise
    (and the latest one's backward still works)."""
    from mxnet_tpu_torch import autograd, gluon
    net = _hyb_mlp(card)
    net.hybridize()
    x = torch.randn(8, 784, device=card)
    y = torch.zeros(8, device=card)
    _step(net, x, y)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        l1 = lossfn(net(x), y)
        l2 = lossfn(net(x), y)
    with pytest.raises(MXNetError, match="before this call's backward"):
        autograd.backward(l1)
    autograd.backward(l2)


def test_host_reading_block_runs_eagerly_and_counts(card):
    """Mask-RCNN (``reads_host``): ``hybridize()`` warns once, every call
    runs eagerly and is counted, and the outputs equal the eager net's."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo.rcnn import mask_rcnn_toy
    net = mask_rcnn_toy(classes=3)
    net.initialize(ctx=card, seed=0)
    x = torch.randn(1, 3, 64, 64, device=card)
    with autograd.predict_mode(), torch.no_grad():
        want = net(x)
    with pytest.warns(RuntimeWarning, match="reads the host"):
        net.hybridize()
    with autograd.predict_mode(), torch.no_grad():
        outs = [net(x) for _ in range(3)]
    assert net.eager_calls == 3 and net.graph_stats()["entries"] == 0
    for out in outs:
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def test_model_server_workers_share_one_captured_bucket(card):
    """Four ``ModelServer`` workers replay one captured bucket graph; each
    request's output equals a direct forward of its padded batch row."""
    import threading
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.serving import ModelServer
    net = _hyb_mlp(card)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(784).astype(np.float32) for _ in range(64)]
    srv = ModelServer(net, max_batch=4, batch_buckets=(4,), workers=4,
                      deadline_ms=0, batch_window_us=200)
    assert srv.warmup(xs[0]) == 1
    before = net.graph_stats()["replays"]
    results = {}
    with srv:
        def client(t):
            for i in range(t, 64, 4):
                results[i] = srv.infer(xs[i], timeout=60)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    batches = srv.stats()["batches"]
    assert net.graph_stats()["replays"] - before == batches
    with autograd.predict_mode(), torch.no_grad():
        for i in range(64):
            want = net(torch.as_tensor(xs[i][None], device=card))
            np.testing.assert_allclose(results[i], want[0].cpu().numpy(),
                                       rtol=0, atol=1e-5)


def test_capture_failure_raises(card):
    """A block that reads the host in its forward and is not marked
    ``reads_host`` fails its capture with ``MXNetError``.  The generators
    come out of capture with it: afterwards dropout draws eagerly (torch's
    default generator and the port's), a hybridized dropout block
    captures and draws fresh masks, and the block marked ``reads_host``
    runs eagerly."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon import HybridBlock, nn

    class Reads(HybridBlock):
        def forward(self, x):
            return x * float(x.sum().item())

    net = Reads()
    net.hybridize()
    x = torch.ones(4, device=card)
    net(x)                                         # warm: eager
    with pytest.raises(MXNetError, match="could not be captured"):
        net(x)
    ones = torch.ones(64, 32, device=card)
    assert torch.nn.functional.dropout(ones, 0.5).eq(0).any()
    with autograd.train_mode():
        assert nd.Dropout(ones, p=0.5).eq(0).any()
    drop = nn.HybridSequential()
    drop.add(nn.Dense(64, in_units=32), nn.Dropout(0.5))
    drop.initialize(ctx=card, seed=0)
    drop.hybridize()
    outs = []
    for _ in range(4):
        with autograd.record():
            outs.append(drop(ones).detach())
    assert drop.graph_stats()["replays"] == 3
    for i in range(1, 4):
        assert not torch.equal(outs[i], outs[i - 1])
    Reads.reads_host = True
    assert torch.equal(net(x), x * 4.0) and net.eager_calls == 1


# -- generation serving: prefill and decode graphs over one KV pool -------

def _lm(card, seed=0, **kw):
    from mxnet_tpu_torch.gluon.model_zoo.transformer import CausalLM
    kw = {"vocab_size": 257, "num_layers": 2, "units": 64,
          "hidden_size": 128, "num_heads": 4, **kw}
    net = CausalLM(**kw)
    net.initialize(ctx=card, seed=seed)
    return net


def _filled_pool(net, n_blocks, block, seed):
    """A pool of finite random K/V, as a served pool looks mid-run."""
    g = torch.Generator().manual_seed(seed)
    pool = net.init_kv_pool(n_blocks, block)
    pool.copy_(torch.randn(pool.shape, generator=g))
    return pool


def _decode_state(rows, occupied, width, n_blocks, block, seed):
    """tokens, positions, tables (int32, host) of a decode step with the
    first ``occupied`` rows live (distinct blocks each) and the rest
    empty, pointing at scratch."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros(rows, np.int32)
    positions = np.zeros(rows, np.int32)
    tables = np.zeros((rows, width), np.int32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    for i in range(occupied):
        pos = int(rng.integers(0, width * block))
        tokens[i] = rng.integers(1, 257)
        positions[i] = pos
        for j in range(pos // block + 1):
            tables[i, j] = free.pop()
    return tokens, positions, tables


def test_decode_replay_is_its_eager_step_bitwise(card):
    """A decode graph's replay gives the eager ``hybrid_decode``'s logits
    and pool bit for bit (every block but scratch, which the warm call
    wrote), on a pool of random K/V with 5 of 16 rows live."""
    net = _lm(card)
    pool_e = _filled_pool(net, 64, 16, 1)
    pool_g = pool_e.clone()
    host = _decode_state(16, 5, 6, 64, 16, 2)
    zeros = [np.zeros_like(a) for a in host]
    graph = net.cached_graph(*zeros, pool_g, entry="decode")
    with torch.inference_mode():
        want, _ = net.hybrid_decode(
            *[torch.as_tensor(a, device=card) for a in host], pool_e)
    got, pool = graph.raw(*host, pool_g)
    assert pool is pool_g
    assert _bitwise(got, want)
    assert _bitwise(pool_g[:, 1:], pool_e[:, 1:])
    st = graph.stats()
    assert [g["replays"] for g in st["graphs"]] == [1]
    assert st["warm_calls"] == 1
    assert net.graph_stats()["entries"] == 0       # the handle owns it


def test_generation_graphs_carry_one_pool_in_place(card):
    """A prefill and a decode graph over one pool: the pool is captured as
    it is (its address never changes, each raw returns it), a replay
    copies out the logits alone, and another pool in its place raises."""
    net = _lm(card)
    pool = net.init_kv_pool(16, 16)
    ptr = pool.data_ptr()
    pre = net.cached_graph(np.zeros((1, 16), np.int32),
                           np.zeros((1,), np.int32),
                           np.zeros((1, 1), np.int32), pool, entry="prefill")
    dec = net.cached_graph(np.zeros((4,), np.int32), np.zeros((4,), np.int32),
                           np.zeros((4, 2), np.int32), pool, entry="decode")
    toks = np.zeros((1, 16), np.int32)
    toks[0, :5] = [3, 1, 4, 1, 5]
    logits, out = pre.raw(toks, np.array([5], np.int32),
                          np.array([[7]], np.int32), pool)
    assert out is pool and logits.shape == (1, 257)
    assert bool(pool[:, 7, :5].abs().sum() > 0)      # the prompt's K/V
    for _ in range(3):
        logits, out = dec.raw(np.array([9, 0, 0, 0], np.int32),
                              np.array([5, 0, 0, 0], np.int32),
                              np.array([[7, 0]] + [[0, 0]] * 3, np.int32),
                              pool)
        assert out is pool and pool.data_ptr() == ptr
    st = [g for h in (pre, dec) for g in h.stats()["graphs"]]
    assert [g["replays"] for g in st] == [1, 3]
    assert [g["copy_bytes"] for g in st] == [257 * 4, 4 * 257 * 4]
    with pytest.raises(MXNetError, match="carried in place"):
        dec.raw(np.zeros(4, np.int32), np.zeros(4, np.int32),
                np.zeros((4, 2), np.int32), pool.clone())


def test_decode_row_is_bitwise_at_every_slot_count(card):
    """Row 0's logits at decode_rows(n) rows with n = 1, 3, 4 and 16 rows
    live (the others hold other requests' state) are bit for bit the same:
    the decode step's GEMMs keep their shapes and every op is
    row-independent."""
    from mxnet_tpu_torch.serving.server import decode_rows
    net = _lm(card, units=128, num_heads=2, hidden_size=256)
    rows = {decode_rows(n) for n in (1, 3, 4, 16)}
    assert rows == {16}
    base = _filled_pool(net, 96, 16, 3)
    first = _decode_state(16, 1, 5, 96, 16, 4)
    outs = []
    for n in (1, 3, 4, 16):
        pool = base.clone()
        tokens, positions, tables = _decode_state(16, n, 5, 96, 16, 5)
        # row 0 is the same request in every run; its blocks are its own
        # (the other rows' blocks are drawn apart from them)
        others = set(first[2][0][first[2][0] > 0].tolist())
        tables[np.isin(tables, list(others))] = 0
        tokens[0], positions[0], tables[0] = (first[0][0], first[1][0],
                                              first[2][0])
        graph = net.cached_graph(*[np.zeros_like(a) for a in
                                   (tokens, positions, tables)], pool,
                                 entry="decode")
        logits, _ = graph.raw(tokens, positions, tables, pool)
        outs.append(logits[0].clone())
    for o in outs[1:]:
        assert _bitwise(o, outs[0])


def test_generation_server_batched_equals_alone_on_card(card, monkeypatch):
    """``GenerationServer`` on the card: 12 requests at 4 slots (turnover,
    both prefill modes) give the tokens each gets alone at 1 slot, bit for
    bit; every KV block returns; the pool never moves."""
    from mxnet_tpu_torch.serving import GenerationServer
    net = _lm(card)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 250, int(rng.integers(4, 16)))
               for _ in range(12)]
    caps = [int(c) for c in rng.integers(2, 24, 12)]

    def serve(slots, mode):
        monkeypatch.setenv("MXTPU_SERVING_PREFILL_MODE", mode)
        srv = GenerationServer(net, slots=slots, kv_block=16, kv_blocks=64,
                               max_new_tokens=24, prompt_buckets=(16,),
                               deadline_ms=0)
        ptr = srv.pool.data_ptr()
        with srv:
            srv.warmup()
            reqs = [srv.submit_generate(p, max_new_tokens=c)
                    for p, c in zip(prompts, caps)]
            out = [r.result(timeout=120) for r in reqs]
        assert srv.stats()["kv_blocks_used"] == 0
        assert srv.pool.data_ptr() == ptr
        return out

    alone = serve(1, "interleave")
    assert serve(4, "interleave") == alone
    assert serve(4, "step") == alone
    assert [len(t) for t in alone] == caps


def test_generation_server_past_one_decode_graph_on_card(card, monkeypatch):
    """At 17 slots, 20 requests queued at once in step mode: a decode step
    replays the one 16-row decode graph twice, no other decode graph is
    captured, and each request's tokens are bit for bit those it gets
    alone."""
    from mxnet_tpu_torch.serving import GenerationServer
    monkeypatch.setenv("MXTPU_SERVING_PREFILL_MODE", "step")
    net = _lm(card)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 250, int(rng.integers(4, 16)))
               for _ in range(20)]
    caps = [int(c) for c in rng.integers(2, 24, 20)]

    def serve(slots):
        srv = GenerationServer(net, slots=slots, kv_block=16, kv_blocks=64,
                               max_new_tokens=24, prompt_buckets=(16,),
                               deadline_ms=0)
        reqs = [srv.submit_generate(p, max_new_tokens=c)
                for p, c in zip(prompts, caps)]
        steps = srv.stats()["decode_steps"]
        srv.warmup()
        with srv:
            out = [r.result(timeout=120) for r in reqs]
            steps = srv.stats()["decode_steps"] - steps
            st = srv.graph_stats()["decode"]
        assert srv.stats()["kv_blocks_used"] == 0
        return out, steps, st

    alone, _, _ = serve(1)
    batched, steps, st = serve(17)
    assert batched == alone
    assert list(st) == [16] and len(st[16]["graphs"]) == 1
    assert st[16]["graphs"][0]["replays"] > steps


def test_generation_server_unload_frees_its_card_memory(card):
    """``ModelRegistry.unload`` then ``load`` (the reload path of a
    generation model) leaves nothing behind: once the caller drops the
    unloaded server, its pool and every graph's memory are freed, the
    block's cache never held a generation graph, and the card holds after
    two more reloads what it held after the first (which also made the
    process's one-time cuBLAS workspaces)."""
    import gc
    import weakref
    from mxnet_tpu_torch.serving import GenerationServer, ModelRegistry
    net = _lm(card)
    reg = ModelRegistry()

    def cycle():
        srv = GenerationServer(net, slots=4, kv_block=16, kv_blocks=64,
                               max_new_tokens=24, prompt_buckets=(16, 32),
                               deadline_ms=0)
        reg.load("lm", srv, warm=True)
        assert srv.stats()["executables"] == 3
        assert len(srv.generate(np.arange(1, 9), timeout=120)) == 24
        pool = weakref.ref(srv.pool)
        reg.unload("lm")
        assert srv.stats()["executables"] == 0
        del srv
        gc.collect()
        torch.cuda.synchronize(card)
        assert pool() is None
        return torch.cuda.memory_allocated(card)

    base = cycle()
    assert [cycle(), cycle()] == [base, base]
    assert net.graph_stats()["entries"] == 0


# ------------------------- the training surface around gluon.Trainer
#
# The optimizers on the card against the same steps on the CPU (every
# weight and state within 1e-5 x max(1, |w|): the same elementwise
# operations, norms summed in another order); LARS, LBSGD and LAMB read
# nothing back; a checkpoint resumed on the card equals the
# uninterrupted run bit for bit.

def _surface_net(dev, seed=5, dtype=None):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(96, in_units=64), nn.Dense(32, in_units=96))
    net.initialize(ctx=dev, seed=seed)
    if dtype is not None:
        net.cast(dtype)
    return net


def _surface_steps(net, name, kw, grads, no_reads=False):
    from mxnet_tpu_torch import gluon, lr_scheduler
    sched = lr_scheduler.CosineScheduler(max_update=8, warmup_steps=2,
                                         base_lr=kw["learning_rate"])
    tr = gluon.Trainer(net.collect_params(), name,
                       dict(kw, wd=1e-4, lr_scheduler=sched))
    for step in grads:
        for p, g in zip(tr._params, step):
            p._grad_tensor().copy_(g)
            p.fresh = False
        if no_reads:
            torch.cuda.set_sync_debug_mode("error")
        try:
            tr.step(4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return tr


def _flat_state(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [t for s in state for t in _flat_state(s)]
    return [state]


SURFACE_OPTS = [
    ("lars", {"learning_rate": 0.1}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9,
               "warmup_strategy": "lars"}),
    ("lamb", {"learning_rate": 1e-3}),
    ("lamb", {"learning_rate": 1e-3, "multi_precision": True}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("ftml", {"learning_rate": 0.0025}),
    ("nadam", {"learning_rate": 1e-3}),
    ("adamw", {"learning_rate": 1e-3, "multi_precision": True}),
]


@pytest.mark.parametrize("name,kw", SURFACE_OPTS)
def test_optimizer_on_card_matches_cpu(card, name, kw):
    """4 Trainer steps on the card and on the CPU from the same weights
    and gradients; LARS, LBSGD and LAMB under
    ``set_sync_debug_mode("error")`` (a read back raises) with no host
    read counted."""
    from mxnet_tpu_torch import cpu
    from mxnet_tpu_torch.engine import engine
    dtype = torch.bfloat16 if kw.get("multi_precision") else None
    gen = torch.Generator().manual_seed(9)
    shapes = [p.shape for p in _surface_net(cpu()).collect_params()
              .values()]
    grads = [[torch.randn(s, generator=gen).to(dtype or torch.float32)
              for s in shapes] for _ in range(4)]
    reads = engine().host_reads
    card_tr = _surface_steps(_surface_net(card, dtype=dtype), name, kw,
                             [[g.to(card) for g in s] for s in grads],
                             no_reads=name in ("lars", "lbsgd", "lamb"))
    torch.cuda.synchronize()
    assert engine().host_reads == reads
    cpu_tr = _surface_steps(_surface_net(cpu(), dtype=dtype), name, kw,
                            grads)
    for i, (p, q) in enumerate(zip(card_tr._params, cpu_tr._params)):
        pairs = [(p._tensor(), q._tensor())] + list(zip(
            _flat_state(card_tr._states[i]), _flat_state(cpu_tr._states[i])))
        for a, b in pairs:
            a, b = a.detach().float().cpu(), b.detach().float()
            assert ((a - b).abs() / b.abs().clamp(min=1.0)).max() <= 1e-5
        if dtype is not None:
            assert torch.equal(p._tensor(), card_tr._states[i][1].to(dtype))


def test_clip_global_norm_reads_once_on_card(card):
    """One host read for the whole list; the norm and the scaled arrays
    as on the CPU."""
    from mxnet_tpu_torch.engine import engine
    from mxnet_tpu_torch.gluon import utils
    gen = torch.Generator().manual_seed(2)
    host = [torch.randn(s, generator=gen) for s in [(300, 7), (11,), (5, 5)]]
    dev = [t.to(card) for t in host]
    reads = engine().host_reads
    norm = utils.clip_global_norm(dev, 1.0)
    assert engine().host_reads - reads == 1
    assert norm == pytest.approx(utils.clip_global_norm(host, 1.0),
                                 rel=1e-6)
    for a, b in zip(dev, host):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-7)


def test_resume_on_card_bitwise(card, tmp_path):
    """SGD with momentum under a multi-factor schedule on a small conv
    net: steps 1-3, ``save_parameters`` + ``save_states``, a fresh net
    (another seed) and Trainer load both; steps 4-6 under deterministic
    cuDNN give the uninterrupted run's losses and weights bit for
    bit."""
    from mxnet_tpu_torch import autograd, gluon, lr_scheduler
    from mxnet_tpu_torch.gluon import nn

    def make(seed):
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(8, 3, in_channels=3), nn.BatchNorm(
                in_channels=8), nn.Activation("relu"), nn.Flatten(),
                nn.Dense(10, in_units=8 * 14 * 14))
        net.initialize(ctx=card, seed=seed)
        net.collect_params(".*gamma|.*beta|.*bias").setattr("wd_mult", 0.0)
        sched = lr_scheduler.MultiFactorScheduler(
            step=[2, 4], factor=0.1, base_lr=0.05, warmup_steps=1)
        return net, gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
            "lr_scheduler": sched})

    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(16, 3, 16, 16, device=card, generator=gen)
    y = torch.randint(0, 10, (16,), device=card, generator=gen).float()

    def step(net, tr):
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        autograd.backward(loss)
        tr.step(16)
        return loss.detach()
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        full, full_tr = make(0)
        full_losses = [step(full, full_tr) for _ in range(6)]
        first, first_tr = make(0)
        for _ in range(3):
            step(first, first_tr)
        first.save_parameters(str(tmp_path / "n.params"))
        first_tr.save_states(str(tmp_path / "n.states"))
        resumed, resumed_tr = make(1)
        resumed.load_parameters(str(tmp_path / "n.params"))
        resumed_tr.load_states(str(tmp_path / "n.states"))
        losses = [step(resumed, resumed_tr) for _ in range(3)]
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    assert all(torch.equal(a, b) for a, b in zip(losses, full_losses[3:]))
    for a, b in zip(resumed.collect_params().values(),
                    full.collect_params().values()):
        assert a._tensor().device == card and \
            torch.equal(a._tensor(), b._tensor())
    for i, s in full_tr._states.items():
        assert resumed_tr._states[i].device == card
        assert torch.equal(resumed_tr._states[i], s)


# ---- the data pipeline's device stage (gluon.data.DataLoader) -------------

class _Rows:
    """Sample i: a 1 M-element fp32 row of ``i + j * 1e-6`` and label i."""

    def __len__(self):
        return 24

    def __getitem__(self, i):
        return (np.float32(i) + np.arange(1 << 20, dtype=np.float32) * 1e-6,
                np.float32(i))


@pytest.mark.parametrize("depth", [1, 3])
def test_device_stage_yields_the_host_batches(card, depth):
    """Batches of 16 MB copied on the side stream: the consumer reads each
    at once on its own stream (a missing wait on the copy's event gives a
    torn batch), then stalls the card, so that later copies land while it
    still holds earlier batches (a buffer reused under a copy, or a
    missing ``record_stream``, gives wrong data)."""
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.gluon.data import DataLoader
    ds = _Rows()
    loader = DataLoader(ds, batch_size=4, num_workers=2, pin_memory=True,
                        device_prefetch=depth)
    held, seen = [], []
    with gpu(0):
        for x, y in loader:
            assert x._data.is_cuda and x._data.device == card
            seen.append((x._data.clone(), y._data.clone()))
            held.append(x)
            torch.cuda._sleep(2_000_000)
            if len(held) > 2:
                held.pop(0)
    torch.cuda.synchronize()
    assert len(seen) == 6
    for b, (x, y) in enumerate(seen):
        want = np.stack([ds[i][0] for i in range(4 * b, 4 * b + 4)])
        assert torch.equal(x.cpu(), torch.as_tensor(want))
        assert torch.equal(y.cpu(), torch.arange(4 * b, 4 * b + 4,
                                                 dtype=torch.float32))


def test_pin_memory_batches_are_pinned(card):
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.dataloader import default_batchify_fn
    for fn in (None, lambda s: default_batchify_fn(s)):
        x, y = next(iter(DataLoader(_Rows(), batch_size=2, num_workers=1,
                                    pin_memory=True, batchify_fn=fn)))
        assert x._data.is_pinned() and y._data.is_pinned()
        assert not x._data.is_cuda
    x, _ = next(iter(DataLoader(_Rows(), batch_size=2)))
    assert not x._data.is_pinned()


def test_native_record_iter_batches_keep_their_bits_on_the_card(card,
                                                                 tmp_path):
    from mxnet_tpu_torch import gluon, gpu, io, recordio
    rng = np.random.default_rng(0)
    prefix = str(tmp_path / "r")
    w = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(16):
        img = rng.integers(0, 255, (40 + i, 50, 3), dtype=np.uint8)
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                     recordio._raw_payload(img)))
    w.close()
    it = io.ImageRecordIter(prefix + ".rec", (3, 32, 32), 8,
                            path_imgidx=prefix + ".idx", shuffle=True,
                            rand_crop=True, rand_mirror=True, resize=36,
                            mean_r=120.0, std_r=60.0, use_native=True)
    n = 0
    for b in it:
        host = b.data[0]._data
        dev = gluon.utils.split_and_load(b.data[0], [gpu(0)])[0]
        assert dev._data.is_cuda
        assert torch.equal(dev._data.cpu().view(torch.int32),
                           host.view(torch.int32))
        n += 1
    assert n == 2


# ------------------------------------------ Gluon's model surface (phase 18)


def test_registry_multi_sgd_mom_update_still_launches_once(card):
    """With the SGD family in the registry, ``nd.multi_sgd_mom_update``
    (phase 11's update) and the registry's op both launch the momentum
    kernel once a call."""
    from mxnet_tpu_torch import gpu, nd
    from mxnet_tpu_torch.ndarray.register import invoke_by_name
    ws = [nd.ones((64, 32), ctx=gpu(0)) for _ in range(2)]
    gs = [nd.ones((64, 32), ctx=gpu(0)) for _ in range(2)]
    ms = [nd.zeros((64, 32), ctx=gpu(0)) for _ in range(2)]
    args = [t for w, g, m in zip(ws, gs, ms) for t in (w, g, m)]
    rates = [nd.array(np.full(2, 0.1, np.float32), ctx=gpu(0)),
             nd.zeros((2,), ctx=gpu(0))]
    before = multi_sgd_mom.launches
    nd.multi_sgd_mom_update(*args, *rates, momentum=0.9, out=ws)
    assert multi_sgd_mom.launches - before == 1
    invoke_by_name("multi_sgd_mom_update", args + rates, {"momentum": 0.9})
    assert multi_sgd_mom.launches - before == 2


@pytest.mark.parametrize("kind,bidir", [("LSTM", False), ("GRU", True),
                                        ("RNN", True)])
def test_cudnn_rnn_layer_matches_cpu(card, kind, bidir):
    """cuDNN (TF32 off) against torch's CPU loop: the output and the
    states within 1e-5, every gradient within 5e-5 (sums over 12 steps of
    8 samples in another order: 1.6e-5 measured on an H100) of a 2-layer
    width-64 layer; the weights are one cuDNN buffer a layer, so cuDNN
    copies nothing (no warning)."""
    import warnings
    from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params
    rs = np.random.RandomState(5)
    x = rs.randn(12, 8, 32).astype(np.float32)
    runs = []
    for ctx in (card, cpu()):
        net = getattr(gluon.rnn, kind)(64, num_layers=2, bidirectional=bidir,
                                       input_size=32)
        net.initialize(ctx=ctx, seed=3)
        xs = torch.tensor(x, device=ctx, requires_grad=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with autograd.record():
                out, states = net(xs, [s._data for s in net.begin_state(
                    8, ctx=ctx)])
            autograd.backward([out] + states)
        assert not [w for w in caught if "contiguous" in str(w.message)]
        runs.append([out, *states, xs.grad] + [
            p._grad_tensor() for p in net.collect_params().values()])
    for i, (a, b) in enumerate(zip(*runs)):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(),
                                   atol=1e-5 if i < 1 + len(states) else 5e-5,
                                   rtol=1e-4)


def test_hybridized_lstm_replays_bitwise_its_eager_step(card):
    """A hybridized LSTM language model's recording call replays bit for
    bit the eager call's loss and gradients (cuDNN deterministic); set
    data keeps the cuDNN buffer (the entry is not captured again)."""
    import chip_smoke
    from mxnet_tpu_torch import autograd
    torch.backends.cudnn.deterministic = True
    try:
        net = chip_smoke.WordLM(200, 64, 64, 2, 0.0)
        net.initialize(ctx=card, seed=1)
        x = torch.randint(0, 200, (10, 4), device=card)
        h = [s._data for s in net.begin_state(4, ctx=card)]

        def step():
            with autograd.record():
                out, _ = net(x, h)
                loss = out.square().mean()
            autograd.backward(loss)
            return [loss] + [p._grad_tensor().clone()
                             for p in net.collect_params().values()]
        eager = step()
        net.hybridize()
        runs = [step() for _ in range(3)]
        stats = net.graph_stats()
        ptrs = [p._tensor().data_ptr() for p in net.rnn.collect_params()
                .values()]
        first = next(iter(net.rnn.collect_params().values()))
        first.set_data(np.zeros((256, 64), np.float32))
        assert [p._tensor().data_ptr() for p in net.rnn.collect_params()
                .values()] == ptrs
    finally:
        torch.backends.cudnn.deterministic = False
    assert stats["replays"] == 2
    for run in runs:
        assert all(torch.equal(a, b) for a, b in zip(run, eager))


def test_hybridized_lstm_dropout_is_fresh_per_replay_and_seeded(card):
    """Dropout between the LSTM's layers (the port's generator) draws new
    masks at each replay, and a reseeded run repeats them."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import random as mx_random

    def run():
        net = gluon.rnn.LSTM(32, num_layers=2, dropout=0.5, input_size=16)
        net.initialize(ctx=card, seed=0)
        net.hybridize()
        x = torch.ones(6, 4, 16, device=card)
        outs = []
        for _ in range(4):
            with autograd.record():
                outs.append(net(x).detach())
        return outs, net.graph_stats()["replays"]

    mx_random.seed(3)
    a, replays = run()
    assert replays >= 2
    for i in range(2, 4):
        assert not torch.equal(a[i], a[i - 1])
    mx_random.seed(3)
    b, _ = run()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_hybridized_hybrid_forward_block_on_card(card):
    """A block written for the JAX package (``hybrid_forward`` with ``F``
    and its registered parameters) captures and replays on the card,
    equal to its eager call bit for bit."""
    from mxnet_tpu_torch import autograd, gluon

    class FC(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.weight = self.params.get("weight", shape=(8, 12))
                self.bias = self.params.get("bias", shape=(8,))

        def hybrid_forward(self, F, x, weight, bias):
            return F.tanh(F.FullyConnected(x.reshape((0, -1)), weight,
                                           bias, num_hidden=8)) * 2.0

    net = FC()
    net.initialize(ctx=card, seed=0)
    x = torch.randn(4, 3, 4, device=card)
    with autograd.record():
        want = net(x)
    autograd.backward(want)
    grad = net.weight._grad_tensor().clone()
    net.hybridize()
    for _ in range(3):
        with autograd.record():
            got = net(x)
        autograd.backward(got)
        assert torch.equal(got, want) and \
            torch.equal(net.weight._grad_tensor(), grad)
    assert net.graph_stats()["replays"] == 2


def test_ceil_mode_and_exclusive_pooling_on_card(card):
    from mxnet_tpu_torch.gluon import nn
    x = torch.randn(2, 8, 15, 13)
    for layer in (nn.MaxPool2D(3, 2, ceil_mode=True),
                  nn.AvgPool2D(3, 2, 1, ceil_mode=True,
                               count_include_pad=False),
                  nn.MaxPool3D(2, ceil_mode=True)):
        xin = x if "3D" not in type(layer).__name__ else x.unsqueeze(2)
        want = layer(xin)
        got = layer(xin.to(card))
        torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=1e-6)


def test_get_model_builds_each_family_on_the_card_by_default(card):
    """``initialize()`` without a context places every family on
    ``gpu(0)``; a forward there gives finite logits."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    for name, size in (("alexnet", 64), ("vgg11", 32), ("resnet18_v2", 32),
                       ("mobilenet_v2_0_25", 32), ("densenet121", 32),
                       ("squeezenet1_1", 32), ("inception_v3", 299)):
        net = vision.get_model(name, classes=10)
        net.initialize()
        with autograd.predict_mode(), torch.no_grad():
            out = net(torch.randn(1, 3, size, size, device=card))
        assert out.device == card and out.shape == (1, 10)
        assert bool(torch.isfinite(out).all())
        assert all(p.device == card
                   for p in net.collect_params().values())


# ---- the symbolic AMP and Module surface -------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registry_flash_op_launches_the_kernel(card, dtype):
    """``_contrib_flash_attention`` through the registry on the card: one
    kernel launch a call, forward and q/k/v gradients against autograd
    through the plain version (run in fp32 on the same inputs), within
    ``TOL`` x max(1, max|grad|) for the gradients."""
    from mxnet_tpu_torch import autograd, nd
    g = torch.Generator().manual_seed(16)
    q, k, v = (torch.randn(2 * 12, 96, 64, generator=g).to(card, dtype)
               for _ in range(3))
    vl = torch.tensor([96.0, 41.0], device=card)
    head = torch.randn(2 * 12, 96, 64, generator=g).to(card, dtype)
    arrays = [nd.NDArray(t.clone()) for t in (q, k, v)]
    for a in arrays:
        a.attach_grad()
    before = flash_attention.launches
    with autograd.record():
        out = nd.flash_attention(*arrays, valid_len=nd.NDArray(vl),
                                 scale=0.125)
    out.backward(nd.NDArray(head))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = flash_attention_plain(*leaves, vl.repeat_interleave(12), False,
                                0.125)
    ref.backward(head.float())
    tol = TOL[dtype]
    assert (out._data.float() - ref).abs().max().item() <= tol
    for a, leaf in zip(arrays, leaves):
        scale = max(1.0, leaf.grad.abs().max().item())
        assert (a.grad._data.float() - leaf.grad).abs().max().item() <= \
            tol * scale


def test_tie_orders_on_card_match_the_cpu(card):
    """``topk``, ``sort`` and ``argsort`` with ties: the card's orders are
    the CPU's, bit for bit (stable sorts only), and the JAX package's
    rules (``topk`` lowest index first, ``argsort`` descending highest)."""
    from mxnet_tpu_torch import nd
    x = torch.tensor([[1, 3, 3, 2, 3, 1, 0, 3]] * 3 + [[2] * 8],
                     dtype=torch.float32).repeat(64, 1)
    for name, kw in (("topk", {"k": 3, "ret_typ": "both"}),
                     ("topk", {"k": 4, "is_ascend": True}),
                     ("topk", {"k": 3, "ret_typ": "mask"}),
                     ("sort", {"is_ascend": False}),
                     ("argsort", {"is_ascend": False}),
                     ("argsort", {})):
        got = getattr(nd, name)(x.to(card), **kw)
        want = getattr(nd, name)(x, **kw)
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (name, kw)
    top = nd.topk(x.to(card), k=3).cpu().long()
    assert torch.equal(top[0], torch.tensor([1, 2, 4]))
    desc = nd.argsort(x.to(card), is_ascend=False).cpu().long()
    assert torch.equal(desc[0], torch.tensor([7, 4, 2, 1, 3, 5, 0, 6]))


def test_gather_nd_clamps_out_of_range_indices_on_card(card):
    """Out-of-range ``gather_nd``/``_advanced_index`` indices are clamped
    (no device-side assert), as the JAX package's gathers; the gradient
    skips them; ``scatter_nd`` keeps the last of repeated updates."""
    from mxnet_tpu_torch import nd
    data = torch.arange(12.0).reshape(3, 4)
    idx = torch.tensor([[0.0, 5, -1, -9, 2], [1, 9, -2, 2, 100]])
    for dev in (card, torch.device("cpu")):
        d = data.to(dev).requires_grad_()
        out = nd.gather_nd(d, idx.to(dev))
        out.sum().backward()
        torch.cuda.synchronize()
        assert out.cpu().tolist() == [1.0, 11.0, 10.0, 2.0, 11.0]
        assert d.grad.cpu().flatten().nonzero().flatten().tolist() == \
            [1, 10]
        rows = nd.get_op("_advanced_index").get_fn({})(
            d.detach(), torch.tensor([0.0, 7, -1, -8], device=dev))
        assert rows[:, 0].cpu().tolist() == [0.0, 8.0, 8.0, 0.0]
    upd = torch.arange(1.0, 9.0)
    pos = torch.tensor([[3.0, 1, 3, 3, 1, 0, 3, 1]])
    got = nd.scatter_nd(upd.to(card), pos.to(card), shape=(4,))
    assert got.cpu().tolist() == [6.0, 8.0, 0.0, 7.0]


def test_multi_all_finite_reads_nothing_back_on_card(card):
    """``multi_all_finite`` over NDArrays on the card answers a 1-element
    float32 array there: no host read until the caller reads it; 1 clean,
    0 with one ``inf``."""
    from mxnet_tpu_torch import engine, nd
    eng = engine.engine()
    arrays = [nd.NDArray(torch.randn(n, device=card)) for n in (5, 1000,
                                                                 77)]
    before = eng.host_reads
    ok = nd.multi_all_finite(*arrays, num_arrays=3)
    assert eng.host_reads == before
    assert ok.context.device_type == "gpu" and ok.shape == (1,)
    assert ok.asscalar() == 1.0 and eng.host_reads == before + 1
    arrays[1]._data[500] = math.inf
    bad = nd.multi_all_finite(*arrays, num_arrays=3)
    assert eng.host_reads == before + 1
    assert bad.asscalar() == 0.0


def test_exported_resnet_imported_and_served_on_card(card, tmp_path):
    """A small ResNet v1 exported on the card, imported by
    ``SymbolBlock.imports`` and served by ``ModelServer.from_exported``
    (captured graphs over batch buckets 1 and 4): both held against the
    Gluon forward of the same images, 1e-4 of ``max(1, max |logit|)``
    (cuDNN may pick other algorithms at other batch sizes)."""
    from mxnet_tpu_torch import autograd, gpu
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.serving import ModelServer
    net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                          [8, 16, 32, 64, 128], classes=10)
    net.initialize(Xavier("gaussian", "in", 2), ctx=gpu(0), seed=0)
    x = torch.randn(6, 3, 32, 32, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad(), autograd.predict_mode():
        ref = net(x.to(card)).cpu()
    sym_file, param_file = net.export(str(tmp_path / "small"))
    imported = SymbolBlock.imports(sym_file, "data", param_file)
    first = next(iter(imported.collect_params().values()))
    assert first._tensor().device == card
    with torch.no_grad(), autograd.predict_mode():
        out = imported(x.to(card)).cpu()
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 1e-4 * scale
    srv = ModelServer.from_exported(sym_file, "data", param_file,
                                    max_batch=4, batch_buckets=(1, 4),
                                    deadline_ms=0)
    try:
        srv.warmup(x[0].numpy())
        srv.start()
        answers = [srv.infer(x[i].numpy(), timeout=120) for i in range(6)]
    finally:
        srv.stop()
    assert srv._block.graph_stats()["graphs"] == 2
    got = torch.as_tensor(np.stack(answers))
    assert (got - ref).abs().max().item() <= 1e-4 * scale
