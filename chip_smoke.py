#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke]

Phases (any failure exits non-zero without printing the ok line).  Every
kernel's launch count is set to 0 just before each main path (serving,
MLP, ResNet-50) and read just after; a path must launch its kernel the
expected number of times and the other kernels not at all:

1. device check: a CUDA card must be present; prints the card's name and
   power limit; TF32 is switched off so every fp32 tolerance means fp32;
2. build: compiles every CUDA source of the port (one nvcc each, in
   parallel) and prints the ptxas register/spill report;
3. kernels: calls each kernel's wrapper at the shapes its main path gives
   it and holds the result against the plain PyTorch version on the same
   inputs.  Flash attention at the BERT-base serving shapes (fp32 max-abs
   <= 1e-4; bf16 <= 2e-2 against the plain version in fp32); the two
   multi-tensor SGD kernels on ResNet-50's 161 trainable shapes, in the
   Trainer's groups of 4 and as one group of 161, and on the MLP's 6
   shapes in its groups of 4, clip on and off, wd != 0, rescale != 1, plus
   odd sizes on misaligned pointers (fp32 max-abs <= 1e-6; they round as
   the plain version does, so 0 is expected).  Times
   kernel, plain version and the library call (``scaled_dot_product_
   attention``; ``torch.optim.SGD(fused=True)``) with CUDA events, the
   SGD kernels' device time also with torch.profiler (their back-to-back
   calls are bound by the host), and computes the bound;
4. serving: BERT-base (12 layers, 768 wide, 12 heads, FFN 3072, vocab
   30522, max length 512, weights from ``--seed``) served by
   ``ModelServer`` over length buckets 32..512 and batch buckets 1 and 8;
   requests submitted from threads; checks finite, correctly unpadded
   outputs, batching invariance against the direct forward on the card,
   one request against the same weights on the CPU (plain path), and that
   the flash kernel launched exactly 12 times per dispatched batch;
5. MLP training (BASELINE config #1 at full width): Dense 784-128 relu -
   64 relu - 10, batch 64, ``gluon.Trainer("sgd", lr 0.1)``, 20 steps on
   one seeded batch; the loss must fall and the plain-SGD kernel must
   launch exactly 2 times per step;
6. ResNet-50 v1 training (config #2 at full width and depth):
   ``Xavier("gaussian", "in", 2)`` weights from ``--seed``, hybridized,
   batch 128 of synthetic 3x224x224 fp32, ``Trainer("sgd", lr 0.1,
   momentum 0.9, wd 1e-4)``, 3 warm and 10 timed steps of
   ``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``autograd.backward`` -> ``trainer.step``.  Checks a finite loss,
   exactly 41 momentum-kernel launches per step, the aggregated update
   against the per-tensor one from the same weights and gradients
   (max-abs <= 1e-6), and one batch-2 step from the initial weights on
   the card against the same step on the CPU: loss within 1e-4, and every
   updated weight and running statistic, leaf by leaf, held against the
   same step in float64 on the CPU: the card's error, as a share of the
   leaf's change in that step (L2 norms), at most 4x the CPU fp32 run's
   share + 1e-3 (some leaves' fp32 step is itself far from float64, so
   one fixed tolerance would test their conditioning, not the card);
   prints
   images/s, step time, peak memory and a ``torch.profiler`` breakdown of
   one step;
7. prints one JSON line of kernel measurements, the card line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Writes the full report to ``<out>/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from mxnet_tpu_torch import autograd, gluon, load_reference_params
from mxnet_tpu_torch.context import cpu, gpu
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo.transformer import bert_base
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
from mxnet_tpu_torch.initializer import Xavier
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
from mxnet_tpu_torch.kernels.multi_sgd import (multi_sgd, multi_sgd_mom,
                                               multi_sgd_mom_plain,
                                               multi_sgd_plain)
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.serving import ModelServer
from mxnet_tpu_torch.serving.server import readback

# H100 SXM published peaks (dense): fp32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LENGTH_BUCKETS = (32, 64, 128, 256, 512)
BATCH_BUCKETS = (1, 8)
LAYERS, HEADS, HEAD_DIM, VOCAB = 12, 12, 64, 30522
N_REQUESTS = 32
FLASH_TPU = "mxnet_tpu/kernels/flash_attention.py:107"
FLASH_SRC = "mxnet_tpu_torch/kernels/csrc/flash_attention.cu"
SGD_TPU = "mxnet_tpu/kernels/multi_sgd.py:138"
SGD_MOM_TPU = "mxnet_tpu/kernels/multi_sgd.py:142"
SGD_SRC = "mxnet_tpu_torch/kernels/csrc/multi_sgd.cu"
SGD_TOL = 1e-6
AGG = 4                              # MXNET_OPTIMIZER_AGGREGATION_SIZE
MLP_SHAPES = [(128, 784), (128,), (64, 128), (64,), (10, 64), (10,)]
MLP_BATCH, MLP_STEPS = 64, 20
RESNET_BATCH, RESNET_WARM, RESNET_STEPS = 128, 3, 10
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CPU_CHECK_BATCH = 2
LEAF_K, LEAF_FLOOR = 4.0, 1e-3


def _short(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def zero_counts() -> None:
    """Set every kernel's launch count to 0, just before a main path."""
    for wrapper in (flash_attention, multi_sgd, multi_sgd_mom):
        wrapper.launches = 0


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    three warm calls, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(vl_bh, lq, lk, d, dtype):
    """(bound_ms, bound_by, flops, bytes) of one flash-attention call, for
    the keys this run's lengths make live (min(ceil(vl), Lk) per row; the
    output depends on no later key, and a row with none is 0 whatever its
    q): 4 * Lq * keys * D operations; out written once, and the q rows
    and K/V keys that are live read once."""
    bh = vl_bh.numel()
    keys_bh = torch.clamp(torch.ceil(vl_bh.float()), 0, lk)
    keys = keys_bh.sum().item()
    live_bh = int((keys_bh > 0).sum().item())
    flops = 4.0 * lq * keys * d
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = ((live_bh + bh) * lq + 2 * keys) * d * itemsize + bh * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def check_flash(gen, name, b, h, lq, lk, d, dtype, causal, iters):
    dev = gpu(0)
    bh = b * h
    q, k, v = (torch.randn(bh, n, d, generator=gen).to(dev, dtype)
               for n in (lq, lk, lk))
    vl = torch.randint(1, lk + 1, (b,), generator=gen).float()
    vl[0] = 0.0                                   # a batch-pad row
    vl = vl.to(dev)
    vl_bh = vl.repeat_interleave(h)
    scale = 1.0 / math.sqrt(d)
    out = flash_attention(q, k, v, vl, causal, scale)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), vl_bh,
                                causal, scale)
    err = (out.float() - ref).abs().max().item()
    if not err <= TOL[dtype]:
        raise AssertionError(f"flash {name}: max-abs {err} > {TOL[dtype]}")
    row = {"case": name, "B": b, "H": h, "Lq": lq, "Lk": lk, "D": d,
           "dtype": _short(dtype), "causal": causal,
           "max_abs_err": err}
    if iters:
        key = torch.arange(lk, device=dev)[None, :] < vl[:, None]
        mask = key[:, None, None, :]
        if causal:
            mask = mask & torch.ones(lq, lk, dtype=torch.bool, device=dev) \
                .tril(lk - lq)
        q4, k4, v4 = (t.view(b, h, -1, d) for t in (q, k, v))
        bound_ms, bound_by, flops, nbytes = flash_bound(vl_bh, lq, lk, d,
                                                        dtype)
        row.update(
            ms=cuda_ms(lambda: flash_attention(q, k, v, vl, causal, scale),
                       iters),
            plain_ms=cuda_ms(lambda: flash_attention_plain(
                q, k, v, vl_bh, causal, scale), iters),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=scale), iters),
            bound_ms=bound_ms, bound_by=bound_by, flops=flops,
            bytes=nbytes)
    return row


def kernel_phase(seed: int):
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for lq in (128, 512):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_flash(
                gen, f"bert_base B=8 L={lq} {_short(dtype)}", 8, HEADS, lq,
                lq, HEAD_DIM, dtype, False, iters=50))
    # the causal mask with Lq > Lk (dead rows), and the other head dims
    rows.append(check_flash(gen, "causal Lq=160 Lk=96", 2, HEADS, 160, 96,
                            HEAD_DIM, torch.float32, True, iters=0))
    rows.append(check_flash(gen, "D=128 ragged", 2, 4, 200, 131, 128,
                            torch.float32, False, iters=0))
    rows.append(check_flash(gen, "D=32 ragged bf16", 2, 4, 77, 77, 32,
                            torch.bfloat16, True, iters=0))
    return rows


def bucket_lengths(rng, n_requests):
    """Request lengths in 16..512 drawn from ``rng``, cycling over the
    length buckets so every bucket is served."""
    lows = (16,) + tuple(b + 1 for b in LENGTH_BUCKETS[:-1])
    return [int(rng.integers(lows[i % 5], LENGTH_BUCKETS[i % 5] + 1))
            for i in range(n_requests)]


def profile_batch(net, dev, n_iters=3):
    """Where the time of a served B=8, L=512 batch goes: device time by
    kernel class (torch.profiler) over ``n_iters`` forward + readback
    calls of the cached graph, beside their host wall time."""
    from torch.profiler import ProfilerActivity, profile
    b, s = BATCH_BUCKETS[-1], LENGTH_BUCKETS[-1]
    arrays = (np.zeros((b, s), np.int32), np.zeros((b, s), np.int32),
              np.full((b,), s, np.float32))
    graph = net.cached_graph(*arrays)
    readback(graph.raw(*arrays))     # warm: the page-locked host buffers
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n_iters):
            readback(graph.raw(*arrays))
        wall_ms = (time.monotonic() - t0) * 1e3 / n_iters
    classes = {"flash_attention": 0.0, "gemm": 0.0, "memcpy": 0.0,
               "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        if "flash_fwd_kernel" in name:
            cls = "flash_attention"
        elif "memcpy" in name:
            cls = "memcpy"
        elif any(w in name for w in ("gemm", "cutlass", "xmma", "sm90")):
            cls = "gemm"
        else:
            cls = "other"
        classes[cls] += e.self_device_time_total / 1e3 / n_iters
    busy = sum(classes.values())
    return {"batch": [b, s], "wall_ms": wall_ms, "device_ms": classes,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms)}


def serve_phase(seed: int, n_requests: int, card: str):
    dev = gpu(0)
    net = bert_base(dropout=0.0)
    net.initialize(ctx=dev, seed=seed)
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, VOCAB, n).astype(np.int32),
             rng.integers(0, 2, n).astype(np.int32), np.float32(n))
            for n in bucket_lengths(rng, n_requests)]
    srv = ModelServer(net, max_batch=BATCH_BUCKETS[-1],
                      length_buckets=LENGTH_BUCKETS,
                      batch_buckets=BATCH_BUCKETS, queue_depth=4 * n_requests,
                      deadline_ms=0, workers=2, batch_window_us=5000)
    results, futs = {}, {}
    try:
        t0 = time.monotonic()
        graphs = srv.warmup(*[(np.zeros(n, np.int32), np.zeros(n, np.int32),
                               np.float32(n)) for n in LENGTH_BUCKETS])
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        srv.start()
        torch.cuda.reset_peak_memory_stats()
        b0 = srv.stats()["batches"]
        zero_counts()

        def client(tid, n_clients=4):
            mine = range(tid, n_requests, n_clients)
            for i in mine:
                futs[i] = srv.submit(*reqs[i])
            for i in mine:
                results[i] = futs[i].result(timeout=600)

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.monotonic() - t0
        launches = flash_attention.launches
        other = multi_sgd.launches + multi_sgd_mom.launches
        batches = srv.stats()["batches"] - b0
        if any(t.is_alive() for t in threads) or len(results) != n_requests:
            raise AssertionError("requests did not complete")
    finally:
        srv.stop()
    stats = srv.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != LAYERS * batches or other:
        raise AssertionError(f"flash launches {launches} != {LAYERS} x "
                             f"{batches} batches, or {other} SGD launches")
    buckets = set()
    for i, (toks, _, _) in enumerate(reqs):
        mlm, nsp = results[i]
        n = toks.shape[0]
        if mlm.shape != (n, VOCAB) or nsp.shape != (2,):
            raise AssertionError(f"request {i}: shapes {mlm.shape} "
                                 f"{nsp.shape}, want ({n}, {VOCAB}), (2,)")
        if not (np.isfinite(mlm).all() and np.isfinite(nsp).all()):
            raise AssertionError(f"request {i}: non-finite output")
        buckets.add(next(b for b in LENGTH_BUCKETS if b >= n))
    if buckets != set(LENGTH_BUCKETS):
        raise AssertionError(f"buckets served {sorted(buckets)}")

    def direct(model, i, device):
        with torch.inference_mode():
            out = model(*[torch.as_tensor(np.asarray(a)[None], device=device)
                          for a in reqs[i]])
        return [o[0].cpu().numpy() for o in out]

    def max_err(i, outs):
        return max(float(np.abs(a - b).max())
                   for a, b in zip(results[i], outs))

    invariance = {i: max_err(i, direct(net, i, dev)) for i in range(4)}
    breakdown = profile_batch(net, dev)
    del net
    torch.cuda.empty_cache()
    cpu_net = bert_base(dropout=0.0)
    cpu_net.initialize(ctx=cpu(), seed=seed)
    shortest = min(range(n_requests), key=lambda i: reqs[i][0].shape[0])
    cpu_err = max_err(shortest, direct(cpu_net, shortest, cpu()))
    if max(invariance.values()) > 1e-3 or cpu_err > 1e-3:
        raise AssertionError(f"served vs direct max-abs {invariance}, "
                             f"vs CPU plain path {cpu_err} (limit 1e-3)")
    lat = np.array([(futs[i].t_done - futs[i].t_enqueue) * 1e3
                    for i in range(n_requests)])
    dispatch = registry().histogram("serving.dispatch_us")
    return {
        "card": card, "requests": n_requests, "batches": batches,
        "flash_launches": launches, "graphs": graphs,
        "warmup_s": warm_s, "wall_s": wall,
        "requests_per_s": n_requests / wall,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "dispatch_ms_p50_bucketed": dispatch.percentile(50) / 1e3,
        "dispatch_ms_p99_bucketed": dispatch.percentile(99) / 1e3,
        "peak_memory_gb": peak_gb, "stats": stats,
        "batching_invariance_max_abs": invariance,
        "cpu_plain_path_max_abs": cpu_err,
        "cpu_check_length": int(reqs[shortest][0].shape[0]),
        "profile": breakdown,
    }


def _groups(n, size):
    return [list(range(lo, min(lo + size, n))) for lo in range(0, n, size)]


def resnet50_trainable_shapes():
    return [p.shape for p in resnet50_v1().collect_params().values()
            if p.grad_req != "null"]


def sgd_bound(n_elems: int, momentum: bool):
    """(bound_ms, bytes) of one update over ``n_elems`` fp32 elements:
    sgd reads w, g and writes w (12 B/element), sgd_mom also reads and
    writes m (20 B/element); 4-6 flops per element are far below the
    card's 20 flops per byte, so bytes bound it."""
    nbytes = (20 if momentum else 12) * n_elems
    return nbytes / PEAK_BYTES * 1e3, nbytes


class SgdCase:
    """fp32 weights, gradients and momenta of ``shapes`` on the card, with
    per-tensor lr and wd, all drawn from ``gen``; ``offset`` > 0 places
    every tensor that many elements into its buffer (misaligned)."""

    def __init__(self, gen, shapes, offset=0):
        dev = gpu(0)

        def make(shape, scale):
            n = math.prod(shape)
            buf = torch.randn(n + offset, device=dev, generator=gen) * scale
            return buf[offset:].view(shape)

        self.shapes = shapes
        self.w = [make(s, 1.0) for s in shapes]
        self.g = [make(s, 2.0) for s in shapes]
        self.m = [make(s, 0.1) for s in shapes]
        k = len(shapes)
        self.lrs = (torch.rand(k, generator=torch.Generator().manual_seed(k))
                    * 0.2 + 0.01).tolist()
        self.wds = (torch.rand(k, generator=torch.Generator().manual_seed(
            k + 1)) * 1e-3).tolist()
        self.n = sum(math.prod(s) for s in shapes)

    def clones(self):
        return ([t.clone() for t in self.w], [t.clone() for t in self.m])


def check_sgd(case: SgdCase, momentum: bool, group: int, clip: float,
              rescale: float):
    """Kernel in groups of ``group`` against the plain version over the
    whole set; returns (max-abs error, launches, expected launches: one
    per 64 tensors of each group)."""
    wk, mk = case.clones()
    wp, mp = case.clones()
    before = multi_sgd.launches + multi_sgd_mom.launches
    groups = _groups(len(case.shapes), group)
    for idx in groups:
        pick = [case.lrs[i] for i in idx], [case.wds[i] for i in idx]
        if momentum:
            multi_sgd_mom([wk[i] for i in idx], [case.g[i] for i in idx],
                          [mk[i] for i in idx], *pick, 0.9, rescale, clip)
        else:
            multi_sgd([wk[i] for i in idx], [case.g[i] for i in idx],
                      *pick, rescale, clip)
    launches = multi_sgd.launches + multi_sgd_mom.launches - before
    if momentum:
        multi_sgd_mom_plain(wp, case.g, mp, case.lrs, case.wds, 0.9,
                            rescale, clip)
    else:
        multi_sgd_plain(wp, case.g, case.lrs, case.wds, rescale, clip)
    torch.cuda.synchronize()
    outs = zip(wk + mk, wp + mp) if momentum else zip(wk, wp)
    err = max((a - b).abs().max().item() for a, b in outs)
    return err, launches, sum(-(-len(idx) // 64) for idx in groups)


def device_ms(fn, iters: int) -> float:
    """Device time of one ``fn`` call: the summed time of the CUDA kernels
    it launches (torch.profiler) over ``iters`` calls, after three warm
    calls.  Unlike ``cuda_ms`` it leaves out the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / iters / 1e3


def time_sgd(case: SgdCase, momentum: bool, iters: int):
    """Times of one update over the whole set at the Trainer's settings of
    the ResNet recipe (lr 0.1, wd 1e-4, momentum 0.9, rescale 1/128, no
    clip): the kernel in groups of 4 (the main path) and as one group, the
    plain version, and fused torch.optim.SGD.  ``ms``, ``plain_ms`` and
    ``library_ms`` are device time (``device_ms``); the ``*_wall_ms`` keys
    are CUDA-event time of back-to-back calls, which includes the host's
    launch overhead whenever the host is slower than the card."""
    w, m = case.clones()
    lrs, wds = [0.1] * len(w), [1e-4] * len(w)
    rescale = 1.0 / RESNET_BATCH
    groups = _groups(len(w), AGG)

    def kernel(gs):
        for idx in gs:
            sub = ([w[i] for i in idx], [case.g[i] for i in idx])
            if momentum:
                multi_sgd_mom(*sub, [m[i] for i in idx], lrs[:len(idx)],
                              wds[:len(idx)], 0.9, rescale)
            else:
                multi_sgd(*sub, lrs[:len(idx)], wds[:len(idx)], rescale)

    def plain():
        if momentum:
            multi_sgd_mom_plain(w, case.g, m, lrs, wds, 0.9, rescale)
        else:
            multi_sgd_plain(w, case.g, lrs, wds, rescale)

    params = [torch.nn.Parameter(t.clone()) for t in case.w]
    for p, g in zip(params, case.g):
        p.grad = g
    lib = torch.optim.SGD(params, lr=0.1, momentum=0.9 if momentum else 0.0,
                          weight_decay=1e-4, fused=True)
    one_group = [list(range(len(w)))]
    before = multi_sgd.launches + multi_sgd_mom.launches
    row = {"wall_ms": cuda_ms(lambda: kernel(groups), iters)}
    row["launches_per_update"] = (multi_sgd.launches + multi_sgd_mom.launches
                                  - before) / (iters + 3)
    row.update(
        ms=device_ms(lambda: kernel(groups), 5),
        one_group_ms=device_ms(lambda: kernel(one_group), 5),
        one_group_wall_ms=cuda_ms(lambda: kernel(one_group), iters),
        plain_ms=device_ms(plain, 5), plain_wall_ms=cuda_ms(plain, iters),
        library_ms=device_ms(lib.step, 5),
        library_wall_ms=cuda_ms(lib.step, iters))
    bound_ms, nbytes = sgd_bound(case.n, momentum)
    row.update(bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
               elements=case.n, tensors=len(w))
    return row


def sgd_kernel_phase(seed: int):
    """Both multi-tensor SGD kernels against their plain versions on
    ResNet-50's and the MLP's trainable shapes and on odd, misaligned ones;
    their times at ResNet-50's and the MLP's shapes."""
    gen = torch.Generator(device=gpu(0)).manual_seed(seed)
    resnet = SgdCase(gen, resnet50_trainable_shapes())
    odd_shapes = [(1,), (3,), (7, 5), (1023,), (4097,), (8191,), (8193,),
                  (3, 33333)] * 9
    mlp = SgdCase(gen, MLP_SHAPES)
    cases = [(resnet, "resnet50", (AGG, 161), RESNET_BATCH),
             (mlp, "mlp", (AGG,), MLP_BATCH),
             (SgdCase(gen, odd_shapes), "odd x72", (AGG, 72), RESNET_BATCH),
             (SgdCase(gen, odd_shapes, offset=1), "odd x72 misaligned",
              (AGG, 72), RESNET_BATCH)]
    checks = []
    for momentum in (False, True):
        for case, name, groups, batch in cases:
            for group in groups:
                for clip in (-1.0, 0.5):
                    err, launches, want = check_sgd(
                        case, momentum, group, clip, 1.0 / batch)
                    checks.append({
                        "kernel": "multi_sgd_mom" if momentum
                        else "multi_sgd", "case": name, "group": group,
                        "clip": clip, "rescale": 1.0 / batch,
                        "launches": launches, "expected_launches": want,
                        "max_abs_err": err})
    bad = [c for c in checks if not c["max_abs_err"] <= SGD_TOL
           or c["launches"] != c["expected_launches"]]
    times = {"multi_sgd_mlp": time_sgd(mlp, False, iters=200),
             "multi_sgd_resnet50": time_sgd(resnet, False, iters=20),
             "multi_sgd_mom_resnet50": time_sgd(resnet, True, iters=20)}
    return {"checks": checks, "failed": bad, "times": times}


def mlp_phase(seed: int):
    """Config #1: the 784-128-64-10 MLP trained by plain SGD on one seeded
    batch; the plain-SGD kernel must launch exactly twice per step (6
    parameters in groups of 4)."""
    dev = gpu(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu", in_units=784),
            nn.Dense(64, activation="relu", in_units=128),
            nn.Dense(10, in_units=64))
    net.initialize(ctx=dev, seed=seed)
    net.hybridize()
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((MLP_BATCH, 784),
                                            dtype=np.float32), device=dev)
    y = torch.as_tensor(rng.integers(0, 10, MLP_BATCH).astype(np.float32),
                        device=dev)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    for _ in range(MLP_STEPS):
        with autograd.record():
            loss = lossfn(net(x), y)
        autograd.backward(loss)
        trainer.step(MLP_BATCH)
        losses.append(loss.detach().mean())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = multi_sgd.launches
    other = multi_sgd_mom.launches + flash_attention.launches
    losses = [v.item() for v in losses]
    return {"steps": MLP_STEPS, "batch": MLP_BATCH, "launches": launches,
            "other_kernel_launches": other,
            "losses": losses, "step_ms": wall / MLP_STEPS * 1e3,
            "ok": launches == 2 * MLP_STEPS and other == 0
            and losses[-1] < losses[0]
            and all(math.isfinite(v) for v in losses)}


def _device_classes(prof, wall_ms):
    """Device time of one profiled step by kernel class, and its idle
    share of the step's wall time."""
    classes = {"conv_gemm": 0.0, "batchnorm": 0.0, "elementwise": 0.0,
               "multi_sgd_mom": 0.0, "memcpy": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        if "multi_sgd" in name:
            cls = "multi_sgd_mom"
        elif "memcpy" in name or "memset" in name:
            cls = "memcpy"
        elif any(w in name for w in ("conv", "gemm", "xmma", "cutlass",
                                     "sm90", "implicit", "winograd",
                                     "fft", "wgrad", "dgrad", "fprop")):
            cls = "conv_gemm"
        elif any(w in name for w in ("bn_", "batch_norm", "batchnorm")):
            cls = "batchnorm"
        elif any(w in name for w in ("elementwise", "reduce", "softmax",
                                     "foreach")):
            cls = "elementwise"
        else:
            cls = "other"
        ms = e.self_device_time_total / 1e3
        classes[cls] += ms
        top.append((ms, e.key[:90], e.count))
    busy = sum(classes.values())
    top.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_ms": classes,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top_kernels": [{"ms": t, "name": n, "calls": c}
                            for t, n, c in top[:12]]}


def _snapshot(net):
    return {k: p.data().detach().clone()
            for k, p in net.collect_params().items()}


def _max_diff(a, b):
    """Max-abs difference of two snapshots of one architecture, parameter
    by parameter in order (instance prefixes may differ)."""
    return max((x.float().cpu() - y.float().cpu()).abs().max().item()
               for x, y in zip(a.values(), b.values()))


def one_step(model, x, y, lossfn):
    """One Trainer step of ``model`` at the ResNet recipe; returns the
    loss (float64, on the CPU) and the updated parameters."""
    tr = gluon.Trainer(model.collect_params(), "sgd", RESNET_OPT)
    with autograd.record():
        loss = lossfn(model(x), y)
    autograd.backward(loss)
    tr.step(x.shape[0])
    return loss.detach().cpu().double(), _snapshot(model)


def leaf_check(run, cpu32, cpu64, init):
    """Each leaf's error against the float64 step, as a share of the
    leaf's change in that step (L2 norms): ``run``'s share must be at most
    ``LEAF_K`` times the CPU fp32 run's + ``LEAF_FLOOR``.  A fault in one
    leaf's gradient or statistics shows as a share near 1 in that leaf;
    fp32 rounding gives ~1e-6 where the step is well conditioned and up to
    the CPU's own share where it is not.  Snapshots are of one
    architecture, matched parameter by parameter in order; names from
    ``init``."""
    rows = []
    for name, r, c, ref, w0 in zip(init, run.values(), cpu32.values(),
                                   cpu64.values(), init.values()):
        ref = ref.double().cpu()
        change = (ref - w0.double().cpu()).norm().item()
        share = [(t.double().cpu() - ref).norm().item() / change
                 if change > 0 else math.inf for t in (r, c)]
        rows.append({"leaf": name, "run": share[0], "cpu": share[1],
                     "limit": LEAF_K * share[1] + LEAF_FLOOR})
    bad = [r for r in rows if not r["run"] <= r["limit"]]
    cpu_shares = sorted(r["cpu"] for r in rows)
    return {
        "ok": not bad, "leaves": len(rows), "failed": bad,
        "tight": sum(r["limit"] <= 10 * LEAF_FLOOR for r in rows),
        "cpu_share_median": cpu_shares[len(rows) // 2],
        "worst_cpu": sorted(rows, key=lambda r: -r["cpu"])[:6],
        "worst_margin": sorted(rows, key=lambda r: r["limit"]
                               - r["run"])[:6]}


def resnet_phase(seed: int, card: str):
    """Config #2: ResNet-50 v1 at batch 128 through gluon.Trainer."""
    from torch.profiler import ProfilerActivity, profile
    dev = gpu(0)
    net = resnet50_v1(classes=1000)
    net.initialize(Xavier("gaussian", "in", 2), ctx=dev, seed=seed)
    net.hybridize()
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(RESNET_BATCH, 3, 224, 224, device=dev, generator=gen)
    y = torch.randint(0, 1000, (RESNET_BATCH,), device=dev,
                      generator=gen).float()
    params = net.collect_params()
    w_init = _snapshot(net)
    trainer = gluon.Trainer(params, "sgd", RESNET_OPT)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(tr, xb, yb):
        with autograd.record():
            loss = lossfn(net(xb), yb)
        autograd.backward(loss)
        tr.step(xb.shape[0])
        return loss.detach().mean()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = [step(trainer, x, y) for _ in range(RESNET_WARM)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses += [step(trainer, x, y) for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = multi_sgd_mom.launches
    other = multi_sgd.launches + flash_attention.launches
    steps = RESNET_WARM + RESNET_STEPS
    losses = [v.item() for v in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainable = [p for p in params.values() if p.grad_req != "null"]
    groups = -(-len(trainable) // AGG)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.monotonic()
        step(trainer, x, y)
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t1) * 1e3
    breakdown = _device_classes(prof, prof_wall_ms)

    # the aggregated update against the per-tensor one, from the same
    # weights and gradients
    w0 = _snapshot(net)
    with autograd.record():
        loss = lossfn(net(x), y)
    autograd.backward(loss)
    grads = {p.name: p.grad().clone() for p in trainable}
    results = []
    for agg in (AGG, 0):
        with torch.no_grad():
            for k, p in params.items():
                p.data().copy_(w0[k])
        for p in trainable:
            p.grad().copy_(grads[p.name])
            p.fresh = False
        tr = gluon.Trainer(params, "sgd", RESNET_OPT)
        tr.optimizer.aggregate_num = agg
        tr.step(RESNET_BATCH)
        results.append(_snapshot(net))
    torch.cuda.synchronize()
    agg_vs_per_tensor = _max_diff(*results)

    # one step at batch 2 from the initial weights on the card, on the CPU
    # in fp32 and on the CPU in float64 (the arbiter)
    arrays = {k: v.cpu().numpy() for k, v in w_init.items()}
    load_reference_params(net, arrays, ctx=dev)
    xb, yb = x[:CPU_CHECK_BATCH], y[:CPU_CHECK_BATCH]
    after = {"card": one_step(net, xb, yb, lossfn)}
    for name, dtype in (("cpu", torch.float32), ("cpu64", torch.float64)):
        model = resnet50_v1(classes=1000)
        load_reference_params(model, arrays, ctx=cpu())
        after[name] = one_step(model.to(dtype), xb.cpu().to(dtype),
                               yb.cpu(), lossfn)
    cpu_loss_err = (after["card"][0] - after["cpu"][0]).abs().max().item()
    cpu_weight_err = _max_diff(after["card"][1], after["cpu"][1])
    leaves = leaf_check(after["card"][1], after["cpu"][1],
                        after["cpu64"][1], w_init)
    ok = (launches == groups * steps and other == 0
          and all(math.isfinite(v) for v in losses)
          and agg_vs_per_tensor <= SGD_TOL and cpu_loss_err <= 1e-4
          and leaves["ok"])
    return {
        "card": card, "batch": RESNET_BATCH, "warm_steps": RESNET_WARM,
        "timed_steps": RESNET_STEPS, "trainable_params": len(trainable),
        "launches": launches, "launches_per_step": launches / steps,
        "other_kernel_launches": other,
        "expected_launches_per_step": groups, "losses": losses,
        "images_per_s": RESNET_BATCH * RESNET_STEPS / wall,
        "step_ms": wall / RESNET_STEPS * 1e3, "peak_memory_gb": peak_gb,
        "profile": breakdown,
        "aggregated_vs_per_tensor_max_abs": agg_vs_per_tensor,
        "cpu_check_batch": CPU_CHECK_BATCH,
        "cpu_check_loss_abs_err": cpu_loss_err,
        "cpu_check_weight_max_abs": cpu_weight_err,
        "cpu_check_leaves": leaves, "ok": ok}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/chip_smoke")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  [{name}] {line.strip()}")

    rows = kernel_phase(args.seed)
    for r in rows:
        print("flash", json.dumps(r), flush=True)

    serving = serve_phase(args.seed, N_REQUESTS, card)
    print(f"serving on {card}: {serving['requests']} requests in "
          f"{serving['batches']} batches, p50 "
          f"{serving['latency_ms_p50']:.3f} ms, p99 "
          f"{serving['latency_ms_p99']:.3f} ms, "
          f"{serving['requests_per_s']:.3f} requests/s, peak memory "
          f"{serving['peak_memory_gb']:.3f} GB")
    print(f"stats on {card}:", json.dumps(serving["stats"]))
    print(f"profile on {card}:", json.dumps(serving["profile"]))

    sgd = sgd_kernel_phase(args.seed)
    for c in sgd["checks"]:
        print("sgd check", json.dumps(c), flush=True)
    for name, t in sgd["times"].items():
        print(f"sgd time {name} on {card}:", json.dumps(t), flush=True)

    mlp = mlp_phase(args.seed)
    print(f"mlp on {card}:", json.dumps(mlp), flush=True)
    resnet = resnet_phase(args.seed, card)
    print(f"resnet50 on {card}: {resnet['images_per_s']:.1f} images/s, "
          f"step {resnet['step_ms']:.2f} ms, peak memory "
          f"{resnet['peak_memory_gb']:.2f} GB, "
          f"{resnet['launches_per_step']} momentum launches per step")
    print(f"resnet50 on {card}:", json.dumps(resnet), flush=True)

    main_row = next(r for r in rows if r["case"].startswith(
        "bert_base B=8 L=512 float32"))
    # each SGD kernel's error at the shapes of its main path
    sgd_err = {k: max(c["max_abs_err"] for c in sgd["checks"]
                      if c["kernel"] == k and c["case"] == case)
               for k, case in (("multi_sgd", "mlp"),
                               ("multi_sgd_mom", "resnet50"))}

    def sgd_row(name, replaces, launches, t):
        return {"name": name, "route": "cuda", "source": SGD_SRC,
                "replaces": replaces, "launches": launches,
                "max_abs_err": sgd_err[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": f"{t['tensors']} tensors, {t['elements']} fp32"}

    kernels = [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU, "launches": serving["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "shape": main_row["case"],
    }, sgd_row("multi_sgd", SGD_TPU, mlp["launches"],
               sgd["times"]["multi_sgd_mlp"]),
        sgd_row("multi_sgd_mom", SGD_MOM_TPU, resnet["launches"],
                sgd["times"]["multi_sgd_mom_resnet50"])]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_logs": logs, "flash": rows,
         "serving": serving, "sgd": sgd, "mlp": mlp, "resnet50": resnet,
         "kernels": kernels}, indent=1))
    failed = [f"sgd kernel checks {sgd['failed']}"] if sgd["failed"] else []
    failed += [f"{name} phase" for name, ph in (("mlp", mlp),
                                                ("resnet50", resnet))
               if not ph["ok"]]
    if failed:
        print(f"chip_smoke: failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
