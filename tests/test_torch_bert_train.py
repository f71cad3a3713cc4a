"""BERT pretraining (config #3's recipe at ``bert_small`` size) in the port
held against the JAX package: ``bert_small(dropout=0.0)``, the MLM + NSP
loss of ``chip_smoke.mlm_nsp_loss`` built from each package's ``nd`` ops,
``autograd.record`` -> ``backward`` -> ``gluon.Trainer("adam", lr 1e-4)``,
3 steps on one batch of ``chip_smoke.bert_batch`` (B=2, S=32), from the
JAX package's initialised weights (``load_reference_params``).

The JAX side runs with ``MXNET_ATTENTION_KERNEL=flash`` (its Pallas kernel
in interpret mode, its custom VJP backward); the port with ``auto`` (the
flash path: the kernel's plain version on the CPU and the chunked torch
backward).  Each JAX run sits in a module-scoped fixture (~20 s each).

Bounds, fp32: each step's loss to 1e-5 relative; each leaf's gradient at
step 1 to ``max|Δ| <= 1e-4 * max|g_jax| + 1e-6``; each leaf's weights after
step 3 to ``1e-4 * max|w_jax| + 1e-6``.  bf16 AMP (``amp.init("bfloat16")``
on both sides): losses to 1e-3 relative and step-1 gradients to 0.1 of
each leaf's max|g_jax| (readings at ``AMP_LOSS_RTOL``), the first
forward's casts op for op as the JAX package's dispatch hook makes them,
the MLM logits bf16 in both, every parameter and gradient fp32 in both.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as mx
from mxnet_tpu.contrib import amp as jax_amp
from mxnet_tpu.gluon.model_zoo import transformer as jax_tf
from mxnet_tpu.ndarray import register as jax_register
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params, nd
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.contrib.amp import amp as amp_policy
from mxnet_tpu_torch.gluon.model_zoo import transformer as port_tf
from mxnet_tpu_torch.kernels.flash_attention import \
    flash_attention as flash_kernel

B, S, VOCAB, STEPS, LR = 2, 32, 1000, 3, 1e-4
REF_PREFIX = "bertmodel98_"
INIT_SEED = 0            # the JAX package's initial weights
# AMP bounds, from readings at INIT_SEED 0, 1, 2 (port vs JAX, both AMP):
# losses 1.4e-4 - 2.2e-4 relative, step-1 gradients 0.039 - 0.048 of a
# leaf's max|g|.  The port's fp32 run sits as close to the JAX AMP run
# (losses 1.9e-4 - 3.5e-4, gradients 0.037 - 0.048): at this size bf16
# moves the numbers no further than two roundings of it differ, so the
# cast policy is held op for op by its trace instead.
AMP_LOSS_RTOL, AMP_GRAD_SHARE = 1e-3, 0.1
# the ops at which the port casts under AMP (``amp.cast``'s call sites)
CAST_POINTS = {"FullyConnected", "Convolution", "batch_dot", "softmax",
               "LayerNorm", "log_softmax", "sum", "mean"}


def _batch(seed=0):
    return chip_smoke.bert_batch(seed, B, S, VOCAB)


def _jax_nd(batch):
    inputs, segs, vl, labels, weights, nsp_y = batch
    return (mx.nd.array(inputs, dtype="int32"), mx.nd.array(segs,
                                                             dtype="int32"),
            mx.nd.array(vl), mx.nd.array(labels, dtype="int32"),
            mx.nd.array(weights), mx.nd.array(nsp_y, dtype="int32"))


def _casts(log, name, inputs):
    """Append (op, dtypes of its inputs after the AMP casts) to ``log``
    for an op of ``CAST_POINTS``."""
    if name in CAST_POINTS:
        log.append((name, tuple(str(getattr(x, "dtype", None)).replace(
            "torch.", "") for x in inputs)))


def _jax_run(bf16: bool, dropout=0.0, steps=STEPS):
    """Initial weights, per-step losses, step-1 gradients, final weights,
    the MLM logits' dtype, the parameters' dtypes, by name without the
    prefix, and (under AMP) the first step's forward casts."""
    casts = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_ATTENTION_KERNEL", "flash")
        mp.delenv("MXNET_USE_FLASH_ATTENTION", raising=False)
        if bf16:
            jax_amp.init("bfloat16")
            hook = jax_register._invoke_hook

            def logged(name, inputs):
                inputs = hook(name, inputs)
                if not casts or casts[-1] is not None:
                    _casts(casts, name, inputs)
                return inputs
            jax_register.set_invoke_hook(logged)
        try:
            mx.random.seed(INIT_SEED)
            ref = jax_tf.bert_small(dropout=dropout, prefix=REF_PREFIX)
            ref.initialize()
            params = ref.collect_params()

            def by_name(fn):
                return {k[len(REF_PREFIX):]: fn(p) for k, p in
                        params.items()}

            init = by_name(lambda p: p.data().asnumpy())
            tr = mx.gluon.Trainer(params, "adam", {"learning_rate": LR})
            x = _jax_nd(_batch())
            losses, grads, mlm_dtype = [], None, None
            for _ in range(steps):
                with mx.autograd.record():
                    mlm, nsp = ref(*x[:3])
                    loss = chip_smoke.mlm_nsp_loss(mlm, nsp, *x[3:],
                                                   F=mx.nd)
                casts.append(None)          # the first forward ends
                loss.backward()
                if grads is None:
                    grads = by_name(lambda p: p.grad().asnumpy())
                    mlm_dtype = str(mlm.dtype)
                tr.step(1)
                losses.append(float(loss.asnumpy()))
            final = by_name(lambda p: p.data().asnumpy())
        finally:
            jax_amp.disable()
    return {"init": init, "losses": losses, "grads": grads,
            "final": final, "mlm_dtype": mlm_dtype,
            "param_dtypes": {str(v.dtype) for v in final.values()},
            "casts": casts[:casts.index(None)]}


def _port_run(init, bf16: bool, steps=STEPS):
    net = port_tf.bert_small(dropout=0.0)
    load_reference_params(net, {REF_PREFIX + k: v for k, v in init.items()},
                          ctx=cpu())
    params = net.collect_params()

    def by_name(fn):
        return {k[len(net.prefix):]: fn(p) for k, p in params.items()}

    casts = []
    cast = amp_policy.cast

    def logged(name, *inputs):
        inputs = cast(name, *inputs)
        if not casts or casts[-1] is not None:
            _casts(casts, name, inputs)
        return inputs

    if bf16:
        amp.init("bfloat16")
    try:
        tr = gluon.Trainer(params, "adam", {"learning_rate": LR})
        x = [torch.as_tensor(a) for a in _batch()]
        losses, grads, mlm_dtype = [], None, None
        for _ in range(steps):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(amp_policy, "cast", logged)
                with autograd.record():
                    mlm, nsp = net(*x[:3])
                    loss = chip_smoke.mlm_nsp_loss(mlm, nsp, *x[3:])
            casts.append(None)              # the first forward ends
            autograd.backward(loss)
            if grads is None:
                grads = by_name(lambda p: p._grad_tensor().detach().clone())
                mlm_dtype = str(mlm.dtype).replace("torch.", "")
            tr.step(1)
            losses.append(loss.item())
        state_dtypes = {str(t.dtype) for st in tr._states.values()
                        for t in st}
    finally:
        amp.disable()
    final = by_name(lambda p: p._tensor().detach().clone())
    return {"losses": losses, "mlm_dtype": mlm_dtype,
            "grads": {k: g.numpy() for k, g in grads.items()},
            "grad_dtypes": {str(g.dtype) for g in grads.values()},
            "final": {k: w.numpy() for k, w in final.items()},
            "param_dtypes": {str(w.dtype) for w in final.values()},
            "state_dtypes": state_dtypes,
            "casts": casts[:casts.index(None)]}


@pytest.fixture(scope="module")
def fp32_runs():
    ref = _jax_run(bf16=False)
    return ref, _port_run(ref["init"], bf16=False)


@pytest.fixture(scope="module")
def amp_runs():
    ref = _jax_run(bf16=True)
    return ref, _port_run(ref["init"], bf16=True)


def _leaf_bound(port, ref, share=1e-4):
    """Leaves whose max-abs difference exceeds ``share * max|ref| +
    1e-6``, with their error and limit."""
    assert port.keys() == ref.keys()
    bad = {}
    for k, r in ref.items():
        err = float(np.abs(port[k] - r).max())
        limit = share * float(np.abs(r).max()) + 1e-6
        if not err <= limit:
            bad[k] = (err, limit)
    return bad


def test_fp32_losses_match(fp32_runs):
    ref, port = fp32_runs
    assert len(port["losses"]) == STEPS
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    assert port["losses"][-1] < port["losses"][0]


def test_fp32_step1_gradients_match_leaf_by_leaf(fp32_runs):
    ref, port = fp32_runs
    assert len(ref["grads"]) == len(port["grads"]) > 30
    assert _leaf_bound(port["grads"], ref["grads"]) == {}


def test_fp32_weights_after_three_steps_match(fp32_runs):
    ref, port = fp32_runs
    assert _leaf_bound(port["final"], ref["final"]) == {}
    moved = max(float(np.abs(ref["final"][k] - ref["init"][k]).max())
                for k in ref["init"])
    assert moved > 1e-5


def test_amp_losses_dtypes_and_fp32_weights(amp_runs, fp32_runs):
    ref, port = amp_runs
    np.testing.assert_allclose(port["losses"], ref["losses"],
                               rtol=AMP_LOSS_RTOL)
    assert ref["mlm_dtype"] == port["mlm_dtype"] == "bfloat16"
    assert ref["param_dtypes"] == {"float32"}
    assert port["param_dtypes"] == port["grad_dtypes"] == \
        port["state_dtypes"] == {"torch.float32"}
    assert {str(g.dtype) for g in ref["grads"].values()} == {"float32"}
    # AMP moved the numbers: the bf16 run is not the fp32 run
    assert port["losses"] != fp32_runs[1]["losses"]


def test_amp_casts_match_the_reference_op_for_op(amp_runs):
    """Under AMP the first forward's cast points, in order, cast their
    inputs to the dtypes the JAX package's dispatch hook casts the same
    ops' inputs to: every FullyConnected bf16 (the MLM decoder's tied
    weight included), LayerNorm, log_softmax, sum and mean fp32.  A run
    without AMP, or a policy that moves one of these ops to another list,
    fails here; the losses and gradients below cannot tell them apart."""
    ref, port = amp_runs
    assert port["casts"] == ref["casts"]
    assert ("FullyConnected", ("bfloat16",) * 3) in port["casts"]
    assert ("log_softmax", ("float32",)) in port["casts"]


def test_amp_step1_gradients_match_leaf_by_leaf(amp_runs):
    """Step 1's gradients under AMP, leaf by leaf, within
    ``AMP_GRAD_SHARE`` of each leaf's max|g_jax|: both sides round the
    same bf16 GEMM operands, but their elementwise ops (gelu, the
    Dense bias add) round differently in bf16."""
    ref, port = amp_runs
    assert len(port["grads"]) == len(ref["grads"]) > 30
    assert _leaf_bound(port["grads"], ref["grads"], AMP_GRAD_SHARE) == {}


def test_record_without_train_mode_takes_masked_softmax(monkeypatch):
    """A block with attention dropout, recording in predict mode
    (``record(train_mode=False)``): both packages leave the flash path
    (the reference's condition is ``is_recording() or is_training()``),
    the port calls its flash op 0 times, and its outputs agree with the
    reference's masked softmax."""
    calls = []
    real = port_tf.flash_attention
    monkeypatch.setattr(port_tf, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_ATTENTION_KERNEL", "flash")
        mp.delenv("MXNET_USE_FLASH_ATTENTION", raising=False)
        ref = jax_tf.bert_small(dropout=0.1, prefix=REF_PREFIX)
        ref.initialize()
        x = _jax_nd(_batch(1))
        with mx.autograd.record(train_mode=False):
            want = [o.asnumpy() for o in ref(*x[:3])]
    port = port_tf.bert_small(dropout=0.1)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()}, ctx=cpu())
    xs = [torch.as_tensor(a) for a in _batch(1)]
    before = flash_kernel.launches
    with autograd.record(train_mode=False):
        got = [o.detach().numpy() for o in port(*xs[:3])]
    assert calls == [] and flash_kernel.launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
    # outside record and training, the same block takes the flash path
    with torch.no_grad():
        port(*xs[:3])
    assert len(calls) == 2
