"""BERT pretraining under ``amp.init("float16")`` (BASELINE config #3 is
"fp16 mixed-precision") in the port held against the JAX package:
``bert_small(dropout=0.0)`` from the JAX package's weights, the MLM + NSP
loss of ``chip_smoke.mlm_nsp_loss``, ``gluon.Trainer("adam", lr 1e-4)``
with ``amp.init_trainer``, ``amp.scale_loss`` and ``amp.unscale``, two
steps on one batch of ``chip_smoke.bert_batch`` (B=2, S=32).

The JAX side runs its Pallas flash kernel in interpret mode on fp16
q/k/v (``MXNET_ATTENTION_KERNEL=flash``); the port the flash path's plain
version and the chunked backward, which accumulates in fp32 and returns
fp16 gradients.  The loss scaler starts at 2**40 with a factor of 2**30:
the first step's fp16 gradients overflow in both packages and the step
is skipped, the scale falls to 2**10, and the second step applies.

Bounds: the first forward's casts op for op as the JAX package's dispatch
hook makes them (every FullyConnected fp16, LayerNorm, log_softmax, sum
and mean fp32); the skip decisions and scales equal; no weight moves in
the skipped step; losses within 1e-3 relative and the second step's
gradients (unscaled) within 0.02 of each leaf's max|g_jax| (readings:
losses 1.2e-5 relative, gradients 0.0019; fp16 rounds
GEMM operands to 11 significant bits, bf16 to 8: the bf16 bounds of
``tests/test_torch_bert_train.py`` are 1e-3 and 0.1); parameters,
gradients and Adam states fp32.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as mx
from mxnet_tpu.contrib import amp as jax_amp
from mxnet_tpu.contrib.amp.loss_scaler import DynamicLossScaler as JaxScaler
from mxnet_tpu.gluon.model_zoo import transformer as jax_tf
from mxnet_tpu.ndarray import register as jax_register
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.contrib.amp import amp as amp_policy
from mxnet_tpu_torch.contrib.amp.loss_scaler import DynamicLossScaler
from mxnet_tpu_torch.gluon.model_zoo import transformer as port_tf

B, S, VOCAB, LR = 2, 32, 1000, 1e-4
REF_PREFIX = "bertmodel97_"
SCALER = {"init_scale": 2.0 ** 40, "scale_factor": 2.0 ** 30}
CAST_POINTS = {"FullyConnected", "Convolution", "batch_dot", "softmax",
               "LayerNorm", "log_softmax", "sum", "mean"}
LOSS_RTOL, GRAD_SHARE = 1e-3, 0.02


@pytest.fixture(autouse=True)
def _amp_off_after():
    try:
        yield
    finally:
        amp.disable()
        jax_amp.disable()


def _casts(log, name, inputs):
    if name in CAST_POINTS:
        log.append((name, tuple(str(getattr(x, "dtype", None)).replace(
            "torch.", "") for x in inputs)))


def _batch():
    return chip_smoke.bert_batch(0, B, S, VOCAB)


def _jax_run():
    casts, record = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_ATTENTION_KERNEL", "flash")
        mp.delenv("MXNET_USE_FLASH_ATTENTION", raising=False)
        jax_amp.init("float16")
        hook = jax_register._invoke_hook

        def logged(name, inputs):
            inputs = hook(name, inputs)
            if not record:
                _casts(casts, name, inputs)
            return inputs
        jax_register.set_invoke_hook(logged)
        try:
            mx.random.seed(0)
            ref = jax_tf.bert_small(dropout=0.0, prefix=REF_PREFIX)
            ref.initialize()
            params = ref.collect_params()

            def by_name(fn):
                return {k[len(REF_PREFIX):]: fn(p)
                        for k, p in params.items()}

            init = by_name(lambda p: p.data().asnumpy())
            default = jax_amp.init_trainer(mx.gluon.Trainer(
                params, "adam", {"learning_rate": LR}))
            tr = jax_amp.init_trainer(
                mx.gluon.Trainer(params, "adam", {"learning_rate": LR}),
                JaxScaler(**SCALER))
            inputs, segs, vl, labels, weights, nsp_y = _batch()
            x = (mx.nd.array(inputs, dtype="int32"),
                 mx.nd.array(segs, dtype="int32"), mx.nd.array(vl),
                 mx.nd.array(labels, dtype="int32"), mx.nd.array(weights),
                 mx.nd.array(nsp_y, dtype="int32"))
            for _ in range(2):
                with mx.autograd.record():
                    mlm, nsp = ref(*x[:3])
                    loss = chip_smoke.mlm_nsp_loss(mlm, nsp, *x[3:],
                                                   F=mx.nd)
                with jax_amp.scale_loss(loss, tr) as scaled:
                    scaled.backward()
                scale = tr._amp_loss_scaler.loss_scale
                grads = by_name(lambda p: p.grad().asnumpy() / scale)
                skip = jax_amp.unscale(tr)
                if not skip:
                    tr.step(1)
                record.append({
                    "loss": float(loss.asnumpy()), "skip": skip,
                    "scale": tr._amp_loss_scaler.loss_scale,
                    "grads": grads, "mlm_dtype": str(mlm.dtype),
                    "weights": by_name(lambda p: p.data().asnumpy())})
        finally:
            jax_amp.disable()
    return {"init": init, "steps": record, "casts": casts,
            "default_scale": default._amp_loss_scaler.loss_scale}


def _port_run(init):
    net = port_tf.bert_small(dropout=0.0)
    load_reference_params(net, {REF_PREFIX + k: v for k, v in init.items()},
                          ctx=cpu())
    params = net.collect_params()

    def by_name(fn):
        return {k[len(net.prefix):]: fn(p) for k, p in params.items()}

    casts, record = [], []
    cast = amp_policy.cast

    def logged(name, *inputs):
        inputs = cast(name, *inputs)
        if not record:
            _casts(casts, name, inputs)
        return inputs

    amp.init("float16")
    try:
        default = amp.init_trainer(gluon.Trainer(params, "adam",
                                                 {"learning_rate": LR}))
        tr = amp.init_trainer(gluon.Trainer(params, "adam",
                                            {"learning_rate": LR}),
                              DynamicLossScaler(**SCALER))
        x = [torch.as_tensor(a) for a in _batch()]
        for _ in range(2):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(amp_policy, "cast", logged)
                with autograd.record():
                    mlm, nsp = net(*x[:3])
                    loss = chip_smoke.mlm_nsp_loss(mlm, nsp, *x[3:])
            with amp.scale_loss(loss, tr) as scaled:
                autograd.backward(scaled)
            scale = tr._amp_loss_scaler.loss_scale
            grads = by_name(lambda p: (p.grad() / scale).numpy())
            grad_dtypes = {str(p.grad().dtype) for p in params.values()}
            skip = amp.unscale(tr)
            if not skip:
                tr.step(1)
            record.append({
                "loss": loss.item(), "skip": skip,
                "scale": tr._amp_loss_scaler.loss_scale, "grads": grads,
                "grad_dtypes": grad_dtypes,
                "mlm_dtype": str(mlm.dtype).replace("torch.", ""),
                "weights": by_name(lambda p: p.data().detach().numpy()
                                   .copy())})
        states = {str(t.dtype) for st in tr._states.values() for t in st}
    finally:
        amp.disable()
    return {"steps": record, "casts": casts, "state_dtypes": states,
            "default_scale": default._amp_loss_scaler.loss_scale}


@pytest.fixture(scope="module")
def fp16_runs():
    ref = _jax_run()
    return ref, _port_run(ref["init"])


def test_fp16_casts_match_the_reference_op_for_op(fp16_runs):
    ref, port = fp16_runs
    assert port["casts"] == ref["casts"]
    assert ("FullyConnected", ("float16",) * 3) in port["casts"]
    assert ("log_softmax", ("float32",)) in port["casts"]
    assert ref["steps"][0]["mlm_dtype"] == port["steps"][0]["mlm_dtype"] \
        == "float16"


def test_fp16_loss_scaling_skips_the_overflow_step_as_the_reference(
        fp16_runs):
    """The default scaler starts at 2**16 in both; from 2**40 the first
    step overflows in both, is skipped (no weight moves) and the scale
    falls to 2**10; the second step applies in both."""
    ref, port = fp16_runs
    assert ref["default_scale"] == port["default_scale"] == 2.0 ** 16
    for r, p in zip(ref["steps"], port["steps"]):
        assert (r["skip"], r["scale"]) == (p["skip"], p["scale"])
    assert [p["skip"] for p in port["steps"]] == [True, False]
    assert port["steps"][0]["scale"] == 2.0 ** 10
    first = port["steps"][0]["weights"]
    for k, w in ref["init"].items():
        np.testing.assert_array_equal(first[k], w)
    moved = max(np.abs(port["steps"][1]["weights"][k] - w).max()
                for k, w in ref["init"].items())
    assert moved > 1e-5


def test_fp16_losses_and_gradients_match(fp16_runs):
    ref, port = fp16_runs
    np.testing.assert_allclose([p["loss"] for p in port["steps"]],
                               [r["loss"] for r in ref["steps"]],
                               rtol=LOSS_RTOL)
    g_ref, g_port = ref["steps"][1]["grads"], port["steps"][1]["grads"]
    assert g_ref.keys() == g_port.keys() and len(g_ref) > 30
    bad = {k: float(np.abs(g_port[k] - r).max()) for k, r in g_ref.items()
           if not np.abs(g_port[k] - r).max()
           <= GRAD_SHARE * np.abs(r).max() + 1e-6}
    assert bad == {}


def test_fp16_weights_gradients_and_states_stay_fp32(fp16_runs):
    _, port = fp16_runs
    assert {str(w.dtype) for w in port["steps"][1]["weights"].values()} \
        == {"float32"}
    assert port["steps"][1]["grad_dtypes"] == {"torch.float32"}
    assert port["state_dtypes"] == {"torch.float32"}
