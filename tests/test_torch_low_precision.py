"""Low precision in the port held against the JAX package on the CPU, with
the same numpy inputs: the SGD updates on bf16/fp16 weights and the mixed
(fp32 master) update, ``mp_sgd_update``, ``Parameter.cast`` and
``Block.cast``, BatchNorm on bf16 activations, ``load_reference_params``
of bf16 weights, and one Trainer step of a small ResNet v1 in the two
bf16 recipes (``amp.init("bfloat16")``; ``cast("bfloat16")`` with
``multi_precision``).

Tolerances, stated per test:
- the SGD update in bf16/fp16 against the Pallas kernels (interpret
  mode): each momentum within 2 ulp of its dtype at the scale of its
  operands (max of |mu m|, |lr (c + wd w)| and the result), each weight
  within 2 ulp at the scale of |w|, |m'| and the result, plus the
  momentum's own difference, which w' = w + m' carries.  The JAX package
  rounds every operation to bf16/fp16, the port once at the end;
- the mixed update: masters and momenta within 1e-6 relative (fp32, the
  same operations), each weight exactly its master rounded;
- BatchNorm: 2 ulp of bf16 at the output's scale (the JAX op normalises
  op by op in bf16, ``F.batch_norm`` in fp32 with one rounding);
- the small ResNet's bf16 step: each leaf's distance from the JAX
  package's step at most 4x the JAX step's own distance from the exact
  (float64) step + 1e-3 of the leaf's change, and the losses likewise
  (at batch 8, 64x64, the bf16 steps of the two packages sit 0.6-1.6x
  their own error apart, seeds 0-2).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import amp as jax_amp
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu_torch import (autograd, cpu, gluon, load_reference_params,
                             optimizer)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as port_resnet
from mxnet_tpu_torch.ndarray import ops_optimizer as ops

ms = importlib.import_module("mxnet_tpu_torch.kernels.multi_sgd")

SHAPES = [(3, 5), (1000,), (17, 9, 2), (1,), (128, 128)]
WDS = [0.0, 0.01, 0.1, 0.0, 0.001]
# torch dtype, jnp dtype, significant bits, least normal exponent
LOW = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 8, -126),
       "float16": (torch.float16, jnp.float16, 11, -14)}


@pytest.fixture(autouse=True)
def _amp_off_after():
    try:
        yield
    finally:
        amp.disable()
        jax_amp.disable()


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's Pallas kernels themselves, in interpret mode."""
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")


def _ulp(x, name):
    """One ulp of ``name`` (bfloat16/float16) at the magnitude |x|."""
    _, _, bits, emin = LOW[name]
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, np.maximum(e - 1, emin) - (bits - 1))


def _f(x):
    """float64 numpy of a torch tensor or a jax/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _low_set(name, seed, scale_m=0.1):
    dt, jdt = LOW[name][:2]
    rng = np.random.default_rng(seed)
    w, g, m = ([torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                 * k).to(dt) for s in SHAPES]
               for k in (1.0, 2.0, scale_m))
    return w, g, m, [[jnp.asarray(t.float().numpy()).astype(jdt)
                      for t in ts] for ts in (w, g, m)]


# ------------------------------------------------------------- SGD update

@pytest.mark.parametrize("clip", [-1.0, 0.7])
@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_sgd_update_on_low_precision_weights_matches_pallas_kernel(
        pallas_interpret, name, momentum, clip):
    """``multi_sgd(_mom)`` on bf16/fp16 w, g, m (the plain version, the
    CPU path) against ``fused_multi_sgd(_mom)`` on the same values, lr
    0.1, rescale 0.5, momentum 0.9: see the module docstring."""
    from mxnet_tpu.kernels import fused_multi_sgd, fused_multi_sgd_mom
    w, g, m, (jw, jg, jm) = _low_set(name, 11)
    lrs = [0.1] * len(SHAPES)
    pw, pm = [t.clone() for t in w], [t.clone() for t in m]
    if momentum:
        ms.multi_sgd_mom(pw, g, pm, lrs, WDS, 0.9, 0.5, clip)
        jw_out, jm_out = fused_multi_sgd_mom(jw, jg, jm, lrs, WDS,
                                             momentum=0.9, rescale_grad=0.5,
                                             clip_gradient=clip)
    else:
        ms.multi_sgd(pw, g, lrs, WDS, 0.5, clip)
        jw_out = fused_multi_sgd(jw, jg, lrs, WDS, rescale_grad=0.5,
                                 clip_gradient=clip)
    for i, wd in enumerate(WDS):
        assert pw[i].dtype == w[i].dtype
        c = np.abs(_f(g[i])) * 0.5
        if clip > 0:
            c = np.minimum(c, clip)
        step = 0.1 * (c + wd * np.abs(_f(w[i])))
        dm = 0.0
        scale_w = [np.abs(_f(w[i])), step]
        if momentum:
            a, b = _f(pm[i]), _f(jm_out[i])
            scale_m = np.maximum.reduce([0.9 * np.abs(_f(m[i])), step,
                                         np.abs(a), np.abs(b)])
            dm = np.abs(a - b)
            assert (dm <= 2 * _ulp(scale_m, name)).all(), i
            scale_w = [np.abs(_f(w[i])), np.abs(a), np.abs(b)]
        a, b = _f(pw[i]), _f(jw_out[i])
        scale = np.maximum.reduce(scale_w + [np.abs(a), np.abs(b)])
        assert (np.abs(a - b) <= 2 * _ulp(scale, name) + dm).all(), i


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_lr_rounding_to_the_weight_dtype_shows(pallas_interpret, name):
    """lr 0.1 is 0.10009765625 in bf16 and 0.0999755859375 in fp16.  On the
    gradients in [1, 2) where that rounding changes round(lr g) (w = 0,
    wd = 0, rescale 1, so each package rounds once), the port's update is
    the JAX kernel's bit for bit, and not what an fp32 lr would give."""
    from mxnet_tpu.kernels import fused_multi_sgd
    dt, jdt, bits, _ = LOW[name]
    g = 1.0 + torch.arange(2 ** (bits - 1), dtype=torch.float64) \
        / 2 ** (bits - 1)
    lr = ms.round_scalar(0.1, dt)
    fp32_lr = (-(g.float() * np.float32(0.1))).to(dt)
    crafted = g[(-(g * lr)).to(dt) != fp32_lr].to(dt)
    assert lr != np.float32(0.1) and crafted.numel() > 0
    w = [torch.zeros_like(crafted)]
    ms.multi_sgd(w, [crafted], [0.1], [0.0])
    want = fused_multi_sgd([jnp.zeros(crafted.shape, jdt)],
                           [jnp.asarray(crafted.float().numpy()).astype(jdt)],
                           [0.1], [0.0])[0]
    np.testing.assert_array_equal(_f(w[0]), _f(want))
    assert (w[0] != (-(crafted.float() * np.float32(0.1))).to(dt)).all()


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_mixed_update_matches_multi_mp_sgd_mom_update(name):
    """``multi_mp_sgd_mom_update`` (the mixed path's plain version) against
    the JAX op: masters and momenta within 1e-6 relative, every weight
    exactly its master rounded, and within one ulp of the JAX weight."""
    dt = LOW[name][0]
    w, g, m, _ = _low_set(name, 12)
    m = [t.float() for t in m]
    w32 = [t.float() + 1e-3 for t in w]          # masters ahead of w
    lrs = [0.1, 0.2, 0.3, 0.4, 0.05]
    pw, pm, p32 = ([t.clone() for t in ts] for ts in (w, m, w32))
    data = [t for quad in zip(pw, g, pm, p32) for t in quad]
    out = ops.multi_mp_sgd_mom_update(*data, lrs, WDS, momentum=0.9,
                                      rescale_grad=0.5, clip_gradient=0.7,
                                      num_weights=len(SHAPES))
    assert all(o is t for o, t in zip(out, [t for trio in zip(pw, pm, p32)
                                            for t in trio]))
    jdata = []
    for a, b, c, d in zip(w, g, m, w32):
        jdata += [jnd.array(a.float().numpy()).astype(name),
                  jnd.array(b.float().numpy()).astype(name),
                  jnd.array(c.numpy()), jnd.array(d.numpy())]
    want = jnd.multi_mp_sgd_mom_update(
        *jdata, jnd.array(np.array(lrs, np.float32)),
        jnd.array(np.array(WDS, np.float32)), momentum=0.9,
        rescale_grad=0.5, clip_gradient=0.7, num_weights=len(SHAPES))
    for i in range(len(SHAPES)):
        jw, jm, j32 = (_f(want[3 * i + k].asnumpy()) for k in range(3))
        for got, ref in ((pm[i], jm), (p32[i], j32)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_f(got), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max())
        assert pw[i].dtype == dt and torch.equal(pw[i], p32[i].to(dt))
        assert (np.abs(_f(pw[i]) - jw) <= _ulp(jw, name)).all()


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_mp_sgd_update_matches_jax(name, monkeypatch):
    """``mp_sgd_update`` (no momentum, fp32 master) against the JAX op,
    and ``SGD`` with ``multi_precision`` and no momentum takes it (the
    JAX package's SGD runs ``mp_sgd_mom_update`` on a zero momentum there,
    which gives the same numbers)."""
    dt = LOW[name][0]
    w, g, _, _ = _low_set(name, 13)
    for i, wd in enumerate(WDS):
        w32 = w[i].float() + 1e-3
        pw, p32 = w[i].clone(), w32.clone()
        out = ops.mp_sgd_update(pw, g[i], p32, 0.1, wd=wd, rescale_grad=0.5,
                                clip_gradient=0.7)
        assert out[0] is pw and out[1] is p32
        jw, j32 = jnd.mp_sgd_update(
            jnd.array(w[i].float().numpy()).astype(name),
            jnd.array(g[i].float().numpy()).astype(name),
            jnd.array(w32.numpy()), jnd.array(np.float32(0.1)), wd=wd,
            rescale_grad=0.5, clip_gradient=0.7)
        ref = _f(j32.asnumpy())
        np.testing.assert_allclose(_f(p32), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
        assert torch.equal(pw, p32.to(dt))
    calls = []
    monkeypatch.setattr(ops, "mp_sgd_mom_update",
                        lambda *a, **k: calls.append(a))
    opt = optimizer.SGD(learning_rate=0.1, multi_precision=True)
    state = opt.create_state_multi_precision(0, w[0])
    assert state[0] is None and state[1].dtype == torch.float32
    opt.update_multi([0], [w[0].clone()], [g[0]], [state])
    assert calls == [] and opt.num_update == 1


def test_momentum_state_keeps_the_weight_dtype_and_masters_are_fp32():
    opt = optimizer.SGD(learning_rate=0.1, momentum=0.9)
    w = torch.zeros(3, dtype=torch.bfloat16)
    assert opt.create_state(0, w).dtype == torch.bfloat16
    opt.multi_precision = True
    mom, w32 = opt.create_state_multi_precision(0, w)
    assert mom.dtype == w32.dtype == torch.float32


# ------------------------------------------------------- Parameter, Block

def _mlp(lib, **kw):
    net = lib.gluon.nn.HybridSequential(**kw)
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(16, activation="relu", in_units=8),
                lib.gluon.nn.Dense(4, in_units=16))
    return net


def test_parameter_cast_keeps_grad_req_and_drops_the_gradient():
    """dtype, the same ``nn.Parameter`` (so the module registration sees
    the new tensor), ``grad_req`` kept, the old gradient dropped and the
    next one in the new dtype; an uninitialized parameter records the
    dtype only; data as the JAX package's ``Parameter.cast`` makes it."""
    x = np.random.default_rng(0).standard_normal((5, 3), dtype=np.float32)
    ref = mx.gluon.nn.Dense(2, in_units=3, prefix="dense98_")
    ref.initialize()
    dense = nn.Dense(2, in_units=3)
    load_reference_params(dense, {k: p.data().asnumpy() for k, p in
                                  ref.collect_params().items()}, ctx=cpu())
    dense.bias.grad_req = "add"
    ref.bias.grad_req = "add"
    tensor = dense.weight._tensor()
    with autograd.record():
        loss = dense(torch.from_numpy(x)).sum()
    autograd.backward(loss)
    assert dense.weight._grad_tensor().abs().sum() > 0
    dense.cast("bfloat16")
    ref.cast("bfloat16")
    for (k, jp), p in zip(ref.collect_params().items(),
                          dense.collect_params().values()):
        assert p.dtype == torch.bfloat16 and str(jp.dtype) == "bfloat16"
        assert p.grad_req == jp.grad_req
        assert torch.equal(p._tensor().float(),
                           torch.from_numpy(_f(jp.data().asnumpy())).float())
        assert not p._grad_tensor().any() and \
            p._grad_tensor().dtype == torch.bfloat16
    assert dense.weight._tensor() is tensor
    assert dict(dense.named_parameters())["weight"].dtype == torch.bfloat16
    assert dense.bias.grad_req == "add" and dense.weight.fresh
    with autograd.record():
        loss = dense(torch.from_numpy(x).bfloat16()).float().sum()
    autograd.backward(loss)
    assert dense.weight._grad_tensor().dtype == torch.bfloat16
    assert dense.weight._grad_tensor().abs().sum() > 0
    late = gluon.Parameter("late", shape=(2,))
    late.cast("float16")
    late.initialize(ctx=cpu())
    assert late._tensor().dtype == torch.float16


def test_block_cast_matches_jax_and_the_hybridized_graph_follows():
    """A hybridized MLP in both packages runs once in fp32, is cast to
    bf16 and runs again on bf16 inputs: outputs bf16 in both, within 2
    bf16 ulp at their scale; the port's ``CachedGraph`` made before the
    cast runs on the cast weights; gradients bf16 in both."""
    x = np.random.default_rng(1).standard_normal((6, 8), dtype=np.float32)
    ref = _mlp(mx, prefix="hybrid_sequential98_")
    ref.initialize()
    ref.hybridize()
    port = _mlp(mt)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()}, ctx=cpu())
    port.hybridize()
    graph = port.cached_graph(x)
    ref(mx.nd.array(x))
    ref.cast("bfloat16")
    port.cast("bfloat16")
    xb = mx.nd.array(x).astype("bfloat16")
    with mx.autograd.record():
        jy = ref(xb)
    jy.backward()
    px = torch.from_numpy(x).bfloat16()
    with autograd.record():
        py = port(px)
    autograd.backward(py)
    assert str(jy.dtype) == "bfloat16" and py.dtype == torch.bfloat16
    want = _f(jy.asnumpy())
    assert (np.abs(_f(py) - want)
            <= 2 * _ulp(np.abs(want).max(), "bfloat16")).all()
    (gy,) = graph.raw(px)
    assert gy.dtype == torch.bfloat16 and torch.equal(gy, py.detach())
    for jp, p in zip(ref.collect_params().values(),
                     port.collect_params().values()):
        assert str(jp.grad().dtype) == "bfloat16"
        assert p._grad_tensor().dtype == torch.bfloat16


def test_trainer_refuses_a_state_made_before_a_cast():
    net = nn.Dense(2, in_units=3)
    net.initialize(ctx=cpu())
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    for dtype in (torch.float32, torch.bfloat16):
        with autograd.record():
            loss = net(torch.ones(1, 3, dtype=dtype)).float().sum()
        autograd.backward(loss)
        if dtype == torch.float32:
            tr.step(1)
            net.cast("bfloat16")
    with pytest.raises(MXNetError, match="cast before the first step"):
        tr.step(1)


# -------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("params", ["float32", "bfloat16"])
def test_batchnorm_on_bf16_activations_matches_jax(params):
    """bf16 activations with fp32 parameters (AMP) or bf16 parameters
    (``cast``): two training forwards, then one in predict mode.  Outputs
    bf16 within 2 bf16 ulp at the output's scale; the statistics taken in
    fp32 and the running statistics kept in the parameters' dtype, within
    2 ulp of it (1e-6 relative in fp32); the input gradient bf16."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 5, 4, 4), dtype=np.float32) * 3 + 1
    ref = mx.gluon.nn.BatchNorm(in_channels=5, prefix="batch_norm98_")
    ref.initialize()
    port = nn.BatchNorm(in_channels=5)
    arrays = {k: rng.uniform(0.5, 1.5, 5).astype(np.float32)
              for k in ref.collect_params()}
    for k, p in ref.collect_params().items():
        p.set_data(mx.nd.array(arrays[k]))
    load_reference_params(port, arrays, ctx=cpu())
    if params == "bfloat16":
        ref.cast("bfloat16")
        port.cast("bfloat16")
    xb = torch.from_numpy(x).bfloat16()
    for train in (True, True, False):
        jx = mx.nd.array(x).astype("bfloat16")
        px = xb.clone().requires_grad_()
        if train:
            jx.attach_grad()
            with mx.autograd.record():
                jy = ref(jx)
            jy.backward()
            with autograd.record():
                py = port(px)
            autograd.backward(py)
            assert px.grad.dtype == torch.bfloat16
        else:
            jy = ref(jx)
            with torch.no_grad():
                py = port(px)
        assert py.dtype == torch.bfloat16 and str(jy.dtype) == "bfloat16"
        want = _f(jy.asnumpy())
        assert (np.abs(_f(py) - want)
                <= 2 * _ulp(np.abs(want).max(), "bfloat16")).all(), train
    for k in ("running_mean", "running_var"):
        jp, p = ref.collect_params()["batch_norm98_" + k], getattr(port, k)
        assert str(p._tensor().dtype) == f"torch.{params}" == \
            f"torch.{jp.data().dtype}"
        want = _f(jp.data().asnumpy())
        tol = 2 * _ulp(want, "bfloat16") if params == "bfloat16" \
            else 1e-6 * np.abs(want)
        assert (np.abs(_f(p._tensor()) - want) <= tol).all(), k


def test_batchnorm_cast_float16_keeps_fp32_parameters_as_mxnet():
    """MXNet 1.x's ``BatchNorm.cast`` keeps the parameters fp32 under
    float16, and so does the port; the JAX package casts them to fp16 (a
    departure of the reference, ROADMAP).  The layer then takes fp16
    activations, returns fp16 and keeps fp32 statistics; its output is
    within 2 fp16 ulp (at the output's scale) of the JAX layer's, whose
    parameters are the same values in fp16."""
    x = np.random.default_rng(3).standard_normal((4, 3, 5, 5),
                                                 dtype=np.float32)
    ref = mx.gluon.nn.BatchNorm(in_channels=3, prefix="batch_norm97_")
    ref.initialize()
    port = nn.BatchNorm(in_channels=3)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()}, ctx=cpu())
    dense = nn.Dense(4, in_units=2)
    dense.initialize(ctx=cpu())
    seq = nn.HybridSequential()
    seq.add(dense, port)
    seq.cast("float16")
    ref.cast("float16")
    assert {str(p.dtype) for p in ref.collect_params().values()} == \
        {"float16"}
    assert {p._tensor().dtype for p in port.collect_params().values()} == \
        {torch.float32}
    assert dense.weight._tensor().dtype == torch.float16
    with mx.autograd.record():
        jy = ref(mx.nd.array(x).astype("float16"))
    with autograd.record():
        py = port(torch.from_numpy(x).half())
    assert py.dtype == torch.float16
    assert port.running_mean._tensor().dtype == torch.float32
    want = _f(jy.asnumpy())
    assert (np.abs(_f(py) - want)
            <= 2 * _ulp(np.abs(want).max(), "float16")).all()


# ------------------------------------------- the small ResNet, two recipes

SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
REF = "res_net_v198_"
BATCH = 8


def _resnet_data():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((BATCH, 3, 64, 64), dtype=np.float32),
            rng.integers(0, 10, BATCH).astype(np.float32))


def _jax_resnet_step(recipe):
    """One Trainer step of the JAX package's small ResNet: its initial
    weights (bf16 after ``cast``), loss, updated parameters and optimizer
    states, by name without the prefix."""
    X, Y = _resnet_data()
    if recipe == "amp":
        jax_amp.init("bfloat16")
    try:
        mx.random.seed(0)
        ref = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, *SPEC,
                                  classes=10, prefix=REF)
        ref.initialize(mx.init.Xavier("gaussian", "in", 2))
        x = mx.nd.array(X)
        ref(x)
        opt = dict(OPT)
        if recipe == "cast":
            ref.cast("bfloat16")
            x = x.astype("bfloat16")
            opt["multi_precision"] = True
        params = ref.collect_params()
        names = [k[len(REF):] for k in params]
        init = {n: p.data().asnumpy() for n, p in zip(names,
                                                      params.values())}
        tr = mx.gluon.Trainer(params, "sgd", opt)
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                ref(x), mx.nd.array(Y))
        loss.backward()
        tr.step(BATCH)
        trainable = [n for n, p in zip(names, params.values())
                     if p.grad_req != "null"]
        states = {trainable[i]: st for (i, _), st in tr._states.items()}
        return {"init": init, "loss": _f(loss.asnumpy()),
                "final": {n: p.data().asnumpy() for n, p in
                          zip(names, params.values())},
                "states": states}
    finally:
        jax_amp.disable()


def _port_resnet_step(recipe, init, dtype=None):
    """The same step in the port from the JAX package's initial weights;
    with ``dtype`` (float64), the exact step: no AMP, no masters."""
    X, Y = _resnet_data()
    net = port_resnet.ResNetV1(port_resnet.BottleneckV1, *SPEC, classes=10)
    if recipe == "cast":
        net.cast("bfloat16")
    load_reference_params(net, {REF + k: v for k, v in init.items()},
                          ctx=cpu())
    x, opt = torch.from_numpy(X), dict(OPT)
    if recipe == "cast":
        x = x.bfloat16()
        opt["multi_precision"] = True
    if dtype is not None:
        net.cast(dtype)
        x = x.to(dtype)
        opt.pop("multi_precision", None)
    elif recipe == "amp":
        amp.init("bfloat16")
    try:
        params = net.collect_params()
        names = [k[len(net.prefix):] for k in params]
        loaded = {n: p._tensor().detach().clone() for n, p in
                  zip(names, params.values())}
        tr = gluon.Trainer(params, "sgd", opt)
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(x), torch.from_numpy(Y))
        autograd.backward(loss)
        tr.step(BATCH)
    finally:
        amp.disable()
    trainable = [n for n, p in zip(names, params.values())
                 if p.grad_req != "null"]
    return {"loaded": loaded, "loss": _f(loss), "loss_dtype": loss.dtype,
            "final": {n: p._tensor().detach().clone() for n, p in
                      zip(names, params.values())},
            "states": {trainable[i]: st for i, st in tr._states.items()}}


@pytest.fixture(scope="module", params=["amp", "cast"])
def resnet_steps(request):
    """(recipe, JAX step, port step, exact float64 step)."""
    ref = _jax_resnet_step(request.param)
    return (request.param, ref, _port_resnet_step(request.param,
                                                  ref["init"]),
            _port_resnet_step(request.param, ref["init"], torch.float64))


def _near_reference(port, ref, exact, init):
    """Leaves (name -> (distance, limit)) where the port's value lies
    further from the JAX package's than 4x the JAX value's own distance
    from the exact step + 1e-3 of the leaf's change (L2 norms)."""
    bad = {}
    for k, r in ref.items():
        r, e = _f(r), _f(exact[k])
        change = np.linalg.norm(e - _f(init[k]))
        dist = np.linalg.norm(_f(port[k]) - r)
        limit = 4 * np.linalg.norm(r - e) + 1e-3 * change
        if not dist <= limit:
            bad[k] = (dist, limit)
    return bad


def test_small_resnet_step_matches_jax_in_both_bf16_recipes(resnet_steps):
    """One SGD-momentum step (lr 0.1, wd 1e-4, batch 8 of 64x64) of
    ``ResNetV1(BottleneckV1, [1,1,1,1], [8..128])`` from the JAX
    package's weights: under ``amp.init("bfloat16")``, and after
    ``cast("bfloat16")`` with ``multi_precision``.  The losses, every
    updated parameter and running statistic, every momentum (and, after
    ``cast``, every fp32 master) held against the JAX step: see
    ``_near_reference`` and the module docstring."""
    recipe, ref, port, exact = resnet_steps
    assert np.abs(port["loss"] - ref["loss"]).max() \
        <= 4 * np.abs(ref["loss"] - exact["loss"]).max() + 1e-6
    assert _near_reference(port["final"], ref["final"], exact["final"],
                           ref["init"]) == {}
    assert port["states"].keys() == ref["states"].keys()
    if recipe == "amp":
        moms = {k: (port["states"][k], ref["states"][k].asnumpy(),
                    exact["states"][k]) for k in ref["states"]}
    else:
        moms = {k: (port["states"][k][0], ref["states"][k][0].asnumpy(),
                    exact["states"][k]) for k in ref["states"]}
        masters = {k: (port["states"][k][1], ref["states"][k][1].asnumpy(),
                       exact["final"][k]) for k in ref["states"]}
        assert _near_reference(
            *(dict((k, v[j]) for k, v in masters.items()) for j in range(3)),
            ref["init"]) == {}
    zeros = {k: np.zeros(np.shape(v[1])) for k, v in moms.items()}
    assert _near_reference(
        *(dict((k, v[j]) for k, v in moms.items()) for j in range(3)),
        zeros) == {}


def test_small_resnet_dtypes_in_both_bf16_recipes(resnet_steps):
    """AMP: every parameter and momentum fp32, the loss fp32 (log_softmax
    is on the FP32 list).  ``cast``: the JAX package's bf16 weights load
    bit for bit; every parameter bf16 and exactly its fp32 master
    rounded; momenta and masters fp32."""
    recipe, ref, port, _ = resnet_steps
    if recipe == "amp":
        assert {p.dtype for p in port["final"].values()} == {torch.float32}
        assert {s.dtype for s in port["states"].values()} == \
            {torch.float32}
        assert {str(s.dtype) for s in ref["states"].values()} == \
            {"float32"}
        assert port["loss_dtype"] == torch.float32
        return
    for k, arr in ref["init"].items():
        assert arr.dtype.name == "bfloat16"
        np.testing.assert_array_equal(
            port["loaded"][k].view(torch.int16).numpy(),
            np.ascontiguousarray(arr).view(np.int16))
    assert {p.dtype for p in port["final"].values()} == {torch.bfloat16}
    for k, (mom, w32) in port["states"].items():
        assert mom.dtype == w32.dtype == torch.float32
        assert torch.equal(port["final"][k], w32.to(torch.bfloat16))
    assert {str(s[1].dtype) for s in ref["states"].values()} == {"float32"}
