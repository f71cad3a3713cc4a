"""The port's multi-tensor SGD (plain versions of the two CUDA kernels),
update operators, SGD optimizer and gluon.Trainer held against the JAX
package on the CPU, with the same numpy inputs.

Tolerances: the plain versions against the Pallas kernels in interpret
mode 1e-6 (fp32, the same operations; measured 0 or one ulp); aggregated
against per-tensor updates inside the port, bit for bit (one formula, one
rounding per operation); port ops against JAX ops 1e-6; bf16 weights of
the multi-precision path to one bf16 ulp (2^-8 relative) of the JAX
result, their fp32 masters and momenta 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu_torch import autograd, cpu, gluon, optimizer
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.kernels import (multi_sgd, multi_sgd_mom,
                                     multi_sgd_mom_plain, multi_sgd_plain)
from mxnet_tpu_torch.ndarray import ops_optimizer as ops

SHAPES = [(3, 5), (1000,), (17, 9, 2), (1,), (128, 128)]   # test_kernels.py
LRS = [0.1, 0.2, 0.3, 0.4, 0.05]
WDS = [0.0, 0.01, 0.1, 0.0, 0.001]


def _set(seed):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(s, dtype=np.float32) for s in SHAPES]
            for _ in range(3)]


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels themselves in interpret mode
    (its off-TPU default is a jnp twin), as tests/test_kernels.py does."""
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("clip", [-1.0, 0.7])
def test_multi_sgd_plain_matches_pallas_kernel(pallas_interpret, clip):
    from mxnet_tpu.kernels import fused_multi_sgd
    ws, gs, _ = _set(0)
    want = fused_multi_sgd(ws, gs, LRS, WDS, rescale_grad=0.5,
                           clip_gradient=clip)
    got = _t(ws)
    multi_sgd_plain(got, _t(gs), LRS, WDS, 0.5, clip)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("clip", [-1.0, 0.7])
def test_multi_sgd_mom_plain_matches_pallas_kernel(pallas_interpret, clip):
    from mxnet_tpu.kernels import fused_multi_sgd_mom
    ws, gs, ms = _set(1)
    w_want, m_want = fused_multi_sgd_mom(ws, gs, ms, LRS, WDS, momentum=0.9,
                                         rescale_grad=0.25,
                                         clip_gradient=clip)
    w_got, m_got = _t(ws), _t(ms)
    multi_sgd_mom_plain(w_got, _t(gs), m_got, LRS, WDS, 0.9, 0.25, clip)
    for got, want in zip(w_got + m_got, list(w_want) + list(m_want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_wrappers_take_the_plain_version_on_cpu():
    ws, gs, ms = _set(2)
    a_w, a_m, b_w, b_m = _t(ws), _t(ms), _t(ws), _t(ms)
    before = (multi_sgd.launches, multi_sgd_mom.launches)
    multi_sgd_mom(a_w, _t(gs), a_m, torch.tensor(LRS), np.array(WDS), 0.9,
                  0.5, 1.0)
    multi_sgd_mom_plain(b_w, _t(gs), b_m, LRS, WDS, 0.9, 0.5, 1.0)
    multi_sgd(a_w, _t(gs), LRS, WDS)
    multi_sgd_plain(b_w, _t(gs), LRS, WDS)
    assert (multi_sgd.launches, multi_sgd_mom.launches) == before
    for a, b in zip(a_w + a_m, b_w + b_m):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_reject_ragged_groups():
    ws, gs, _ = _set(3)
    with pytest.raises(MXNetError, match="lrs"):
        multi_sgd(_t(ws), _t(gs), LRS[:-1], WDS)
    with pytest.raises(MXNetError, match="weights"):
        multi_sgd([], [], [], [])


@pytest.mark.parametrize("clip", [None, 0.3])
def test_multi_ops_match_per_tensor_and_jax(clip):
    ws, gs, ms = _set(4)
    kw = {"rescale_grad": 0.5}
    if clip is not None:
        kw["clip_gradient"] = clip
    # aggregated, in place
    w_agg, m_agg = _t(ws), _t(ms)
    data = [t for trio in zip(w_agg, _t(gs), m_agg) for t in trio]
    out = ops.multi_sgd_mom_update(*data, LRS, WDS, momentum=0.9,
                                   num_weights=len(SHAPES), **kw)
    assert all(o is t for o, t in zip(out, [t for pair in zip(w_agg, m_agg)
                                            for t in pair]))
    # per tensor
    w_pt, m_pt = _t(ws), _t(ms)
    for w, g, m, lr, wd in zip(w_pt, _t(gs), m_pt, LRS, WDS):
        ops.sgd_mom_update(w, g, m, lr, momentum=0.9, wd=wd, **kw)
    for a, b in zip(w_agg + m_agg, w_pt + m_pt):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the JAX op
    jdata = [nd.array(a) for trio in zip(*(ws, gs, ms)) for a in trio]
    want = nd.multi_sgd_mom_update(
        *jdata, nd.array(np.array(LRS, np.float32)),
        nd.array(np.array(WDS, np.float32)), momentum=0.9,
        num_weights=len(SHAPES), **kw)
    got = [t for pair in zip(w_agg, m_agg) for t in pair]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.asnumpy(), rtol=0,
                                   atol=1e-6)


def test_multi_sgd_update_matches_per_tensor_and_jax():
    ws, gs, _ = _set(5)
    w_agg = _t(ws)
    ops.multi_sgd_update(*[t for pair in zip(w_agg, _t(gs)) for t in pair],
                         LRS, WDS, rescale_grad=2.0, clip_gradient=1.5)
    w_pt = _t(ws)
    for w, g, lr, wd in zip(w_pt, _t(gs), LRS, WDS):
        ops.sgd_update(w, g, lr, wd=wd, rescale_grad=2.0, clip_gradient=1.5)
    want = nd.multi_sgd_update(
        *[nd.array(a) for pair in zip(ws, gs) for a in pair],
        nd.array(np.array(LRS, np.float32)),
        nd.array(np.array(WDS, np.float32)), rescale_grad=2.0,
        clip_gradient=1.5, num_weights=len(SHAPES))
    for a, b, w in zip(w_agg, w_pt, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy(), w.asnumpy(), rtol=0, atol=1e-6)


def test_multi_mp_sgd_mom_bf16_matches_per_tensor_and_jax():
    ws, gs, ms = _set(6)
    ws16 = [torch.from_numpy(w).bfloat16() for w in ws]
    gs16 = [torch.from_numpy(g).bfloat16() for g in gs]
    w32s = [w.float() for w in ws16]           # masters of the bf16 weights
    agg = [[w.clone() for w in ws16], _t(ms), [w.clone() for w in w32s]]
    data = [t for quad in zip(agg[0], gs16, agg[1], agg[2]) for t in quad]
    ops.multi_mp_sgd_mom_update(*data, LRS, WDS, momentum=0.9,
                                rescale_grad=0.5)
    pt = [[w.clone() for w in ws16], _t(ms), [w.clone() for w in w32s]]
    for w, g, m, w32, lr, wd in zip(*pt[:1], gs16, pt[1], pt[2], LRS, WDS):
        ops.mp_sgd_mom_update(w, g, m, w32, lr, momentum=0.9, wd=wd,
                              rescale_grad=0.5)
    for a, b in zip(sum(agg, []), sum(pt, [])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    jdata = []
    for w, g, m, w32 in zip(ws16, gs16, ms, w32s):
        jdata += [nd.array(w.float().numpy()).astype("bfloat16"),
                  nd.array(g.float().numpy()).astype("bfloat16"),
                  nd.array(m), nd.array(w32.numpy())]
    want = nd.multi_mp_sgd_mom_update(
        *jdata, nd.array(np.array(LRS, np.float32)),
        nd.array(np.array(WDS, np.float32)), momentum=0.9,
        rescale_grad=0.5, num_weights=len(SHAPES))
    for i, (w, m, w32) in enumerate(zip(*agg)):
        jw, jm, jw32 = (want[3 * i + j] for j in range(3))
        assert w.dtype == torch.bfloat16
        np.testing.assert_allclose(w.float().numpy(),
                                   jw.astype("float32").asnumpy(),
                                   rtol=2 ** -8, atol=1e-6)
        np.testing.assert_allclose(m.numpy(), jm.asnumpy(), atol=1e-6)
        np.testing.assert_allclose(w32.numpy(), jw32.asnumpy(), atol=1e-6)


def _mlp_params(dtype="float32", seed=0):
    net = nn.HybridSequential()
    net.add(nn.Dense(9, activation="relu", in_units=6, dtype=dtype),
            nn.Dense(4, in_units=9, dtype=dtype))
    net.initialize(ctx=cpu(), seed=seed)
    return net


@pytest.mark.parametrize("momentum,mp", [(0.0, False), (0.9, False),
                                         (0.9, True), (0.0, True)])
def test_sgd_update_multi_matches_per_tensor(momentum, mp):
    """SGD.update_multi against the same updates one tensor at a time,
    including the multi-precision branch with bf16 weights (and its
    per-tensor fallback without momentum)."""
    dtype = "bfloat16" if mp else "float32"
    rng = np.random.default_rng(7)
    nets = [_mlp_params(dtype), _mlp_params(dtype)]
    params = [list(n.collect_params().values()) for n in nets]
    grads = [torch.from_numpy(rng.standard_normal(p.shape,
                                                  dtype=np.float32))
             .to(p.dtype) for p in params[0]]
    opts = [optimizer.SGD(learning_rate=0.1, momentum=momentum, wd=1e-3,
                          clip_gradient=0.8, multi_precision=mp,
                          rescale_grad=0.5) for _ in nets]
    idx = list(range(len(grads)))
    states = [[o.create_state_multi_precision(i, p.data())
               for i, p in zip(idx, ps)] for o, ps in zip(opts, params)]
    with torch.no_grad():
        for _ in range(2):
            opts[0].update_multi(idx, [p.data() for p in params[0]], grads,
                                 states[0])
            for i, p, g, s in zip(idx, params[1], grads, states[1]):
                opts[1].update_multi_precision(i, p.data(), g, s)
    for a, b in zip(*params):
        torch.testing.assert_close(a.data(), b.data(), rtol=0, atol=0)
    assert opts[0].num_update == opts[1].num_update == 2


def _jax_mlp(X, Y, steps, trainer_kw, **train):
    net = mx.gluon.nn.HybridSequential(prefix="hybrid_sequential99_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(9, activation="relu", in_units=6),
                mx.gluon.nn.Dense(4, in_units=9))
    net.initialize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", trainer_kw)
    lossfn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        with mx.autograd.record():
            loss = lossfn(net(mx.nd.array(X)), mx.nd.array(Y))
        loss.backward()
        tr.step(X.shape[0], **train)
    return net


def _port_like(ref):
    from mxnet_tpu_torch import load_reference_params
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(9, activation="relu", in_units=6),
                nn.Dense(4, in_units=9))
    load_reference_params(net, {k: p.data().asnumpy() for k, p in
                                ref.collect_params().items()}, ctx=cpu())
    return net


@pytest.mark.parametrize("trainer_kw", [
    {"learning_rate": 0.1},
    {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
     "clip_gradient": 0.05},
])
def test_trainer_matches_jax_with_lr_and_wd_mult(trainer_kw):
    """Three steps of gluon.Trainer, with lr_mult/wd_mult on one weight,
    from the JAX package's weights (atol 1e-6)."""
    rng = np.random.default_rng(8)
    X = rng.standard_normal((8, 6), dtype=np.float32)
    Y = rng.integers(0, 4, 8).astype(np.float32)
    ref0 = _jax_mlp(X, Y, 0, trainer_kw)
    port = _port_like(ref0)
    for net in (ref0, port):
        w = [p for k, p in net.collect_params().items()
             if k.endswith("dense1_weight")][0]
        w.lr_mult, w.wd_mult = 0.5, 3.0
    tr = gluon.Trainer(port.collect_params(), "sgd", trainer_kw)
    ref_tr = mx.gluon.Trainer(ref0.collect_params(), "sgd", trainer_kw)
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    ref_loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(3):
        with mx.autograd.record():
            jl = ref_loss(ref0(mx.nd.array(X)), mx.nd.array(Y))
        jl.backward()
        ref_tr.step(8)
        with autograd.record():
            pl = lossfn(port(torch.from_numpy(X)), torch.from_numpy(Y))
        autograd.backward(pl)
        tr.step(8)
        np.testing.assert_allclose(pl.detach().numpy(), jl.asnumpy(),
                                   atol=1e-6)
    for (k, p), q in zip(ref0.collect_params().items(),
                         port.collect_params().values()):
        np.testing.assert_allclose(q.data().detach().numpy(),
                                   p.data().asnumpy(), atol=1e-6,
                                   err_msg=k)


def test_trainer_groups_by_aggregation_size(monkeypatch):
    """6 MLP parameters at the default size 4: two multi-tensor calls per
    step; at size 1 the per-tensor path."""
    calls = []
    real = ops.multi_sgd_update

    def spy(*data, **kw):
        calls.append(kw["num_weights"])
        return real(*data, **kw)

    monkeypatch.setattr(ops, "multi_sgd_update", spy)
    net = nn.HybridSequential()
    net.add(nn.Dense(5, activation="relu", in_units=4),
            nn.Dense(5, activation="relu", in_units=5),
            nn.Dense(3, in_units=5))
    net.initialize(ctx=cpu())
    x = torch.randn(2, 4)
    for size, want in (("4", [4, 2]), ("1", [])):
        monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", size)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        calls.clear()
        with autograd.record():
            out = net(x)
        autograd.backward(out)
        tr.step(2)
        assert calls == want


def test_trainer_kvstore_and_learning_rate():
    net = _mlp_params()
    for kv in ("device", "local", None):
        gluon.Trainer(net.collect_params(), "sgd", kvstore=kv)
    with pytest.raises(MXNetError, match="kvstore"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    with pytest.raises(MXNetError, match="unknown optimizer"):
        gluon.Trainer(net.collect_params(), "nosuch")
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.3})
    assert tr.learning_rate == 0.3
    tr.set_learning_rate(0.05)
    assert tr.learning_rate == tr.optimizer.lr == 0.05


def test_optimizer_multipliers_and_schedule():
    """lr/wd multipliers from param_dict (1.0 for an index it lacks), and
    the update count, as the JAX package's Optimizer takes them from
    gluon's Trainer; without an lr_scheduler, set_learning_rate sets the
    rate (schedules: tests/test_torch_training_surface.py); a name that
    neither package registers is refused."""
    class Param:
        lr_mult, wd_mult = 3.0, 0.0

    opt = optimizer.create("sgd", learning_rate=0.4, wd=0.1,
                           param_dict={0: Param()})
    ref = mx.optimizer.create("sgd", learning_rate=0.4, wd=0.1,
                              param_dict={0: Param()})
    for get, want in (("_get_lr", [1.2, 0.4]), ("_get_wd", [0.0, 0.1])):
        got = [getattr(opt, get)(i) for i in range(2)]
        assert got == pytest.approx([getattr(ref, get)(i) for i in range(2)])
        assert got == pytest.approx(want)
    w, g = torch.ones(2), torch.ones(2)
    opt.update(1, w, g, None)
    opt.update(1, w, g, None)
    assert opt.num_update == 2
    opt.set_learning_rate(0.1)
    assert opt.learning_rate == opt._get_lr(1) == 0.1
    with pytest.raises(MXNetError, match="unknown optimizer"):
        optimizer.create("nosuch_optimizer")
