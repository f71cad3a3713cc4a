"""The port's optimizers, learning-rate schedules and ``gluon.Trainer``
with a schedule, held against the JAX package on the CPU with the same
numpy inputs.

- Every registered optimizer (17 names; ``rmsprop`` plain and centered,
  ``sgd``, ``signum`` and ``dcasgd`` with and without momentum, LBSGD's
  four warmup strategies) takes 3 steps on 4 small tensors with
  ``lr_mult``/``wd_mult`` from ``param_dict``, ``clip_gradient`` and
  ``rescale_grad``: weights and states within 1e-6 (atol) + 1e-6 (rtol).
  SGLD's JAX run takes the noise the port's generator draws.
- ``multi_precision`` with bf16 weights (``sgd``, ``nag``, ``adamw``,
  ``lamb``): each weight within one bf16 ulp (2^-8 relative) of the JAX
  result, the fp32 masters and states within 1e-6, and each weight its
  master rounded, bit for bit.
- Every scheduler and warmup mode at ``num_update`` 0..40: exactly the
  JAX package's rates, called in order and called fresh at each count.
- ``gluon.Trainer`` with an ``lr_scheduler`` (and ``begin_num_update``)
  for 6 steps: the rates and the weights within 1e-6.
"""
import math
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import autograd, cpu, gluon, lr_scheduler, optimizer
from mxnet_tpu_torch import random as prandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn

SHAPES = [(5, 3), (7,), (2, 3, 4), (4, 4)]
MULTS = [(1.0, 1.0), (0.5, 2.0), (2.0, 0.0), (1.0, 1.0)]
COMMON = {"learning_rate": 0.05, "wd": 0.01, "clip_gradient": 0.3,
          "rescale_grad": 0.5}
BF16_ULP = 2 ** -8

CONFIGS = [
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
    ("adam", {}), ("adagrad", {}), ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_weights": 2.0}), ("ftrl", {}),
    ("signum", {"wd_lh": 0.01}), ("signum", {"momentum": 0.0}),
    ("adadelta", {}), ("adamw", {}), ("lars", {}),
    ("lbsgd", {"warmup_strategy": "linear", "momentum": 0.9,
               "warmup_epochs": 1, "updates_per_epoch": 4}),
    ("lbsgd", {"warmup_strategy": "power2", "warmup_epochs": 1,
               "updates_per_epoch": 4}),
    ("lbsgd", {"warmup_strategy": "sqrt", "warmup_epochs": 1,
               "updates_per_epoch": 4}),
    ("lbsgd", {"warmup_strategy": "lars", "momentum": 0.9}),
    ("ftml", {}), ("lamb", {}), ("lamb", {"lower_bound": 0.5,
                                          "upper_bound": 2.0}),
    ("adamax", {}), ("nadam", {}), ("sgld", {}), ("dcasgd", {}),
    ("dcasgd", {"momentum": 0.9}),
]


class _Mult:
    def __init__(self, lr_mult, wd_mult):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult


def _param_dict():
    return {i: _Mult(*m) for i, m in enumerate(MULTS)}


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _flat(s)]
    return [state]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return x.astype("float32").asnumpy()


def _arrays(seed, steps=3):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s, dtype=np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s, dtype=np.float32) for s in SHAPES]
          for _ in range(steps)]
    return ws, gs


def _run_jax(name, kw, ws, gs, dtype=None):
    opt = mx.optimizer.create(name, param_dict=_param_dict(), **COMMON,
                              **kw)
    cast = (lambda a: mx.nd.array(a).astype(dtype)) if dtype else \
        mx.nd.array
    weights = [cast(w) for w in ws]
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(weights)]
    for step in gs:
        for i, (w, g) in enumerate(zip(weights, step)):
            opt.update_multi_precision(i, w, cast(g), states[i])
    return opt, weights, states


def _run_port(name, kw, ws, gs, dtype=None):
    opt = optimizer.create(name, param_dict=_param_dict(), **COMMON, **kw)
    weights = [torch.tensor(w, dtype=dtype) for w in ws]
    states = [opt.create_state_multi_precision(i, w)
              for i, w in enumerate(weights)]
    with torch.no_grad():
        for step in gs:
            for i, (w, g) in enumerate(zip(weights, step)):
                opt.update_multi_precision(
                    i, w, torch.tensor(g, dtype=dtype), states[i])
    return opt, weights, states


def _close(a, b, msg):
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6,
                               err_msg=msg)


@pytest.mark.parametrize("name,kw", CONFIGS, ids=[
    f"{n}-{i}" for i, (n, _) in enumerate(CONFIGS)])
def test_optimizer_matches_jax(name, kw, monkeypatch):
    ws, gs = _arrays(CONFIGS.index((name, kw)))
    if name == "sgld":
        # the JAX run takes the noise the port draws, in the same order
        prandom.seed(5)
        gen = prandom.generator(cpu())
        noise = [torch.empty(s).normal_(0.0, math.sqrt(
            COMMON["learning_rate"] * m[0]), generator=gen).numpy()
            for _ in gs for s, m in zip(SHAPES, MULTS)][::-1]
        monkeypatch.setattr(mx.nd.random, "normal",
                            lambda loc, scale, shape, ctx, dtype:
                            mx.nd.array(noise.pop()))
        prandom.seed(5)
    jopt, jw, js = _run_jax(name, kw, ws, gs)
    popt, pw, ps = _run_port(name, kw, ws, gs)
    assert popt.num_update == jopt.num_update == len(gs)
    for i in range(len(SHAPES)):
        _close(pw[i], jw[i], f"{name} weight {i}")
        pflat, jflat = _flat(ps[i]), _flat(js[i])
        assert len(pflat) == len(jflat)
        for k, (a, b) in enumerate(zip(pflat, jflat)):
            _close(a, b, f"{name} state {i}.{k}")


@pytest.mark.parametrize("name,kw", [("sgd", {"momentum": 0.9}), ("sgd", {}),
                                     ("nag", {"momentum": 0.9}),
                                     ("adamw", {}), ("lamb", {})])
def test_multi_precision_bf16_matches_jax(name, kw):
    ws, gs = _arrays(100)
    kw = dict(kw, multi_precision=True)
    _, jw, js = _run_jax(name, kw, ws, gs, dtype="bfloat16")
    _, pw, ps = _run_port(name, kw, ws, gs, dtype=torch.bfloat16)
    for i in range(len(SHAPES)):
        assert pw[i].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(pw[i]), _np(jw[i]), rtol=BF16_ULP,
                                   atol=1e-6, err_msg=f"{name} weight {i}")
        master = ps[i][1]
        assert master.dtype == torch.float32
        assert torch.equal(pw[i], master.bfloat16())
        for k, (a, b) in enumerate(zip(_flat(ps[i]), _flat(js[i]))):
            _close(a, b, f"{name} state {i}.{k}")


def test_sgld_noise_moments():
    """SGLD's noise, (w' - w + lr/2 * (g + wd * w)) / sqrt(lr) over 1M
    elements: mean 0 and std 1 within 5e-3."""
    lr, wd = 0.04, 0.01
    opt = optimizer.create("sgld", learning_rate=lr, wd=wd)
    w = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0))
    g = torch.randn(1 << 20, generator=torch.Generator().manual_seed(1))
    w0 = w.clone()
    with torch.no_grad():
        opt.update(0, w, g, None)
    noise = (w - w0 + lr / 2 * (g + wd * w0)) / math.sqrt(lr)
    assert abs(noise.mean().item()) < 5e-3
    assert abs(noise.std().item() - 1) < 5e-3


SCHEDULERS = [
    ("FactorScheduler", {"step": 4, "factor": 0.7, "stop_factor_lr": 0.02,
                         "base_lr": 0.3}),
    ("FactorScheduler", {"step": 3, "factor": 0.5, "base_lr": 0.3,
                         "warmup_steps": 5, "warmup_begin_lr": 0.01}),
    ("MultiFactorScheduler", {"step": [6, 9, 20], "factor": 0.1,
                              "base_lr": 0.05, "warmup_steps": 3}),
    ("MultiFactorScheduler", {"step": [10, 30], "factor": 0.5,
                              "base_lr": 0.05, "warmup_steps": 4,
                              "warmup_begin_lr": 0.02,
                              "warmup_mode": "constant"}),
    ("PolyScheduler", {"max_update": 30, "base_lr": 0.1, "pwr": 2,
                       "final_lr": 0.001}),
    ("PolyScheduler", {"max_update": 13, "base_lr": 1e-4, "pwr": 1,
                       "warmup_steps": 3}),
    ("CosineScheduler", {"max_update": 35, "base_lr": 0.2, "final_lr": 0.01,
                         "warmup_steps": 5, "warmup_begin_lr": 0.05}),
    ("CosineScheduler", {"max_update": 20, "base_lr": 0.2, "warmup_steps": 2,
                         "warmup_mode": "constant"}),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_matches_jax_exactly(name, kw):
    ref = getattr(mx.lr_scheduler, name)(**kw)
    ours = getattr(lr_scheduler, name)(**kw)
    want = [ref(n) for n in range(41)]
    assert [ours(n) for n in range(41)] == want
    # a fresh scheduler at a resumed count catches up to the same rate
    assert [getattr(lr_scheduler, name)(**kw)(n)
            for n in range(41)] == want


def test_optimizer_takes_lr_scheduler_and_begin_num_update():
    """The options the port dropped: the schedule's rate at
    ``begin_num_update``, the count starting there, and
    ``set_learning_rate`` refused while a schedule is set."""
    def sched(pkg):
        return pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                                base_lr=0.5)
    ours = optimizer.create("sgd", learning_rate=0.5,
                            lr_scheduler=sched(pmx),
                            begin_num_update=7)
    ref = mx.optimizer.create("sgd", learning_rate=0.5,
                              lr_scheduler=sched(mx), begin_num_update=7)
    assert ours.num_update == ref.num_update == 7
    assert ours.learning_rate == ref.learning_rate == 0.5 * 0.5 ** 3
    w = torch.ones(3)
    with torch.no_grad():
        ours.update(0, w, torch.ones(3), None)
    assert ours._index_update_count[0] == 8 and ours.num_update == 8
    with pytest.raises(MXNetError, match="lr_scheduler"):
        ours.set_learning_rate(0.1)


def test_lr_and_wd_mult_lookup_order_matches_jax():
    """``param_dict`` first, then the index in the ``set_lr_mult`` /
    ``set_wd_mult`` tables, then the name ``param_idx2name`` gives it."""
    kw = {"learning_rate": 0.4, "wd": 0.1,
          "param_idx2name": {1: "w1", 2: "w2", 3: "w3"},
          "param_dict": {0: _Mult(3.0, 0.0)}}
    opts = [pkg.optimizer.create("sgd", **kw) for pkg in (mx, pmx)]
    for opt in opts:
        opt.set_lr_mult({1: 2.0, "w2": 0.5, "w3": 4.0, 3: 0.25})
        opt.set_wd_mult({"w1": 5.0, 2: 0.0})
    for get in ("_get_lr", "_get_wd"):
        got, want = ([getattr(o, get)(i) for i in range(5)] for o in
                     reversed(opts))
        assert got == pytest.approx(want)
    assert [opts[1]._get_lr(i) for i in range(4)] == \
        pytest.approx([1.2, 0.8, 0.2, 0.1])


def test_updater_states_keep_nadam_schedule():
    """``Updater.get_states(dump_optimizer=True)`` writes the optimizer's
    ``extra_state`` in the JAX package's layout, and a fresh updater that
    loads it continues Nadam's momentum schedule: the resumed run equals
    the uninterrupted one bit for bit."""
    ws, gs = _arrays(200, steps=4)

    def steps(upd, weights, grads):
        for step in grads:
            for i, (w, g) in enumerate(zip(weights, step)):
                upd(i, torch.tensor(g), w)

    def make():
        return optimizer.get_updater(optimizer.create("nadam", **COMMON))
    full = make()
    full_w = [torch.tensor(w) for w in ws]
    steps(full, full_w, gs)
    first = make()
    resumed_w = [torch.tensor(w) for w in ws]
    steps(first, resumed_w, gs[:2])
    blob = first.get_states(dump_optimizer=True)
    ref = mx.optimizer.get_updater(mx.optimizer.create("nadam", **COMMON))
    ref(0, mx.nd.array(gs[0][0]), mx.nd.array(ws[0]))
    ref_keys = set(pickle.loads(ref.get_states(dump_optimizer=True)))
    assert set(pickle.loads(blob)) == ref_keys
    second = make()
    second.set_states(blob)
    assert second.optimizer.m_schedule == first.optimizer.m_schedule != 1.0
    steps(second, resumed_w, gs[2:])
    for a, b in zip(resumed_w, full_w):
        assert torch.equal(a, b)


def _mlp(pkg_nn, prefix):
    net = pkg_nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg_nn.Dense(9, activation="relu", in_units=6),
                pkg_nn.Dense(4, in_units=9))
    return net


@pytest.mark.parametrize("opt_name,opt_kw,sched", [
    ("sgd", {"learning_rate": 0.2, "momentum": 0.9, "wd": 1e-3},
     ("MultiFactorScheduler", {"step": [2, 4], "factor": 0.1,
                               "base_lr": 0.2, "warmup_steps": 2,
                               "warmup_mode": "linear"})),
    ("adam", {"learning_rate": 0.01, "begin_num_update": 2},
     ("PolyScheduler", {"max_update": 8, "base_lr": 0.01, "pwr": 1,
                        "warmup_steps": 1})),
])
def test_trainer_with_lr_scheduler_matches_jax(opt_name, opt_kw, sched):
    """Six Trainer steps with a schedule through ``optimizer_params``:
    each step's rate and the weights equal the JAX package's (the port
    used to drop ``lr_scheduler`` and ``begin_num_update`` and train at
    the constant rate)."""
    from mxnet_tpu_torch import load_reference_params
    rng = np.random.default_rng(8)
    X = rng.standard_normal((8, 6), dtype=np.float32)
    Y = rng.integers(0, 4, 8).astype(np.float32)
    ref = _mlp(mx.gluon.nn, "hybrid_sequential98_")
    ref.initialize()
    port = _mlp(nn, "hybrid_sequential98_")
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()}, ctx=cpu())
    name, skw = sched
    trainers = [
        mx.gluon.Trainer(ref.collect_params(), opt_name, dict(
            opt_kw, lr_scheduler=getattr(mx.lr_scheduler, name)(**skw))),
        gluon.Trainer(port.collect_params(), opt_name, dict(
            opt_kw, lr_scheduler=getattr(lr_scheduler, name)(**skw)))]
    jloss, ploss = mx.gluon.loss.SoftmaxCrossEntropyLoss(), \
        gluon.loss.SoftmaxCrossEntropyLoss()
    rates = [[], []]
    for _ in range(6):
        with mx.autograd.record():
            jl = jloss(ref(mx.nd.array(X)), mx.nd.array(Y))
        jl.backward()
        trainers[0].step(8)
        with autograd.record():
            pl = ploss(port(torch.from_numpy(X)), torch.from_numpy(Y))
        autograd.backward(pl)
        trainers[1].step(8)
        for r, tr in zip(rates, trainers):
            r.append(tr.learning_rate)
    assert rates[1] == rates[0] and len(set(rates[0])) > 1
    for (k, p), q in zip(ref.collect_params().items(),
                         port.collect_params().values()):
        np.testing.assert_allclose(q.data().detach().numpy(),
                                   p.data().asnumpy(), atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["adam", "ftrl", "nadam"])
def test_multi_precision_leaves_fp32_weights_alone(name):
    """``multi_precision`` changes nothing for fp32 weights: a state that
    is a pair of fp32 tensors (Adam's ``(mean, var)``) is not taken for
    a ``(state, master)`` pair."""
    ws, gs = _arrays(300)
    kw = {"multi_precision": True}
    _, jw, js = _run_jax(name, kw, ws, gs)
    _, pw, ps = _run_port(name, kw, ws, gs)
    for i in range(len(SHAPES)):
        _close(pw[i], jw[i], f"{name} weight {i}")
        for k, (a, b) in enumerate(zip(_flat(ps[i]), _flat(js[i]))):
            _close(a, b, f"{name} state {i}.{k}")
