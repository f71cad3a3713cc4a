"""Checkpoints and the parameter surface of the port against the JAX
package on the CPU: ``Block.save_parameters``/``load_parameters``,
``Trainer.save_states``/``load_states`` and ``ParameterDict.save``/
``load``, each file written by one package and loaded by the other in
both directions; a run resumed from a checkpoint equals the
uninterrupted run bit for bit (SGD with momentum under a stateful
schedule, Adam, Nadam); ``Constant``, ``collect_params(select)``,
``update_on_kvstore`` and ``compression_params``.

Tolerances: a file carries values bit for bit (compared exactly); a step
taken after loading, in each package, within 1e-6 (the packages' own
parity, as ``tests/test_torch_optimizer.py`` holds it).
"""
import pickle
import re
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import (autograd, cpu, gluon, load_reference_params,
                             lr_scheduler)
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn

PREFIX = "ckpt0_"


def _mlp(pnn, bn=False):
    net = pnn.HybridSequential(prefix=PREFIX)
    with net.name_scope():
        net.add(pnn.Dense(9, activation="relu", in_units=6))
        if bn:
            net.add(pnn.BatchNorm(in_channels=9))
        net.add(pnn.Dense(4, in_units=9))
    return net


def _port(seed=0, bn=False):
    net = _mlp(nn, bn)
    net.initialize(ctx=cpu(), seed=seed)
    return net


def _jax(bn=False):
    net = _mlp(mx.gluon.nn, bn)
    net.initialize()
    return net


def _data(seed=1, steps=6):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((8, 6), dtype=np.float32),
             rng.integers(0, 4, 8).astype(np.float32)) for _ in range(steps)]


def _port_step(net, trainer, x, y):
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(torch.from_numpy(x)),
                                                     torch.from_numpy(y))
    autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss.detach()


def _jax_step(net, trainer, x, y):
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(mx.nd.array(x)),
                                                        mx.nd.array(y))
    loss.backward()
    trainer.step(x.shape[0])


def _assert_equal_nets(port, ref, atol=0.0):
    for (k, p), q in zip(ref.collect_params().items(),
                         port.collect_params().values()):
        np.testing.assert_allclose(q._tensor().detach().numpy(),
                                   p.data().asnumpy(), rtol=0, atol=atol,
                                   err_msg=k)


def test_save_parameters_cross_loads_both_ways(tmp_path):
    """A ``save_parameters`` file of each package (attribute-path names,
    BatchNorm's running statistics included) loads in the other bit for
    bit; so does a file of fully prefixed names."""
    ref = _jax(bn=True)
    ref.save_parameters(str(tmp_path / "jax.params"))
    port = _port(seed=3, bn=True)
    port.load_parameters(str(tmp_path / "jax.params"))
    _assert_equal_nets(port, ref)
    port2 = _port(seed=4, bn=True)
    port2.save_parameters(str(tmp_path / "port.params"))
    ref.load_parameters(str(tmp_path / "port.params"))
    _assert_equal_nets(port2, ref)
    # fully prefixed names (ParameterDict.save) load through the fallback
    port2.collect_params().save(str(tmp_path / "full.params"))
    port3 = _port(seed=5, bn=True)
    port3.load_parameters(str(tmp_path / "full.params"))
    _assert_equal_nets(port3, ref)


def test_load_parameters_errors_and_options(tmp_path):
    small, big = _port(), _port(bn=True)
    small.save_parameters(str(tmp_path / "small.params"))
    big.save_parameters(str(tmp_path / "big.params"))
    first = {k: v for k, v in pnd.load(str(tmp_path / "small.params"),
                                       ctx="cpu").items()
             if k.startswith("0.")}
    pnd.save(str(tmp_path / "first.params"), first)
    with pytest.raises(MXNetError, match="'1.weight' missing from"):
        _port().load_parameters(str(tmp_path / "first.params"))
    with pytest.raises(MXNetError, match="unknown parameter '1.gamma'"):
        _port().load_parameters(str(tmp_path / "big.params"))
    part = _port(seed=7, bn=True)
    gamma = part.collect_params()[PREFIX + "batch_norm0_gamma"]
    epoch = gamma.epoch
    part.load_parameters(str(tmp_path / "big.params"), ignore_extra=True)
    assert gamma.epoch != epoch            # in through set_data
    loose = _port(seed=8)
    loose.load_parameters(str(tmp_path / "first.params"), allow_missing=True)
    weights = [(a, b) for a, b in zip(loose.collect_params().values(),
                                      small.collect_params().values())
               if a.name.endswith("weight")]
    assert [torch.equal(a._tensor(), b._tensor()) for a, b in weights] == \
        [True, False]


def test_parameter_dict_save_load_and_prefixes(tmp_path):
    """``ParameterDict.save(strip_prefix=)`` writes the JAX package's
    names; its ``load(restore_prefix=)`` reads them back, and each
    package loads the other's file."""
    ref = _jax()
    port = _port(seed=2)
    port.collect_params().save(str(tmp_path / "p.params"),
                               strip_prefix=PREFIX)
    ref.collect_params().load(str(tmp_path / "p.params"),
                              restore_prefix=PREFIX)
    _assert_equal_nets(port, ref)
    assert sorted(mx.nd.load(str(tmp_path / "p.params"))) == sorted(
        k[len(PREFIX):] for k in ref.collect_params())
    ref2 = _jax()
    ref2.collect_params().save(str(tmp_path / "j.params"))
    port.collect_params().load(str(tmp_path / "j.params"))
    _assert_equal_nets(port, ref2)
    with pytest.raises(MXNetError, match="missing from"):
        port.collect_params().load(str(tmp_path / "p.params"))
    port.collect_params().load(str(tmp_path / "p.params"),
                               allow_missing=True, ignore_extra=True)


def test_collect_params_select_setattr_and_constant():
    """``collect_params(select)`` gives the JAX package's names; the
    Trainer takes ``wd_mult`` 0 set through it; a ``Constant`` holds its
    value, takes no gradient and stays out of the Trainer."""
    pat = ".*gamma|.*beta|.*bias"
    ref, port = _jax(bn=True), _port(bn=True)
    assert list(port.collect_params(pat)) == list(ref.collect_params(pat))
    port.collect_params(pat).setattr("wd_mult", 0.0)
    tr = gluon.Trainer(port.collect_params(), "sgd", {"wd": 0.1})
    wds = {p.name: tr.optimizer._get_wd(i) for i, p in
           enumerate(tr._params)}
    assert all((wd == 0.0) == bool(re.match(pat, name))
               for name, wd in wds.items())
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    const, jconst = gluon.Constant("c", value), mx.gluon.Constant("c", value)
    assert const.grad_req == jconst.grad_req == "null"
    const.initialize(ctx=cpu())
    jconst.initialize()
    np.testing.assert_array_equal(const._tensor().numpy(),
                                  jconst.data().asnumpy())
    assert gluon.Trainer([const], "sgd")._params == []
    port.collect_params().zero_grad()
    port.collect_params().reset_ctx(cpu())


def _train_port(net, trainer, data):
    return [_port_step(net, trainer, x, y) for x, y in data]


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.3, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01}),
    ("nadam", {"learning_rate": 0.01}),
])
def test_resume_equals_uninterrupted_run_bitwise(tmp_path, name, kw):
    """Steps 1-3, then ``save_parameters`` + ``save_states``; a fresh net
    (another seed), a fresh Trainer and a fresh scheduler load both and
    take steps 4-6: the losses and every weight and state equal the
    uninterrupted run's bit for bit."""
    def trainer(net):
        sched = lr_scheduler.MultiFactorScheduler(
            step=[2, 4], factor=0.5, base_lr=kw["learning_rate"],
            warmup_steps=1) if name == "sgd" else None
        return gluon.Trainer(net.collect_params(), name,
                             dict(kw, lr_scheduler=sched))
    data = _data()
    full = _port(seed=0)
    full_tr = trainer(full)
    full_losses = _train_port(full, full_tr, data)
    first = _port(seed=0)
    first_tr = trainer(first)
    _train_port(first, first_tr, data[:3])
    first.save_parameters(str(tmp_path / "net.params"))
    first_tr.save_states(str(tmp_path / "net.states"))
    resumed = _port(seed=9)
    resumed_tr = trainer(resumed)
    resumed.load_parameters(str(tmp_path / "net.params"))
    resumed_tr.load_states(str(tmp_path / "net.states"))
    assert resumed_tr.optimizer.num_update == 3
    losses = _train_port(resumed, resumed_tr, data[3:])
    for a, b in zip(losses, full_losses[3:]):
        assert torch.equal(a, b)
    for a, b in zip(resumed.collect_params().values(),
                    full.collect_params().values()):
        assert torch.equal(a._tensor(), b._tensor())
    for i, s in full_tr._states.items():
        got, want = resumed_tr._states[i], s
        for a, b in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            assert torch.equal(a, b)
    blob = pickle.loads((tmp_path / "net.states").read_bytes())
    assert ("optimizer_extra" in blob) == (name == "nadam")


def _jax_states(trainer):
    return {i: [s.asnumpy() for s in (st if isinstance(st, tuple)
                                      else (st,))]
            for (i, _), st in trainer._states.items()}


def _port_states(trainer):
    return {i: [s.numpy() for s in (st if isinstance(st, tuple)
                                    else (st,))]
            for i, st in trainer._states.items()}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.3, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
])
def test_save_states_cross_loads_both_ways(tmp_path, name, kw):
    """Two steps in one package, ``save_states``, then the other package
    loads the file (and the weights): the states and counts equal the
    saving run's, and one more step in each package agrees within
    1e-6."""
    data = _data(2, steps=3)
    ref = _jax()
    port = _port()
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()}, ctx=cpu())
    # port -> JAX
    ptr = gluon.Trainer(port.collect_params(), name, kw)
    _train_port(port, ptr, data[:2])
    ptr.save_states(str(tmp_path / "port.states"))
    for k, p in ref.collect_params().items():       # copies: no aliasing
        p.set_data(mx.nd.array(port.collect_params()[k]._tensor().detach()
                               .numpy().copy()))
    jtr = mx.gluon.Trainer(ref.collect_params(), name, kw)
    jtr.load_states(str(tmp_path / "port.states"))
    assert jtr.optimizer.num_update == ptr.optimizer.num_update == 2
    assert jtr.optimizer._index_update_count == \
        ptr.optimizer._index_update_count
    for i, arrays in _port_states(ptr).items():
        for a, b in zip(arrays, _jax_states(jtr)[i]):
            np.testing.assert_array_equal(a, b)
    _port_step(port, ptr, *data[2])
    _jax_step(ref, jtr, *data[2])
    _assert_equal_nets(port, ref, atol=1e-6)
    # JAX -> port
    jtr.save_states(str(tmp_path / "jax.states"))
    fresh = _port(seed=6)
    load_reference_params(fresh, {k: p.data().asnumpy() for k, p in
                                  ref.collect_params().items()}, ctx=cpu())
    ftr = gluon.Trainer(fresh.collect_params(), name, kw)
    ftr.load_states(str(tmp_path / "jax.states"))
    assert ftr.optimizer.num_update == 3
    for i, arrays in _jax_states(jtr).items():
        for a, b in zip(arrays, _port_states(ftr)[i]):
            np.testing.assert_array_equal(a, b)
    _port_step(fresh, ftr, *data[0])
    _jax_step(ref, jtr, *data[0])
    _assert_equal_nets(fresh, ref, atol=1e-6)


def test_update_on_kvstore_and_compression(tmp_path):
    """``update_on_kvstore=True`` runs the optimizer through the local
    kvstore's updater: the same weights as the local update, and its
    states saved and loaded through the kvstore.  ``compression_params``
    on a local store warns and changes nothing."""
    data = _data(3, steps=4)
    kw = {"learning_rate": 0.2, "momentum": 0.9}
    local, kv = _port(), _port()
    ltr = gluon.Trainer(local.collect_params(), "sgd", kw)
    with pytest.warns(UserWarning, match="compression"):
        ktr = gluon.Trainer(kv.collect_params(), "sgd", kw,
                            kvstore="local", update_on_kvstore=True,
                            compression_params={"type": "2bit"})
    _train_port(local, ltr, data[:2])
    _train_port(kv, ktr, data[:2])
    for a, b in zip(local.collect_params().values(),
                    kv.collect_params().values()):
        torch.testing.assert_close(a._tensor(), b._tensor(), rtol=0, atol=1e-6)
    with pytest.raises(MXNetError, match="update_on_kvstore"):
        ktr.allreduce_grads()
    ktr.save_states(str(tmp_path / "kv.states"))
    again = _port()
    load_reference_params(again, {k: p._tensor().detach().numpy() for k, p in
                                  kv.collect_params().items()}, ctx=cpu())
    atr = gluon.Trainer(again.collect_params(), "sgd", kw,
                        kvstore="local", update_on_kvstore=True)
    atr.load_states(str(tmp_path / "kv.states"))
    _train_port(kv, ktr, data[2:])
    _train_port(again, atr, data[2:])
    for a, b in zip(again.collect_params().values(),
                    kv.collect_params().values()):
        assert torch.equal(a._tensor(), b._tensor())
    with pytest.raises(MXNetError, match="requires a kvstore"):
        gluon.Trainer(kv.collect_params(), "sgd", kvstore=None,
                      update_on_kvstore=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gluon.Trainer(kv.collect_params(), "sgd", update_on_kvstore=False)


def test_nadam_states_carry_the_schedule_unlike_jax(tmp_path):
    """A departure from the JAX package: the port's ``save_states``
    writes Nadam's ``m_schedule`` (``optimizer_extra``), so the port
    resumes it; the JAX package writes no such key and its resumed Nadam
    starts the schedule again at 1.0 (and ignores the key when it loads
    the port's file)."""
    data = _data(4, steps=2)
    kw = {"learning_rate": 0.01}
    port = _port()
    ptr = gluon.Trainer(port.collect_params(), "nadam", kw)
    _train_port(port, ptr, data)
    ptr.save_states(str(tmp_path / "port.states"))
    resumed = gluon.Trainer(_port().collect_params(), "nadam", kw)
    resumed.load_states(str(tmp_path / "port.states"))
    assert resumed.optimizer.m_schedule == ptr.optimizer.m_schedule != 1.0
    ref = _jax()
    jtr = mx.gluon.Trainer(ref.collect_params(), "nadam", kw)
    jtr.load_states(str(tmp_path / "port.states"))
    assert jtr.optimizer.m_schedule == 1.0
    for x, y in data:
        _jax_step(ref, jtr, x, y)
    jtr.save_states(str(tmp_path / "jax.states"))
    assert "optimizer_extra" not in pickle.loads(
        (tmp_path / "jax.states").read_bytes())
    fresh = gluon.Trainer(_port().collect_params(), "nadam", kw)
    fresh.load_states(str(tmp_path / "jax.states"))
    assert fresh.optimizer.m_schedule == 1.0
