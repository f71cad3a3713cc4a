"""``gluon.contrib`` of the port held against the JAX package on the CPU
(``mxnet_tpu/gluon/contrib/{nn,rnn,estimator}.py``): ``SyncBatchNorm`` on
one process, the convolutional recurrent cells (one step and an unroll),
``VariationalDropoutCell``'s per-sequence masks, and ``Estimator.fit``
with its handlers against the JAX package's on the same batches (fp32,
1e-5).
"""
import logging
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.contrib import estimator as jest
from mxnet_tpu_torch.gluon.contrib import estimator as pest

TOL = dict(rtol=1e-5, atol=1e-5)


def _carry(port_block, ref_block):
    mt.load_reference_params(port_block, {
        k: p.data().asnumpy() for k, p in ref_block.collect_params().items()},
        ctx=mt.cpu())


def test_sync_batch_norm_is_batch_norm_on_one_process():
    x = np.random.default_rng(0).standard_normal((4, 3, 5, 5)) \
        .astype(np.float32)
    ref = mx.gluon.contrib.nn.SyncBatchNorm(in_channels=3, prefix="sbn_")
    ref.initialize()
    with pytest.warns(UserWarning, match="num_devices is ignored"):
        mt.gluon.contrib.nn.SyncBatchNorm(in_channels=3, num_devices=4)
    net = mt.gluon.contrib.nn.SyncBatchNorm(in_channels=3, prefix="sbn_")
    _carry(net, ref)
    with mx.autograd.record():
        want = ref(mx.nd.array(x)).asnumpy()
    with mt.cpu(), mt.autograd.record():
        got = net(mt.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(net.running_mean.data().asnumpy(),
                               ref.running_mean.data().asnumpy(), **TOL)
    assert mt.gluon.contrib.nn.Identity is mt.gluon.nn.Identity
    assert mt.gluon.contrib.nn.HybridConcurrent is \
        mt.gluon.nn.HybridConcurrent


@pytest.mark.parametrize("kind", ["ConvRNNCell", "ConvLSTMCell",
                                  "ConvGRUCell"])
def test_conv_cells_match_the_jax_package(kind):
    rng = np.random.default_rng(1)
    seq = rng.standard_normal((2, 3, 3, 6, 6)).astype(np.float32)  # NTCHW
    ref = getattr(mx.gluon.contrib.rnn, kind)((3, 6, 6), 4, prefix="cc_")
    ref.initialize(mx.init.Xavier())
    ref_states = ref.begin_state(2)
    step, states = ref(mx.nd.array(seq[:, 0]), ref_states)
    ref_outs, ref_last = ref.unroll(3, mx.nd.array(seq), layout="NTC",
                                    merge_outputs=True)
    cell = getattr(mt.gluon.contrib.rnn, kind)((3, 6, 6), 4, prefix="cc_")
    _carry(cell, ref)
    assert sorted(cell.collect_params()) == sorted(ref.collect_params())
    with mt.cpu():
        got, got_states = cell(mt.nd.array(seq[:, 0]),
                               cell.begin_state(2, ctx=mt.cpu()))
        outs, last = cell.unroll(3, mt.nd.array(seq), layout="NTC",
                                 merge_outputs=True)
    np.testing.assert_allclose(got.asnumpy(), step.asnumpy(), **TOL)
    for a, b in zip(states + ref_last, got_states + last):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), **TOL)
    np.testing.assert_allclose(outs.asnumpy(), ref_outs.asnumpy(), **TOL)
    assert cell.state_info(2) == ref.state_info(2)


def test_conv_cell_refuses_an_even_state_kernel():
    with pytest.raises(mt.MXNetError, match="odd"):
        mt.gluon.contrib.rnn.ConvRNNCell((3, 6, 6), 4, h2h_kernel=(2, 2))


def _dropout_cell(lib):
    base = lib.gluon.rnn.LSTMCell(6, input_size=5, prefix="vd_")
    return lib.gluon.contrib.rnn.VariationalDropoutCell(
        base, drop_inputs=0.5, drop_states=0.5, drop_outputs=0.5), base


def test_variational_dropout_is_the_base_cell_outside_recording():
    x = np.random.default_rng(2).standard_normal((2, 4, 5)) \
        .astype(np.float32)
    ref, ref_base = _dropout_cell(mx)
    ref_base.initialize(mx.init.Xavier())
    want, _ = ref.unroll(4, mx.nd.array(x), merge_outputs=True)
    cell, base = _dropout_cell(mt)
    _carry(base, ref_base)
    with mt.cpu():
        got, _ = cell.unroll(4, mt.nd.array(x), merge_outputs=True)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


def test_variational_dropout_keeps_one_mask_a_sequence():
    """While recording, one output mask serves every step (the zeros sit
    in the same units at each step), a new sequence draws again, and
    ``mx.random.seed`` replays the draws."""
    x = np.ones((2, 4, 5), np.float32)
    cell, base = _dropout_cell(mt)
    base.initialize(ctx=mt.cpu(), seed=0)

    def run():
        with mt.cpu(), mt.autograd.record():
            out, _ = cell.unroll(4, mt.nd.array(x), merge_outputs=False)
        return np.stack([o.asnumpy() for o in out])
    mt.random.seed(7)
    first = run()
    zeros = first == 0
    assert zeros.any() and (zeros == zeros[0]).all()
    assert not np.array_equal(run() == 0, zeros)
    mt.random.seed(7)
    np.testing.assert_array_equal(run(), first)


def _mlp(lib):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix="est_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=8),
                nn.Dense(3, in_units=16))
    return net


def _batches():
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((4, 8)).astype(np.float32),
             rng.integers(0, 3, 4).astype(np.float32)) for _ in range(4)]


@pytest.fixture(scope="module")
def fitted():
    """The JAX package's Estimator over 4 batches, 2 epochs, SGD."""
    net = _mlp(mx)
    net.initialize(mx.init.Xavier())
    init = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    est = jest.Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         train_metrics=mx.metric.Accuracy(), trainer=trainer)
    data = [(mx.nd.array(x), mx.nd.array(y)) for x, y in _batches()]
    est.fit(data, val_data=data, epochs=2)
    return dict(init=init, after={k: p.data().asnumpy() for k, p in
                                  net.collect_params().items()},
                acc=est.train_metrics[0].get(),
                val=est.evaluate(data), batches=est.processed_batches)


def _port_estimator(ref, **kw):
    net = _mlp(mt)
    mt.load_reference_params(net, ref["init"], ctx=mt.cpu())
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    est = pest.Estimator(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                          train_metrics=mt.metric.Accuracy(),
                          trainer=trainer, **kw)
    return net, est


def test_estimator_fit_matches_the_jax_package(fitted):
    net, est = _port_estimator(fitted)
    with mt.cpu():
        data = [(mt.nd.array(x), mt.nd.array(y)) for x, y in _batches()]
        est.fit(data, val_data=data, epochs=2)
        val = est.evaluate(data)
    assert est.processed_batches == fitted["batches"] == 8
    for name, p in net.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), fitted["after"][name],
                                   err_msg=name, **TOL)
    assert est.train_metrics[0].get()[0] == fitted["acc"][0]
    np.testing.assert_allclose(est.train_metrics[0].get()[1],
                               fitted["acc"][1])
    np.testing.assert_allclose([v for _, v in val],
                               [v for _, v in fitted["val"]])


def test_estimator_handlers(fitted, tmp_path, caplog):
    net, est = _port_estimator(fitted)
    loss_metric = est.loss_metric
    handlers = [pest.StoppingHandler(max_batch=3),
                pest.CheckpointHandler(str(tmp_path), "m"),
                pest.LoggingHandler(log_interval=1),
                pest.EarlyStoppingHandler(loss_metric, patience=1)]
    with mt.cpu(), caplog.at_level(logging.INFO):
        data = [(x, y) for x, y in _batches()]       # numpy batches
        est.fit(data, epochs=3, event_handlers=handlers)
    assert est.processed_batches == 3 and est.current_epoch == 0
    assert sorted(os.listdir(tmp_path)) == ["m-epoch0.params", "m.states"]
    assert sum("[batch" in r.getMessage() for r in caplog.records) == 3
    net2 = _mlp(mt)
    net2.load_parameters(str(tmp_path / "m-epoch0.params"), ctx=mt.cpu())
    for (_, a), (_, b) in zip(sorted(net.collect_params().items()),
                              sorted(net2.collect_params().items())):
        np.testing.assert_array_equal(a.data().asnumpy(),
                                      b.data().asnumpy())


def test_estimator_refuses_a_loss_that_is_not_a_block():
    with pytest.raises(mt.MXNetError):
        pest.Estimator(_mlp(mt), lambda p, y: p)
    with pytest.raises(mt.MXNetError):
        pest.LoggingHandler(log_interval=0)
    with pytest.raises(mt.MXNetError):
        pest.EarlyStoppingHandler(None, mode="up")
