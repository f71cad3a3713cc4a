"""The port's Module API (``Module``, ``BucketingModule``, the updater,
the kvstore, ``io``, ``metric``, ``callback`` and ``model``) held against
the JAX package's.

Config #4's bucketing workflow at a small size (``mx.rnn`` LSTM, hidden
16, embedding 16, vocabulary 20, buckets 4 and 6, batch 4): both
packages' ``BucketingModule``s start from the JAX module's initialised
weights and take the same 5 batches through ``forward``, ``backward`` and
``update`` (SGD with momentum, so the updater's states matter); the
first gradients, every weight after the 5 updates and the
``Perplexity`` over the 5 batches agree within 1e-5.  Checkpoints cross
between the packages both ways.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB, EMB, HID, BATCH, BUCKETS, STEPS = 20, 16, 16, 4, (4, 6), 5
OPT = {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-5}


def _sym_gen(pkg):
    def sym_gen(seq_len):
        data, label = pkg.sym.var("data"), pkg.sym.var("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=VOCAB, output_dim=EMB,
                                  name="embed")
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(pkg.rnn.LSTMCell(HID, prefix=f"lstm_l{i}_"))
        outputs, _ = stack.unroll(seq_len, embed, layout="NTC",
                                  merge_outputs=True)
        pred = pkg.sym.reshape(outputs, shape=(-1, HID))
        pred = pkg.sym.FullyConnected(pred, num_hidden=VOCAB, name="pred")
        label = pkg.sym.reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _batches():
    rs = np.random.RandomState(0)
    out = []
    for step in range(STEPS):
        key = BUCKETS[step % 2 == 0]
        data = rs.randint(1, VOCAB, (BATCH, key)).astype(np.float32)
        data[0, -1] = 0
        label = np.zeros_like(data)
        label[:, :-1] = data[:, 1:]
        out.append((key, data, label))
    return out


def _batch(pkg, key, data, label, ctx):
    return pkg.io.DataBatch(
        [pkg.nd.array(data, ctx=ctx)], [pkg.nd.array(label, ctx=ctx)],
        bucket_key=key,
        provide_data=[pkg.io.DataDesc("data", data.shape)],
        provide_label=[pkg.io.DataDesc("softmax_label", label.shape)])


def _drive(pkg, ctx, arg_params=None):
    """A BucketingModule over the batches; returns the initial weights,
    the first gradients, the final weights and the perplexity."""
    mod = pkg.mod.BucketingModule(_sym_gen(pkg), default_bucket_key=6,
                                  context=ctx)
    shape = (BATCH, 6)
    mod.bind(data_shapes=[pkg.io.DataDesc("data", shape)],
             label_shapes=[pkg.io.DataDesc("softmax_label", shape)])
    mod.init_params(arg_params=arg_params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    metric = pkg.metric.Perplexity(ignore_label=0)
    grads = None
    for key, data, label in _batches():
        batch = _batch(pkg, key, data, label, ctx)
        mod.forward(batch, is_train=True)
        mod.backward()
        if grads is None:
            cur = mod._curr_module
            grads = {n: cur._exec_group.grad_arrays_of(n)[0].asnumpy()
                     for n in cur._param_names}
        mod.update()
        mod.update_metric(metric, batch.label)
    final = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return {"mod": mod, "init": init, "grads": grads, "final": final,
            "perplexity": metric.get()[1]}


@pytest.fixture(scope="module")
def jax_run():
    mx.random.seed(0)
    return _drive(mx, mx.cpu())


@pytest.fixture(scope="module")
def port_run(jax_run):
    arg = {k: nd.array(v, ctx=mt.cpu()) for k, v in jax_run["init"].items()}
    return _drive(mt, mt.cpu(), arg)


def test_parameters_match_jax_after_five_updates(jax_run, port_run):
    assert port_run["final"].keys() == jax_run["final"].keys()
    for k, w in jax_run["final"].items():
        assert not np.allclose(w, jax_run["init"][k]) or k.endswith("bias")
        np.testing.assert_allclose(port_run["final"][k], w, err_msg=k, **TOL)


def test_first_gradients_match_jax(jax_run, port_run):
    for k, g in jax_run["grads"].items():
        np.testing.assert_allclose(port_run["grads"][k], g, err_msg=k,
                                   **TOL)


def test_perplexity_matches_jax(jax_run, port_run):
    assert abs(port_run["perplexity"] - jax_run["perplexity"]) <= \
        1e-5 * jax_run["perplexity"]


def test_buckets_share_the_parameter_tensors(port_run):
    mods = list(port_run["mod"].buckets.values())
    assert len(mods) == 2
    a, b = mods
    for n in a._param_names:
        assert a._arg_params[n]._data.data_ptr() == \
            b._arg_params[n]._data.data_ptr()
        assert a._grad_params[n]._data.data_ptr() == \
            b._grad_params[n]._data.data_ptr()
    assert a._updater is b._updater


def test_lstm_forget_bias_from_the_initializer():
    mt.random.seed(0)
    mod = mt.mod.BucketingModule(_sym_gen(mt), default_bucket_key=4,
                                 context=mt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 4))],
             label_shapes=[("softmax_label", (BATCH, 4))])
    mod.init_params()
    arg, _ = mod.get_params()
    bias = arg["lstm_l0_i2h_bias"].asnumpy()
    assert (bias[HID:2 * HID] == 1.0).all() and (bias[:HID] == 0).all()
    w = arg["embed_weight"].asnumpy()
    assert 0 < np.abs(w).max() <= 0.01


def test_checkpoint_round_trips_and_loads_in_jax(port_run, tmp_path):
    prefix = str(tmp_path / "lm")
    port_run["mod"].save_checkpoint(prefix, 3, save_optimizer_states=True)
    sym, arg, aux = mx.model.load_checkpoint(prefix, 3)
    assert sym.list_arguments() == \
        port_run["mod"].symbol.list_arguments()
    for k, w in port_run["final"].items():
        np.testing.assert_array_equal(arg[k].asnumpy(), w)
    sym2, arg2, _ = mt.model.load_checkpoint(prefix, 3, ctx=mt.cpu())
    for k, w in port_run["final"].items():
        np.testing.assert_array_equal(arg2[k].asnumpy(), w)
    # the optimizer states come back into a loaded module
    mod = mt.mod.Module.load(prefix, 3, load_optimizer_states=True,
                             context=mt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 6))],
             label_shapes=[("softmax_label", (BATCH, 6))])
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    before = port_run["mod"]._buckets[6]._updater.states
    after = mod._updater.states
    assert before.keys() == after.keys()
    for k in before:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)


def test_jax_checkpoint_loads_and_runs_in_port(jax_run, tmp_path):
    prefix = str(tmp_path / "jax_lm")
    jmod = jax_run["mod"]
    jmod.save_checkpoint(prefix, 1)
    key, data, label = _batches()[0]
    jmod.forward(_batch(mx, key, data, label, mx.cpu()), is_train=False)
    want = jmod.get_outputs()[0].asnumpy()
    mod = mt.mod.Module.load(prefix, 1, context=mt.cpu())
    mod.bind(data_shapes=[("data", data.shape)],
             label_shapes=[("softmax_label", label.shape)],
             for_training=False)
    mod.forward(_batch(mt, key, data, label, mt.cpu()), is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want, **TOL)


def _mlp(pkg):
    data = pkg.sym.var("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(data, num_hidden=8,
                                                  name="fc1"),
                           act_type="relu")
    out = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(out, pkg.sym.var("softmax_label"),
                                 name="softmax")


def _mlp_data():
    rs = np.random.RandomState(2)
    x = rs.randn(30, 5).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.float32) + (x[:, 1] > 0)


def test_module_fit_score_predict_match_jax():
    """``Module.fit`` (NDArrayIter, last batch padded, Adam), ``score``
    and ``predict`` in both packages from the JAX module's initial
    weights."""
    x, y = _mlp_data()
    mx.random.seed(0)
    mod0 = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod0.bind([("data", (8, 5))], [("softmax_label", (8,))])
    mod0.init_params()
    init = {k: v.asnumpy() for k, v in mod0.get_params()[0].items()}
    runs = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        it = pkg.io.NDArrayIter(x, y, batch_size=8)
        mod = pkg.mod.Module(_mlp(pkg), context=ctx)
        mod.fit(it, num_epoch=3, optimizer="adam",
                optimizer_params={"learning_rate": 0.05},
                arg_params={k: pkg.nd.array(v, ctx=ctx)
                            for k, v in init.items()},
                eval_metric="acc")
        arg, _ = mod.get_params()
        runs.append(({k: v.asnumpy() for k, v in arg.items()},
                     dict(mod.score(it, ["acc", "ce"])),
                     mod.predict(it).asnumpy()))
    (wj, sj, pj), (wp, sp, pp) = runs
    for k in wj:
        assert not np.allclose(wj[k], init[k]), k
        np.testing.assert_allclose(wp[k], wj[k], err_msg=k, **TOL)
    assert sp.keys() == sj.keys()
    for k in sj:
        assert abs(sp[k] - sj[k]) <= 1e-5, k
    assert pp.shape == pj.shape == (30, 3)
    np.testing.assert_allclose(pp, pj, **TOL)


def test_module_defaults_to_the_current_context():
    mod = mt.mod.Module(_mlp(mt))
    assert mod._context == [mt.current_context()] == [mt.gpu(0)]
    with mt.cpu():
        assert mt.mod.Module(_mlp(mt))._context == [mt.cpu()]


def test_module_errors_and_fixed_params():
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu(),
                        fixed_param_names=["fc1_weight"])
    with pytest.raises(MXNetError, match="bind"):
        mod.init_params()
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    with pytest.raises(MXNetError, match="missing parameter"):
        mod.init_params(arg_params={"fc1_bias": nd.zeros((8,),
                                                         ctx=mt.cpu())})
    mod.init_params()
    mod.init_optimizer(optimizer_params={"learning_rate": 1.0})
    before = mod.get_params()[0]
    x, y = _mlp_data()
    mod.forward_backward(mt.io.DataBatch([nd.array(x[:4], ctx=mt.cpu())],
                                         [nd.array(y[:4], ctx=mt.cpu())]))
    mod.update()
    after = mod.get_params()[0]
    np.testing.assert_array_equal(after["fc1_weight"].asnumpy(),
                                  before["fc1_weight"].asnumpy())
    assert not np.array_equal(after["fc2_weight"].asnumpy(),
                              before["fc2_weight"].asnumpy())
    with pytest.raises(MXNetError, match="contexts"):
        m = mt.mod.Module(_mlp(mt), context=[mt.cpu(), mt.cpu()])
        m.bind([("data", (4, 5))], [("softmax_label", (4,))])


def test_ndarray_iter_matches_jax():
    x = np.arange(21, dtype=np.float32).reshape(7, 3)
    y = np.arange(7, dtype=np.float32)
    for handle in ("pad", "discard", "roll_over"):
        got = []
        for pkg in (mt, mx):
            it = pkg.io.NDArrayIter(x, y, batch_size=3,
                                    last_batch_handle=handle)
            got.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                        for epoch in range(2) for b in it])
            assert it.provide_data[0].name == "data"
            assert it.provide_label[0].shape == (3,)
        assert len(got[0]) == len(got[1])
        for a, b in zip(*got):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]


@pytest.mark.parametrize("name,kwargs", [
    ("perplexity", {}), ("perplexity", {"ignore_label": 1}),
    ("ce", {}), ("loss", {}), ("acc", {})])
def test_metrics_match_jax(name, kwargs):
    rs = np.random.RandomState(6)
    p = rs.rand(6, 4).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    label = rs.randint(0, 4, (6,)).astype(np.float32)
    ours = mt.metric.create(name, **kwargs)
    theirs = mx.metric.create(name, **kwargs)
    for _ in range(2):
        ours.update([nd.array(label, ctx=mt.cpu())],
                    [nd.array(p, ctx=mt.cpu())])
        theirs.update([mx.nd.array(label)], [mx.nd.array(p)])
    assert ours.get()[0] == theirs.get()[0]
    assert abs(ours.get()[1] - theirs.get()[1]) <= 1e-6 * max(
        1.0, abs(theirs.get()[1]))
    comp = mt.metric.create([name, "acc"])
    assert isinstance(comp, mt.metric.CompositeEvalMetric)


def test_updater_states_round_trip_with_jax():
    w = np.random.RandomState(8).randn(5).astype(np.float32)
    g = np.ones(5, np.float32)
    up = mt.optimizer.get_updater(mt.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9))
    weight = nd.array(w, ctx=mt.cpu())
    up(0, nd.array(g, ctx=mt.cpu()), weight)
    blob = up.get_states(dump_optimizer=True)
    jup = mx.optimizer.get_updater(mx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9))
    jup.set_states(blob)
    np.testing.assert_allclose(jup.states[0].asnumpy(),
                               up.states[0].numpy())
    fresh = mt.optimizer.get_updater(mt.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9))
    fresh.set_states(jup.get_states())
    torch.testing.assert_close(fresh.states[0], up.states[0])


def test_kvstore_local_push_pull_and_dist_refusal():
    kv = mt.kvstore.create("local")
    with mt.cpu():
        kv.init(3, nd.ones((2,)))
        kv.push(3, [nd.ones((2,)), nd.ones((2,)) * 2])
        np.testing.assert_array_equal(kv.pull(3).asnumpy(), [3, 3])
        out = nd.zeros((2,))
        kv.pull(3, out=out)
        np.testing.assert_array_equal(out.asnumpy(), [3, 3])
        kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.5))
        kv.push(3, nd.ones((2,)))
        np.testing.assert_array_equal(kv.pull(3).asnumpy(), [2.5, 2.5])
        with pytest.raises(MXNetError, match="not initialized"):
            kv.pull(9)
    # nccl is the one-process store here; a dist store without the
    # launcher's variables (or a joined group) refuses, as in the JAX
    # package, and dist_async is refused by design
    assert mt.kvstore.create("nccl").type == "nccl"
    with pytest.raises(MXNetError, match="launcher env vars are unset"):
        mt.kvstore.create("dist_sync")
    with pytest.raises(MXNetError, match="dist_async"):
        mt.kvstore.create("dist_async")


def test_callbacks(tmp_path, caplog):
    speed = mt.callback.Speedometer(batch_size=4, frequent=2)
    metric = mt.metric.create("acc")
    metric.update([np.array([1])], [np.array([[0.2, 0.8]])])
    with caplog.at_level(logging.INFO):
        for n in range(5):
            speed(mt.model.BatchEndParam(0, n, metric, None))
    assert len(speed.speeds) == 2 and all(s > 0 for s in speed.speeds)
    assert "samples/sec" in caplog.text
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    mod.init_params()
    arg, aux = mod.get_params()
    mt.callback.do_checkpoint(str(tmp_path / "m"), period=2)(
        1, mod.symbol, arg, aux)
    assert (tmp_path / "m-0002.params").exists()
    mt.callback.module_checkpoint(mod, str(tmp_path / "n"))(0)
    assert (tmp_path / "n-0001.params").exists()
    assert (tmp_path / "n-symbol.json").exists()
