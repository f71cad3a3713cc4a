"""``HybridBlock.hybridize`` (MXNet's CachedOp) in the port, held against
the JAX package's on the CPU with the same numpy inputs and the JAX
package's weights carried across by ``load_reference_params``.

On the CPU an entry's callable is the eager forward (the CUDA graphs are
held on the card, ``tests/test_torch_cuda.py``), so what these tests hold
is the cache's bookkeeping: the keys, the LRU of 32 and its one warning,
``cache_info()``, ``cast`` dropping the cache, the storage epoch that
``set_data`` advances, children set inactive, BatchNorm's write-back,
dropout, ``cached_graph``, a host-reading block, and training through a
hybridized block.

Tolerances, fp32: outputs and losses 1e-5 (one op, summation order
differs), BatchNorm's running statistics 1e-6, a small BERT's hybridized
losses 1e-5 relative; the port's hybridized call against its own eager
call, bit for bit.
"""
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.contrib import amp as jax_amp
from mxnet_tpu.gluon.model_zoo import transformer as jax_tf
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params, nd
from mxnet_tpu_torch import random as mx_random
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import HybridBlock, nn
from mxnet_tpu_torch.gluon.model_zoo import transformer as port_tf
from mxnet_tpu_torch.gluon.model_zoo.rcnn import mask_rcnn_toy
from mxnet_tpu_torch.kernels import counters


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _np(t):
    return t.detach().float().numpy()


def _seq(lib, widths=(16, 4), in_units=8, **kw):
    net = lib.gluon.nn.HybridSequential(**kw)
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(widths[0], activation="relu",
                                   in_units=in_units),
                lib.gluon.nn.Dense(widths[1], in_units=widths[0]))
    return net


def _pair(widths=(16, 4), in_units=8, prefix="hybrid_sequential97_"):
    """The same MLP in both packages, the port's on the JAX weights."""
    ref = _seq(mx, widths, in_units, prefix=prefix)
    ref.initialize(mx.init.Xavier())
    port = _seq(mt, widths, in_units)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    return ref, port


def test_hybridize_matches_eager_and_jax():
    """(test_gluon.py:42) eager, first and second hybridized calls agree
    in the port bit for bit and with the JAX package's within 1e-5."""
    x = np.random.default_rng(0).random((3, 8), dtype=np.float32)
    ref, port = _pair()
    want = [ref(mx.nd.array(x)).asnumpy()]
    eager = port(torch.from_numpy(x))
    ref.hybridize()
    port.hybridize()
    want += [ref(mx.nd.array(x)).asnumpy() for _ in range(2)]
    hybrid = [port(torch.from_numpy(x)) for _ in range(2)]
    for h in hybrid:
        assert torch.equal(h, eager)
    for w, p in zip(want, [eager] + hybrid):
        np.testing.assert_allclose(_np(p), w, atol=1e-5)
    assert port._cached_graph.cache_info() == \
        ref._cached_graph.cache_info()


def test_hybridized_training_matches_jax():
    """(test_gluon.py:56) 20 hybridized SGD steps: per-step losses within
    1e-5 of the JAX package's hybridized run, and the loss falls."""
    rng = np.random.default_rng(1)
    x = rng.random((8, 4), dtype=np.float32)
    y = np.array([0, 1] * 4, np.float32)
    ref, port = _pair(widths=(16, 2), in_units=4)
    ref.hybridize()
    port.hybridize()
    jt = mx.gluon.Trainer(ref.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    pt = gluon.Trainer(port.collect_params(), "sgd",
                       {"learning_rate": 0.1})
    jl_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    pl_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    theirs, ours = [], []
    for _ in range(20):
        with mx.autograd.record():
            jl = jl_fn(ref(mx.nd.array(x)), mx.nd.array(y))
        jl.backward()
        jt.step(8)
        with autograd.record():
            pl = pl_fn(port(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(pl)
        pt.step(8)
        theirs.append(jl.asnumpy())
        ours.append(_np(pl))
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    assert ours[-1].mean() < ours[0].mean()
    assert port._cached_graph.cache_info() == \
        ref._cached_graph.cache_info()


def test_hybridized_batchnorm_running_stats_match_jax():
    """(test_gluon.py:91) Two recording calls of a hybridized BatchNorm
    write the same running statistics as the JAX package's, within
    1e-6, and the second call moves them."""
    x = (np.random.default_rng(2).random((4, 3, 2, 2), dtype=np.float32)
         * 5 + 2)
    ref = mx.gluon.nn.BatchNorm(in_channels=3)
    ref.initialize()
    port = nn.BatchNorm(in_channels=3)
    port.initialize(ctx=cpu())
    ref.hybridize()
    port.hybridize()
    stats = []
    for _ in range(2):
        with mx.autograd.record():
            ref(mx.nd.array(x))
        with autograd.record():
            port(torch.from_numpy(x))
        for jp, pp in ((ref.running_mean, port.running_mean),
                       (ref.running_var, port.running_var)):
            np.testing.assert_allclose(_np(pp._tensor()), jp.data().asnumpy(),
                                       atol=1e-6)
        stats.append(_np(port.running_mean._tensor()).copy())
    assert not np.allclose(stats[0], stats[1])


def test_set_data_after_the_first_call_changes_the_next_output():
    """Repair of the storage epoch: ``set_data`` after the first
    hybridized call changes the next output in both packages (the JAX
    package re-reads its parameters at every call; the port drops the
    stale entry and makes it anew)."""
    x = np.random.default_rng(3).random((2, 8), dtype=np.float32)
    ref, port = _pair()
    ref.hybridize()
    port.hybridize()
    first = port(torch.from_numpy(x))
    ref(mx.nd.array(x))
    sig_entry = port._cached_graph.values()[0]
    epoch = sig_entry.epoch
    for jp, pp in zip(ref.collect_params().values(),
                      port.collect_params().values()):
        w = jp.data().asnumpy() * 0.5
        jp.set_data(mx.nd.array(w))
        pp.set_data(w)
    want = ref(mx.nd.array(x)).asnumpy()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, atol=1e-5)
    assert not torch.equal(got, first)
    entry = port._cached_graph.values()[0]
    assert entry is not sig_entry and entry.epoch > epoch
    assert port._cached_graph.cache_info()["currsize"] == 1


def test_cast_drops_the_cache_in_both_packages():
    x = np.random.default_rng(4).random((2, 8), dtype=np.float32)
    ref, port = _pair()
    ref.hybridize()
    port.hybridize()
    ref(mx.nd.array(x))
    port(torch.from_numpy(x))
    assert port._cached_graph.cache_info()["currsize"] == 1
    ref.cast("bfloat16")
    port.cast("bfloat16")
    assert port._cached_graph.cache_info() == \
        ref._cached_graph.cache_info() == \
        {"hits": 0, "misses": 0, "maxsize": 32, "currsize": 0}
    out = port(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    assert port._cached_graph.cache_info()["currsize"] == 1


class _JaxDouble(mx.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return x.astype("float32") * 2


class _PortDouble(HybridBlock):
    def forward(self, x):
        return x.float() * 2


def _signature_sequence(net, lib, ag, arr):
    """Calls of ``net`` over shapes, dtypes, training and recording."""
    for shape, dtype, scope in [
            ((2, 3), "float32", None), ((2, 3), "float32", None),
            ((4, 3), "float32", None), ((2, 3), "int32", None),
            ((2, 3), "float32", "train"), ((2, 3), "float32", "record"),
            ((2, 3), "float32", "record"), ((2, 3), "float32", "pause"),
            ((4, 3), "int32", None), ((2, 3), "int32", None)]:
        x = arr(np.ones(shape, dtype))
        if scope is None:
            net(x)
        else:
            with {"train": ag.train_mode, "record": ag.record,
                  "pause": ag.pause}[scope]():
                net(x)


def test_cache_info_and_eviction_match_jax():
    """One entry per (shapes, dtypes, training mode) in both packages (a
    recording and a plain call of one signature share it), the same hits
    and misses; past 32 signatures the oldest is evicted, with one
    ``RuntimeWarning`` of the JAX package's text."""
    ref, port = _JaxDouble(), _PortDouble()
    ref.hybridize()
    port.hybridize()
    _signature_sequence(ref, mx, mx.autograd,
                        lambda a: mx.nd.array(a, dtype=a.dtype))
    _signature_sequence(port, None, autograd, torch.from_numpy)
    assert port._cached_graph.cache_info() == \
        ref._cached_graph.cache_info()
    assert port._cached_graph.cache_info()["currsize"] == 5
    caught = {}
    for name, net, arr in (("jax", ref, mx.nd.array),
                           ("port", port, torch.from_numpy)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for n in range(1, 34):
                net(arr(np.ones((n, 1), np.float32)))
        caught[name] = [str(m.message) for m in w
                        if issubclass(m.category, RuntimeWarning)
                        and "LRU-evicted" in str(m.message)]
    assert port._cached_graph.cache_info() == \
        ref._cached_graph.cache_info()
    assert port._cached_graph.cache_info()["currsize"] == 32
    assert len(caught["port"]) == len(caught["jax"]) == 1
    assert caught["port"][0].replace(port.name, "X") == \
        caught["jax"][0].replace(ref.name, "X")


def test_keys_take_keywords_none_and_amp():
    """The port's blocks take keyword inputs and optional Nones: each
    structure is its own entry; so is each AMP target dtype (a departure:
    the JAX package's jit keeps the graph traced before ``amp.init``)."""
    net = port_tf.bert_small(dropout=0.0)
    net.initialize(ctx=cpu(), seed=0)
    net.hybridize()
    tok = torch.zeros(2, 8, dtype=torch.int32)
    mask = torch.ones(2, 8)
    net(tok, tok)
    net(tok, tok, None)
    net(tok, tok, valid_mask=mask)
    net(tok, tok, mask)
    assert net._cached_graph.cache_info()["currsize"] == 4
    amp.init("bfloat16")
    try:
        mlm, _ = net(tok, tok)
    finally:
        amp.disable()
    assert mlm.dtype == torch.bfloat16
    assert net._cached_graph.cache_info()["currsize"] == 5


def test_amp_after_the_first_call_departs_from_jax():
    """``amp.init`` after the first hybridized call: the port makes a new
    entry and the Dense computes in bf16; the JAX package replays the
    graph it traced in fp32 (ROADMAP.md, departures)."""
    x = np.random.default_rng(5).random((4, 16), dtype=np.float32)
    ref = mx.gluon.nn.Dense(8, in_units=16)
    ref.initialize()
    port = nn.Dense(8, in_units=16)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    ref.hybridize()
    port.hybridize()
    ref(mx.nd.array(x))
    port(torch.from_numpy(x))
    amp.init("bfloat16")
    jax_amp.init("bfloat16")
    try:
        jy = ref(mx.nd.array(x))
        py = port(torch.from_numpy(x))
    finally:
        amp.disable()
        jax_amp.disable()
    assert str(jy.dtype) == "float32"
    assert py.dtype == torch.bfloat16
    assert port._cached_graph.cache_info()["currsize"] == 2


def test_children_are_inactive_as_in_jax():
    """Only the outermost active block keeps a cache: ``hybridize()``
    sets every child inactive, also one hybridized before its parent."""
    ref, port = _pair()
    child = list(port._modules.values())[0]
    ref[0].hybridize()
    child.hybridize()
    assert child._active and ref[0]._active
    ref.hybridize()
    port.hybridize()
    for r, p in zip(ref._children.values(), port._modules.values()):
        assert r._active is p._active is False
    assert port._active and ref._active
    x = np.ones((2, 8), np.float32)
    port(torch.from_numpy(x))
    assert child._cached_graph.cache_info()["currsize"] == 0


def test_translate_stays_eager():
    """``TransformerNMT.translate`` calls the decoder child, which the
    outer ``hybridize()`` set inactive: it runs eagerly, as the JAX
    package's."""
    net = port_tf.TransformerNMT(50, num_layers=1, units=32,
                                 hidden_size=64, num_heads=2)
    net.initialize(ctx=cpu(), seed=0)
    net.hybridize()
    src = np.array([[3, 4, 5, 6]], np.float32)
    tokens, _ = net.translate(nd.array(src, ctx=cpu()), 1, 2, 5, 1)
    assert net._cached_graph.cache_info()["currsize"] == 0
    assert not net.decoder._active and len(tokens) == 1


def test_dropout_is_fresh_and_seeded():
    """(test_random_ops.py:341) Two recording calls of a hybridized
    Dense + Dropout draw different masks, as in the JAX package; a
    reseeded run repeats (``gluon.nn.Dropout`` and ``nd.Dropout``)."""
    class NdDrop(HybridBlock):
        def forward(self, x):
            return nd.Dropout(x, p=0.5)

    def run():
        net = nn.HybridSequential()
        net.add(nn.Dense(16, in_units=8), nn.Dropout(0.5), NdDrop())
        net.initialize(ctx=cpu(), seed=0)
        net.hybridize()
        x = torch.ones(4, 8)
        outs = []
        for _ in range(3):
            with autograd.record():
                outs.append(net(x).detach())
        return outs

    torch.manual_seed(3)
    mx_random.seed(3)
    a = run()
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    torch.manual_seed(3)
    mx_random.seed(3)
    assert all(torch.equal(u, v) for u, v in zip(a, run()))

    ref = mx.gluon.nn.HybridSequential()
    with ref.name_scope():
        ref.add(mx.gluon.nn.Dense(16), mx.gluon.nn.Dropout(0.5))
    ref.initialize()
    ref.hybridize()
    xj = mx.nd.array(np.ones((4, 8), np.float32))
    with mx.autograd.record():
        ja = ref(xj).asnumpy()
    with mx.autograd.record():
        jb = ref(xj).asnumpy()
    assert not np.allclose(ja, jb)


def test_cached_graph_matches_the_hybridized_call_bitwise():
    """(test_serving.py:91) ``cached_graph(x).raw`` equals the hybridized
    call on the same signature bit for bit, and uses the same entry."""
    x = np.random.default_rng(6).standard_normal((4, 8)).astype(np.float32)
    _, port = _pair()
    port.hybridize()
    g = port.cached_graph(x)
    info = port._cached_graph.cache_info()
    with autograd.predict_mode():
        ref = port(torch.from_numpy(x))
    (out,) = g.raw(x)
    assert torch.equal(out, ref.detach())
    assert port._cached_graph.cache_info()["currsize"] == info["currsize"]
    with autograd.record():
        (again,) = g.raw(x)
    assert again.grad_fn is None


def test_cached_graph_of_an_inactive_block_fills_the_cache_as_jax():
    x = np.ones((2, 8), np.float32)
    ref, port = _pair()
    ref.cached_graph(mx.nd.array(x))
    port.cached_graph(x)
    assert port._cached_graph.cache_info() == \
        ref._cached_graph.cache_info()


def test_deferred_shapes_run_eagerly_then_cache_as_jax():
    """A hybridized net with deferred widths: the first call settles them
    eagerly, later calls go through the entry; outputs within 1e-5 of
    the JAX package's and the cache's counts equal."""
    x = np.random.default_rng(7).random((3, 5), dtype=np.float32)
    ref = mx.gluon.nn.HybridSequential(prefix="hybrid_sequential96_")
    with ref.name_scope():
        ref.add(mx.gluon.nn.Dense(6, activation="relu"),
                mx.gluon.nn.Dense(2))
    ref.initialize()
    ref.hybridize()
    port = nn.HybridSequential()
    with port.name_scope():
        port.add(nn.Dense(6, activation="relu"), nn.Dense(2))
    port.initialize(ctx=cpu())
    port.hybridize()
    want = ref(mx.nd.array(x))
    port(torch.from_numpy(x))
    load_reference_params(port, _arrays(ref), ctx=cpu())
    for _ in range(2):
        want = ref(mx.nd.array(x)).asnumpy()
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, atol=1e-5)
    assert port._cached_graph.cache_info() == \
        ref._cached_graph.cache_info()


def _table(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape) \
        .astype(np.float32) * 0.3


class _JaxTable(mx.init.Initializer):
    def _init_weight(self, name, arr):
        arr[:] = _table(arr.shape)


class _PortTable(mt.initializer.Initializer):
    def init_weight(self, name, arr, generator):
        arr.copy_(torch.from_numpy(_table(tuple(arr.shape))))


def test_deferred_first_step_records_then_replays_as_jax():
    """A hybridized net with deferred widths whose first call is a
    training step under ``record()`` (Gluon's usual loop): that call
    settles the widths and records, as the JAX package's first call runs
    eagerly on the tape, so its loss and gradients equal the JAX
    package's within 1e-5; the second step goes through the entry with
    the same agreement."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 5)).astype(np.float32)
    y = np.array([0, 1, 1, 0], np.float32)
    ref = mx.gluon.nn.HybridSequential(prefix="hybrid_sequential95_")
    with ref.name_scope():
        ref.add(mx.gluon.nn.Dense(6, activation="relu"),
                mx.gluon.nn.Dense(2))
    ref.initialize(_JaxTable())
    port = nn.HybridSequential()
    with port.name_scope():
        port.add(nn.Dense(6, activation="relu"), nn.Dense(2))
    port.initialize(_PortTable(), ctx=cpu())
    ref.hybridize()
    port.hybridize()
    jt = mx.gluon.Trainer(ref.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    pt = gluon.Trainer(port.collect_params(), "sgd", {"learning_rate": 0.1})
    jl_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    pl_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        with mx.autograd.record():
            jl = jl_fn(ref(mx.nd.array(x)), mx.nd.array(y))
        jl.backward()
        with autograd.record():
            pl = pl_fn(port(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(pl)
        np.testing.assert_allclose(_np(pl), jl.asnumpy(), atol=1e-5)
        for (name, jp), pp in zip(ref.collect_params().items(),
                                  port.collect_params().values()):
            np.testing.assert_allclose(_np(pp._grad_tensor()),
                                       jp.grad().asnumpy(),
                                       atol=1e-5, err_msg=name)
        jt.step(4)
        pt.step(4)
    stats = port.graph_stats()
    assert (stats["deferred_calls"], stats["cpu_calls"]) == (1, 1)
    assert port._cached_graph.cache_info() == \
        ref._cached_graph.cache_info()


REF_PREFIX = "bertmodel97_"


@pytest.fixture(scope="module")
def jax_bert_hybridized():
    """3 hybridized Adam steps of ``bert_small(dropout=0.0)`` in the JAX
    package (its plain attention path): initial weights and losses."""
    mx.random.seed(0)
    ref = jax_tf.bert_small(dropout=0.0, prefix=REF_PREFIX)
    ref.initialize()
    ref.hybridize()
    init = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    tr = mx.gluon.Trainer(ref.collect_params(), "adam",
                          {"learning_rate": 1e-4})
    inputs, segs, vl, labels, weights, nsp_y = \
        chip_smoke.bert_batch(0, 2, 32, 1000)
    x = (mx.nd.array(inputs, dtype="int32"), mx.nd.array(segs, dtype="int32"),
         mx.nd.array(vl))
    y = (mx.nd.array(labels, dtype="int32"), mx.nd.array(weights),
         mx.nd.array(nsp_y, dtype="int32"))
    losses = []
    for _ in range(3):
        with mx.autograd.record():
            loss = chip_smoke.mlm_nsp_loss(*ref(*x), *y, F=mx.nd)
        loss.backward()
        tr.step(1)
        losses.append(float(loss.asnumpy()))
    return init, losses, ref._cached_graph.cache_info()


def test_small_bert_trains_hybridized_like_jax(jax_bert_hybridized):
    """3 hybridized Adam steps of ``bert_small``: losses within 1e-5
    relative of the JAX package's hybridized run; one entry, as there."""
    init, want, info = jax_bert_hybridized
    net = port_tf.bert_small(dropout=0.0)
    load_reference_params(net, init, ctx=cpu())
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-4})
    batch = [torch.as_tensor(a) for a in chip_smoke.bert_batch(0, 2, 32,
                                                                1000)]
    losses = []
    for _ in range(3):
        with autograd.record():
            loss = chip_smoke.mlm_nsp_loss(*net(*batch[:3]), *batch[3:])
        autograd.backward(loss)
        tr.step(1)
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert net._cached_graph.cache_info() == info


def test_mask_rcnn_warns_once_and_equals_eager():
    """A host-reading block (Mask-RCNN's NMS reads its keep set on the
    host): ``hybridize()`` warns once, its calls run eagerly and are
    counted, and the outputs equal the eager net's."""
    net = mask_rcnn_toy(classes=3)
    net.initialize(ctx=cpu(), seed=0)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 3, 64, 64)).astype(np.float32))
    with autograd.predict_mode():
        want = net(x)
    with pytest.warns(RuntimeWarning, match="reads the host"):
        net.hybridize()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        net.hybridize()                 # once per block
        with autograd.predict_mode():
            outs = [net(x) for _ in range(2)]
    assert net.eager_calls == 2
    assert net._cached_graph.cache_info()["currsize"] == 0
    for out in outs:
        for a, b in zip(out, want):
            assert torch.equal(a, b)


def test_launch_counts_held_back_by_a_capture_and_added_per_replay():
    """``counters``: outside a captured stream a launch counts at once;
    a capture's delta counts only when replayed."""
    class Holder:
        launches = 0
    by = {"torch.float32": 0}
    counters.bump(Holder, "launches")
    with counters.recording() as delta:
        counters.bump(Holder, "launches")        # no stream captures here
    assert Holder.launches == 2 and delta == {}
    delta = {(id(Holder), "launches"): (Holder, "launches", 3),
             (id(by), "torch.float32"): (by, "torch.float32", 3)}
    for _ in range(2):
        counters.replay(delta)
    assert Holder.launches == 8 and by["torch.float32"] == 6
