"""The port's ``mx.rnn`` (symbolic cells, ``encode_sentences``,
``BucketSentenceIter``) held against the JAX package's.

Each cell is unrolled in both packages into a graph with the same
arguments; bound over the same numpy weights (hidden 16, input 8,
batch 3, 5 steps), the outputs and every gradient agree within 1e-5.
The data helpers give the same ids and, from the same Python and numpy
seeds, the same batches in the same order.
"""
import random
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd, rnn
from mxnet_tpu_torch.base import MXNetError

TOL = dict(atol=1e-5, rtol=1e-5)
N, T, I, H = 3, 5, 8, 16


def _numberless(names):
    return [re.sub(r"\d+", "#", n) for n in names]


def _cell(pkg, kind):
    if kind == "stack":
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.LSTMCell(H, prefix="l0_"))
        stack.add(pkg.rnn.GRUCell(H, prefix="l1_"))
        return stack
    cls = {"lstm": pkg.rnn.LSTMCell, "gru": pkg.rnn.GRUCell,
           "rnn": pkg.rnn.RNNCell}[kind]
    return cls(H, prefix=f"{kind}_")


def _unrolled(pkg, kind, merge):
    data = pkg.sym.var("data")
    outputs, states = _cell(pkg, kind).unroll(T, data, layout="NTC",
                                              merge_outputs=merge)
    if merge:
        return pkg.sym.Group([outputs] + list(states))
    return pkg.sym.Group(list(outputs) + list(states))


def _run(pkg, sym, values, head_seed=7):
    ctx = pkg.cpu()
    exe = sym.simple_bind(ctx=ctx, data=(N, T, I))
    for k, v in values.items():
        exe.arg_dict[k][:] = pkg.nd.array(v, ctx=ctx)
    outs = exe.forward(is_train=True)
    rs = np.random.RandomState(head_seed)
    heads = [rs.randn(*o.shape).astype(np.float32) for o in outs]
    exe.backward([pkg.nd.array(h, ctx=ctx) for h in heads])
    return ([o.asnumpy() for o in outs],
            {k: g.asnumpy() for k, g in exe.grad_dict.items()})


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn", "stack"])
@pytest.mark.parametrize("merge", [True, False])
def test_unrolled_cell_matches_jax(kind, merge):
    ours, theirs = _unrolled(mt, kind, merge), _unrolled(mx, kind, merge)
    assert ours.list_arguments() == theirs.list_arguments()
    # auto-named nodes carry each package's own counters
    assert _numberless(ours.list_outputs()) == \
        _numberless(theirs.list_outputs())
    shapes, _, _ = theirs.infer_shape(data=(N, T, I))
    assert ours.infer_shape(data=(N, T, I))[0] == shapes
    rs = np.random.RandomState(1)
    values = {n: (rs.randn(*s) * 0.3).astype(np.float32)
              for n, s in zip(theirs.list_arguments(), shapes)}
    outs, grads = _run(mt, ours, values)
    want_outs, want_grads = _run(mx, theirs, values)
    for a, b in zip(outs, want_outs):
        np.testing.assert_allclose(a, b, **TOL)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k], g, err_msg=k, **TOL)


def test_lstm_bias_initialises_the_forget_gate():
    sym = _unrolled(mt, "lstm", True)
    init = sym.attr_dict()["lstm_i2h_bias"]["__init__"]
    bias = np.zeros(4 * H, np.float32)
    t = torch.from_numpy(bias)
    mt.init.Uniform()(mt.init.InitDesc("lstm_i2h_bias",
                                       {"__init__": init}), t,
                      torch.Generator())
    assert (bias[H:2 * H] == 1.0).all()
    assert (bias[:H] == 0).all() and (bias[2 * H:] == 0).all()


def test_encode_sentences_matches_jax():
    sents = [["a", "b", "c"], ["c", "d"], ["e", "a", "f", "g"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 1}):
        assert rnn.encode_sentences(sents, **kw) == \
            mx.rnn.encode_sentences(sents, **kw)
    vocab = {"\n": -1, "a": 0, "b": 1}
    with pytest.raises(MXNetError, match="unknown token"):
        rnn.encode_sentences([["a", "z"]], vocab=dict(vocab))
    coded, v = rnn.encode_sentences([["a", "z"]], vocab=dict(vocab),
                                    unknown_token="<unk>")
    assert coded == [[0, 2]] and v["<unk>"] == 2


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    rs = np.random.RandomState(3)
    sents = [list(rs.randint(1, 30, rs.randint(2, 9))) for _ in range(90)]
    batches = []
    for pkg in (rnn, mx.rnn):
        random.seed(11)
        np.random.seed(11)
        it = pkg.BucketSentenceIter(sents, 4, buckets=[4, 6, 8],
                                    invalid_label=0, layout=layout)
        batches.append([(b.bucket_key, b.data[0].asnumpy(),
                         b.label[0].asnumpy(), b.provide_data[0].shape)
                        for b in it])
        batches[-1].append((it.default_bucket_key, it.ndiscard,
                            it.provide_data[0].shape))
    assert len(batches[0]) == len(batches[1]) > 10
    for ours, theirs in zip(*batches):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    # labels are the data shifted by one, padded with invalid_label
    key, data, label, _ = batches[0][0]
    if layout == "TN":
        data, label = data.T, label.T
    np.testing.assert_array_equal(label[:, :-1], data[:, 1:])
    assert (label[:, -1] == 0).all()


def test_bucket_sentence_iter_yields_cpu_ndarrays():
    it = rnn.BucketSentenceIter([[1, 2, 3]] * 4, 2, buckets=[3])
    batch = next(iter(it))
    assert isinstance(batch.data[0], nd.NDArray)
    assert batch.data[0].context == mt.cpu()
    assert batch.bucket_key == 3
