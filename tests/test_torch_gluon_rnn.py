"""``gluon.rnn`` in the port (the recurrent cells, ``unroll``, and the
``RNN``/``LSTM``/``GRU`` layers over the fused ``RNN`` op), held against
the JAX package on the CPU with the same numpy inputs and the JAX
package's weights carried across by ``load_reference_params``: outputs,
final states and gradients (inputs, states, every parameter), then two
steps of a small word language model trained in both packages.

The departures from the JAX package follow MXNet, each with its test:
dropout between layers (the JAX op ignores ``p``), the states ``unroll``
returns with ``valid_length`` (each sequence's at its last valid step),
and ``params=`` tying a decoder to an embedding.

Tolerance, fp32: ``atol=1e-5, rtol=1e-5`` (a few recurrent steps of one
evaluation each), 1e-4 for the language model's weights after two SGD
steps at lr 20.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, cpu, load_reference_params, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import ops_nn

TOL = dict(atol=1e-5, rtol=1e-5)
RS = np.random.RandomState(23)


def _arrays(net):
    """The JAX package's parameters as numpy arrays."""
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _port_arrays(net):
    return {k: p.data().detach().numpy()
            for k, p in net.collect_params().items()}


def _pair(make, x_shape):
    """``make(lib)`` in both packages, the JAX one initialized and run
    once (its deferred shapes), its weights carried into the port's."""
    ref = make(mx)
    ref.initialize(mx.init.Xavier())
    port = make(mt)
    port.initialize(ctx=cpu())
    return ref, port


def _grads(net):
    return [p.grad() for p in net.collect_params().values()
            if p.grad_req != "null"]


def _check_grads(port, ref, tol=TOL):
    ours = [g.numpy() for g in _grads(port)]
    theirs = [g.asnumpy() for g in _grads(ref)]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, **tol)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in _flat(o)]
    return [out]


def _run(lib, net, x, states, unroll=None):
    """Forward (or ``unroll``) under ``record()``, a backward with a
    seeded head gradient on every output; returns the outputs and the
    gradients of the input and the states."""
    nd_ = lib.nd
    arrays = [nd_.array(x)] + [nd_.array(s) for s in states]
    for a in arrays:
        a.attach_grad()
    with lib.autograd.record():
        if unroll is not None:
            out = net.unroll(begin_state=arrays[1:] or None,
                             inputs=arrays[0], **unroll)
        elif states:
            out = net(arrays[0], arrays[1:])
        else:
            out = net(arrays[0])
    outs = _flat(out)
    rng = np.random.default_rng(3)
    heads = [nd_.array(rng.standard_normal(o.shape).astype(np.float32))
             for o in outs]
    lib.autograd.backward(outs, heads)
    return ([o.asnumpy() for o in outs],
            [a.grad.asnumpy() for a in arrays])


def _compare(make, x, states=(), unroll=None, tol=TOL):
    ref, port = _pair(make, x.shape)
    if unroll is not None:
        ref.unroll(inputs=mx.nd.array(x), **unroll)
    elif states:
        ref(mx.nd.array(x), [mx.nd.array(s) for s in states])
    else:
        ref(mx.nd.array(x))
    load_reference_params(port, _arrays(ref), ctx=cpu())
    want, want_g = _run(mx, ref, x, states, unroll)
    with mt.cpu():
        got, got_g = _run(mt, port, x, states, unroll)
    assert len(got) == len(want)
    for a, b in zip(got + got_g, want + want_g):
        np.testing.assert_allclose(a, b, **tol)
    _check_grads(port, ref, tol)
    return ref, port


# ---------------------------------------------------------------------------
# cells

X_NTC = RS.randn(3, 5, 8).astype(np.float32)
X_TNC = RS.randn(5, 3, 8).astype(np.float32)


@pytest.mark.parametrize("cell,layout", [
    ("RNNCell", "NTC"), ("LSTMCell", "NTC"), ("GRUCell", "TNC"),
    ("LSTMCell", "TNC")])
def test_cell_unroll_matches_jax(cell, layout):
    x = X_NTC if layout == "NTC" else X_TNC
    _compare(lambda lib: getattr(lib.gluon.rnn, cell)(16),
             x, unroll={"length": 5, "layout": layout})


def test_cell_step_with_states_matches_jax():
    h = RS.randn(3, 16).astype(np.float32)
    c = RS.randn(3, 16).astype(np.float32)
    _compare(lambda lib: lib.gluon.rnn.LSTMCell(16, input_size=8),
             X_NTC[:, 0], states=(h, c))


def _stack(lib):
    r = lib.gluon.rnn
    seq = r.SequentialRNNCell()
    with seq.name_scope():
        seq.add(r.LSTMCell(16, input_size=8))
        seq.add(r.DropoutCell(0.0))
        seq.add(r.ResidualCell(r.GRUCell(16, input_size=16)))
    return seq


def _bidir(lib):
    r = lib.gluon.rnn
    return r.BidirectionalCell(r.LSTMCell(16, input_size=8),
                               r.GRUCell(16, input_size=8))


@pytest.mark.parametrize("make,layout", [(_stack, "NTC"), (_bidir, "NTC"),
                                         (_bidir, "TNC")],
                         ids=["sequential_dropout_residual",
                              "bidirectional_ntc", "bidirectional_tnc"])
def test_modifier_cells_match_jax(make, layout):
    x = X_NTC if layout == "NTC" else X_TNC
    _compare(make, x, unroll={"length": 5, "layout": layout})


def test_unroll_with_valid_length_masks_and_keeps_each_last_state():
    """Outputs past each length are zero in both packages; the states are
    each sequence's at its last valid step (MXNet's ``unroll``): the JAX
    package's cell unrolled over that sequence alone gives them, while
    its own ``unroll`` returns the batch's last step."""
    lengths = np.array([5, 2, 3], np.float32)
    ref = mx.gluon.rnn.LSTMCell(16, input_size=8)
    ref.initialize(mx.init.Xavier())
    port = mt.gluon.rnn.LSTMCell(16, input_size=8)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    want, jax_states = ref.unroll(5, mx.nd.array(X_NTC), layout="NTC",
                                  valid_length=mx.nd.array(lengths))
    with mt.cpu():
        got, states = port.unroll(5, nd.array(X_NTC), layout="NTC",
                                  valid_length=nd.array(lengths))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    for i, n in enumerate(lengths.astype(int)):
        _, alone = ref.unroll(int(n), mx.nd.array(X_NTC[i:i + 1, :n]),
                              layout="NTC")
        for s, a in zip(states, alone):
            np.testing.assert_allclose(s.asnumpy()[i], a.asnumpy()[0],
                                       **TOL)
    assert not np.allclose(states[0].asnumpy()[1],
                           jax_states[0].asnumpy()[1], atol=1e-3)


def test_begin_state_and_bidirectional_step_refusal():
    with mt.cpu():
        cell = mt.gluon.rnn.LSTMCell(6)
        st = cell.begin_state(4)
        assert [s.shape for s in st] == [(4, 6), (4, 6)]
        layer = mt.gluon.rnn.GRU(5, num_layers=3, bidirectional=True)
        assert [s.shape for s in layer.begin_state(2)] == [(6, 2, 5)]
    bi = mt.gluon.rnn.BidirectionalCell(mt.gluon.rnn.RNNCell(4),
                                        mt.gluon.rnn.RNNCell(4))
    with pytest.raises(MXNetError):
        bi(torch.zeros(2, 3), [torch.zeros(2, 4)] * 2)


# ---------------------------------------------------------------------------
# the fused layers and the RNN op


@pytest.mark.parametrize("kind,layout,bidir", [
    ("LSTM", "TNC", False), ("LSTM", "NTC", True), ("GRU", "TNC", True),
    ("GRU", "NTC", False), ("RNN", "TNC", True), ("RNN", "NTC", False)])
def test_layer_matches_jax(kind, layout, bidir):
    """Two layers of width 16: the output, the final states and every
    gradient, with states given."""
    x = X_NTC if layout == "NTC" else X_TNC
    dirs = 2 if bidir else 1
    states = [RS.randn(2 * dirs, 3, 16).astype(np.float32)
              for _ in range(2 if kind == "LSTM" else 1)]
    kw = {"activation": "tanh"} if kind == "RNN" else {}
    _compare(lambda lib: getattr(lib.gluon.rnn, kind)(
        16, num_layers=2, layout=layout, bidirectional=bidir, input_size=8,
        **kw), x, states)


def test_layer_without_states_and_deferred_input_matches_jax():
    ref, port = _pair(lambda lib: lib.gluon.rnn.LSTM(16, num_layers=2), None)
    want = ref(mx.nd.array(X_TNC)).asnumpy()
    load_reference_params(port, _arrays(ref), ctx=cpu())
    with mt.cpu():
        got = port(nd.array(X_TNC)).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    names = [k[len(port.prefix):] for k in port.collect_params()]
    assert names == [f"l{i}_{n}" for i in range(2) for n in (
        "i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")]


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_relu"])
def test_rnn_op_matches_jax(mode):
    from mxnet_tpu.ndarray.ops_nn import rnn_param_size as jax_size
    n = ops_nn.rnn_param_size(mode, 2, 8, 6, True)
    assert n == jax_size(mode, 2, 8, 6, True)
    params = (RS.randn(n) * 0.3).astype(np.float32)
    h = RS.randn(4, 3, 6).astype(np.float32)
    ins = [X_TNC, params, h] + ([h * 0.5] if mode == "lstm" else [])
    kw = dict(state_size=6, num_layers=2, mode=mode, bidirectional=True,
              state_outputs=True)
    want = mx.nd.RNN(*[mx.nd.array(a) for a in ins], **kw)
    with mt.cpu():
        got = nd.RNN(*[nd.array(a) for a in ins], **kw)
        single = nd.RNN(*[nd.array(a) for a in ins],
                        **dict(kw, state_outputs=False))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    np.testing.assert_array_equal(single.asnumpy(), got[0].asnumpy())


def test_unported_rnn_options_raise():
    for kw in ({"projection_size": 4}, {"state_clip_min": -1.0},
               {"use_sequence_length": True}):
        with pytest.raises(MXNetError):
            mt.gluon.rnn.LSTM(8, **kw)
    with pytest.raises(MXNetError):
        nd.RNN(torch.zeros(2, 1, 3), torch.zeros(10), torch.zeros(1, 1, 2),
               state_size=2, mode="gru", projection_size=1)


def test_dropout_between_layers_follows_mxnet():
    """In training mode the port drops units between layers (MXNet's
    cuDNN op; masks from the port's generator, so a seed repeats them);
    the JAX op ignores ``p``.  In predict mode both agree."""
    make = lambda lib: lib.gluon.rnn.LSTM(16, num_layers=2, dropout=0.5,
                                          input_size=8)
    ref, port = _pair(make, None)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    x = mx.nd.array(X_TNC)
    with mx.autograd.train_mode():
        jax_train = ref(x).asnumpy()
    jax_predict = ref(x).asnumpy()
    np.testing.assert_array_equal(jax_train, jax_predict)
    with mt.cpu():
        predict = port(nd.array(X_TNC)).asnumpy()
        runs = []
        for _ in range(2):
            mt.random.seed(4)
            with autograd.train_mode():
                runs.append(port(nd.array(X_TNC)).asnumpy())
    np.testing.assert_allclose(predict, jax_predict, **TOL)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.abs(runs[0] - predict).max() > 1e-3


# ---------------------------------------------------------------------------
# a word language model, both packages


class _JaxWordLM(mx.gluon.HybridBlock):
    """MXNet's word_language_model model in the JAX package."""

    def __init__(self, vocab, emb, hidden, layers, dropout, tie=True,
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden = hidden
        nn = mx.gluon.nn
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.Embedding(vocab, emb)
            self.rnn = mx.gluon.rnn.LSTM(hidden, layers, dropout=dropout,
                                         input_size=emb)
            self.decoder = nn.Dense(
                vocab, in_units=hidden,
                params=self.encoder.params if tie else None)

    def hybrid_forward(self, F, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        return self.decoder(output.reshape((-1, self._hidden))), hidden


def _lm_steps(lib, net, ids, steps=2, bptt=6, clip=0.25):
    """The example's loop: per window the hidden state detached, summed
    token losses, clip_global_norm per token, SGD at lr 20."""
    tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 20.0})
    lossfn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    hidden = [lib.nd.zeros((2, ids.shape[1], 16)) for _ in range(2)]
    losses = []
    for i in range(steps):
        x = lib.nd.array(ids[i * bptt:(i + 1) * bptt])
        y = lib.nd.array(ids[i * bptt + 1:(i + 1) * bptt + 1])
        hidden = [h.detach() for h in hidden]
        with lib.autograd.record():
            out, hidden = net(x, hidden)
            loss = lossfn(out, y.reshape((-1,)))
        loss.backward()
        grads = [p.grad() for p in net.collect_params().values()]
        lib.gluon.utils.clip_global_norm(grads, clip * x.size)
        tr.step(x.size)
        losses.append(float(loss.mean().asscalar()))
    return losses


def test_word_lm_two_steps_match_jax():
    """Vocabulary 50, width 16, two layers, dropout 0, untied: the losses
    of two windows and every weight after them."""
    ids = np.random.default_rng(8).integers(0, 50, (13, 4)) \
        .astype(np.float32)
    ref = _JaxWordLM(50, 16, 16, 2, 0.0, tie=False, prefix="word_lm9_")
    ref.initialize(mx.init.Xavier())
    port = chip_smoke.WordLM(50, 16, 16, 2, 0.0, tie=False)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    want = _lm_steps(mx, ref, ids)
    with mt.cpu():
        got = _lm_steps(mt, port, ids)
    np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(_port_arrays(port).values(), _arrays(ref).values()):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_params_ties_the_decoder_unlike_jax():
    """``Dense(..., params=embedding.params)`` shares the embedding's
    weight as MXNet's name manager does (one Parameter, the gradient of
    both uses); the JAX package makes the decoder a weight of its own."""
    port = chip_smoke.WordLM(30, 8, 8, 1, 0.0)
    ref = _JaxWordLM(30, 8, 8, 1, 0.0)
    assert port.decoder.weight is port.encoder.weight
    assert ref.decoder.weight is not ref.encoder.weight
    ours = [k[len(port.prefix):] for k in port.collect_params()]
    assert ours.count("embedding0_weight") == 1
    assert not any(k.startswith("dense") for k in ours)
    port.initialize(ctx=cpu())
    with mt.cpu():
        x = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4) % 30)
        h = [nd.zeros((1, 4, 8)) for _ in range(2)]
        with autograd.record():
            out, _ = port(x, h)
        out.backward()
        grad = port.encoder.weight.grad().numpy()
    # the decoder's use reaches every row, the embedding's only the
    # rows it looked up: rows never looked up still get a gradient
    assert np.abs(grad[20:]).sum() > 0
