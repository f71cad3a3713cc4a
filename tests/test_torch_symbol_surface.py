"""The rest of the Symbol/Module surface held against the JAX package's:
``FusedRNNCell`` and the modifier cells, ``SequentialModule`` /
``PythonModule`` / ``PythonLossModule``, ``FeedForward``, ``Monitor``,
the name and attribute scopes, a two-output ``mx.sym.Custom`` and
``gluon.contrib.cnn.DeformableConvolution``, and a tiny version of
``chip_smoke.py`` phase 22 (c)'s NMT through ``BucketingModule`` and
``SequentialModule``.

The same seeded numpy inputs and weights go through both packages on the
CPU.  Values within ``TOL`` (fp32, the same operations, other orders)
unless the test says otherwise.  The JAX package's graphs of a loop body
that uses an outer value recompute it inside the body (the port cuts it
out, as MXNet 1.x does), so their arguments come in another order: the
modules are compared by name.
"""

import numpy as np
import pytest

import chip_smoke
import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = dict(rtol=2e-5, atol=2e-6)
RS = np.random.default_rng(1903)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _bind_eval(pkg, graph, feed, ctx):
    exe = graph.simple_bind(ctx, grad_req="null",
                            **{k: v.shape for k, v in feed.items()})
    for k, v in feed.items():
        exe.arg_dict[k][:] = v
    return [o.asnumpy() for o in exe.forward(is_train=False)]


@pytest.mark.parametrize("mode,bidirectional,layers", [
    ("lstm", True, 1), ("gru", False, 2), ("rnn_tanh", True, 1)])
def test_fused_cell_matches_the_jax_packages_unfused_cells(
        mode, bidirectional, layers):
    """The port's ``FusedRNNCell`` (one ``RNN`` node) on a packed vector
    equals the JAX package's ``unfuse()``'d cells on the weights its
    ``unpack_weights`` cut from that vector; ``pack_weights`` and
    ``unpack_weights`` cross between the packages."""
    t, n, i, h = 4, 3, 5, 6
    x = RS.standard_normal((n, t, i)).astype(np.float32)
    cell_mx = mx.rnn.FusedRNNCell(h, num_layers=layers, mode=mode,
                                  bidirectional=bidirectional,
                                  prefix="enc_", input_size=i)
    size = mt.nd.ops_nn.rnn_param_size(mode, layers, i, h, bidirectional)
    flat = (RS.standard_normal(size) * 0.3).astype(np.float32)
    unpacked = cell_mx.unpack_weights({"enc_parameters": mx.nd.array(flat)})
    stack = cell_mx.unfuse()
    ref = stack._cells[0] if bidirectional else stack
    out_mx, _ = ref.unroll(t, mx.sym.var("data"), merge_outputs=True)
    want = _bind_eval(mx, out_mx, {"data": x, **{
        k: v.asnumpy() for k, v in unpacked.items()}}, mx.cpu())
    cell = mt.rnn.FusedRNNCell(h, num_layers=layers, mode=mode,
                               bidirectional=bidirectional, prefix="enc_",
                               input_size=i)
    out, _ = cell.unroll(t, mt.sym.var("data"), merge_outputs=True)
    with mt.cpu():
        got = _bind_eval(mt, out, {"data": x, "enc_parameters": flat},
                         mt.cpu())
        ours = cell.unpack_weights({"enc_parameters": mt.nd.array(flat)})
        back = cell.pack_weights({k: mt.nd.array(v.asnumpy())
                                  for k, v in unpacked.items()})
        # the port's unfuse() unrolls its bidirectional layer in place
        seq, _ = cell.unfuse().unroll(t, mt.sym.var("data"),
                                      merge_outputs=True)
        unfused = _bind_eval(mt, seq, {"data": x, **{
            k: v.asnumpy() for k, v in ours.items()}}, mt.cpu())
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(unfused[0], want[0], **TOL)
    assert sorted(ours) == sorted(unpacked)
    for k in ours:
        np.testing.assert_array_equal(ours[k].asnumpy(),
                                      unpacked[k].asnumpy())
    np.testing.assert_array_equal(back["enc_parameters"].asnumpy(), flat)
    repacked = cell_mx.pack_weights({k: mx.nd.array(v.asnumpy())
                                     for k, v in ours.items()})
    np.testing.assert_array_equal(repacked["enc_parameters"].asnumpy(),
                                  flat)


def test_residual_and_dropout_cells_match_the_jax_package():
    """``SequentialRNNCell`` of ``LSTMCell``, ``DropoutCell`` (identity at
    inference) and ``ResidualCell(LSTMCell)`` unrolled in both."""
    t, n, h = 4, 3, 6
    x = RS.standard_normal((n, t, h)).astype(np.float32)
    outs, names = {}, None
    for name, pkg in (("jax", mx), ("port", mt)):
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.LSTMCell(h, prefix="a_"))
        stack.add(pkg.rnn.DropoutCell(0.5, prefix="d_"))
        stack.add(pkg.rnn.ResidualCell(pkg.rnn.LSTMCell(h, prefix="b_")))
        out, _ = stack.unroll(t, pkg.sym.var("data"), merge_outputs=True)
        args = out.list_arguments()
        if names is None:
            shapes = dict(zip(args, out.infer_shape(data=x.shape)[0]))
            feed = {k: (RS.standard_normal(s) * 0.3).astype(np.float32)
                    for k, s in shapes.items()}
            feed["data"] = x
            names = args
        assert sorted(args) == sorted(names)
        with mt.cpu():
            outs[name] = _bind_eval(pkg, out, feed, pkg.cpu())[0]
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)


NMT = {"vocab": 40, "embed": 8, "enc": 6, "dec": 10, "att": 7,
       "dropout": 0.0, "batch": 4, "buckets": (5, 8)}


def _nmt_batch(pkg, length):
    rng = np.random.default_rng(length)
    b = chip_smoke.nmt22_batch(rng, length, NMT, NMT["batch"])
    data = [a.asnumpy() for a in b.data]
    label = [a.asnumpy() for a in b.label]
    return pkg.io.DataBatch(
        data=[pkg.nd.array(a) for a in data],
        label=[pkg.nd.array(a) for a in label], bucket_key=length,
        provide_data=[pkg.io.DataDesc("src", data[0].shape),
                      pkg.io.DataDesc("tgt", data[1].shape)],
        provide_label=[pkg.io.DataDesc("label", label[0].shape)])


def _mods(pkg):
    return getattr(pkg, "mod", None) or pkg.module


@pytest.fixture(scope="module")
def nmt_runs():
    """One SGD step in each bucket through ``BucketingModule``, then the
    shortest bucket's step as a ``SequentialModule`` (encoder ``Module``
    and decoder ``Module`` with ``take_labels``), in both packages from
    the same weights: outputs, gradients and weights by name."""
    sym = chip_smoke.nmt22_sym(mt, NMT["buckets"][-1], NMT)
    shapes = dict(zip(sym.list_arguments(), sym.infer_shape(
        src=(4, 8), tgt=(4, 8), label=(4, 8))[0]))
    arg = {k: (RS.uniform(-0.1, 0.1, s)).astype(np.float32)
           for k, s in shapes.items() if k not in ("src", "tgt", "label")}
    res = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        ctx = pkg.cpu()
        with mt.cpu():
            def gen(n, pkg=pkg):
                return (chip_smoke.nmt22_sym(pkg, n, NMT), ("src", "tgt"),
                        ("label",))
            bm = _mods(pkg).BucketingModule(
                gen, default_bucket_key=NMT["buckets"][-1], context=ctx)
            bm.bind([("src", (4, 8)), ("tgt", (4, 8))],
                    [("label", (4, 8))])
            bm.init_params(arg_params={k: pkg.nd.array(v)
                                       for k, v in arg.items()})
            bm.init_optimizer(optimizer="sgd",
                              optimizer_params={"learning_rate": 0.5})
            outs = {}
            for key in NMT["buckets"]:
                b = _nmt_batch(pkg, key)
                bm.forward_backward(b)
                outs[key] = bm.get_outputs()[0].asnumpy()
                bm.update()
            weights = {k: v.asnumpy() for k, v in bm.get_params()[0].items()}
            first, second = chip_smoke.nmt22_stages(pkg, 5, NMT)
            seq = _mods(pkg).SequentialModule()
            seq.add(_mods(pkg).Module(first, data_names=("src", "tgt"),
                                           label_names=None, context=ctx))
            seq.add(_mods(pkg).Module(
                second, data_names=("enc", "bias", "tgt"),
                label_names=("label",), context=ctx), take_labels=True)
            dd = pkg.io.DataDesc
            seq.bind([dd("src", (4, 5)), dd("tgt", (4, 5))],
                     [dd("label", (4, 5))])
            seq.init_params(arg_params={k: pkg.nd.array(v)
                                        for k, v in arg.items()})
            seq.forward_backward(_nmt_batch(pkg, 5))
            seq_out = seq.get_outputs()[0].asnumpy()
            grads = {}
            for m in seq._modules:
                exe = (m._exec_group.execs[0] if hasattr(m, "_exec_group")
                       else m._executor)
                grads.update({k: g.asnumpy() for k, g in zip(
                    exe._symbol.list_arguments(), exe.grad_arrays)
                    if g is not None and k in arg})
        res[name] = {"outs": outs, "weights": weights, "seq_out": seq_out,
                     "seq_grads": grads}
    return res


def test_nmt_buckets_match_the_jax_package(nmt_runs):
    """Phase 22 (c)'s model (widths cut to 10) through ``BucketingModule``:
    each bucket's softmax output, and the weights after the two SGD
    steps, as the JAX package's."""
    jax_r, port = nmt_runs["jax"], nmt_runs["port"]
    for key in NMT["buckets"]:
        np.testing.assert_allclose(port["outs"][key], jax_r["outs"][key],
                                   **TOL)
    assert sorted(port["weights"]) == sorted(jax_r["weights"])
    for k in port["weights"]:
        np.testing.assert_allclose(port["weights"][k], jax_r["weights"][k],
                                   **TOL)


def test_nmt_sequential_module_matches_the_jax_package(nmt_runs):
    """The same model as a ``SequentialModule`` of two ``Module``s: the
    output and every parameter's gradient as the JAX package's."""
    jax_r, port = nmt_runs["jax"], nmt_runs["port"]
    np.testing.assert_allclose(port["seq_out"], jax_r["seq_out"], **TOL)
    assert sorted(port["seq_grads"]) == sorted(jax_r["seq_grads"])
    for k in port["seq_grads"]:
        np.testing.assert_allclose(port["seq_grads"][k],
                                   jax_r["seq_grads"][k], **TOL)


def test_nmt_translates_through_while_loop_and_reloads():
    """The greedy translation graph: tokens (steps, batch), zeros after a
    sentence's EOS, and the same tokens after a JSON round trip."""
    with mt.cpu():
        tr = chip_smoke.nmt22_translate_sym(mt, 5, NMT, steps=6)
        b = _nmt_batch(mt, 5)
        feed = {k: RS.uniform(-0.3, 0.3, s).astype(np.float32)
                for k, s in zip(tr.list_arguments(), tr.infer_shape(
                    src=(4, 5))[0]) if k != "src"}
        feed["src"] = b.data[0].asnumpy()
        toks = _bind_eval(mt, tr, feed, mt.cpu())[0]
        again = _bind_eval(mt, mt.sym.load_json(tr.tojson()), feed,
                           mt.cpu())[0]
    assert toks.shape == (6, 4)
    np.testing.assert_array_equal(toks, again)
    ended = np.cumsum(toks == chip_smoke.NMT22_EOS, 0) - (
        toks == chip_smoke.NMT22_EOS)
    assert (toks[ended > 0] == 0).all()


def _python_square(pkg):
    """A ``PythonModule`` subclass in either package: the elementwise
    square of its data (gradient 2 x)."""
    class Square(_mods(pkg).PythonModule):
        def _compute_output_shapes(self):
            return [("sq_output", self._data_shapes[0].shape)]

        def forward(self, data_batch, is_train=None):
            self._x = data_batch.data[0]
            self._y = self._x * self._x

        def get_outputs(self, merge_multi_context=True):
            return [self._y]

        def backward(self, out_grads=None):
            self._g = out_grads[0] * self._x * 2.0

        def get_input_grads(self, merge_multi_context=True):
            return [self._g]
    return Square(["x"], None, ["sq_output"])


def test_python_modules_chain_as_in_the_jax_package():
    """``Module`` (a dense layer) -> ``PythonModule`` (a square) ->
    ``PythonLossModule`` (softmax cross-entropy's gradient): one SGD step
    gives the JAX package's weights and output."""
    x = RS.standard_normal((6, 5)).astype(np.float32)
    y = RS.integers(0, 3, 6).astype(np.float32)
    w = (RS.standard_normal((3, 5)) * 0.3).astype(np.float32)
    got = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        with mt.cpu():
            mods = _mods(pkg)
            net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3,
                                         no_bias=True, name="fc")
            seq = mods.SequentialModule()
            seq.add(mods.Module(net, data_names=("data",),
                                label_names=None, context=pkg.cpu()))
            seq.add(_python_square(pkg))
            seq.add(mods.PythonLossModule(data_names=("sq_output",)),
                    take_labels=True)
            dd = pkg.io.DataDesc
            seq.bind([dd("data", x.shape)], [dd("softmax_label", y.shape)])
            seq.init_params(arg_params={"fc_weight": pkg.nd.array(w)})
            seq.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.1})
            batch = pkg.io.DataBatch(data=[pkg.nd.array(x)],
                                     label=[pkg.nd.array(y)])
            seq.forward_backward(batch)
            seq.update()
            got[name] = (seq.get_outputs()[0].asnumpy(),
                         seq.get_params()[0]["fc_weight"].asnumpy())
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, **TOL)


def _mlp(pkg):
    s = pkg.sym
    h = s.Activation(s.FullyConnected(s.var("data"), num_hidden=8,
                                      name="fc1"), act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=3, name="fc2"),
                           name="softmax")


def test_feedforward_matches_the_jax_package():
    """``FeedForward`` from the same weights and batches (no shuffle):
    the fitted weights, ``predict`` and ``score`` as the JAX package's."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    y = rng.integers(0, 3, 40).astype(np.float32)
    shapes = {"fc1_weight": (8, 6), "fc1_bias": (8,), "fc2_weight": (3, 8),
              "fc2_bias": (3,)}
    arg = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
           for k, s in shapes.items()}
    res = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        with mt.cpu():
            model = pkg.model.FeedForward(
                _mlp(pkg), ctx=pkg.cpu(), num_epoch=2, optimizer="sgd",
                numpy_batch_size=10, learning_rate=0.1,
                arg_params={k: pkg.nd.array(v) for k, v in arg.items()})
            model.fit(pkg.io.NDArrayIter(x, y, batch_size=10))
            res[name] = ({k: v.asnumpy() for k, v in
                          model.arg_params.items()}, model.predict(x),
                         model.score(x, y))
    for k in shapes:
        np.testing.assert_allclose(res["port"][0][k], res["jax"][0][k],
                                   **TOL)
    np.testing.assert_allclose(res["port"][1], res["jax"][1], **TOL)
    assert res["port"][2] == pytest.approx(res["jax"][2])


def test_feedforward_saves_and_loads(tmp_path):
    """``save`` then ``FeedForward.load`` predicts the same."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((20, 6)).astype(np.float32)
    y = rng.integers(0, 3, 20).astype(np.float32)
    with mt.cpu():
        model = mt.model.FeedForward.create(
            _mlp(mt), x, y, ctx=mt.cpu(), num_epoch=1, numpy_batch_size=10,
            initializer=mt.init.Uniform(0.3))
        model.save(str(tmp_path / "ff"))
        loaded = mt.model.FeedForward.load(str(tmp_path / "ff"), 1,
                                           ctx=mt.cpu(),
                                           numpy_batch_size=10)
        np.testing.assert_array_equal(loaded.predict(x), model.predict(x))


def test_monitor_statistics_match_the_jax_package():
    """The engine tap (``tests/test_aux.py``'s case in both): the stats of
    the matching ops' outputs, the interval, the pattern."""
    rows = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        with mt.cpu():
            mon = pkg.Monitor(interval=2,
                              pattern=".*FullyConnected.*|.*relu.*")
            mon.install()
            try:
                x = pkg.nd.array(np.ones((2, 3), np.float32))
                w = pkg.nd.array(np.ones((4, 3), np.float32))
                mon.tic()
                pkg.nd.FullyConnected(x, w, num_hidden=4, no_bias=True)
                pkg.nd.relu(x - 0.5)
                pkg.nd.sigmoid(x)
                first = mon.toc()
                mon.tic()
                pkg.nd.relu(x)
                second = mon.toc()
                mon.tic()
                pkg.nd.relu(x)
                third = mon.toc()
            finally:
                mon.uninstall()
        rows[name] = (first, second, third)
    for a, b in zip(rows["port"], rows["jax"]):
        assert [(s, n) for s, n, _ in a] == [(s, n) for s, n, _ in b]
        for (_, _, u), (_, _, v) in zip(a, b):
            assert float(u) == pytest.approx(float(v), rel=1e-6)
    assert float(rows["port"][0][0][2]) == pytest.approx(3.0)


def test_fit_monitor_reports_the_weights():
    """``fit(monitor=)`` on a ``Module``: MXNet's ``toc`` rows for the
    arguments matching ``.*weight`` after each batch's update (the port
    follows MXNet 1.x here; the JAX package's tap sees no weight)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((20, 6)).astype(np.float32)
    y = rng.integers(0, 3, 20).astype(np.float32)
    with mt.cpu():
        mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
        mon = mt.Monitor(interval=1, pattern=".*weight")
        seen = []
        mon.toc_print = lambda: seen.append(mon.toc())
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=10), num_epoch=1,
                monitor=mon, initializer=mt.init.Uniform(0.3))
        mon.uninstall()
        w = mod.get_params()[0]["fc1_weight"].asnumpy()
    assert len(seen) == 2
    assert [n for _, n, _ in seen[-1]] == ["fc1_weight", "fc2_weight"]
    assert float(seen[-1][0][2]) == pytest.approx(
        np.linalg.norm(w) / np.sqrt(w.size), rel=1e-6)


def test_name_and_attribute_scopes_match_the_jax_package():
    """``mx.name.Prefix`` and ``mx.AttrScope`` stamp names and attributes
    as the JAX package's (``tests/test_aux.py``'s case)."""
    got = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        with pkg.name.Prefix("stage1_"):
            s = pkg.sym.FullyConnected(pkg.sym.var("d"), num_hidden=4)
            s2 = pkg.sym.FullyConnected(pkg.sym.var("d"), num_hidden=4,
                                        name="explicit")
        with pkg.AttrScope(ctx_group="dev1", tag="a"):
            with pkg.AttrScope(ctx_group="dev2"):
                s4 = pkg.sym.relu(pkg.sym.var("d3"))
                v = pkg.sym.var("w_in_scope")
        s5 = pkg.sym.relu(pkg.sym.var("d4"))
        with pytest.raises(ValueError):
            pkg.AttrScope(shape="x")
        got[name] = (s.name.startswith("stage1_fullyconnected"),
                     s.list_arguments()[1].startswith("stage1_"), s2.name,
                     s4.attr("ctx_group"), s4.attr("tag"),
                     v.attr("ctx_group"), s5.attr("ctx_group"))
    assert got["port"] == got["jax"] == (True, True, "explicit", "dev2",
                                         "a", "dev2", None)


def _register_two_out(pkg):
    op_mod = pkg.operator

    class TwoOut(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0)
            self.assign(out_data[1], req[1], in_data[0] + 1.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * 2.0 + out_grad[1])

    @op_mod.register("two_out19")
    class TwoOutProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_outputs(self):
            return ["double", "plus_one"]

        def list_auxiliary_states(self):
            return ["counter"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], [in_shape[0]]

        def create_operator(self, ctx, shapes, dtypes):
            return TwoOut()


def test_symbol_custom_with_two_outputs_and_an_aux_state():
    """``mx.sym.Custom`` of a prop with two outputs and an auxiliary
    state: two heads named by the node, no auxiliary input (neither
    package creates one), and the JAX package's values and gradient."""
    x = RS.standard_normal((2, 3)).astype(np.float32)
    got = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        _register_two_out(pkg)
        s = pkg.sym.Custom(pkg.sym.var("data"), op_type="two_out19",
                           name="c")
        with mt.cpu():
            exe = s.simple_bind(pkg.cpu(), data=x.shape)
            exe.arg_dict["data"][:] = x
            outs = [o.asnumpy() for o in exe.forward(is_train=True)]
            exe.backward([pkg.nd.ones(x.shape), pkg.nd.ones(x.shape)])
            got[name] = (len(s), s.list_outputs(),
                         s.list_auxiliary_states(), outs,
                         exe.grad_dict["data"].asnumpy())
    assert got["port"][:3] == got["jax"][:3] == (
        2, ["c_output0", "c_output1"], [])
    for a, b in zip(got["port"][3] + [got["port"][4]],
                    got["jax"][3] + [got["jax"][4]]):
        np.testing.assert_allclose(a, b, **TOL)


def test_deformable_convolution_block_matches_the_jax_package():
    """``gluon.contrib.cnn.DeformableConvolution`` from the same weights
    (a non-zero offset branch) on NDArrays, with the input's gradient,
    and on a Symbol (its arguments and its graph's output)."""
    x = RS.standard_normal((2, 4, 7, 8)).astype(np.float32)
    res = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        with mt.cpu():
            net = pkg.gluon.contrib.cnn.DeformableConvolution(
                5, 3, padding=1, num_deformable_group=2, in_channels=4,
                prefix="dc_")
            net.initialize(ctx=pkg.cpu())
            shapes = {k: p.shape for k, p in net.collect_params().items()}
            rs = np.random.default_rng(4)
            for k, p in net.collect_params().items():
                p.set_data(pkg.nd.array(
                    (rs.standard_normal(shapes[k]) * 0.2).astype(
                        np.float32)))
            xa = pkg.nd.array(x)
            xa.attach_grad()
            with pkg.autograd.record():
                y = net(xa)
            y.backward()
            out = net(pkg.sym.var("data"))
            feed = {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}
            feed["data"] = x
            sym_y = _bind_eval(pkg, out, feed, pkg.cpu())[0]
            res[name] = (y.asnumpy(), xa.grad.asnumpy(), sym_y,
                         sorted(out.list_arguments()))
    for a, b in zip(res["port"][:3], res["jax"][:3]):
        np.testing.assert_allclose(a, b, **TOL)
    assert res["port"][3] == res["jax"][3]
