"""``_foreach``/``_while_loop``/``_cond`` and their frontends in ``nd`` and
``sym`` held against the JAX package's (``tests/test_control_flow.py``'s
cases on both packages).

The same seeded numpy inputs go through both packages on the CPU:
``nd.contrib`` recording and not recording, over zero-length data and
with ``while_loop``'s padding; ``sym.contrib`` bound by ``simple_bind``
with forward, backward and the gradient of a captured weight.  Values
within ``TOL`` (fp32, the same operations in another order); a symbol
file holding a loop, written by either package, loads in the other and
computes the same outputs.
"""
import warnings

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-6)
RS = np.random.default_rng(1902)
T, H = 5, 3
DATA = RS.standard_normal((T, H)).astype(np.float32)
W = RS.standard_normal(H).astype(np.float32)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _nd_foreach(pkg, record, data):
    nd = pkg.nd
    d = nd.array(data.copy())
    s0 = nd.array(np.zeros((H,), np.float32))
    w = nd.array(W.copy())
    for a in (d, s0, w):
        a.attach_grad()

    def body(x, states):
        s = states[0] + nd.tanh(x * w)
        return s * 2.0, [s]
    if not record:
        outs, final = nd.contrib.foreach(body, d, [s0])
        return [_np(outs), _np(final[0])]
    with pkg.autograd.record():
        outs, final = nd.contrib.foreach(body, d, [s0])
        loss = nd.sum(outs) + nd.sum(final[0])
    loss.backward()
    return [_np(outs), _np(final[0]), _np(w.grad), _np(s0.grad),
            _np(d.grad)]


def _nd_while(pkg, record, start, maxiter=6):
    nd = pkg.nd
    x = nd.array(np.array(start, np.float32))
    x.attach_grad()

    def run():
        return nd.contrib.while_loop(
            lambda v: nd.sum(v) < 8.0,
            lambda v: ([v * 3.0, nd.tanh(v)], [v * 2.0]), [x],
            max_iterations=maxiter)
    if not record:
        outs, final = run()
        return [_np(o) for o in outs] + [_np(final[0])]
    with pkg.autograd.record():
        outs, final = run()
        loss = nd.sum(outs[0]) + nd.sum(outs[1])
    loss.backward()
    return [_np(o) for o in outs] + [_np(final[0]), _np(x.grad)]


def _nd_cond(pkg, record, value):
    nd = pkg.nd
    x = nd.array(np.array(value, np.float32))
    x.attach_grad()

    def run():
        return nd.contrib.cond(nd.sum(x) > 1.0, lambda: nd.tanh(x) * 5.0,
                               lambda: x * x)
    if not record:
        return [_np(run())]
    with pkg.autograd.record():
        out = run()
    out.backward()
    return [_np(out), _np(x.grad)]


def _nd_zero_length(pkg):
    nd = pkg.nd
    s0 = nd.array(np.ones((H,), np.float32))
    outs, final = nd.contrib.foreach(
        lambda x, st: (x + st[0], [st[0] * 2.0]),
        nd.array(np.zeros((0, H), np.float32)), [s0])
    wo, wf = nd.contrib.while_loop(
        lambda v: nd.sum(v) < 8.0, lambda v: (v * 3.0, [v * 2.0]),
        [nd.array(np.array([100.0], np.float32))], max_iterations=4)
    return [_np(outs), _np(final[0]), _np(wo), _np(wf[0])]


ND_CASES = [
    ("foreach", lambda p: _nd_foreach(p, False, DATA)),
    ("foreach_recording", lambda p: _nd_foreach(p, True, DATA)),
    ("while_loop", lambda p: _nd_while(p, False, [1.0, 0.5])),
    ("while_loop_recording_padded", lambda p: _nd_while(p, True,
                                                        [1.0, 0.5])),
    ("while_loop_full", lambda p: _nd_while(p, True, [0.1, 0.1], 3)),
    ("cond_then", lambda p: _nd_cond(p, True, [2.0, 0.5])),
    ("cond_else", lambda p: _nd_cond(p, True, [0.2, 0.5])),
    ("cond_not_recording", lambda p: _nd_cond(p, False, [2.0, 0.5])),
    ("zero_length", _nd_zero_length),
]


@pytest.mark.parametrize("case", [c for _, c in ND_CASES],
                         ids=[n for n, _ in ND_CASES])
def test_nd_control_flow_matches_the_jax_package(case):
    want = case(mx)
    with mt.cpu():
        got = case(mt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def _sym_graph(pkg, which):
    sym = pkg.sym
    if which == "foreach":
        data, s0, w = sym.var("data"), sym.var("s0"), sym.var("w")

        def body(x, st):
            ns = st[0] + sym.tanh(x * w)
            return ns * ns, [ns]
        outs, fin = sym.contrib.foreach(body, data, [s0])
        return sym.Group([outs, fin[0]]), {
            "data": DATA, "s0": np.zeros(H, np.float32), "w": W}
    if which == "while_loop":
        v, w = sym.var("v"), sym.var("w")
        outs, fin = sym.contrib.while_loop(
            lambda x: sym.sum(x) < 20.0,
            lambda x: (sym.tanh(x * w) * 2.0, [x * 1.5 + w]), [v],
            max_iterations=6)
        return sym.Group([outs, fin[0]]), {
            "v": np.array([1.0, 2.0], np.float32),
            "w": np.array([0.5, -0.25], np.float32)}
    p, a = sym.var("p"), sym.var("a")
    out = sym.contrib.cond(sym.sum(p) > 0.0, lambda: sym.tanh(a) * 3.0,
                           lambda: a * a)
    return out, {"p": np.array([1.0 if which == "cond_then" else -1.0],
                               np.float32),
                 "a": RS.standard_normal(3).astype(np.float32)}


def _sym_run(pkg, graph, feed):
    """forward(is_train) and backward with head gradients of ones: the
    outputs and every argument's gradient."""
    shapes = {k: v.shape for k, v in feed.items()}
    exe = graph.simple_bind(pkg.cpu(), **shapes)
    for k, v in feed.items():
        exe.arg_dict[k][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward([pkg.nd.ones(o.shape) for o in exe.outputs])
    return outs, {k: exe.grad_dict[k].asnumpy() for k in feed}


@pytest.mark.parametrize("which", ["foreach", "while_loop", "cond_then",
                                   "cond_else"])
def test_sym_control_flow_matches_the_jax_package(which):
    """Forward, backward and the captured weight's gradient (``w``, ``a``:
    free variables of the body) through ``simple_bind``."""
    graph, feed = _sym_graph(mx, which)
    want, want_g = _sym_run(mx, graph, feed)
    graph_t, _ = _sym_graph(mt, which)
    assert graph_t.list_arguments() == graph.list_arguments()
    with mt.cpu():
        got, got_g = _sym_run(mt, graph_t, feed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    for k in feed:
        if which.startswith("cond") and k == "p":
            continue
        np.testing.assert_allclose(got_g[k], want_g[k], **TOL)


@pytest.mark.parametrize("which", ["foreach", "while_loop", "cond_then"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_saved_loop_loads_in_the_other_package(which, writer, tmp_path):
    """A ``-symbol.json`` with a control-flow node, written by one
    package, loads in the other and evaluates to the writer's outputs."""
    src, dst = (mx, mt) if writer == "jax" else (mt, mx)
    graph, feed = _sym_graph(src, which)
    graph.save(str(tmp_path / "loop-symbol.json"))
    loaded = dst.sym.load(str(tmp_path / "loop-symbol.json"))
    assert loaded.list_arguments() == graph.list_arguments()
    assert loaded.list_outputs() == graph.list_outputs()
    with mt.cpu():
        want = graph.eval(**{k: src.nd.array(v) for k, v in feed.items()})
        got = loaded.eval(**{k: dst.nd.array(v) for k, v in feed.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


def test_shape_inference_runs_through_the_subgraph():
    """``infer_shape`` goes through a loop's body on meta tensors; a
    ``cond`` whose branches differ in shape raises naming the op."""
    graph, _ = _sym_graph(mt, "foreach")
    _, outs, _ = graph.infer_shape(data=(7, H), s0=(H,), w=(H,))
    assert outs == [(7, H), (H,)]
    graph, _ = _sym_graph(mt, "while_loop")
    _, outs, _ = graph.infer_shape(v=(2,), w=(2,))
    assert outs == [(6, 2), (2,)]
    p, a = mt.sym.var("p"), mt.sym.var("a")
    bad = mt.sym.contrib.cond(p, lambda: a, lambda: mt.sym.sum(a))
    with pytest.raises(mt.MXNetError, match="_cond"):
        bad.infer_shape(p=(1,), a=(3,))


class _Loop(mt.gluon.HybridBlock):
    """A block whose forward calls ``nd.contrib.while_loop``: a host
    read."""

    def hybrid_forward(self, F, x):
        outs, _ = F.contrib.while_loop(
            lambda v: F.sum(v) < 4.0, lambda v: (v * 2.0, [v + 1.0]), [x],
            max_iterations=5)
        return outs


def test_a_hybridized_block_with_while_loop_warns_once_and_runs_eagerly():
    net = _Loop()
    x = mt.nd.array(np.array([0.5, 0.25], np.float32), ctx=mt.cpu())
    eager = net(x).asnumpy()
    net.hybridize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        outs = [net(x).asnumpy() for _ in range(3)]
    hits = [w for w in seen if "reads the host" in str(w.message)]
    assert len(hits) == 1 and "while_loop" in str(hits[0].message)
    assert net.reads_host and net.eager_calls >= 2
    for o in outs:
        np.testing.assert_array_equal(o, eager)


def test_a_body_using_an_outer_value_takes_it_as_an_input():
    """A ``foreach`` body that uses a value computed outside the loop (an
    encoder's projection): the port cuts it out as an input of the node
    (MXNet 1.x's ``_cut_subgraph``; the JAX package computes it again
    inside the body at every step), with the JAX package's outputs and
    gradients."""
    feed = {"data": RS.standard_normal((T, 4)).astype(np.float32),
            "enc": RS.standard_normal((4, H)).astype(np.float32), "w": W,
            "s0": np.zeros((4,), np.float32)}

    def graph(sym):
        proj = sym.tanh(sym.dot(sym.var("enc"), sym.var("w")))   # (4,)
        outs, fin = sym.contrib.foreach(
            lambda x, st: (x * proj + st[0], [st[0] + x * proj]),
            sym.var("data"), [sym.var("s0")])
        return sym.Group([outs, fin[0]])
    want, want_g = _sym_run(mx, graph(mx.sym), feed)
    g = graph(mt.sym)
    loop = next(n for n in g._topo() if n.op == "_foreach")
    inner = loop.attrs["subgraph"].sym
    assert "tanh" not in [n.op for n in inner._topo()]
    assert any(n.endswith("_output") for n in loop.attrs["free_names"])
    with mt.cpu():
        got, got_g = _sym_run(mt, g, feed)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    for k in feed:
        np.testing.assert_allclose(got_g[k], want_g[k], **TOL)
