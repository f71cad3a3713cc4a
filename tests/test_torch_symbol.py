"""The port's Symbol API (``mx.sym``, ``Executor``) held against the JAX
package's on the same graphs and the same numpy values.

Graphs are built in each package with the same explicit names; the
executors are bound over the same argument values, run one training
forward and one backward (the JAX package through ``jax.vjp``, the port
through torch autograd over the eager graph), and their outputs and
gradients compared within 1e-5 (fp32, one evaluation each).  A
``-symbol.json`` written by either package loads in the other with the
same arguments and outputs, and runs to the same values.
"""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError

TOL = dict(atol=1e-5, rtol=1e-5)
B, T, V, E, H = 4, 3, 12, 8, 10


def _graph(sym):
    """Embedding -> split over time -> FC/tanh on each step (shared
    weights) -> scalar arithmetic -> FC -> SoftmaxOutput."""
    data, label = sym.var("data"), sym.var("softmax_label")
    w, b = sym.var("fc1_weight"), sym.var("fc1_bias")
    emb = sym.Embedding(data, input_dim=V, output_dim=E, name="embed")
    steps = sym.split(emb, num_outputs=T, axis=1, squeeze_axis=True,
                      name="steps")
    hs = [sym.Activation(sym.FullyConnected(steps[t], w, b, num_hidden=H,
                                            name=f"fc1_t{t}"),
                         act_type="tanh", name=f"act{t}")
          for t in range(T)]
    h = (hs[0] + hs[1] * 0.5 - 1.0) / 2.0 + (1.0 - hs[2]) * hs[2]
    out = sym.FullyConnected(h, num_hidden=V, name="out")
    return sym.SoftmaxOutput(out, label, name="softmax")


def _values(seed=0):
    rs = np.random.RandomState(seed)
    return {"data": rs.randint(0, V, (B, T)).astype(np.float32),
            "embed_weight": rs.randn(V, E).astype(np.float32),
            "fc1_weight": rs.randn(H, E).astype(np.float32) * 0.5,
            "fc1_bias": rs.randn(H).astype(np.float32),
            "out_weight": rs.randn(V, H).astype(np.float32) * 0.5,
            "out_bias": rs.randn(V).astype(np.float32),
            "softmax_label": rs.randint(0, V, (B,)).astype(np.float32)}


def _jax_exec(sym, values, grad_req="write"):
    exe = sym.simple_bind(ctx=mx.cpu(), grad_req=grad_req,
                          data=(B, T), softmax_label=(B,))
    for k, v in values.items():
        exe.arg_dict[k][:] = mx.nd.array(v)
    return exe


def _port_exec(sym, values, grad_req="write"):
    exe = sym.simple_bind(ctx=mt.cpu(), grad_req=grad_req, data=(B, T),
                          softmax_label=(B,))
    for k, v in values.items():
        exe.arg_dict[k][:] = nd.array(v, ctx=mt.cpu())
    return exe


@pytest.fixture(scope="module")
def jax_run():
    sym = _graph(mx.sym)
    exe = _jax_exec(sym, _values())
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward()
    return {"sym": sym, "json": sym.tojson(), "out": out,
            "grads": {k: v.asnumpy() for k, v in exe.grad_dict.items()
                      if v is not None},
            "shapes": sym.infer_shape(data=(B, T), softmax_label=(B,)),
            "types": sym.infer_type(data="float32")}


def test_arguments_outputs_and_internals_match(jax_run):
    ours, theirs = _graph(mt.sym), jax_run["sym"]
    assert ours.list_arguments() == theirs.list_arguments()
    assert ours.list_outputs() == theirs.list_outputs() == \
        ["softmax_output"]
    assert ours.list_auxiliary_states() == []
    # auto-named nodes (the scalar arithmetic) carry each package's own
    # counters
    assert [re.sub(r"\d+", "#", n) for n in
            ours.get_internals().list_outputs()] == \
        [re.sub(r"\d+", "#", n) for n in
         theirs.get_internals().list_outputs()]


def test_infer_shape_and_type_match(jax_run):
    ours = _graph(mt.sym)
    assert ours.infer_shape(data=(B, T), softmax_label=(B,)) == \
        jax_run["shapes"]
    assert ours.infer_type(data="float32") == jax_run["types"]


def test_forward_and_gradients_match(jax_run):
    exe = _port_exec(_graph(mt.sym), _values())
    out = exe.forward(is_train=True)[0]
    assert isinstance(out, nd.NDArray)
    np.testing.assert_allclose(out.asnumpy(), jax_run["out"], **TOL)
    exe.backward()
    for k, g in jax_run["grads"].items():
        np.testing.assert_allclose(exe.grad_dict[k].asnumpy(), g,
                                   err_msg=k, **TOL)


def test_port_json_loads_and_runs_in_jax(jax_run, tmp_path):
    ours = _graph(mt.sym)
    path = tmp_path / "net-symbol.json"
    ours.save(str(path))
    theirs = mx.sym.load(str(path))
    assert theirs.list_arguments() == ours.list_arguments()
    assert theirs.list_outputs() == ours.list_outputs()
    exe = _jax_exec(theirs, _values())
    np.testing.assert_allclose(exe.forward()[0].asnumpy(), jax_run["out"],
                               **TOL)


def test_jax_json_loads_and_runs_in_port(jax_run):
    ours = mt.sym.load_json(jax_run["json"])
    assert ours.list_arguments() == jax_run["sym"].list_arguments()
    assert ours.list_outputs() == jax_run["sym"].list_outputs()
    exe = _port_exec(ours, _values())
    exe.forward(is_train=True)
    np.testing.assert_allclose(exe.outputs[0].asnumpy(), jax_run["out"],
                               **TOL)
    exe.backward()
    for k, g in jax_run["grads"].items():
        np.testing.assert_allclose(exe.grad_dict[k].asnumpy(), g,
                                   err_msg=k, **TOL)


def test_json_round_trip_keeps_the_graph():
    ours = _graph(mt.sym)
    again = mt.sym.load_json(ours.tojson())
    assert again.tojson() == ours.tojson()
    a, b = (_port_exec(s, _values(1)) for s in (ours, again))
    torch.testing.assert_close(a.forward()[0]._data, b.forward()[0]._data)


def test_grad_req_add_accumulates_and_write_overwrites():
    vals = _values(2)
    write = _port_exec(_graph(mt.sym), vals)
    add = _port_exec(_graph(mt.sym), vals, grad_req="add")
    for exe, n in ((write, 2), (add, 2)):
        for _ in range(n):
            exe.forward(is_train=True)
            exe.backward()
    g_write = write.grad_dict["fc1_weight"].asnumpy()
    np.testing.assert_allclose(add.grad_dict["fc1_weight"].asnumpy(),
                               2 * g_write, **TOL)
    null = _port_exec(_graph(mt.sym), vals, grad_req="null")
    assert all(g is None for g in null.grad_dict.values())


def test_out_grads_scale_the_gradient():
    """A head gradient reaches ops whose backward reads it (here a plain
    FullyConnected head)."""
    def build(sym):
        x = sym.var("x")
        return sym.FullyConnected(x, num_hidden=3, name="fc")

    rs = np.random.RandomState(4)
    vals = {"x": rs.randn(2, 5).astype(np.float32),
            "fc_weight": rs.randn(3, 5).astype(np.float32),
            "fc_bias": rs.randn(3).astype(np.float32)}
    head = rs.randn(2, 3).astype(np.float32)
    grads = []
    for pkg, sym, ctx in ((mx.nd, mx.sym, mx.cpu()),
                          (nd, mt.sym, mt.cpu())):
        exe = build(sym).simple_bind(ctx=ctx, x=(2, 5))
        for k, v in vals.items():
            exe.arg_dict[k][:] = pkg.array(v, ctx=ctx)
        exe.forward(is_train=True)
        exe.backward(pkg.array(head, ctx=ctx))
        grads.append({k: g.asnumpy() for k, g in exe.grad_dict.items()})
    for k in vals:
        np.testing.assert_allclose(grads[1][k], grads[0][k], **TOL)


def test_bind_with_arrays_and_eval():
    x, w = mt.sym.var("x"), mt.sym.var("w")
    y = mt.sym.dot(x, w) * 2.0
    with mt.cpu():
        a = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        b = nd.array(np.ones((3, 2), np.float32))
        exe = y.bind(args={"x": a, "w": b},
                     args_grad={"w": nd.zeros((3, 2))})
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(nd.ones((2, 2)))
        evald = y.eval(x=a, w=b)[0].asnumpy()
    np.testing.assert_allclose(out, 2 * a.asnumpy() @ b.asnumpy())
    np.testing.assert_allclose(evald, out)
    np.testing.assert_allclose(exe.grad_dict["w"].asnumpy(),
                               2 * a.asnumpy().T @ np.ones((2, 2)))
    assert exe.grad_dict["x"] is None


def test_batchnorm_aux_states_are_written_back():
    data = mt.sym.var("data")
    bn = mt.sym.BatchNorm(data, fix_gamma=False, momentum=0.9, name="bn")
    assert bn.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    x = np.random.RandomState(5).randn(8, 3).astype(np.float32) + 2.0
    exe = bn.simple_bind(ctx=mt.cpu(), data=(8, 3))
    exe.arg_dict["bn_gamma"][:] = 1.0
    exe.aux_dict["bn_moving_var"][:] = 1.0
    exe.forward(is_train=True, data=nd.array(x, ctx=mt.cpu()))
    np.testing.assert_allclose(exe.aux_dict["bn_moving_mean"].asnumpy(),
                               0.1 * x.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(exe.aux_dict["bn_moving_var"].asnumpy(),
                               0.9 + 0.1 * x.var(0), rtol=1e-5)
    before = exe.aux_dict["bn_moving_mean"].asnumpy()
    exe.forward(is_train=False, data=nd.array(x, ctx=mt.cpu()))
    np.testing.assert_array_equal(exe.aux_dict["bn_moving_mean"].asnumpy(),
                                  before)


def test_group_attr_and_variable_shapes():
    a = mt.sym.var("a", shape=(2, 3), dtype="float16", lr_mult=2.0)
    b = mt.sym.var("b")
    g = mt.sym.Group([a + b, mt.sym.relu(a, name="r")])
    assert len(g) == 2 and g.list_outputs()[1] == "r_output"
    assert a.attr("__shape__") == (2, 3) and a.attr("lr_mult") == 2.0
    arg_shapes, out_shapes, _ = g.infer_shape(b=(2, 3))
    assert arg_shapes == [(2, 3), (2, 3)] and out_shapes == [(2, 3)] * 2
    arg_types, _, _ = g.infer_type()
    assert arg_types[0] == np.float16


def test_errors():
    with pytest.raises(MXNetError, match="unknown inputs"):
        (mt.sym.var("a") + mt.sym.var("b")).infer_shape(a=(2,))
    exe = mt.sym.relu(mt.sym.var("a")).simple_bind(ctx=mt.cpu(), a=(2,))
    with pytest.raises(MXNetError, match="forward"):
        exe.backward()
    with pytest.raises(MXNetError, match="unknown input"):
        exe.forward(b=nd.zeros((2,), ctx=mt.cpu()))
    with pytest.raises(MXNetError, match="grad_req"):
        mt.sym.relu(mt.sym.var("a")).simple_bind(ctx=mt.cpu(),
                                                 grad_req="sum", a=(2,))
    two = mt.sym.split(mt.sym.var("a"), num_outputs=2)
    with pytest.raises(MXNetError, match="grouped"):
        mt.sym.relu(two)
