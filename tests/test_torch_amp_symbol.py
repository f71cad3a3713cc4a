"""Symbolic AMP: ``contrib.amp.convert_symbol``/``convert_model``, the cast
ops they insert (``amp_cast``, ``amp_multicast``), the finiteness probes
(``all_finite``, ``multi_all_finite``), converted graphs bound by
``Module`` and converted checkpoints, held against the JAX package's.

- The same Symbol converts to the same node list (op, name, attributes,
  inputs, heads) in both packages: a 2-layer encoder of
  ``chip_smoke.sym_encoder`` (width 64, 2 heads), config #1's MLP under a
  regression head and a 2-layer LSTM language model unrolled by
  ``mx.rnn``; each package loads the other's converted JSON.
- A converted encoder bound for inference from fp32 parameters computes
  the JAX package's converted forward within ``BF16_TOL`` (relative L2:
  both run bf16 matrix products, accumulated in another order) and its
  own fp32 forward within ``FP32_GAP``; the outputs' dtypes follow the
  casts (LayerNorm's fp32, the last FullyConnected's bf16), and so does
  ``infer_type``.
- ``save_checkpoint(..., remove_amp_cast=True)`` writes the converted
  graph as the JAX package does (casts kept); each package loads and runs
  the other's.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

import chip_smoke

ENC = dict(units=64, heads=2, ffn=128)
B, L = 2, 16
BF16_TOL = 2e-2        # port vs JAX, both converted (relative L2)
FP32_GAP = 5e-2        # converted vs fp32 (relative L2)


def _lm(pkg):
    data = pkg.sym.var("data")
    embed = pkg.sym.Embedding(data, input_dim=20, output_dim=16,
                              name="embed")
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(16, prefix=f"lstm_l{i}_"))
    outputs, _ = stack.unroll(4, embed, layout="NTC", merge_outputs=True)
    pred = pkg.sym.FullyConnected(pkg.sym.reshape(outputs, shape=(-1, 16)),
                                  num_hidden=20, name="pred")
    label = pkg.sym.reshape(pkg.sym.var("softmax_label"), shape=(-1,))
    return pkg.sym.SoftmaxOutput(pred, label, name="softmax")


BUILDERS = {
    "encoder": lambda pkg: chip_smoke.sym_encoder(pkg.sym, 2, **ENC),
    "encoder_infer": lambda pkg: chip_smoke.sym_encoder(
        pkg.sym, 2, head="infer", **ENC),
    "mlp": lambda pkg: chip_smoke.sym_mlp(pkg.sym, "LinearRegressionOutput"),
    "lstm_lm": _lm,
}


@pytest.fixture
def fresh_names(monkeypatch):
    """Both packages' automatic node names counted from 0 (the LSTM
    cells name some nodes ``{op}{counter}``, and earlier tests in the
    process move the counters)."""
    import mxnet_tpu.symbol.symbol as jax_symbol
    import mxnet_tpu_torch.symbol.symbol as port_symbol
    for module in (jax_symbol, port_symbol):
        monkeypatch.setattr(module, "_name_counters", {})


def _nodes(sym):
    graph = json.loads(sym.tojson())
    return graph["nodes"], graph["heads"]


@pytest.mark.parametrize("kw", [{}, {"target_dtype": "float16"},
                                {"excluded_sym_names": ["enc0_qkv",
                                                        "pred", "fc2"]}],
                         ids=["bf16", "fp16", "excluded"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_convert_symbol_gives_the_jax_node_list(name, kw, fresh_names):
    want = mx.contrib.amp.convert_symbol(BUILDERS[name](mx), **kw)
    got = mt.contrib.amp.convert_symbol(BUILDERS[name](mt), **kw)
    assert _nodes(got) == _nodes(want)
    ops = [n["op"] for n in _nodes(got)[0]]
    assert "amp_cast" in ops


@pytest.mark.parametrize("name", ["encoder_infer", "lstm_lm"])
def test_each_package_loads_the_others_converted_json(name, fresh_names):
    """A converted graph's JSON from either package loads in the other and
    writes back the same JSON; the multi-output ``amp_multicast`` nodes
    keep their outputs."""
    ours = mt.contrib.amp.convert_symbol(BUILDERS[name](mt))
    theirs = mx.contrib.amp.convert_symbol(BUILDERS[name](mx))
    assert mx.sym.load_json(ours.tojson()).tojson() == theirs.tojson()
    back = mt.sym.load_json(theirs.tojson())
    assert back.tojson() == ours.tojson()
    multi = [n for n in back._topo() if n.op == "amp_multicast"]
    assert multi and all(n.num_outputs == len(n.inputs) >= 2
                         for n in multi)


def _params(sym, rs):
    shapes = sym.infer_shape(data=(B, L, ENC["units"]), valid_len=(B,))[0]
    return {n: (0.1 * rs.standard_normal(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "valid_len")}


def _infer(pkg, sym, arg, x, vl, ctx):
    mod = pkg.mod.Module(sym, data_names=("data", "valid_len"),
                         label_names=None, context=ctx)
    mod.bind(data_shapes=[("data", x.shape), ("valid_len", vl.shape)],
             for_training=False)
    mod.init_params(arg_params={k: pkg.nd.array(v.copy(), ctx=ctx)
                                for k, v in arg.items()})
    mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x.copy(), ctx=ctx),
                                       pkg.nd.array(vl.copy(), ctx=ctx)]),
                is_train=False)
    return mod.get_outputs()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def converted_runs():
    rs = np.random.default_rng(21)
    x = rs.standard_normal((B, L, ENC["units"])).astype(np.float32)
    vl = np.array([L, 9], np.float32)
    arg = _params(BUILDERS["encoder_infer"](mt), rs)
    runs = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        sym = BUILDERS["encoder_infer"](pkg)
        conv, carg, _ = pkg.contrib.amp.convert_model(
            sym, {k: pkg.nd.array(v.copy(), ctx=ctx) for k, v in
                  arg.items()}, {}, "bfloat16")
        runs[pkg.__name__] = {
            "fp32": [o.asnumpy().astype(np.float32)
                     for o in _infer(pkg, sym, arg, x, vl, ctx)],
            "bf16": _infer(pkg, conv, arg, x, vl, ctx),
            "carg": carg}
    return runs


def test_converted_forward_matches_jax(converted_runs):
    ours = converted_runs["mxnet_tpu_torch"]
    theirs = converted_runs["mxnet_tpu"]
    for g, w in zip(ours["bf16"], theirs["bf16"]):
        assert str(w.dtype) in str(g.dtype)
        assert _rel(g.asnumpy(), w.asnumpy().astype(np.float32)) <= BF16_TOL
    for g, w in zip(ours["fp32"], theirs["fp32"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_converted_forward_stays_near_fp32(converted_runs):
    """The converted graph's outputs: the hidden states fp32 (LayerNorm is
    an FP32 op), the logits bf16 (FullyConnected is an LP16 op), each
    within ``FP32_GAP`` of the fp32 graph's; the parameters stay fp32."""
    ours = converted_runs["mxnet_tpu_torch"]
    assert [str(o.dtype).replace("torch.", "") for o in ours["bf16"]] == \
        ["float32", "bfloat16"]
    for g, w in zip(ours["bf16"], ours["fp32"]):
        assert _rel(g.asnumpy(), w) <= FP32_GAP
    assert all(v.dtype == np.float32 for v in ours["carg"].values())


def test_infer_type_follows_the_casts_as_jax():
    sym = BUILDERS["encoder_infer"](mt)
    ours = mt.contrib.amp.convert_symbol(sym).infer_type(
        data="float32", valid_len="float32")
    theirs = mx.contrib.amp.convert_symbol(
        BUILDERS["encoder_infer"](mx)).infer_type(data="float32",
                                                  valid_len="float32")
    # numpy dtypes in both; bfloat16 is ml_dtypes' (the JAX package loads it)
    assert ours == theirs
    assert [str(d) for d in ours[1]] == ["float32", "bfloat16"]
    multi = mt.sym.amp_multicast(mt.sym.var("a", dtype="float16"),
                                 mt.sym.cast(mt.sym.var("b"),
                                             dtype="bfloat16"),
                                 num_outputs=2)
    assert multi.infer_type()[1] == [np.dtype(np.float32)] * 2


def test_converted_graph_binds_from_fp32_parameters():
    """Shape inference sees through the casts to the variables under them
    (the JAX package's rule), so a converted graph binds from the data's
    shape alone."""
    conv = mt.contrib.amp.convert_symbol(BUILDERS["encoder"](mt))
    want = mx.contrib.amp.convert_symbol(BUILDERS["encoder"](mx))
    shapes = dict(data=(B, L, ENC["units"]), valid_len=(B,), label=(B,))
    assert conv.infer_shape(**shapes) == want.infer_shape(**shapes)


def test_all_finite_ops_match_jax():
    rs = np.random.default_rng(9)
    clean = rs.standard_normal((3, 4)).astype(np.float32)
    bad = clean.copy()
    bad[1, 2] = np.inf
    nan = clean.copy()
    nan[0, 0] = np.nan
    for arrays in ([clean], [bad], [nan], [clean, clean[0]],
                   [clean, bad[1]], [clean.astype(np.float16), nan]):
        want = (mx.nd.all_finite(mx.nd.array(arrays[0].copy()))
                if len(arrays) == 1 else mx.nd.multi_all_finite(
                    *[mx.nd.array(a.copy()) for a in arrays],
                    num_arrays=len(arrays))).asnumpy()
        with mt.cpu():
            nds = [mt.nd.array(a.copy()) for a in arrays]
            got = (mt.nd.all_finite(nds[0]) if len(arrays) == 1 else
                   mt.nd.multi_all_finite(*nds, num_arrays=len(arrays)))
        assert got.dtype == np.float32 and got.shape == (1,)
        np.testing.assert_array_equal(got.asnumpy(), want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_converted_checkpoint_crosses_packages(tmp_path, writer):
    """``save_checkpoint(..., remove_amp_cast=True)`` of a converted graph
    and its fp32 parameters: either package's checkpoint loads in the
    other, keeps its casts (the JAX package writes the graph as given, and
    so does the port) and gives the writer's converted forward."""
    rs = np.random.default_rng(13)
    x = rs.standard_normal((B, L, ENC["units"])).astype(np.float32)
    vl = np.array([7, L], np.float32)
    arg = _params(BUILDERS["encoder_infer"](mt), rs)
    src, dst = (mt, mx) if writer == "port" else (mx, mt)
    ctx_src = mt.cpu() if src is mt else mx.cpu()
    ctx_dst = mt.cpu() if dst is mt else mx.cpu()
    conv, carg, caux = src.contrib.amp.convert_model(
        BUILDERS["encoder_infer"](src),
        {k: src.nd.array(v.copy(), ctx=ctx_src) for k, v in arg.items()},
        {})
    prefix = str(tmp_path / "enc")
    src.model.save_checkpoint(prefix, 3, conv, carg, caux,
                              remove_amp_cast=True)
    sym, arg2, _ = dst.model.load_checkpoint(
        prefix, 3, **({"ctx": ctx_dst} if dst is mt else {}))
    assert "amp_cast" in [n.op for n in sym._topo()]
    assert sym.tojson() == conv.tojson()
    loaded = {k: v.asnumpy() for k, v in arg2.items()}
    assert loaded.keys() == arg.keys()
    want = _infer(src, conv, arg, x, vl, ctx_src)
    got = _infer(dst, sym, loaded, x, vl, ctx_dst)
    for g, w in zip(got, want):
        assert _rel(np.asarray(g.asnumpy(), np.float32),
                    np.asarray(w.asnumpy(), np.float32)) <= BF16_TOL


def test_convert_symbol_refuses_an_unknown_target():
    with pytest.raises(MXNetError):
        mt.contrib.amp.convert_symbol(BUILDERS["mlp"](mt), "float64")


def test_amp_cast_casts_and_differentiates():
    """``amp_cast`` into bf16 and back is differentiable, the gradient
    arriving in the input's dtype, as in the JAX package."""
    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    res = {}
    for pkg in (mx, mt):
        with (mt.cpu() if pkg is mt else mx.cpu()):
            a = pkg.nd.array(x.copy())
            a.attach_grad()
            with pkg.autograd.record():
                y = pkg.nd.amp_cast(a, dtype="bfloat16")
                z = pkg.nd.sum(pkg.nd.amp_cast(y * y, dtype="float32"))
            z.backward()
            res[pkg.__name__] = (z.asnumpy(), a.grad.asnumpy())
    for g, w in zip(res["mxnet_tpu_torch"], res["mxnet_tpu"]):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   rtol=1e-6)
