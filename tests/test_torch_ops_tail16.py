"""The registry ops the port took over with the symbolic AMP and Module
surface, held against the JAX package's: the shape, indexing and
contraction ops of ``ops_matrix`` (the AMP casts included), the reductions
and orderings of ``ops_reduce``, ``softmin``, ``lars_update`` and
GluonNLP's interleaved attention products.

Every case feeds the same seeded numpy inputs through both packages' ``nd``
frontends on the CPU and compares the outputs (and, for differentiable
ops, the gradient of the outputs' sum with respect to the first input):
exactly where the op copies, casts, indexes, orders or counts, else
within ``TOL`` (fp32).  Ties are deliberate in ``topk``/``sort``/
``argsort``, and the indexing cases include out-of-range and negative
indices.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)


def _f(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _cases():
    rs = np.random.default_rng(16)
    ties = np.array([[1, 3, 3, 2, 3, 1, 0, 3], [5, 5, 5, 5, 4, 4, 6, 6]],
                    np.float32)
    nan = _f(rs, 3, 4)
    nan[0, 1] = nan[2, 3] = np.nan
    # name, inputs, kwargs, exact, gradient
    return [
        ("amp_cast", [_f(rs, 4, 5)], {"dtype": "bfloat16"}, True, True),
        ("amp_cast", [_f(rs, 4, 5)], {"dtype": "float16"}, True, False),
        ("linalg_gemm2", [_f(rs, 3, 4, 5), _f(rs, 3, 6, 5)],
         {"transpose_b": True, "alpha": 0.5}, False, True),
        ("linalg_gemm2", [_f(rs, 5, 4), _f(rs, 5, 6)],
         {"transpose_a": True}, False, True),
        ("shape_array", [_f(rs, 2, 3, 4)], {}, True, False),
        ("size_array", [_f(rs, 2, 3, 4)], {}, True, False),
        ("slice_like", [_f(rs, 4, 5, 6), _f(rs, 2, 3, 4)], {}, True, True),
        ("slice_like", [_f(rs, 4, 5, 6), _f(rs, 2, 3, 4)], {"axes": (0, 2)},
         True, True),
        ("_basic_index", [_f(rs, 4, 5, 6)],
         {"key": (("__slice__", 1, 3, None), 2)}, True, True),
        ("_basic_index", [_f(rs, 4, 5, 6)],
         {"key": (-1, ("__slice__", None, None, 2))}, True, True),
        ("_advanced_index", [_f(rs, 4, 5),
                             np.array([0, 5, -1, -7, 2], np.float32)],
         {}, True, True),
        ("gather_nd", [_f(rs, 3, 4), np.array([[0, 5, -1, -9], [1, 9, -2, 2]],
                                              np.float32)], {}, True, True),
        ("gather_nd", [_f(rs, 3, 4, 2), np.array([[2, 0], [1, 3]],
                                                 np.float32)], {}, True, True),
        ("scatter_nd", [_f(rs, 5), np.array([[0, 2, 0, 4, -1]], np.float32)],
         {"shape": (6,)}, True, True),
        ("scatter_nd", [_f(rs, 5), np.array([[0, 7, -1, -7, 2]], np.float32)],
         {"shape": (6,)}, True, True),
        ("scatter_nd", [_f(rs, 3, 4), np.array([[0, 2, 0], [1, 1, 1]],
                                               np.float32)],
         {"shape": (3, 2, 4)}, True, True),
        ("broadcast_axis", [_f(rs, 1, 3, 1)], {"axis": (0, 2),
                                               "size": (4, 2)}, True, True),
        ("diag", [_f(rs, 4, 5)], {"k": 1}, True, True),
        ("diag", [_f(rs, 4)], {"k": -1}, True, True),
        ("diag", [_f(rs, 2, 4, 4)], {"axis1": 1, "axis2": 2}, True, True),
        ("reshape_like", [_f(rs, 2, 6), _f(rs, 3, 4)], {}, True, True),
        ("reshape_like", [_f(rs, 2, 6, 5), _f(rs, 3, 4)],
         {"lhs_begin": 0, "lhs_end": 2, "rhs_begin": 0, "rhs_end": 2},
         True, True),
        ("cumsum", [_f(rs, 3, 4)], {"axis": 1}, False, True),
        ("cumsum", [_f(rs, 3, 4)], {}, False, True),
        ("cumsum", [_f(rs, 3, 4)], {"axis": 0, "dtype": "float16"}, False,
         False),
        ("trace", [_f(rs, 4, 5)], {"offset": 1}, False, True),
        ("trace", [_f(rs, 3, 4, 4)], {"axis1": 1, "axis2": 2}, False, True),
        ("tril", [_f(rs, 4, 5)], {"k": 1}, True, True),
        ("triu", [_f(rs, 4, 5)], {"k": -1}, True, True),
        ("depth_to_space", [_f(rs, 2, 8, 2, 3)], {"block_size": 2}, True,
         True),
        ("space_to_depth", [_f(rs, 2, 2, 4, 6)], {"block_size": 2}, True,
         True),
        ("identity", [_f(rs, 3, 4)], {}, True, True),
        ("norm", [_f(rs, 4, 5)], {}, False, True),
        ("norm", [_f(rs, 4, 5)], {"ord": 1, "axis": 1, "keepdims": True},
         False, True),
        ("norm", [_f(rs, 4, 5).astype(np.float16)],
         {"axis": 0, "out_dtype": "float32"}, False, False),
        ("nansum", [nan], {"axis": 1}, False, False),
        ("nansum", [nan], {}, False, False),
        ("nanprod", [nan], {"axis": 0, "keepdims": True}, False, False),
        ("argmax_channel", [_f(rs, 3, 5, 2)], {}, True, False),
        ("topk", [ties], {"k": 3}, True, False),
        ("topk", [ties], {"k": 3, "is_ascend": True}, True, False),
        ("topk", [ties], {"k": 2, "ret_typ": "both", "dtype": "int32"}, True,
         False),
        ("topk", [ties], {"k": 3, "ret_typ": "value"}, True, False),
        ("topk", [ties], {"k": 3, "ret_typ": "mask"}, True, False),
        ("topk", [ties.T.copy()], {"k": 2, "axis": 0}, True, False),
        ("sort", [ties], {}, True, False),
        ("sort", [ties], {"is_ascend": False}, True, False),
        ("sort", [_f(rs, 4, 5)], {"axis": 0}, True, True),
        ("argsort", [ties], {}, True, False),
        ("argsort", [ties], {"is_ascend": False}, True, False),
        ("argsort", [ties], {"is_ascend": False, "dtype": "int32"}, True,
         False),
        ("softmin", [_f(rs, 3, 4)], {}, False, True),
        ("softmin", [_f(rs, 3, 4)], {"axis": 0, "temperature": 2.0}, False,
         True),
        ("lars_update", [_f(rs, 4, 5), _f(rs, 4, 5)],
         {"lr": 0.1, "eta": 0.01, "wd": 1e-4, "rescale_grad": 0.5}, False,
         False),
        ("lars_update", [_f(rs, 4, 5), _f(rs, 4, 5)],
         {"lr": 0.1, "clip_gradient": 0.3}, False, False),
        ("lars_update", [np.zeros((3,), np.float32), _f(rs, 3)],
         {"lr": 0.1}, False, False),
        ("_contrib_interleaved_matmul_selfatt_qk", [_f(rs, 6, 2, 3 * 2 * 8)],
         {"heads": 2}, False, True),
        ("_contrib_interleaved_matmul_selfatt_valatt",
         [_f(rs, 6, 2, 3 * 2 * 8), _f(rs, 4, 6, 6)], {"heads": 2}, False,
         True),
        ("_contrib_interleaved_matmul_encdec_qk",
         [_f(rs, 5, 2, 2 * 8), _f(rs, 6, 2, 2 * 2 * 8)], {"heads": 2}, False,
         True),
        ("_contrib_interleaved_matmul_encdec_valatt",
         [_f(rs, 6, 2, 2 * 2 * 8), _f(rs, 4, 5, 6)], {"heads": 2}, False,
         True),
    ]


CASES = _cases()


def _ids():
    seen = {}
    out = []
    for name, *_ in CASES:
        seen[name] = seen.get(name, 0) + 1
        out.append(f"{name}-{seen[name]}")
    return out


def _np(x):
    a = x.asnumpy()
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _run(pkg, name, inputs, kwargs, grad):
    arrays = [pkg.nd.array(a.copy(), dtype=a.dtype) for a in inputs]
    if not grad:
        out = getattr(pkg.nd, name)(*arrays, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [_np(o) for o in outs], None
    arrays[0].attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, name)(*arrays, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        total = pkg.nd.sum(pkg.nd.cast(outs[0], dtype="float32"))
        for o in outs[1:]:
            total = total + pkg.nd.sum(pkg.nd.cast(o, dtype="float32"))
    total.backward()
    return [_np(o) for o in outs], _np(arrays[0].grad)


@pytest.mark.parametrize("name,inputs,kwargs,exact,grad", CASES, ids=_ids())
def test_op_matches_jax(name, inputs, kwargs, exact, grad):
    """Outputs (and the first input's gradient) as the JAX package's:
    exact, or within ``TOL``; the dtype of each output too (bfloat16
    compared as its float32 values)."""
    want, want_g = _run(mx, name, inputs, kwargs, grad)
    with mt.cpu():
        got, got_g = _run(mt, name, inputs, kwargs, grad)
    assert len(got) == len(want)
    pairs = list(zip(got, want)) + ([(got_g, want_g)] if grad else [])
    for g, w in pairs:
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


def test_amp_multicast_widens_as_jax():
    """``amp_multicast`` casts to the promoted dtype: bfloat16 with float16
    gives float32, bfloat16 with float32 float32, bfloat16 alone stays."""
    rs = np.random.default_rng(1)
    for dts, want in ((("bfloat16", "float16"), "float32"),
                      (("bfloat16", "float32"), "float32"),
                      (("bfloat16", "bfloat16"), "bfloat16")):
        vals = [_f(rs, 3) for _ in dts]
        ref = mx.nd.amp_multicast(*[mx.nd.array(v).astype(d)
                                    for v, d in zip(vals, dts)],
                                  num_outputs=2)
        with mt.cpu():
            got = mt.nd.amp_multicast(*[mt.nd.array(v).astype(d)
                                        for v, d in zip(vals, dts)],
                                      num_outputs=2)
        for g, r in zip(got, ref):
            assert str(r.dtype) == want and want in str(g.dtype)
            np.testing.assert_array_equal(_np(g), _np(r))


def test_tie_orders_follow_the_jax_rules():
    """``topk`` puts equal values lowest index first in both directions;
    ``argsort`` descending puts them highest index first (a flipped
    stable ascending sort), in both packages."""
    x = np.array([[1, 3, 3, 2, 3, 1]], np.float32)
    with mt.cpu():
        got = mt.nd.topk(mt.nd.array(x), k=3).asnumpy()
        arg = mt.nd.argsort(mt.nd.array(x), is_ascend=False).asnumpy()
    np.testing.assert_array_equal(got, [[1, 2, 4]])
    np.testing.assert_array_equal(arg, [[4, 2, 1, 3, 5, 0]])
    np.testing.assert_array_equal(
        mx.nd.topk(mx.nd.array(x), k=3).asnumpy(), got)


def test_scatter_nd_is_deterministic_with_repeated_indices():
    """Where indices repeat the last update wins, as the JAX package's
    scatter on the CPU; the port computes it by a max over the update's
    position, so it does not depend on the order of writes."""
    data = np.arange(1, 9, dtype=np.float32)
    idx = np.array([[3, 1, 3, 3, 1, 0, 3, 1]], np.float32)
    want = mx.nd.scatter_nd(mx.nd.array(data), mx.nd.array(idx),
                            shape=(4,)).asnumpy()
    with mt.cpu():
        got = mt.nd.scatter_nd(mt.nd.array(data), mt.nd.array(idx),
                               shape=(4,)).asnumpy()
    np.testing.assert_array_equal(got, [6, 8, 0, 7])
    np.testing.assert_array_equal(got, want)


def test_scatter_nd_infers_binds_and_differentiates_through_sym():
    """``mx.sym.scatter_nd`` goes through ``infer_shape`` (the port runs it
    on ``meta`` tensors: static shapes, no mask) and binds; forward and
    the data's gradient (losing and out-of-range updates get none) as the
    JAX package's executor gives them, exactly."""
    data = np.arange(1, 9, dtype=np.float32)
    idx = np.array([[3, 1, 3, 9, 1, 0, -1, 1]], np.float32)
    head = np.arange(10, 14, dtype=np.float32)
    res = {}
    for pkg in (mx, mt):
        s = pkg.sym.scatter_nd(pkg.sym.var("data"), pkg.sym.var("indices"),
                               shape=(4,), name="s")
        shapes = s.infer_shape(data=data.shape, indices=idx.shape)
        with pkg.cpu():
            grad = pkg.nd.zeros(data.shape)
            exe = s.bind(args={"data": pkg.nd.array(data),
                               "indices": pkg.nd.array(idx)},
                         args_grad={"data": grad},
                         grad_req={"data": "write", "indices": "null"})
            out = exe.forward(is_train=True)[0].asnumpy()
            exe.backward([pkg.nd.array(head)])
            res[pkg] = (shapes, out, _np(exe.grad_dict["data"]))
    assert res[mt][0] == res[mx][0] == ([(8,), (1, 8)], [(4,)], [])
    np.testing.assert_array_equal(res[mt][1], [6, 8, 0, 7])
    np.testing.assert_array_equal(res[mt][2], [0, 0, 0, 0, 0, 10, 13, 11])
    for got, want in zip(res[mt][1:], res[mx][1:]):
        np.testing.assert_array_equal(got, want)


def test_new_ops_are_registered_and_every_port_op_is_a_jax_op():
    """The registry holds 405 names (43 came with the symbolic slice, 132
    with the rest of the op files, 18 with control flow and the rest of
    detection, 10 with quantization and the sliding window), each one
    also a JAX op."""
    from mxnet_tpu.ndarray.register import list_ops as jax_ops
    ours = mt.nd.list_ops()
    assert len(ours) == 405
    assert not set(ours) - set(jax_ops())


def test_topk_refuses_an_unknown_ret_typ():
    with mt.cpu(), pytest.raises(MXNetError):
        mt.nd.topk(mt.nd.array(np.ones((2, 3), np.float32)), ret_typ="x")
    with mt.cpu(), pytest.raises(MXNetError):
        mt.nd.norm(mt.nd.array(np.ones((2, 3), np.float32)), ord=3)


def test_shape_and_size_arrays_are_int32_as_jax():
    """``shape_array``/``size_array`` give int32, as the JAX package's
    (MXNet's give int64): the port follows the reference."""
    with mt.cpu():
        x = mt.nd.array(np.zeros((2, 3, 4), np.float32))
        assert mt.nd.shape_array(x).dtype == np.int32
        assert mt.nd.size_array(x).asnumpy().tolist() == [24]
    assert str(mx.nd.shape_array(mx.nd.zeros((2, 3, 4))).dtype) == "int32"


def test_interleaved_route_matches_plain_attention():
    """GluonNLP's interleaved products around a softmax compute the plain
    attention of the heads they cut out (float64 reference)."""
    rs = np.random.default_rng(3)
    L, B, H, D = 5, 2, 2, 4
    qkv = _f(rs, L, B, H * 3 * D)
    with mt.cpu():
        x = mt.nd.array(qkv)
        att = mt.nd.softmax(mt.nd.contrib.interleaved_matmul_selfatt_qk(
            x, heads=H), axis=-1)
        out = mt.nd.contrib.interleaved_matmul_selfatt_valatt(
            x, att, heads=H).asnumpy()
    p = qkv.astype(np.float64).reshape(L, B, H, 3, D)
    q, k, v = (p[:, :, :, i].transpose(1, 2, 0, 3) for i in range(3))
    s = np.einsum("bhqd,bhkd->bhqk", q / np.sqrt(D), k)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    ref = np.einsum("bhqk,bhkd->bhqd", w, v).transpose(2, 0, 1, 3) \
        .reshape(L, B, H * D)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
