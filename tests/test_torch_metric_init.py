"""The rest of the port's metrics, initializers and ``gluon.utils``
against the JAX package on the CPU, with the same numpy inputs.

Tolerances: metric values within 1e-6 relative (both compute on host
numpy, in the same order); ``Constant`` and ``Bilinear`` fills exactly
equal; ``Orthogonal`` and ``MSRAPrelu`` draw from the port's own
generator, so they are held by their defining properties (orthonormal
rows times ``scale`` within 1e-5; the sample std of a 512 x 512 x 3 x 3
draw within 1 % of sqrt(2 / (1 + slope^2) / fan)); ``clip_global_norm``'s
norm and scaled arrays within 1e-6.
"""
import hashlib
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import cpu, initializer, metric
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import utils


def _batches(seed, classes=5, n=12, batches=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, classes, n).astype(np.float32),
             rng.random((n, classes)).astype(np.float32))
            for _ in range(batches)]


def _binary(seed, n=40, batches=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 2, n).astype(np.float32),
             rng.random((n, 2)).astype(np.float32)) for _ in range(batches)]


def _regression(seed, batches=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((6, 3)).astype(np.float32),
             rng.standard_normal((6, 3)).astype(np.float32))
            for _ in range(batches)]


METRICS = [
    ("top_k_acc", {"top_k": 3}, _batches),
    ("topkaccuracy", {"top_k": 1}, _batches),
    ("f1", {}, _binary), ("f1", {"average": "micro"}, _binary),
    ("mae", {}, _regression), ("mse", {}, _regression),
    ("rmse", {}, _regression), ("negativeloglikelihood", {}, _batches),
    ("pearsoncorrelation", {}, _regression), ("mcc", {}, _binary),
    ("acc", {}, _batches), ("ce", {}, _batches),
]


@pytest.mark.parametrize("name,kw,data", METRICS, ids=[
    f"{m[0]}-{i}" for i, m in enumerate(METRICS)])
def test_metric_matches_jax(name, kw, data):
    ours, ref = metric.create(name, **kw), mx.metric.create(name, **kw)
    for label, pred in data(METRICS.index((name, kw, data))):
        # the port takes tensors and NDArrays alike
        ours.update([torch.from_numpy(label)],
                    [pnd.array(pred, ctx=cpu())])
        ref.update([mx.nd.array(label)], [mx.nd.array(pred)])
    (n1, v1), (n2, v2) = ours.get(), ref.get()
    assert n1 == n2 and v1 == pytest.approx(v2, rel=1e-6)
    ours.reset()
    assert math.isnan(ours.get()[1])


def test_custom_metric_np_and_composite():
    def mean_abs(label, pred):
        return float(np.abs(label - pred).mean())

    def pair(label, pred):
        return float(np.abs(label - pred).sum()), label.size
    data = _regression(7)
    for feval in (mean_abs, pair):
        ours, ref = metric.create(feval), mx.metric.create(feval)
        wrapped = (metric.np(feval), mx.metric.np(feval))
        for label, pred in data:
            for m in (ours, wrapped[0]):
                m.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
            for m in (ref, wrapped[1]):
                m.update([mx.nd.array(label)], [mx.nd.array(pred)])
        assert ours.get() == pytest.approx(ref.get(), rel=1e-6)
        assert wrapped[0].get() == pytest.approx(wrapped[1].get(), rel=1e-6)
    comp = metric.create(["mse", "mae", metric.RMSE()])
    comp.update([torch.from_numpy(data[0][0])], [torch.from_numpy(
        data[0][1])])
    assert comp.get()[0] == ["mse", "mae", "rmse"]
    with pytest.raises(MXNetError, match="unknown metric"):
        metric.create("nosuch_metric")


def _fill(init, shape, name="w_weight", seed=0):
    arr = torch.empty(shape)
    initializer.create(init)(name, arr, torch.Generator().manual_seed(seed))
    return arr


def _jax_fill(init, shape, name="w_weight"):
    arr = mx.nd.zeros(shape)
    init(name, arr)
    return arr.asnumpy()


def test_constant_and_bilinear_equal_jax():
    for shape in [(3, 1, 4, 4), (2, 2, 5, 5), (1, 1, 3, 3)]:
        np.testing.assert_array_equal(
            _fill(initializer.Bilinear(), shape).numpy(),
            _jax_fill(mx.init.Bilinear(), shape))
    np.testing.assert_array_equal(
        _fill(initializer.Constant(0.37), (4, 3)).numpy(),
        _jax_fill(mx.init.Constant(0.37), (4, 3)))
    # the name rules still apply: a bias is zeroed, as in the JAX package
    np.testing.assert_array_equal(
        _fill("constant", (3,), name="fc_bias").numpy(),
        _jax_fill(mx.init.Constant(0.0), (3,), name="fc_bias"))


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 4), (4, 2, 3), (5, 5)])
def test_orthogonal_is_orthonormal_times_scale(shape, rand_type):
    w = _fill(initializer.Orthogonal(scale=1.5, rand_type=rand_type),
              shape).double().reshape(shape[0], -1)
    small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    eye = torch.eye(small.shape[0], dtype=torch.float64)
    torch.testing.assert_close(small, 1.5 ** 2 * eye, rtol=0, atol=1e-5)


def test_msraprelu_scale():
    slope = 0.3
    w = _fill(initializer.MSRAPrelu(factor_type="in", slope=slope),
              (512, 512, 3, 3))
    want = math.sqrt(2.0 / (1 + slope ** 2) / (512 * 9))
    assert abs(w.std().item() / want - 1) < 0.01
    assert abs(w.mean().item()) < 0.01 * want


def test_mixed_load_callable_and_register(tmp_path):
    mixed = initializer.Mixed([".*bias", ".*"],
                              [initializer.Constant(2.0), "one"])
    assert torch.equal(_fill(mixed, (3,), "fc_bias"), torch.zeros(3))
    assert torch.equal(_fill(mixed, (2, 2), "fc_weight"), torch.ones(2, 2))
    with pytest.raises(MXNetError, match="pattern"):
        _fill(initializer.Mixed(["x.*"], ["one"]), (2,), "fc_weight")
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    pnd.save(str(tmp_path / "init.params"),
             {"arg:fc_weight": pnd.array(value, ctx=cpu())})
    load = initializer.Load(str(tmp_path / "init.params"),
                            default_init="zeros")
    np.testing.assert_array_equal(_fill(load, (2, 3), "fc_weight").numpy(),
                                  value)
    assert torch.equal(_fill(load, (4,), "other_weight"), torch.zeros(4))
    with pytest.raises(MXNetError, match="incompatible shapes"):
        _fill(load, (3, 2), "fc_weight")
    with pytest.raises(MXNetError, match="no default_init"):
        _fill(initializer.Load({"a": value}), (2,), "b")

    def ones(name, arr):
        arr.fill_(1.0)
    assert torch.equal(_fill(ones, (2,), "fc_weight"), torch.ones(2))
    with pytest.raises(MXNetError, match="instance"):
        initializer.create(initializer.Xavier)

    @initializer.register
    class Fives(initializer.Initializer):
        def init_weight(self, name, arr, generator):
            arr.fill_(5.0)
    assert torch.equal(_fill("fives", (2,)), torch.full((2,), 5.0))


def test_split_and_load_matches_jax():
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    ours = utils.split_data(pnd.array(data, ctx=cpu()), 3,
                            even_split=False)
    ref = mx.gluon.utils.split_data(mx.nd.array(data), 3, even_split=False)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    with pytest.raises(MXNetError, match="evenly"):
        utils.split_data(pnd.array(data, ctx=cpu()), 3)
    parts = utils.split_and_load(data, [cpu(), cpu()], batch_axis=1)
    assert [p.shape for p in parts] == [(10, 2), (10, 2)]
    assert utils.split_and_load(data, [cpu()])[0].shape == (10, 4)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in [(4, 5), (7,), (2, 3, 3)]]
    ref = [mx.nd.array(a) for a in arrays]
    want = mx.gluon.utils.clip_global_norm(ref, max_norm)
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    got = utils.clip_global_norm(tensors[:2] + [pnd.array(arrays[2],
                                                          ctx=cpu())],
                                 max_norm)
    assert got == pytest.approx(want, rel=1e-6)
    for t, r in zip(tensors[:2], ref):
        np.testing.assert_allclose(t.numpy(), r.asnumpy(), atol=1e-6)
    with pytest.raises(MXNetError, match="no arrays"):
        utils.clip_global_norm([], 1.0)
    with pytest.warns(UserWarning, match="nan or inf"):
        utils.clip_global_norm([torch.tensor([np.inf])], 1.0)


def test_check_sha1_and_download(tmp_path):
    path = tmp_path / "f.bin"
    path.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert utils.check_sha1(str(path), digest)
    assert not utils.check_sha1(str(path), "0" * 40)
    with pytest.raises(MXNetError, match="no network"):
        utils.download("http://localhost/none")
