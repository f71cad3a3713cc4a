"""The port's ``parallel`` layer (``mesh``, ``optim``, ``trainer``:
``ShardedTrainer`` with ZeRO, accumulation, communication buckets, the
non-finite guard and BatchNorm over the global batch) against the JAX
package, whose ``ShardedTrainer`` runs here on conftest's 8-device CPU
mesh.  The port runs at 1 rank in this process and at 2 ranks over gloo
through its launcher (``tests/_torch_launch.py``)."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError

from tests._torch_launch import run_ranks

SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
ADAM = ("adam", {"learning_rate": 0.01})
TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_parallel.py:57-85
STEPS = 3


def _mlp(pkg, prefix="mlp_"):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(64, activation="relu", in_units=16))
        net.add(pkg.gluon.nn.Dense(10, in_units=64))
    return net


def _cnn(pkg, prefix="cnn_"):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.Conv2D(8, 3, padding=1, in_channels=8),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Flatten(),
                nn.Dense(10, in_units=8))
    return net


def _weights(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net.collect_params().items()}


def _jax_net(kind, w):
    net = (_mlp if kind == "mlp" else _cnn)(mx)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(w[k].copy()))
    return net


def _jax_run(kind, w, x, y, opt, steps=STEPS, **kw):
    """The JAX package's ShardedTrainer on the 8-device mesh: the weights
    after each step, and the trainer."""
    net = _jax_net(kind, w)
    guard = kw.pop("guard", None)
    tr = jpar.ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             opt[0], dict(opt[1]), **kw)
    if guard:
        tr.enable_nonfinite_guard(**guard)
    out = []
    for s in range(steps):
        xs = x[s] if isinstance(x, list) else x
        tr.step(xs, y)
        tr.sync_params()
        out.append(_weights(net))
    return out, tr


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    mx.random.seed(3)
    mlp, cnn = _mlp(mx), _cnn(mx)
    mlp.initialize(mx.init.Xavier(rnd_type="gaussian"))
    cnn.initialize(mx.init.Xavier(rnd_type="gaussian"))
    # per-shard distributions differ: shard i of 8 ~ N(i, 1)
    sync_x = np.concatenate([rng.standard_normal((2, 3, 4, 4)) + i
                             for i in range(8)]).astype(np.float32)
    xg = rng.standard_normal((16, 3, 6, 6)).astype(np.float32)
    xg_nan = xg.copy()
    xg_nan[3, 0, 0, 0] = np.nan
    return {"mlp_w": _weights(mlp), "cnn_w": _weights(cnn),
            "x": rng.standard_normal((16, 16)).astype(np.float32),
            "y": rng.integers(0, 10, 16).astype(np.float32),
            "xc": (rng.standard_normal((16, 3, 6, 6)) + 0.5)
            .astype(np.float32),
            "sync_x": sync_x, "guard_x": [xg, xg_nan, xg]}


# -- mesh, rules, functional optimizer: in this process ---------------------

def test_mesh_and_sharding_rules_match_jax():
    import jax
    rules = [(r".*_qkv_weight$", ("tp", None)), (r".*_proj_weight$",
                                                 (None, "tp"))]
    ours, theirs = tpar.ShardingRules(rules), jpar.ShardingRules(rules)
    for name in ("enc0_qkv_weight", "enc0_proj_weight", "enc0_bias"):
        assert tuple(ours.spec_for(name)) == tuple(theirs.spec_for(name))
    m4 = tpar.make_mesh({"dp": 4}, devices=range(4))
    j4 = jpar.make_mesh({"dp": 4}, devices=jax.devices()[:4])
    assert m4.axis_names == j4.axis_names and \
        m4.devices.shape == j4.devices.shape
    assert tpar.axis_size(m4, "dp") == jpar.mesh.axis_size(j4, "dp") == 4
    assert tpar.axis_size(m4, "tp") == jpar.mesh.axis_size(j4, "tp") == 1
    assert tuple(tpar.shard(m4, "dp").spec) == \
        tuple(jpar.shard(j4, "dp").spec)
    assert tuple(tpar.replicated(m4).spec) == \
        tuple(jpar.replicated(j4).spec) == ()
    mesh = tpar.make_mesh()
    assert mesh.axis_names == ("dp",) and mesh.devices.size == 1
    assert tpar.MESH_AXES == jpar.MESH_AXES
    with pytest.raises(MXNetError, match="Queue A 3c"):
        tpar.make_mesh({"dp": 1, "tp": 2}, devices=range(2))
    for name in ("ring_attention", "ResilientTrainer", "HostFenced"):
        with pytest.raises(MXNetError, match="Queue A 3c"):
            getattr(tpar, name)


def test_zero_sharding_and_comm_buckets_match_jax():
    import jax
    from mxnet_tpu.parallel import mesh as jmesh
    for dp in (1, 2, 4):
        m = tpar.make_mesh({"dp": dp}, devices=range(dp))
        j = jpar.make_mesh({"dp": dp}, devices=jax.devices()[:dp])
        for spec, shape in [((), (8, 3)), ((), (6,)), ((), (3, 5)),
                            ((), ()), (("dp", None), (8, 4)),
                            ((None, "dp"), (8, 4)), ((), (1, 7))]:
            ours = tpar.zero_sharding(m, spec, shape)
            theirs = jmesh.zero_sharding(j, spec, shape)
            assert tuple(ours.spec) == tuple(theirs.spec), (dp, spec, shape)
    rng = np.random.default_rng(0)
    for n in (0, 1, 5, 17):
        nbytes = list(rng.integers(1, 5000, n))
        for cap in (0, None, float("inf"), 1, 4096, 10000, 1e9):
            assert tpar.comm_buckets(nbytes, cap) == \
                jmesh.comm_buckets(nbytes, cap), (n, cap)


FOPT = {
    "sgd_and_nag": [("sgd", {"momentum": 0.9, "wd": 1e-3}),
                    ("sgd", {"wd": 1e-3, "clip_gradient": 0.05}),
                    ("nag", {"momentum": 0.9, "wd": 1e-3})],
    "signum_adagrad": [("signum", {"momentum": 0.9, "wd_lh": 1e-3}),
                       ("adagrad", {"wd": 1e-3})],
    "adam_rmsprop": [("adam", {"wd": 1e-3, "clip_gradient": 0.1}),
                     ("rmsprop", {"wd": 1e-3}),
                     ("rmsprop", {"centered": True,
                                  "clip_weights": 0.5})],
}


@pytest.mark.parametrize("group", sorted(FOPT))
def test_functional_optimizer_matches_jax(group):
    import jax.numpy as jnp
    import torch
    rng = np.random.default_rng(4)
    shapes = [(6, 5), (5,), (3, 2, 2)]
    names = [f"p{i}_weight" for i in range(len(shapes))]
    for kind, kw in FOPT[group]:
        w0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
                 for _ in range(3)]
        jopt = jpar.make_functional_optimizer(
            mx.optimizer.create(kind, learning_rate=0.05, **kw), names)
        topt = tpar.make_functional_optimizer(
            mt.optimizer.create(kind, learning_rate=0.05, **kw), names)
        assert topt.kind == jopt.kind and topt.wds == jopt.wds
        jp = [jnp.asarray(w) for w in w0]
        tp = [torch.from_numpy(w.copy()) for w in w0]
        js, ts = jopt.init(jp), topt.init(tp)
        for t, g in enumerate(grads, start=1):
            jp, js = jopt.update(jp, [jnp.asarray(a) for a in g], js,
                                 jnp.int32(t), jnp.float32(0.05),
                                 jnp.float32(0.5))
            tp, ts = topt.update(tp, [torch.from_numpy(a) for a in g], ts,
                                 t, 0.05, 0.5)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{kind} {kw}")


@pytest.mark.parametrize("opt", [SGD, ADAM], ids=["sgd", "adam"])
def test_one_rank_matches_jax_sharded(data, opt):
    want, _ = _jax_run("mlp", data["mlp_w"], data["x"], data["y"], opt)
    net = _mlp(mt)
    net.initialize(ctx=mt.cpu())
    mt.load_reference_params(net, data["mlp_w"], ctx=mt.cpu())
    tr = tpar.ShardedTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                             opt[0], dict(opt[1]))
    assert tr.dp_size == 1
    for s in range(STEPS):
        tr.step(data["x"], data["y"])
        for k, w in _weights(net).items():
            np.testing.assert_allclose(w, want[s][k], **TOL, err_msg=k)


# -- two ranks ---------------------------------------------------------------

WORKER = """
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon, parallel as par
from mxnet_tpu_torch.parallel import dist
dist.init_process_group()
cpu = mt.cpu()
res = {}


def mlp():
    net = gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(gluon.nn.Dense(64, activation="relu", in_units=16))
        net.add(gluon.nn.Dense(10, in_units=64))
    return net


def cnn():
    nn = gluon.nn
    net = nn.HybridSequential(prefix="cnn_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.Conv2D(8, 3, padding=1, in_channels=8),
                nn.BatchNorm(in_channels=8), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Flatten(),
                nn.Dense(10, in_units=8))
    return net


def weights(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net.collect_params().items()}


def run(kind, opt, x, steps=3, **kw):
    net = (mlp if kind == "mlp" else cnn)()
    net.initialize(ctx=cpu)
    mt.load_reference_params(net, INPUTS[kind + "_w"], ctx=cpu)
    guard = kw.pop("guard", None)
    tr = par.ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                            opt[0], dict(opt[1]), **kw)
    if guard:
        tr.enable_nonfinite_guard(**guard)
    out, extra = [], []
    for s in range(steps):
        loss = tr.step(x[s] if isinstance(x, list) else x, INPUTS["y"])
        out.append(weights(net))
        extra.append((float(loss.asnumpy()), tr.last_step_finite,
                      tr.loss_scale))
    return out, extra, tr, net


SGD, ADAM = INPUTS["sgd"], INPUTS["adam"]
res["backend"] = dist.backend()
res["mlp_sgd"] = run("mlp", SGD, INPUTS["x"])[0]
res["mlp_adam"] = run("mlp", ADAM, INPUTS["x"])[0]
res["cnn_sgd"], losses, _, _ = run("cnn", SGD, INPUTS["xc"])
res["cnn_losses"] = losses
res["cnn_accum"] = run("cnn", SGD, INPUTS["xc"], accum_steps=2)[0]
# BatchNorm over the global batch: statistics of every rank's rows
sbn = gluon.nn.HybridSequential(prefix="sbn_")
with sbn.name_scope():
    sbn.add(gluon.contrib.nn.SyncBatchNorm(in_channels=3, momentum=0.0))
sbn.initialize(ctx=cpu)
tr = par.ShardedTrainer(sbn, lambda out, y: mt.nd.mean(out * 0), "sgd",
                        {"learning_rate": 0.0})
tr.step(INPUTS["sync_x"], np.zeros((16,), np.float32))
res["sync"] = (sbn[0].running_mean.data().asnumpy(),
               sbn[0].running_var.data().asnumpy())
# ZeRO, accumulation and buckets against ZeRO 0
variants = {"z0": {}, "z0_again": {}, "z1": {"zero_stage": 1},
            "z2": {"zero_stage": 2}, "z1_a2": {"zero_stage": 1,
                                               "accum_steps": 2},
            "z2_a2": {"zero_stage": 2, "accum_steps": 2},
            "b": {"comm_bucket_mb": 1e-3},
            "z1_b": {"zero_stage": 1, "comm_bucket_mb": 1e-3},
            "z1_binf": {"zero_stage": 1, "comm_bucket_mb": 1e9},
            "z1_plain": {"zero_stage": 1}}
res["zero"] = {}
for name, kw in variants.items():
    w, extra, tr, _ = run("mlp", ADAM if name != "z1_plain" else SGD,
                          INPUTS["x"], **kw)
    res["zero"][name] = {"w": w[-1], "loss": extra[-1][0],
                         "state_bytes": tr.peak_opt_state_bytes(),
                         "buckets": tr.grad_buckets}
# the guard and the dynamic loss scale; a NaN in rank 0's rows
guard = {"dynamic_loss_scale": True, "init_loss_scale": 16.0,
         "scale_growth_interval": 1}
w, extra, tr, net = run("cnn", SGD, INPUTS["guard_x"], guard=guard)
res["guard"] = {"w": w, "extra": extra}
# checkpoints: the JAX package's loads here, the port's there
w, extra, tr, net = run("cnn", SGD, INPUTS["xc"], steps=1)
tr.load_checkpoint(INPUTS["jax_ckpt"])
res["ckpt_loaded"] = (weights(net), tr.num_update)
tr.step(INPUTS["xc"], INPUTS["y"])
res["ckpt_next"] = weights(net)
tr.save_checkpoint(os.path.join(WORK, f"port_ckpt{RANK}"))
# shard_batch places this rank's rows; forward runs the whole batch
w, extra, tr, net = run("mlp", SGD, INPUTS["x"], steps=1)
xs, ys = tr.shard_batch(INPUTS["x"], INPUTS["y"])
tr.step(xs, ys)
res["sharded_step"] = weights(net)
res["forward"] = tr.forward(INPUTS["x"]).asnumpy()
res["rows"] = xs.local.numpy()
save(res)
"""


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """The two ranks' runs, and the JAX checkpoint they load (2 steps)."""
    tmp = tmp_path_factory.mktemp("sharded")
    _, jtr = _jax_run("cnn", data["cnn_w"], data["xc"], data["y"], SGD,
                      steps=2)
    jtr.host_local_ckpt = True
    jtr.save_checkpoint(str(tmp / "jax_ckpt"))
    inputs = dict(data, sgd=SGD, adam=ADAM, jax_ckpt=str(tmp / "jax_ckpt"))
    return run_ranks(2, WORKER, tmp, inputs), tmp


def _close(got, want, **tol):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **(tol or TOL), err_msg=k)


def test_two_ranks_match_jax_sharded(data, ranks):
    results, _ = ranks
    assert results[0]["backend"] == "gloo"
    for key, kind, opt in (("mlp_sgd", "mlp", SGD), ("mlp_adam", "mlp", ADAM),
                           ("cnn_sgd", "cnn", SGD)):
        want, _ = _jax_run(kind, data[kind + "_w"],
                           data["x" if kind == "mlp" else "xc"], data["y"],
                           opt)
        for s in range(STEPS):
            for res in results:
                _close(res[key][s], want[s])
            for k in want[s]:      # replicas bit for bit equal
                np.testing.assert_array_equal(results[0][key][s][k],
                                              results[1][key][s][k])


def test_accumulation_batchnorm_matches_jax(data, ranks):
    """Two microbatches, each normalized over its global rows, running
    statistics moved once a microbatch (tests/test_parallel.py:548)."""
    results, _ = ranks
    want, _ = _jax_run("cnn", data["cnn_w"], data["xc"], data["y"], SGD,
                       accum_steps=2)
    for s in range(STEPS):
        _close(results[1]["cnn_accum"][s], want[s])


def test_batchnorm_statistics_are_the_global_batchs(data, ranks):
    """tests/test_parallel.py:202: with each rank's rows drawn around
    other means, the running statistics are the global batch's; the
    per-rank statistics would miss them by far."""
    results, _ = ranks
    x = data["sync_x"]
    want_mean, want_var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    assert want_var.mean() > 4.0
    per_rank_var = np.mean([x[r * 8:(r + 1) * 8].var(axis=(0, 2, 3))
                            for r in range(2)], axis=0)
    assert np.abs(per_rank_var - want_var).min() > 1.0
    for res in results:
        mean, var = res["sync"]
        np.testing.assert_allclose(mean, want_mean, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(var, want_var, rtol=1e-3, atol=1e-3)


def test_zero_accumulation_and_buckets_match_zero0(ranks):
    """A layout or schedule change, not a numerics change (on the MLP, as
    tests/test_parallel.py:312 runs them: accumulation over BatchNorm
    normalizes each microbatch alone): every variant within
    tests/test_parallel.py:355's tolerance of ZeRO 0; ZeRO 0 twice
    and a bucket cap that holds everything (one bucket, the fused path)
    bit for bit; ZeRO 1's optimizer state about half of ZeRO 0's."""
    results, _ = ranks
    for res in results:
        z = res["zero"]
        ref = z["z0"]
        np.testing.assert_array_equal(ref["loss"], z["z0_again"]["loss"])
        for k in ref["w"]:
            np.testing.assert_array_equal(ref["w"][k], z["z0_again"]["w"][k])
            np.testing.assert_array_equal(z["z1"]["w"][k],
                                          z["z1_binf"]["w"][k])
        assert z["z1_binf"]["buckets"] is None and z["z0"]["buckets"] is None
        assert z["b"]["buckets"] is not None and len(z["b"]["buckets"]) > 1
        for name in ("z1", "z2", "z1_a2", "z2_a2", "b", "z1_b"):
            _close(z[name]["w"], ref["w"], rtol=1e-5, atol=1e-6)
        ratio = z["z1"]["state_bytes"] / ref["state_bytes"]
        assert 0.45 < ratio < 0.6, ratio
        assert z["z1_plain"]["state_bytes"] < z["z1"]["state_bytes"]


def test_guard_and_loss_scale_match_jax(data, ranks):
    """A NaN in one rank's rows skips the whole step on every rank
    (weights, momenta and running statistics kept) and halves the
    dynamic loss scale, as the JAX package's guarded step does."""
    results, _ = ranks
    guard = {"dynamic_loss_scale": True, "init_loss_scale": 16.0,
             "scale_growth_interval": 1}
    want, jtr = _jax_run("cnn", data["cnn_w"], data["guard_x"], data["y"],
                         SGD, guard=guard)
    for res in results:
        w, extra = res["guard"]["w"], res["guard"]["extra"]
        assert [e[1] for e in extra] == [True, False, True]
        for k in w[0]:
            np.testing.assert_array_equal(w[0][k], w[1][k])
        for s in range(STEPS):
            _close(w[s], want[s])
        assert extra[-1][2] == jtr.loss_scale


def test_checkpoints_load_across_packages(data, ranks):
    results, tmp = ranks
    want, _ = _jax_run("cnn", data["cnn_w"], data["xc"], data["y"], SGD)
    for r, res in enumerate(results):
        loaded, t = res["ckpt_loaded"]
        assert t == 2
        for k in loaded:
            np.testing.assert_array_equal(loaded[k], want[1][k])
        _close(res["ckpt_next"], want[2])
    # the JAX package resumes from the port's rank-0 checkpoint
    net = _jax_net("cnn", data["cnn_w"])
    jtr = jpar.ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              *SGD)
    jtr.step(data["xc"], data["y"])
    jtr.load_checkpoint(str(tmp / "port_ckpt0"))
    jtr.sync_params()
    assert jtr.num_update == 3
    for k, w in _weights(net).items():
        np.testing.assert_array_equal(w, results[0]["ckpt_next"][k])


def test_shard_batch_and_forward(data, ranks):
    results, _ = ranks
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["rows"], data["x"][r * 8:
                                                            (r + 1) * 8])
        assert res["forward"].shape == (16, 10)
    want, _ = _jax_run("mlp", data["mlp_w"], data["x"], data["y"], SGD,
                       steps=2)
    _close(results[0]["sharded_step"], want[1])
