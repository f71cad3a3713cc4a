"""The port's distributed kvstores, launcher and ``gluon.Trainer``'s dist
path (``mxnet_tpu_torch/{kvstore,kvstore_server}.py``,
``parallel/dist.py``, ``tools/launch.py``) against the JAX package.

Ranks run on the CPU over gloo, started by the port's launcher (one
launch checks many invariants, as ``tests/test_dist.py``'s worker does);
the JAX references run in this process."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

from tests._torch_launch import ROOT, run_ranks

OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
THR = 0.5
STEPS = 3

KV_WORKER = """
from mxnet_tpu_torch import kvstore as kv, nd, cpu
from mxnet_tpu_torch.parallel import dist
res = {}
with cpu():
    store = kv.create("dist_sync")
    rank, nw = store.rank, store.num_workers
    res["rank"], res["nw"], res["backend"] = rank, nw, dist.backend()
    store.init(3, nd.ones((4, 5)) * (1.0 if rank == 0 else 99.0))
    out = nd.zeros((4, 5))
    store.pull(3, out=out)
    res["init"] = out.asnumpy()
    store.push(3, nd.ones((4, 5)) * 2.0)
    store.pull(3, out=out)
    res["push"] = out.asnumpy()
    store.push(3, nd.ones((4, 5)) * (rank + 1))
    store.pull(3, out=out)
    res["distinct"] = out.asnumpy()
    # a list of keys of two dtypes in one push
    store.init([5, 6], [nd.zeros((3,)), nd.zeros((2, 2), dtype="float64")])
    store.push([5, 6], [nd.array(INPUTS["g5"][rank]),
                        nd.array(INPUTS["g6"][rank], dtype="float64")])
    res["list"] = [store.pull(5).asnumpy(), store.pull(6).asnumpy()]
    s2 = kv.KVStore("dist_sync")
    s2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    s2.init(7, nd.zeros((8,)))
    g = np.full((8,), 0.3, np.float32)
    o2 = nd.zeros((8,))
    s2.push(7, nd.array(g))
    s2.pull(7, out=o2)
    res["c1"] = o2.asnumpy()
    s2.push(7, nd.array(g))
    s2.pull(7, out=o2)
    res["c2"] = o2.asnumpy()
    # random gradients through compression, three pushes of two keys
    s2.init([8, 9], [nd.zeros((37,)), nd.zeros((5, 3))])
    res["comp"] = []
    for step in range(3):
        s2.push([8, 9], [nd.array(a) for a in INPUTS["comp"][step][rank]])
        res["comp"].append([s2.pull(8).asnumpy(), s2.pull(9).asnumpy()])
    res["host"] = [dist.allreduce_host(np.arange(4.0) * (rank + 1)),
                   dist.reduce_scatter_host(np.ones((2 * nw, 2)) * rank),
                   dist.broadcast_host(np.array([rank + 5])),
                   dist.allgather_bytes(b"r" * (rank + 1))]
    store.barrier()
"""

TRAINER_WORKER = """
import time
from mxnet_tpu_torch import autograd, gluon, kvstore as kv, nd, cpu
from mxnet_tpu_torch.faults import DeadlineExceeded
from mxnet_tpu_torch.parallel import dist


def mlp():
    net = gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(gluon.nn.Dense(64, activation="relu", in_units=20))
        net.add(gluon.nn.Dense(10, in_units=64))
    return net


res = {}
with cpu():
    store = kv.create("dist_sync")
    rank, nw = store.rank, store.num_workers
    x, y = INPUTS["x"], INPUTS["y"]
    half = x.shape[0] // nw
    xr = nd.array(x[rank * half:(rank + 1) * half])
    yr = nd.array(y[rank * half:(rank + 1) * half])
    lossfn = gluon.loss.SoftmaxCrossEntropyLoss()
    for mode in ("off", "on", "2bit"):
        net = mlp()
        net.initialize(ctx=cpu())
        mt_load(net, INPUTS["w"])
        tr = gluon.Trainer(
            net.collect_params(), "sgd", dict(INPUTS["opt"]),
            kvstore=kv.KVStore("dist_sync"),
            update_on_kvstore={"off": False, "on": True, "2bit": False}[mode],
            compression_params=({"type": "2bit", "threshold": 0.5}
                                if mode == "2bit" else None))
        before, pulled = [], []
        for _ in range(INPUTS["steps"]):
            with autograd.record():
                loss = lossfn(net(xr), yr)
            autograd.backward(loss)
            tr.step(x.shape[0])
            before.append({k: p.data().asnumpy()
                           for k, p in net.collect_params().items()})
            pulled.append({k: p.grad().asnumpy()
                           for k, p in net.collect_params().items()})
        res[mode] = {"weights": before, "pulled": pulled,
                     "update_on_kvstore": tr._update_on_kvstore}
    # a barrier that a peer never reaches raises instead of hanging
    if rank == 0:
        t0 = time.monotonic()
        try:
            dist.barrier("lonely", timeout=2.0)
            res["deadline"] = "returned"
        except DeadlineExceeded as e:
            res["deadline"] = str(e)
        res["deadline_s"] = time.monotonic() - t0
    else:
        time.sleep(4.0)
"""


def _worker(body):
    return ("import mxnet_tpu_torch as mt\n"
            "def mt_load(net, arrays):\n"
            "    mt.load_reference_params(net, arrays, ctx=mt.cpu())\n"
            + body + "\nsave(res)\n")


def _jax_mlp():
    net = mx.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(64, activation="relu", in_units=20))
        net.add(mx.gluon.nn.Dense(10, in_units=64))
    return net


def _quantize(acc):
    """The JAX package's 2-bit quantization of one pushed array: its
    codes and the quantized values."""
    codes = np.zeros(acc.shape, np.uint8)
    codes[acc >= THR] = 1
    codes[acc <= -THR] = 2
    q = np.where(codes == 1, THR, np.where(codes == 2, -THR, 0)) \
        .astype(acc.dtype)
    return codes, q


def _compressed_sums(per_rank_steps):
    """Each step's sum over ranks of ``mxnet_tpu.kvstore``'s 2-bit codes
    (packed and unpacked by the JAX functions) of gradient + residual."""
    nw = len(per_rank_steps[0])
    resid = [None] * nw
    out = []
    for grads in per_rank_steps:
        signed = 0
        for r in range(nw):
            acc = grads[r] if resid[r] is None else grads[r] + resid[r]
            codes, q = _quantize(acc)
            resid[r] = acc - q
            packed = mx.kvstore._pack2bit(codes.ravel())
            signed = signed + mx.kvstore._unpack2bit(packed, acc.size)
        out.append((signed.astype(np.float32) * THR)
                   .reshape(per_rank_steps[0][0].shape))
    return out


def _kv_inputs(nw, seed):
    rng = np.random.default_rng(seed)
    comp = [[[rng.uniform(-0.6, 0.6, 37).astype(np.float32),
              rng.uniform(-0.6, 0.6, (5, 3)).astype(np.float32)]
             for _ in range(nw)] for _ in range(3)]
    return {"g5": rng.standard_normal((nw, 3)).astype(np.float32),
            "g6": rng.standard_normal((nw, 2, 2)),
            "comp": comp}


def _check_kv(results, inputs):
    nw = len(results)
    for r, res in enumerate(results):
        assert res["rank"] == r and res["nw"] == nw
        assert res["backend"] == "gloo"
        np.testing.assert_array_equal(res["init"], 1.0)
        np.testing.assert_array_equal(res["push"], 2.0 * nw)
        np.testing.assert_array_equal(res["distinct"],
                                      sum(k + 1 for k in range(nw)))
        np.testing.assert_allclose(res["list"][0], inputs["g5"].sum(0),
                                   rtol=1e-6, atol=1e-6)
        assert res["list"][1].dtype == np.float64
        np.testing.assert_allclose(res["list"][1], inputs["g6"].sum(0),
                                   rtol=1e-12)
        np.testing.assert_array_equal(res["c1"], 0.0)
        np.testing.assert_array_equal(res["c2"], 0.5 * nw)
        for key in range(2):
            want = _compressed_sums([[step[k][key] for k in range(nw)]
                                     for step in inputs["comp"]])
            for step in range(3):
                np.testing.assert_array_equal(res["comp"][step][key],
                                              want[step])
        red, scat, bc, agb = res["host"]
        np.testing.assert_array_equal(red, np.arange(4.0) * sum(
            k + 1 for k in range(nw)))
        np.testing.assert_array_equal(
            scat, np.full((2, 2), float(sum(range(nw)))))
        np.testing.assert_array_equal(bc, [5])
        assert agb == [b"r" * (k + 1) for k in range(nw)]
        # every rank holds the same bits
        for key in ("push", "distinct", "c2"):
            np.testing.assert_array_equal(res[key], results[0][key])


def test_kvstore_invariants_at_two_ranks(tmp_path):
    inputs = _kv_inputs(2, 0)
    _check_kv(run_ranks(2, _worker(KV_WORKER), tmp_path, inputs), inputs)


def test_kvstore_invariants_at_three_ranks(tmp_path):
    inputs = _kv_inputs(3, 1)
    _check_kv(run_ranks(3, _worker(KV_WORKER), tmp_path, inputs), inputs)


@pytest.mark.parametrize("n", [1, 4, 33])
def test_pack2bit_is_the_jax_byte_layout(n):
    import torch
    from mxnet_tpu_torch import kvstore as tkv
    codes = np.random.default_rng(n).integers(0, 3, n).astype(np.uint8)
    ours = tkv._pack2bit(torch.from_numpy(codes)).numpy()
    want = mx.kvstore._pack2bit(codes)
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(
        tkv._unpack2bit(torch.from_numpy(want), n).numpy(),
        mx.kvstore._unpack2bit(want, n))


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The ranks' three Trainer runs (update off and on the store, and
    2-bit compression) from the JAX package's initial weights."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 20)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.float32)
    net = _jax_mlp()
    mx.random.seed(5)
    net.initialize(mx.init.Xavier())
    w = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    inputs = {"x": x, "y": y, "w": w, "opt": OPT, "steps": STEPS}
    results = run_ranks(2, _worker(TRAINER_WORKER),
                        tmp_path_factory.mktemp("trainer"), inputs)
    return inputs, results


def _jax_reference(inputs, nw=2):
    """The JAX package's one-process Trainer: each rank's half through its
    own forward and backward, the gradients summed (``grad_req="add"``),
    then one step."""
    net = _jax_mlp()
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(inputs["w"][k].copy()))
        p.grad_req = "add"
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    lossfn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = inputs["x"], inputs["y"]
    half = x.shape[0] // nw
    after = []
    for _ in range(STEPS):
        net.collect_params().zero_grad()
        for r in range(nw):
            with mx.autograd.record():
                loss = lossfn(net(mx.nd.array(x[r * half:(r + 1) * half])),
                              mx.nd.array(y[r * half:(r + 1) * half]))
            loss.backward()
        tr.step(x.shape[0])
        after.append({k: p.data().asnumpy()
                      for k, p in net.collect_params().items()})
    return after


@pytest.mark.parametrize("mode", ["off", "on"])
def test_trainer_over_dist_sync_matches_the_summed_halves(trainer_runs,
                                                          mode):
    inputs, results = trainer_runs
    want = _jax_reference(inputs)
    for res in results:
        run = res[mode]
        assert run["update_on_kvstore"] == (mode == "on")
        for step in range(STEPS):
            for k, w in want[step].items():
                np.testing.assert_allclose(run["weights"][step][k], w,
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{mode} {step} {k}")
    # replicas stay bit for bit equal
    for step in range(STEPS):
        for k in want[0]:
            np.testing.assert_array_equal(results[0][mode]["weights"][step][k],
                                          results[1][mode]["weights"][step][k])


def test_trainer_compression_pulls_the_quantized_sums(trainer_runs):
    """With 2-bit compression each step's pulled gradient is the sum over
    the ranks of the JAX quantization of each half's gradient plus its
    residual, the gradients taken at the weights the ranks held."""
    inputs, results = trainer_runs
    run = results[0]["2bit"]
    net = _jax_mlp()
    net.initialize()
    lossfn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = inputs["x"], inputs["y"]
    names = list(inputs["w"])
    per_step = []
    for step in range(STEPS):
        start = inputs["w"] if step == 0 else run["weights"][step - 1]
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(start[k].copy()))
        grads = []
        for r in range(2):
            # the JAX package's "write" gradient adds on a second backward
            # without a step: clear it between the halves
            net.collect_params().zero_grad()
            with mx.autograd.record():
                loss = lossfn(net(mx.nd.array(x[r * 8:(r + 1) * 8])),
                              mx.nd.array(y[r * 8:(r + 1) * 8]))
            loss.backward()
            grads.append({k: p.grad().asnumpy().copy()
                          for k, p in net.collect_params().items()})
        per_step.append(grads)
    for k in names:
        want = _compressed_sums([[g[r][k] for r in range(2)]
                                 for g in per_step])
        for step in range(STEPS):
            for res in results:
                np.testing.assert_allclose(res["2bit"]["pulled"][step][k],
                                           want[step], atol=1e-5,
                                           err_msg=f"{k} step {step}")
    assert any(np.abs(w).max() > 0 for w in want)


def test_barrier_without_a_peer_raises_deadline_exceeded(trainer_runs):
    _, results = trainer_runs
    assert "timed out" in results[0]["deadline"], results[0]["deadline"]
    assert 1.5 < results[0]["deadline_s"] < 10


def test_launcher_sets_the_dmlc_environment(tmp_path):
    code = ("import json, os; json.dump({k: os.environ[k] for k in "
            "('DMLC_ROLE', 'DMLC_PS_ROOT_URI', 'DMLC_PS_ROOT_PORT', "
            "'DMLC_NUM_WORKER', 'DMLC_WORKER_ID')}, open(os.path.join("
            f"{str(tmp_path)!r}, os.environ['DMLC_WORKER_ID'] + '.json'), "
            "'w'))")
    from mxnet_tpu_torch.tools import launch
    assert launch.main(["-n", "3", sys.executable, "-c", code]) == 0
    import json
    envs = [json.load(open(tmp_path / f"{r}.json")) for r in range(3)]
    for r, env in enumerate(envs):
        assert env["DMLC_ROLE"] == "worker"
        assert env["DMLC_PS_ROOT_URI"] == "127.0.0.1"
        assert env["DMLC_NUM_WORKER"] == "3" and env["DMLC_WORKER_ID"] == str(r)
        assert env["DMLC_PS_ROOT_PORT"] == envs[0]["DMLC_PS_ROOT_PORT"]


def test_launcher_propagates_the_first_failure_and_ends_the_peers():
    """A rank that dies while its peer waits ends the job: the launcher
    returns its exit code and kills the waiting rank."""
    code = ("import os, sys, time\n"
            "if os.environ['DMLC_WORKER_ID'] == '1':\n"
            "    sys.exit(7)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "mxnet_tpu_torch", "tools",
                                      "launch.py"), "-n", "2",
         sys.executable, "-c", code], cwd=ROOT, timeout=60,
        capture_output=True)
    assert proc.returncode == 7
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("role,rc", [("server", 0), ("scheduler", 0),
                                     ("worker", 0), ("", 1)])
def test_kvstore_server_roles_exit_as_the_jax_package(monkeypatch, role,
                                                      rc):
    from mxnet_tpu import kvstore_server as jax_server
    from mxnet_tpu_torch import kvstore_server
    monkeypatch.setenv("DMLC_ROLE", role)
    assert kvstore_server._main() == jax_server._main() == rc


def test_store_types_and_refusals():
    for name in ("local", "device", "nccl"):
        assert mt.kv.create(name).type == mx.kv.create(name).type == name
        assert mt.kv.create(name).num_workers == 1
    with pytest.raises(MXNetError) as ours:
        mt.kv.create("dist_async")
    with pytest.raises(mx.base.MXNetError) as theirs:
        mx.kv.create("dist_async")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(MXNetError, match="unknown kvstore"):
        mt.kv.create("dist_sync_device")
    with pytest.raises(MXNetError, match="dist_\\* kvstores only"):
        mt.kv.create("local").set_gradient_compression({"type": "2bit"})
    with pytest.raises(MXNetError, match="Queue A 3b"):
        mt.kv.create("local").row_sparse_pull(0, out=None, row_ids=[0])
    from mxnet_tpu_torch.parallel import dist
    with pytest.raises(MXNetError, match="Queue A 3c"):
        dist.init_process_group("127.0.0.1:1", 2, 0, elastic=True)
    assert mt.runtime.is_enabled("DIST_KVSTORE")
