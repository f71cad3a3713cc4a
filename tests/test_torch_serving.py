"""The port's ModelServer serving the port's bert_small on the CPU, held
against the JAX package's bert_small forward of each single sample, plus
the serving contract: length buckets, 429 backpressure, deadline expiry,
drain on stop, and the no-JAX import rule of the port.

Every server is stopped in a finally block so a failing assertion never
leaks threads into the rest of the suite.
"""
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import transformer as jax_tf
from mxnet_tpu_torch import cpu, load_reference_params
from mxnet_tpu_torch.gluon.model_zoo import transformer as port_tf
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.serving import (Bucketer, DeadlineExceeded,
                                     ModelServer, NoBucketError,
                                     ServerClosed, ServerOverloaded)

REPO = Path(__file__).resolve().parents[1]


def _sample(rs, n, vocab=1000):
    return (rs.randint(0, vocab, (n,)).astype(np.int64),
            rs.randint(0, 2, (n,)).astype(np.int64), np.float32(n))


def _port_bert():
    net = port_tf.bert_small(dropout=0.0)
    net.initialize(ctx=cpu(), seed=3)
    return net


def test_served_bert_matches_reference_per_sample():
    """Mixed lengths across two length buckets, batched by the server, each
    equal to the JAX forward of that sample alone (atol 1e-4)."""
    # an explicit prefix leaves the JAX package's instance counter alone
    # (tests/test_transformer.py looks its model up as bertmodel0_)
    ref = jax_tf.bert_small(dropout=0.0, prefix="bertmodel99_")
    ref.initialize()
    port = port_tf.bert_small(dropout=0.0)
    load_reference_params(port, {k: p.data().asnumpy() for k, p in
                                 ref.collect_params().items()}, ctx=cpu())
    rs = np.random.RandomState(0)
    samples = [_sample(rs, n) for n in (5, 16, 9, 30, 21, 32)]
    srv = ModelServer(port, max_batch=4, length_buckets=(16, 32),
                      batch_buckets=(1, 4), deadline_ms=0, workers=2,
                      batch_window_us=20000)
    b0 = registry().counter("serving.batches").n
    try:
        futs = [srv.submit(*s) for s in samples]
        srv.start()
        outs = [f.result(timeout=60) for f in futs]
    finally:
        srv.stop()
    assert registry().counter("serving.batches").n - b0 < len(samples)
    for (toks, types, vl), (mlm, nsp) in zip(samples, outs):
        n = toks.shape[0]
        assert mlm.shape == (n, 1000) and nsp.shape == (2,)
        want = ref(mx.nd.array(toks[None], dtype="int32"),
                   mx.nd.array(types[None], dtype="int32"),
                   mx.nd.array(np.array([vl])))
        np.testing.assert_allclose(mlm, want[0].asnumpy()[0], atol=1e-4)
        np.testing.assert_allclose(nsp, want[1].asnumpy()[0], atol=1e-4)


def test_length_bucket_key_and_int64_canonicalisation():
    """int64 ids serve as int32 and a 0-d valid length passes unpadded, so
    equal requests key one bucket."""
    b = Bucketer(max_batch=4, length_buckets=(16, 32))
    srv = ModelServer(_port_bert(), max_batch=4, length_buckets=(16, 32),
                      deadline_ms=0)
    try:
        req = srv.submit(*_sample(np.random.RandomState(1), 20))
        assert req.key == (((32,), "int32"), ((32,), "int32"),
                           ((), "float32"))
        with pytest.raises(NoBucketError):
            srv.submit(*_sample(np.random.RandomState(1), 33))
    finally:
        srv.stop()
    assert b.batch_buckets == (1, 2, 4)


def test_concurrent_clients_warmup_and_stats():
    net = _port_bert()
    rs = np.random.RandomState(2)
    samples = [_sample(rs, int(n)) for n in rs.randint(1, 33, 12)]
    reg = registry()
    done0 = reg.counter("serving.requests_done").n
    real0 = reg.counter("serving.tokens_real").n
    srv = ModelServer(net, max_batch=4, length_buckets=(16, 32),
                      deadline_ms=0, workers=2, batch_window_us=2000)
    results = {}

    def client(tid):
        for i in range(tid, len(samples), 3):
            results[i] = srv.infer(*samples[i], timeout=60)

    try:
        n_graphs = srv.warmup(*[(np.zeros(n, np.int32),
                                 np.zeros(n, np.int32), np.float32(n))
                                for n in (16, 32)])
        assert n_graphs == 2 * 3            # 2 lengths x batch 1, 2, 4
        srv.start()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
    assert len(results) == len(samples)
    for i, (toks, _, _) in enumerate(samples):
        assert results[i][0].shape == (toks.shape[0], 1000)
        assert np.isfinite(results[i][0]).all()
    # the counters are process-global: compare deltas
    st = srv.stats()
    assert st["executables"] == 6
    assert st["done"] == done0 + len(samples)
    assert st["tokens_real"] == real0 + sum(s[0].shape[0] for s in samples)


def test_backpressure_rejects_past_queue_depth():
    srv = ModelServer(_port_bert(), max_batch=2, queue_depth=3,
                      deadline_ms=0, length_buckets=(16,))
    c0 = registry().counter("serving.rejected_429").n
    rs = np.random.RandomState(3)
    try:
        for _ in range(3):        # not started: nothing drains the queue
            srv.submit(*_sample(rs, 8))
        with pytest.raises(ServerOverloaded):
            srv.submit(*_sample(rs, 8))
        assert registry().counter("serving.rejected_429").n == c0 + 1
    finally:
        srv.stop()                # sheds the queued three


def test_deadline_expiry_is_429_style():
    srv = ModelServer(_port_bert(), max_batch=2, queue_depth=8,
                      deadline_ms=0, length_buckets=(16,))
    rs = np.random.RandomState(4)
    d0 = registry().counter("serving.rejected_deadline").n
    try:
        req = srv.submit(*_sample(rs, 8), deadline_ms=10)
        time.sleep(0.05)          # expires while queued (not started)
        srv.start()
        with pytest.raises(DeadlineExceeded):
            req.result(timeout=30)
        mlm, nsp = srv.infer(*_sample(rs, 8), timeout=60)
        assert mlm.shape == (8, 1000) and nsp.shape == (2,)
    finally:
        srv.stop()
    assert srv.stats()["rejected_deadline"] == d0 + 1


def test_stop_drains_queued_requests():
    srv = ModelServer(_port_bert(), max_batch=4, deadline_ms=0, workers=1,
                      length_buckets=(16,))
    rs = np.random.RandomState(5)
    futs = [srv.submit(*_sample(rs, 10)) for _ in range(6)]
    srv.start()
    srv.stop(drain=True)
    for f in futs:
        assert f.result(timeout=1)[0].shape == (10, 1000)
    with pytest.raises(ServerClosed):
        srv.submit(*_sample(rs, 10))


def test_port_imports_without_jax():
    """The port and chip_smoke.py's module-level code import with jax and
    the JAX package poisoned, and no source of the port imports either."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'mxnet_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import mxnet_tpu_torch, mxnet_tpu_torch.kernels._build\n"
            "import mxnet_tpu_torch.gluon.model_zoo.transformer\n"
            "import mxnet_tpu_torch.gluon.model_zoo.vision.resnet\n"
            "import mxnet_tpu_torch.gluon.model_zoo.vision\n"
            "import mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.gluon.nn\n"
            "import mxnet_tpu_torch.gluon.loss\n"
            "import mxnet_tpu_torch.ndarray.ops_ctc\n"
            "import mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.optimizer\n"
            "import mxnet_tpu_torch.ndarray.ops_optimizer\n"
            "import mxnet_tpu_torch.kernels.multi_sgd\n"
            "import mxnet_tpu_torch.rtc, mxnet_tpu_torch.operator\n"
            "import mxnet_tpu_torch.metric, mxnet_tpu_torch.kernels._nvrtc\n"
            "import mxnet_tpu_torch.ndarray.ops_custom\n"
            "import mxnet_tpu_torch.contrib.amp, mxnet_tpu_torch.ndarray.ops_nn\n"
            "import mxnet_tpu_torch.ndarray.ops_matrix\n"
            "import mxnet_tpu_torch.ndarray.ops_reduce\n"
            "import mxnet_tpu_torch.ndarray.ops_elemwise\n"
            "import mxnet_tpu_torch.ndarray.ops_random\n"
            "import mxnet_tpu_torch.ndarray.register\n"
            "import mxnet_tpu_torch.ndarray.ndarray\n"
            "import mxnet_tpu_torch.ndarray.random\n"
            "import mxnet_tpu_torch.ndarray.utils\n"
            "import mxnet_tpu_torch.context, mxnet_tpu_torch.engine\n"
            "import mxnet_tpu_torch.random, mxnet_tpu_torch.autograd\n"
            "import mxnet_tpu_torch.serving.kv_cache\n"
            "import mxnet_tpu_torch.serving.registry\n"
            "import mxnet_tpu_torch.serving.frontend\n"
            "import mxnet_tpu_torch.serving.server\n"
            "import mxnet_tpu_torch.gluon.cached_op\n"
            "import mxnet_tpu_torch.parallel, mxnet_tpu_torch.kvstore\n"
            "import mxnet_tpu_torch.parallel.dist\n"
            "import mxnet_tpu_torch.parallel.trainer\n"
            "import mxnet_tpu_torch.tools.launch\n"
            "import mxnet_tpu_torch.kvstore_server\n"
            "import mxnet_tpu_torch.observability.registry\n"
            "import mxnet_tpu_torch.observability.trace\n"
            "import mxnet_tpu_torch.observability.tracing\n"
            "import mxnet_tpu_torch.observability.flight\n"
            "import mxnet_tpu_torch.observability.export\n"
            "import mxnet_tpu_torch.observability.sampler\n"
            "import mxnet_tpu_torch.observability.watchdog\n"
            "import mxnet_tpu_torch.tuning\n"
            "import mxnet_tpu_torch.tuning.controllers\n"
            "import mxnet_tpu_torch.profiler\n"
            "import chip_smoke\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'mxnet_tpu.'))"
            " for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mxnet_tpu)\b",
                     re.MULTILINE)
    dyn = re.compile(r"import_module\(|__import__\(")
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    for f in files:
        text = f.read_text()
        assert not bad.search(text), f
        assert not dyn.search(text), f
