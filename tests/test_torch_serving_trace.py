"""Causal tracing, flight records and introspection of the port's serving
layer, held against the JAX package's on the CPU.

The same requests go through both packages' ``ModelServer`` (a small
``Dense`` block), ``GenerationServer`` (``causal_lm_small``, 2 layers, 64
wide) and ``HttpFrontend``; the span trees (each span named by its name
and its parent's, request roots by their request id, links resolved the
same way, and the spans' args) and the flight request records must be
the same.  The span tree does not depend on the model, so the weights
need not match.  Each run uses a fresh ``Tracer`` and ``FlightRecorder``;
every server and frontend is stopped in a ``finally`` block.
"""
import http.client
import importlib
import json
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

PKGS = {"jax": "mxnet_tpu", "port": "mxnet_tpu_torch"}


def _obs(pkg, name):
    return importlib.import_module(f"{pkg}.observability.{name}")


@pytest.fixture()
def traced(monkeypatch):
    """Tracing on in both packages, each through a fresh tracer (and the
    exemplar hook it installs)."""
    monkeypatch.setenv("MXTPU_TRACE", "1")
    monkeypatch.delenv("MXTPU_TRACE_SAMPLE", raising=False)
    out = {}
    for key, pkg in PKGS.items():
        trc = _obs(pkg, "tracing")
        tr = trc.Tracer(ring=512)
        monkeypatch.setattr(trc, "_tracer_inst", tr)
        monkeypatch.setattr(_obs(pkg, "registry"), "_exemplar_trace_hook",
                            trc._active_trace_id)
        out[key] = tr
    return out


def _dense(pkg):
    gl = importlib.import_module(f"{pkg}.gluon")
    net = gl.nn.HybridSequential()
    with net.name_scope():
        net.add(gl.nn.Dense(8, in_units=4))
    if pkg == "mxnet_tpu":
        net.initialize()
    else:
        net.initialize(ctx="cpu", seed=0)
    net.hybridize()
    return net


def _canon(spans):
    """The span ring as comparable rows: (label, link labels, args)."""
    by = {s["span_id"]: s for s in spans}

    def label(s):
        if s["name"] in ("serving.request", "serving.generate"):
            return f"{s['name']}#{s['args']['rid']}"
        p = by.get(s.get("parent_id") or "")
        return f"{s['name']}<{label(p) if p else 'remote'}"

    rows = []
    for s in spans:
        links = sorted(label(by[ls]) for _lt, ls in s.get("links") or ()
                       if ls in by)
        rows.append((label(s), links,
                     sorted((s.get("args") or {}).items())))
    return sorted(rows)


def _records(rec):
    return sorted((r["request_id"], r["bucket"], r["batch_size"], r["ok"],
                   r["trace_id"] is not None) for r in rec.requests())


def _serve_dense(pkg, traced_tr, n=5):
    srv_mod = importlib.import_module(f"{pkg}.serving")
    rec = _obs(pkg, "flight").FlightRecorder(capacity=32)
    srv = srv_mod.ModelServer(_dense(pkg), max_batch=4, workers=1,
                              batch_window_us=1000.0, deadline_ms=0,
                              flight=rec)
    rs = np.random.RandomState(0)
    xs = [rs.randn(4).astype(np.float32) for _ in range(n)]
    try:
        reqs = [srv.submit(x) for x in xs]     # queued before the start:
        srv.start()                            # batches of 4, then 1
        outs = [r.result(timeout=60) for r in reqs]
    finally:
        srv.stop()
    return reqs, outs, rec


def test_model_server_span_tree_and_flight_records_match(traced):
    got = {}
    for key, pkg in PKGS.items():
        reqs, outs, rec = _serve_dense(pkg, traced[key])
        spans = traced[key].spans()
        got[key] = (_canon(spans), _records(rec), spans, reqs, rec)
    assert got["jax"][0] == got["port"][0]
    assert got["jax"][1] == got["port"][1]
    canon, records, spans, reqs, rec = got["port"]
    names = [row[0] for row in canon]
    assert "serving.readback<serving.dispatch<serving.assemble<" \
        "serving.request#0" in names
    asm = [row for row in canon if row[0].startswith("serving.assemble")]
    assert sorted(len(row[1]) for row in asm) == [0, 3]
    # the flight records and the exemplars point into the span ring
    tids = {s["trace_id"] for s in spans}
    assert {r["trace_id"] for r in rec.requests()} <= tids
    ex = _obs("mxnet_tpu_torch", "registry").registry().get(
        "serving.request_us").exemplars()
    assert {t for lst in ex.values() for t, _v, _ts in lst} & tids


def test_tracing_leaves_the_served_values_alone(traced, monkeypatch):
    on = _serve_dense("mxnet_tpu_torch", traced["port"])[1]
    monkeypatch.setenv("MXTPU_TRACE", "0")
    reqs, off, _ = _serve_dense("mxnet_tpu_torch", traced["port"])
    assert all(r.trace is None for r in reqs)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def lms():
    np.random.seed(0)
    mx.random.seed(0)
    jax_lm = importlib.import_module(
        "mxnet_tpu.gluon.model_zoo.transformer").causal_lm_small()
    jax_lm.initialize()
    jax_lm.hybridize()
    port_lm = importlib.import_module(
        "mxnet_tpu_torch.gluon.model_zoo.transformer").causal_lm_small()
    port_lm.initialize(ctx="cpu", seed=0)
    port_lm.hybridize()
    return {"jax": jax_lm, "port": port_lm}


def test_generation_server_span_tree_and_flight_records_match(traced, lms):
    got = {}
    for key, pkg in PKGS.items():
        srv_mod = importlib.import_module(f"{pkg}.serving")
        rec = _obs(pkg, "flight").FlightRecorder(capacity=32)
        srv = srv_mod.GenerationServer(
            lms[key], slots=2, kv_block=16, kv_blocks=16, max_new_tokens=3,
            prompt_buckets=(16,), queue_depth=8, deadline_ms=0, flight=rec)
        try:
            reqs = [srv.submit_generate(np.arange(3 + i, dtype=np.int32))
                    for i in range(3)]
            srv.start()
            for r in reqs:
                r.result(timeout=120)
        finally:
            srv.stop()
        got[key] = (_canon(traced[key].spans()), _records(rec))
    assert got["jax"] == got["port"]
    names = [row[0] for row in got["port"][0]]
    assert "serving.prefill<serving.generate#2" in names
    steps = [row for row in got["port"][0]
             if row[0].startswith("serving.decode_step")]
    assert steps and any(row[1] for row in steps)


def _post(port, path, obj, headers):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("POST", path, body=json.dumps(obj), headers=headers)
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, \
            r.read()
    finally:
        c.close()


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def test_frontend_traceparent_parents_and_echoes_as_jax(traced, lms):
    caller = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    got = {}
    for key, pkg in PKGS.items():
        srv_mod = importlib.import_module(f"{pkg}.serving")
        reg = srv_mod.ModelRegistry()
        reg.load("m", srv_mod.ModelServer(_dense(pkg), max_batch=2,
                                          batch_window_us=100.0,
                                          deadline_ms=0), priority=1,
                 slo_ms=25.0)
        reg.load("g", srv_mod.GenerationServer(
            lms[key], slots=2, kv_block=16, kv_blocks=16,
            max_new_tokens=2, prompt_buckets=(16,), deadline_ms=0),
            priority=0)
        fe = srv_mod.HttpFrontend(reg, port=0).start()
        try:
            st, hdrs, body = _post(
                fe.port, "/v1/models/m/predict",
                {"inputs": [[0.25] * 4], "dtype": "float32"},
                {"traceparent": caller})
            st2, hdrs2, _ = _post(fe.port, "/v1/models/g/generate",
                                  {"prompt": [1, 2, 3]},
                                  {"traceparent": caller})
            desc = {m["name"]: m["slo_ms"] for m in json.loads(
                _get(fe.port, "/v1/models")[2])["models"]}
        finally:
            fe.stop(drain=True)
        assert st == 200 and st2 == 200
        spans = traced[key].spans()
        roots = [s for s in spans if s["name"] in ("serving.request",
                                                   "serving.generate")]
        got[key] = (sorted((s["name"], s["trace_id"], s["parent_id"])
                           for s in roots),
                    hdrs["traceparent"].split("-")[1],
                    hdrs2["traceparent"].split("-")[1], desc,
                    sorted({s["name"] for s in spans}))
    assert got["jax"] == got["port"]
    assert got["port"][0] == [("serving.generate", "ab" * 16, "cd" * 8),
                              ("serving.request", "ab" * 16, "cd" * 8)]
    assert got["port"][3] == {"m": 25.0, "g": 0.0}


def test_debug_routes_over_the_front_door(monkeypatch):
    srv_mod = mt.serving
    reg = srv_mod.ModelRegistry()
    fe = srv_mod.HttpFrontend(reg, port=0).start()
    try:
        monkeypatch.delenv("MXTPU_DEBUG_ENDPOINTS", raising=False)
        for path in ("/debug/stacks", "/debug/profile", "/debug"):
            assert _get(fe.port, path)[0] == 404
        monkeypatch.setenv("MXTPU_DEBUG_ENDPOINTS", "1")
        st, ctype, body = _get(fe.port, "/debug/stacks")
        assert st == 200 and ctype == "application/json"
        names = {t["name"] for t in json.loads(body)["threads"]}
        assert any(n.startswith("Thread-") or "MainThread" == n
                   for n in names)
        st, _, body = _get(fe.port, "/debug/profile?seconds=0.05&hz=100")
        assert st == 200 and body
        assert _get(fe.port, "/debug/flight")[0] == 200
        assert _get(fe.port, "/debug/vars")[0] == 200
        assert _get(fe.port, "/healthz")[0] == 200
    finally:
        fe.stop(drain=True)


def test_servers_beat_the_watchdog_touchpoints():
    wd = _obs("mxnet_tpu_torch", "watchdog").watchdog()
    srv = mt.serving.ModelServer(_dense("mxnet_tpu_torch"), max_batch=2,
                                 workers=1, deadline_ms=0)
    before = {t["touchpoint"]: t["beats"] for t in wd.touchpoints()}
    try:
        srv.start()
        srv.submit(np.zeros(4, np.float32)).result(timeout=60)
    finally:
        srv.stop()
    after = {t["touchpoint"]: t["beats"] for t in wd.touchpoints()}
    assert after["serving.dispatch"] > before.get("serving.dispatch", 0)
    tps = {t["touchpoint"]: t["hist"] for t in wd.touchpoints()}
    assert tps["serving.dispatch"] == "serving.dispatch_us"


def test_frontend_sigterm_installs_and_restores_the_stack_signal(
        monkeypatch):
    import signal
    monkeypatch.setenv("MXTPU_STACKS_SIGNAL", "SIGUSR2")
    prev_term = signal.getsignal(signal.SIGTERM)
    prev_usr2 = signal.getsignal(signal.SIGUSR2)
    fe = mt.serving.HttpFrontend(mt.serving.ModelRegistry(), port=0)
    try:
        fe.install_sigterm()
        assert signal.getsignal(signal.SIGUSR2) is not prev_usr2
        fe.uninstall_sigterm()
        assert signal.getsignal(signal.SIGTERM) == prev_term
        assert signal.getsignal(signal.SIGUSR2) == prev_usr2
    finally:
        fe.stop(drain=True)


def test_sampled_dispatch_worker_frames_carry_the_batch_trace(traced):
    """A dispatch worker holds the batch's dispatch span as its active
    context while it runs the batch, so a profile window tags the worker's
    frames with that trace (a slow block on the CPU, where the forward
    runs in the worker's own frames)."""
    import threading
    import torch
    from mxnet_tpu_torch.gluon import HybridBlock

    started = threading.Event()

    class Slow(HybridBlock):
        def forward(self, x):
            started.set()
            time.sleep(0.3)
            return x * 2.0

    srv = mt.serving.ModelServer(Slow(), max_batch=1, workers=1,
                                 deadline_ms=0)
    smp = _obs("mxnet_tpu_torch", "sampler")
    trc = _obs("mxnet_tpu_torch", "tracing")
    # a span is mirrored for other threads from its activation on, while
    # a consumer (the daemon sampler, the watchdog) tracks them
    trc.enable_thread_span_tracking()
    try:
        srv.warmup(np.ones(4, np.float32))     # the build's own call
        started.clear()
        srv.start()
        req = srv.submit(np.ones(4, np.float32))
        assert started.wait(30)
        win = smp.profile(seconds=0.15, hz=200.0)
        req.result(timeout=60)
    finally:
        srv.stop()
        trc.disable_thread_span_tracking()
    tid = req.trace.trace_id
    worker = {t: n for (s, t), n in win.counts.items()
              if s.startswith("mxtpu-serving-worker")}
    assert worker.get(tid, 0) >= 1, worker
    assert torch.equal(torch.as_tensor(req.result()),
                       torch.full((4,), 2.0))


def test_front_door_answers_a_burst_of_connections():
    """96 clients connecting at once are all answered: the listen backlog
    holds the burst (``socketserver``'s default of 5 reset most of them,
    as the JAX package's front door still does)."""
    import threading
    reg = mt.serving.ModelRegistry()
    reg.load("m", mt.serving.ModelServer(_dense("mxnet_tpu_torch"),
                                         max_batch=8, deadline_ms=0,
                                         batch_window_us=1000.0),
             priority=1)
    fe = mt.serving.HttpFrontend(reg, port=0, addr="127.0.0.1").start()
    n = 96
    start, statuses = threading.Barrier(n), []

    def client():
        start.wait(30)
        st, _, _ = _post(fe.port, "/v1/models/m/predict",
                         {"inputs": [[0.25] * 4], "dtype": "float32"}, {})
        statuses.append(st)
    threads = [threading.Thread(target=client) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        fe.stop(drain=True)
    assert not any(t.is_alive() for t in threads)
    assert statuses == [200] * n
