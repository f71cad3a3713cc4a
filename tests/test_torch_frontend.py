"""The port's front door on the CPU: ``ModelRegistry`` behind
``HttpFrontend`` (JSON predict, SSE token streaming, ``/v1/models``,
``/healthz``, ``/readyz``), the registry's priority gate, the blue/green
weight swap, ``set_workers`` and SIGTERM draining; the counterparts of
``tests/test_frontend.py``'s tests.  W3C ``traceparent`` stitching and the
``/debug`` routes are held in ``tests/test_torch_serving_trace.py``, the
SLO controller in ``tests/test_torch_tuning.py`` and the Prometheus text in
``tests/test_torch_observability.py``.

Concurrent HTTP clients must get exactly the floats ``submit()`` returns;
an SSE stream carries exactly the tokens ``generate()`` returns; a client
that hangs up mid-stream leaves no KV block allocated.  The causal LM is
the port's ``causal_lm_small``, module-scoped; every frontend and server
is stopped in a ``finally`` block.
"""
import http.client
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon.model_zoo.transformer import causal_lm_small
from mxnet_tpu_torch.serving import (GenerationServer, HttpFrontend,
                                     ModelRegistry, ModelServer,
                                     RequestCancelled, ServingError,
                                     UnknownModel)


class _Elemwise(HybridBlock):
    """Row-independent elementwise model: a batched row is bit for bit the
    batch-1 row whatever else is in the batch."""

    def forward(self, x):
        return torch.tanh(x * 2.0) + 0.5


class _Elemwise2(HybridBlock):
    """The 'green' weights of the swap test: visibly different."""

    def forward(self, x):
        return torch.tanh(x * 3.0) - 0.25


def _net(cls=_Elemwise):
    net = cls()
    net.hybridize()
    return net


@pytest.fixture(scope="module")
def lm():
    net = causal_lm_small()
    net.initialize(ctx="cpu", seed=0)
    net.hybridize()
    return net


def _gen_server(lm, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("kv_block", 16)
    kw.setdefault("kv_blocks", 64)
    kw.setdefault("max_new_tokens", 64)
    kw.setdefault("prompt_buckets", (16,))
    kw.setdefault("queue_depth", 16)
    kw.setdefault("deadline_ms", 0)
    return GenerationServer(lm, **kw)


def _post(port, path, obj, headers=None, timeout=60.0):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path, body=json.dumps(obj),
                  headers=headers or {})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), json.loads(r.read())
    finally:
        c.close()


def _get(port, path, timeout=30.0):
    """(status, the JSON body; or the text of a plain-text one, as the
    ``/debug`` routes' 404 is)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("GET", path)
        r = c.getresponse()
        body = r.read()
        if (r.getheader("Content-Type") or "").startswith("text/plain"):
            return r.status, body.decode()
        return r.status, json.loads(body)
    finally:
        c.close()


def _sse_events(raw: str):
    """An SSE body as (event name, payload dict) pairs."""
    out = []
    for chunk in raw.split("\n\n"):
        name, data = "message", None
        for line in chunk.strip().splitlines():
            if line.startswith("event:"):
                name = line.partition(":")[2].strip()
            elif line.startswith("data:"):
                data = json.loads(line.partition(":")[2])
        if data is not None:
            out.append((name, data))
    return out


def _sse_generate(port, name, prompt, timeout=120.0, headers=(), **kw):
    """One generation streamed over a raw socket: (events, the
    socket-measured TTFT in seconds, the response headers)."""
    body = json.dumps(dict(prompt=list(map(int, prompt)), **kw))
    extra = "".join(f"{k}: {v}\r\n" for k, v in headers)
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        t0 = time.monotonic()
        s.sendall((f"POST /v1/models/{name}/generate HTTP/1.1\r\n"
                   f"Host: t\r\nContent-Type: application/json\r\n{extra}"
                   f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
        buf, ttft = b"", None
        while True:
            chunk = s.recv(65536)
            if ttft is None and b"data:" in buf + chunk:
                ttft = time.monotonic() - t0
            if not chunk:
                break
            buf += chunk
    finally:
        s.close()
    head, _, payload = buf.partition(b"\r\n\r\n")
    hdrs = {}
    for line in head.decode().splitlines()[1:]:
        k, _, v = line.partition(":")
        hdrs[k.strip().lower()] = v.strip()
    return _sse_events(payload.decode()), ttft, hdrs


# -- wire surface ------------------------------------------------------------

def test_health_ready_models_and_404():
    reg = ModelRegistry()
    fe = HttpFrontend(reg, port=0).start()
    try:
        assert _get(fe.port, "/healthz")[0] == 200
        status, body = _get(fe.port, "/readyz")
        assert status == 503 and body["ready"] is False
        reg.load("m", ModelServer(_net(), max_batch=4,
                                  batch_window_us=100.0), priority=1)
        status, body = _get(fe.port, "/readyz")
        assert status == 200 and body["ready"] is True
        status, body = _get(fe.port, "/v1/models")
        assert status == 200
        (m,) = body["models"]
        assert m["name"] == "m" and m["kind"] == "predict"
        assert m["status"] == "ready" and "stats" in m
        assert _get(fe.port, "/nope")[0] == 404
        assert _get(fe.port, "/debug/spans")[0] == 404
        assert _post(fe.port, "/v1/models/ghost/predict",
                     {"inputs": [[0.0]]})[0] == 404
        assert _post(fe.port, "/v2/elsewhere", {})[0] == 404
    finally:
        fe.stop(drain=True)


def test_concurrent_http_clients_bitwise_match_direct_submit():
    srv = ModelServer(_net(), max_batch=8, batch_window_us=300.0)
    reg = ModelRegistry()
    reg.load("elem", srv, priority=1)
    fe = HttpFrontend(reg, port=0).start()
    rng = np.random.default_rng(7)
    xs = [rng.uniform(-1, 1, (16,)).astype(np.float32) for _ in range(24)]
    direct = [srv.infer(x) for x in xs]
    failures = []

    def client(idx):
        for i in range(idx, len(xs), 4):
            status, _, body = _post(
                fe.port, "/v1/models/elem/predict",
                {"inputs": [xs[i].tolist()], "dtype": "float32"})
            got = np.asarray(body["outputs"][0], dtype=np.float32)
            if status != 200 or not np.array_equal(got, direct[i]):
                failures.append((i, status))

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert failures == []
        assert reg.get("elem").c_done.n == len(xs)
    finally:
        fe.stop(drain=True)


def test_predict_error_mapping(lm):
    reg = ModelRegistry()
    reg.load("p", ModelServer(_net(), max_batch=4, batch_window_us=100.0),
             priority=1)
    reg.load("g", _gen_server(lm), priority=1)
    fe = HttpFrontend(reg, port=0).start()
    try:
        assert _post(fe.port, "/v1/models/g/predict",
                     {"inputs": [[1]]})[0] == 400
        assert _post(fe.port, "/v1/models/p/generate",
                     {"prompt": [1, 2]})[0] == 400
        assert _post(fe.port, "/v1/models/p/predict", {})[0] == 400
        assert _post(fe.port, "/v1/models/g/generate",
                     {"prompt": list(range(1, 40))})[0] == 400
        status, _, body = _post(fe.port, "/v1/models/none/predict",
                                {"inputs": [[1.0]]})
        assert status == 404 and body["error"] == "UnknownModel"
    finally:
        fe.stop(drain=True)


# -- SSE streaming -----------------------------------------------------------

def test_sse_stream_token_order_and_done_event(lm):
    srv = _gen_server(lm)
    reg = ModelRegistry()
    reg.load("lm", srv, priority=1)
    fe = HttpFrontend(reg, port=0).start()
    try:
        prompt = np.array([3, 5, 7, 9], np.int32)
        direct = srv.generate(prompt, max_new_tokens=6)
        # a traceparent header is accepted and ignored (not ported yet)
        events, ttft, headers = _sse_generate(
            fe.port, "lm", prompt, max_new_tokens=6,
            headers=[("traceparent", f"00-{'ab' * 16}-{'cd' * 8}-01")])
        assert headers["content-type"] == "text/event-stream"
        toks = [e["token"] for n, e in events if n == "message"]
        assert [e["index"] for n, e in events
                if n == "message"] == list(range(len(toks)))
        assert toks == list(direct)
        (done,) = [e for n, e in events if n == "done"]
        assert done["tokens"] == list(direct) and done["n"] == len(toks)
        assert ttft is not None
        assert reg.get("lm").h_ttft.count == 1
    finally:
        fe.stop(drain=True)


def test_sse_mid_stream_disconnect_releases_kv_blocks(lm):
    srv = _gen_server(lm)
    reg = ModelRegistry()
    reg.load("lm", srv, priority=1)
    fe = HttpFrontend(reg, port=0).start()
    try:
        srv.generate(np.array([3, 5, 7], np.int32), max_new_tokens=2)
        body = json.dumps({"prompt": [3, 5, 7], "max_new_tokens": 64})
        s = socket.create_connection(("127.0.0.1", fe.port), timeout=60)
        buf = b""
        try:
            s.sendall((f"POST /v1/models/lm/generate HTTP/1.1\r\n"
                       f"Host: t\r\n"
                       f"Content-Length: {len(body)}\r\n\r\n{body}")
                      .encode())
            while buf.count(b"data:") < 2:
                buf += s.recv(4096)
        finally:
            s.close()               # hang up mid-generation
        deadline = time.time() + 30
        while time.time() < deadline and (srv._kv.used()
                                          or srv._kv.reserved()):
            time.sleep(0.05)
        assert srv._kv.used() == 0 and srv._kv.reserved() == 0
    finally:
        fe.stop(drain=True)


def test_gen_request_stream_raises_cancel_error(lm):
    srv = _gen_server(lm).start()
    try:
        srv.warmup()
        req = srv.submit_generate(np.array([3, 5, 7], np.int32),
                                  max_new_tokens=64)
        it = req.stream(timeout=60)
        next(it)
        assert srv.cancel(req) is True
        with pytest.raises(RequestCancelled):
            for _ in it:
                pass
        assert srv.cancel(req) is False
    finally:
        srv.stop(drain=False)
    assert srv.stats()["kv_blocks_used"] == 0


def test_cancel_while_queued_fails_at_once(lm):
    srv = _gen_server(lm)
    req = srv.submit_generate(np.array([3, 5, 7], np.int32))
    assert srv.cancel(req) is True
    with pytest.raises(RequestCancelled):
        req.result(timeout=5)
    assert srv.stats()["queue_depth"] == 0
    srv.stop(drain=False)


# -- the registry gate -------------------------------------------------------

def test_priority_shedding_429_lowest_first():
    reg = ModelRegistry()
    reg.load("low", ModelServer(_net(), max_batch=4,
                                batch_window_us=100.0), priority=1)
    reg.load("high", ModelServer(_net(_Elemwise2), max_batch=4,
                                 batch_window_us=100.0), priority=3)
    fe = HttpFrontend(reg, port=0).start()
    x = {"inputs": [[0.5] * 16], "dtype": "float32"}
    try:
        reg.set_shed_level(2)
        status, _, body = _post(fe.port, "/v1/models/low/predict", x)
        assert status == 429 and "shed" in body["detail"]
        assert _post(fe.port, "/v1/models/high/predict", x)[0] == 200
        assert reg.get("low").c_shed.n == 1
        assert reg.get("high").c_shed.n == 0
        assert reg.priorities() == [1, 3]
        reg.set_shed_level(0)
        assert _post(fe.port, "/v1/models/low/predict", x)[0] == 200
    finally:
        fe.stop(drain=True)


def test_registry_load_validations():
    reg = ModelRegistry()
    srv = ModelServer(_net(), max_batch=2, batch_window_us=100.0)
    reg.load("a", srv, priority=1)
    try:
        with pytest.raises(ServingError):
            reg.load("a", srv)
        with pytest.raises(ServingError):
            reg.load("sp ace", srv)
        with pytest.raises(UnknownModel):
            reg.unload("ghost")
        with pytest.raises(UnknownModel):
            reg.get("ghost")
        reg.unload("a")
        assert reg.names() == [] and not reg.ready()
    finally:
        reg.stop_all(drain=False)


# -- blue/green swap ---------------------------------------------------------

def test_blue_green_swap_drops_nothing_under_live_traffic():
    srv = ModelServer(_net(), max_batch=4, batch_window_us=200.0)
    reg = ModelRegistry()
    reg.load("m", srv, priority=1)
    fe = HttpFrontend(reg, port=0).start()
    x = np.random.default_rng(3).uniform(-1, 1, (16,)).astype(np.float32)
    old = srv.infer(x)
    outs, errors = [], []
    stop = threading.Event()

    def client():
        c = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        while not stop.is_set():
            try:
                c.request("POST", "/v1/models/m/predict",
                          body=json.dumps({"inputs": [x.tolist()],
                                           "dtype": "float32"}))
                r = c.getresponse()
                body = json.loads(r.read())
                if r.status != 200:
                    errors.append(body)
                else:
                    outs.append(np.asarray(body["outputs"][0], np.float32))
            except Exception as e:      # noqa: BLE001 — collected
                errors.append(repr(e))
        c.close()

    try:
        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        staged = reg.swap("m", _net(_Elemwise2))
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(30)
        new = srv.infer(x)
        assert staged >= 1
        assert reg.get("m").swaps == 1
        assert errors == []
        assert len(outs) > 0
        assert all(np.array_equal(o, old) or np.array_equal(o, new)
                   for o in outs)
        assert not np.array_equal(new, old)
    finally:
        fe.stop(drain=True)


def test_swap_rejected_for_generation_models(lm):
    reg = ModelRegistry()
    reg.load("g", _gen_server(lm), priority=1)
    try:
        with pytest.raises(ServingError):
            reg.swap("g", causal_lm_small())
    finally:
        reg.stop_all(drain=False)


# -- graceful shutdown -------------------------------------------------------

def test_generation_server_sigterm_drains(lm):
    srv = _gen_server(lm).start()
    srv.warmup()
    chained = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    srv.install_sigterm()
    try:
        req = srv.submit_generate(np.array([3, 5, 7], np.int32),
                                  max_new_tokens=4)
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 30
        while time.time() < deadline and not srv._closed:
            time.sleep(0.02)
        assert srv._closed
        assert len(req.result(timeout=30)) == 4
        deadline = time.time() + 10
        while time.time() < deadline and not chained:
            time.sleep(0.02)
        assert chained == [signal.SIGTERM]
    finally:
        srv.uninstall_sigterm()
        signal.signal(signal.SIGTERM, prev)
        srv.stop(drain=False)


def test_model_server_sigterm_drains():
    srv = ModelServer(_net(), max_batch=2, batch_window_us=100.0).start()
    prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    srv.install_sigterm()
    try:
        req = srv.submit(np.zeros(16, np.float32))
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 30
        while time.time() < deadline and not srv._admission.closed:
            time.sleep(0.02)
        assert srv._admission.closed
        np.testing.assert_array_equal(req.result(timeout=30),
                                      np.full(16, 0.5, np.float32))
    finally:
        srv.uninstall_sigterm()
        signal.signal(signal.SIGTERM, prev)
        srv.stop(drain=False)


def test_frontend_sigterm_drains_every_model(lm):
    ms = ModelServer(_net(), max_batch=2, batch_window_us=100.0)
    gs = _gen_server(lm)
    reg = ModelRegistry()
    reg.load("p", ms, priority=1)
    reg.load("g", gs, priority=1)
    fe = HttpFrontend(reg, port=0).start()
    prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    fe.install_sigterm()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 30
        while time.time() < deadline and not (
                gs._closed and ms._admission.closed):
            time.sleep(0.02)
        assert gs._closed and ms._admission.closed
        assert fe.draining
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", fe.port),
                                     timeout=2).close()
    finally:
        fe.uninstall_sigterm()
        signal.signal(signal.SIGTERM, prev)
        fe.stop(drain=False)


# -- worker scaling ----------------------------------------------------------

def test_set_workers_grow_and_shrink_keeps_serving():
    srv = ModelServer(_net(), max_batch=2, batch_window_us=100.0, workers=1)
    reg = ModelRegistry()
    reg.load("m", srv, priority=1)
    x = np.linspace(-1, 1, 16).astype(np.float32)
    want = srv.infer(x)
    try:
        assert srv.set_workers(4) == 4
        assert np.array_equal(srv.infer(x), want)
        assert srv.set_workers(1) == 1
        for _ in range(4):
            assert np.array_equal(srv.infer(x), want)
    finally:
        reg.stop_all(drain=True)
