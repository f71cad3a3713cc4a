"""The port's observability layer held against the JAX package's on the
CPU: the registry (percentiles, exemplars, the fleet merge), the
Prometheus text (plain, with exemplars, and the host-labeled aggregate:
byte for byte), W3C trace context, the Chrome events of a span list,
the tracer's sampling, the flight recorder's dump, the watchdog's stall
decisions and postmortem, the sampler's collapsed stacks, the
``/debug`` routes, the exporters and ``mx.profiler``'s op rows.

Every comparison runs on fresh instances (``MetricsRegistry``,
``Tracer``, ``FlightRecorder``, ``Watchdog``, ``Profiler``), never the
process globals, and feeds both packages the same seeded inputs.
Nothing here asserts on wall-clock time; every thread started is joined
with a timeout.
"""
import importlib
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt


def _mods(pkg):
    return {n: importlib.import_module(f"{pkg}.observability.{n}")
            for n in ("registry", "tracing", "flight", "export", "sampler",
                      "watchdog", "trace")}


J = _mods("mxnet_tpu")
P = _mods("mxnet_tpu_torch")
BOTH = [J, P]


def _fill(m, seed=0, with_ex=False):
    """The same metric history into a fresh registry of package ``m``."""
    reg = m["registry"].MetricsRegistry()
    rs = np.random.RandomState(seed)
    reg.counter("serving.requests", help="requests admitted").inc(17)
    reg.counter("engine.ops_dispatched").inc(3)
    reg.gauge("serving.queue_depth", help="depth\nwith a newline").set(2.5)
    reg.gauge("loader.prefetch_depth").set(4)
    h = reg.histogram("serving.request_us", help="per-request latency")
    for i, v in enumerate(rs.lognormal(7.0, 1.2, 300)):
        h.observe(float(v), trace_id=f"{i:032x}" if with_ex else None)
    g = reg.histogram("loader.batch_build_us", base=10.0, growth=2.0,
                      buckets=12)
    for v in rs.uniform(5.0, 5e4, 40):
        g.observe(float(v))
    for model in ("bert", "lm_b"):
        reg.counter(f"serving.model.{model}.requests",
                    help=f"model {model}: requests admitted").inc(
            rs.randint(1, 9))
        reg.gauge(f"serving.model.{model}.depth").set(rs.randint(0, 4))
        mh = reg.histogram(f"serving.model.{model}.request_us",
                           help=f"model {model}: socket latency")
        for v in rs.lognormal(8.0, 0.5, 25):
            mh.observe(float(v), trace_id="ab" * 16 if with_ex else None)
    return reg


@pytest.fixture()
def exemplars_on(monkeypatch):
    """An exemplar hook in both registries and a frozen wall clock, so the
    exemplar lines carry the same timestamp."""
    for m in BOTH:
        r = m["registry"]
        monkeypatch.setattr(r, "_exemplar_trace_hook", lambda: None)
        monkeypatch.setattr(r._time, "time", lambda: 1700000000.125)


def test_prometheus_text_matches_byte_for_byte(exemplars_on):
    texts = [m["export"].prometheus_text(_fill(m, with_ex=True))
             for m in BOTH]
    assert texts[0] == texts[1]
    ex = [m["export"].prometheus_text(_fill(m, with_ex=True),
                                      exemplars=True) for m in BOTH]
    assert ex[0] == ex[1]
    assert ' # {trace_id="' in ex[1]
    assert 'mxtpu_serving_model_request_us_bucket{model="lm_b",' in ex[1]


def test_aggregate_text_from_synthetic_host_states_matches(monkeypatch):
    texts, merged = [], []
    for i, m in enumerate(BOTH):
        r = m["registry"]
        monkeypatch.setattr(r, "_last_host_states", None)
        monkeypatch.setattr(r, "host_id", lambda: 0)
        local = _fill(m, seed=1)
        peers = [(h, _fill(m, seed=10 + h).export_state())
                 for h in (1, 2)]
        # a peer whose bucketing disagrees is labeled, not merged
        odd = m["registry"].MetricsRegistry()
        odd.histogram("serving.request_us", growth=3.0).observe(5.0)
        peers.append((3, odd.export_state()))
        r.ingest_host_states(peers)
        texts.append(m["export"].prometheus_text_aggregate(local))
        merged.append(r.merge_host_states(r.last_host_states(local)))
    assert texts[0] == texts[1]
    assert merged[0] == merged[1]
    assert 'host="3"' in texts[1]
    assert merged[1]["serving.requests"]["total"] == 17 * 3


def test_percentiles_exemplars_and_snapshot_match(exemplars_on):
    regs = [_fill(m, seed=2, with_ex=True) for m in BOTH]
    hs = [r.get("serving.request_us") for r in regs]
    for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert hs[0].percentile(q) == hs[1].percentile(q)
    assert hs[0].exemplars() == hs[1].exemplars()
    assert hs[0].cumulative_buckets() == hs[1].cumulative_buckets()
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].export_state() == regs[1].export_state()
    assert regs[0].snapshot(all_hosts=True) == \
        regs[1].snapshot(all_hosts=True)
    for r in regs:
        r.reset("serving.")
    assert regs[0].snapshot() == regs[1].snapshot()
    assert hs[1].exemplars() == {}


def test_traceparent_parsing_and_deterministic_ids_match():
    good = "00-" + "0af7651916cd43dd8448eb211c80319c" + "-" \
        + "b7ad6b7169203331" + "-01"
    headers = [good, good.upper().replace("0AF", "0af"),
               "0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331",
               "00-xyz-b7ad6b7169203331-01", "00-" + "a" * 31 + "-"
               + "b" * 16 + "-01", "00-" + "a" * 32 + "-" + "g" * 16,
               "", None, 7, "00", "00-" + "a" * 32]
    for h in headers:
        got = [m["tracing"].parse_traceparent(h) for m in BOTH]
        assert [(g.trace_id, g.span_id) if g else None for g in got][0] \
            == [(g.trace_id, g.span_id) if g else None for g in got][1]
    for parts in [(0, 1), ("fence", 7, "step"), ()]:
        assert mx.observability.tracing.deterministic_trace_id(*parts) \
            == P["tracing"].deterministic_trace_id(*parts)


def _span_list():
    rs = np.random.RandomState(5)
    spans = []
    for k in range(6):
        tid = f"{k // 3:032x}"
        sid = f"{k + 1:016x}"
        s = {"name": f"s{k}", "trace_id": tid, "span_id": sid,
             "parent_id": f"{k:016x}" if k % 3 else None,
             "host": k % 2, "t0_pc": 100.0 + k * 0.01 + rs.rand() * 1e-3,
             "t0_wall": 1.7e9 + k, "dur_us": float(rs.randint(1, 900)),
             "lane": k % 3}
        if k == 4:
            s["links"] = [[f"{0:032x}", f"{1:016x}"],
                          [f"{0:032x}", f"{2:016x}"]]
            s["args"] = {"batch": 4}
        spans.append(s)
    return spans


def test_chrome_events_from_spans_match(tmp_path):
    spans = _span_list()
    for kw in ({}, {"base_pc": 99.5, "tid_offset": 64}):
        ev = [m["tracing"].chrome_events_from_spans(spans, **kw)
              for m in BOTH]
        assert ev[0] == ev[1]
    paths = [m["tracing"].chrome_trace_from_spans(
        spans, str(tmp_path / f"t{i}.json")) for i, m in enumerate(BOTH)]
    loaded = [json.load(open(p)) for p in paths]
    assert loaded[0] == loaded[1]
    assert any(e["ph"] == "s" for e in loaded[1]["traceEvents"])


def test_tracer_sampling_tree_ring_and_jsonl_match(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_TRACE", "1")
    monkeypatch.setenv("MXTPU_TRACE_SAMPLE", "3")
    shapes = []
    for i, m in enumerate(BOTH):
        tr = m["tracing"].Tracer(ring=5, jsonl=str(tmp_path / f"s{i}.jsonl"))
        kept = []
        for k in range(10):
            root = tr.begin("root", args={"k": k})
            kept.append(root is not None)
            if root is not None:
                with root:
                    with tr.begin("child") as c:
                        c.annotate(n=k)
                        tr.record_child("leaf", m["tracing"].now(), 5.0,
                                        {"x": 1})
        det = tr.begin("det", trace_id=m["tracing"].deterministic_trace_id(
            "fence", 3), activate=False)
        det.link(m["tracing"].RemoteContext("c" * 32, "d" * 16))
        det.finish()
        tr.flush_jsonl()
        spans = tr.spans()
        by_id = {s["span_id"]: s for s in spans}
        shapes.append((kept, [(s["name"], by_id.get(s["parent_id"] or "",
                                                    {}).get("name"),
                               s.get("args"), s.get("links"))
                              for s in spans],
                       [json.loads(x)["name"] for x in
                        open(tmp_path / f"s{i}.jsonl")],
                       [tr.sampled_index(j) for j in range(7)]))
        assert m["tracing"].current() is None
    assert shapes[0] == shapes[1]
    assert shapes[1][0] == [k % 3 == 0 for k in range(1, 11)]


def test_off_tracer_records_nothing(monkeypatch):
    monkeypatch.delenv("MXTPU_TRACE", raising=False)
    tr = P["tracing"].Tracer(ring=4)
    assert not tr.enabled and tr.begin("x") is None
    monkeypatch.setenv("MXTPU_TRACE", "0")
    assert tr.begin("x") is None and tr.spans() == []


def _flight_payload(m, path):
    rec = m["flight"].FlightRecorder(capacity=3, path=str(path))
    for s in range(5):
        rec.record(step=s, loss=0.5 / (s + 1), scale=np.float32(2.0 ** s))
    for r in range(4):
        rec.record_request(request_id=r, bucket="16:int32", batch_size=4,
                           us=10.0 * r, trace_id=None, ok=r != 2)
    rec.record_tuning(controller="slo", knob="K", frm=1, to=2,
                      applied=True, reason="r")
    rec.record_membership(event="reform", members=[0, 1],
                          timeline=[("detect", 1.5), ("resume", 2.0)])
    out = rec.dump("why")
    return rec, json.load(open(out))


def test_flight_dump_keys_and_records_match(tmp_path):
    got = [_flight_payload(m, tmp_path / f"f{i}.json")
           for i, m in enumerate(BOTH)]
    (jr, jd), (pr, pd) = got
    assert sorted(jd) == sorted(pd)
    for k in ("reason", "capacity", "n_steps", "steps", "n_requests",
              "requests", "n_tuning", "tuning", "n_membership",
              "membership"):
        assert jd[k] == pd[k], k
    assert jr.live() == pr.live()
    assert pr.sibling_path("postmortem").endswith("f1.postmortem.json")
    off = P["flight"].FlightRecorder(capacity=0)
    off.record(step=1)
    assert off.dump("x") is None and off.records() == []


def test_flight_reads_tensors_only_at_dump(tmp_path):
    """A tensor (a CUDA step loss on the card) is kept by reference and
    read to the host in dump/live, never at record time."""
    rec = P["flight"].FlightRecorder(capacity=4, path=str(tmp_path / "t"))
    loss = torch.tensor(0.25)
    rec.record(step=0, loss=loss, grads=torch.arange(3.0),
               nd=mt.nd.array(np.array([1.5], np.float32), ctx=mt.cpu()))
    assert rec.records()[0]["loss"] is loss
    loss.add_(1.0)                       # the record sees the live value
    d = json.load(open(rec.dump("t")))
    assert d["steps"][0] == {"step": 0, "loss": 1.25,
                             "grads": [0.0, 1.0, 2.0], "nd": 1.5}


def test_flight_excepthook_chains_and_uninstalls(tmp_path, monkeypatch):
    import sys
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    rec = P["flight"].FlightRecorder(capacity=2,
                                     path=str(tmp_path / "crash.json"))
    rec.record(step=1)
    rec.install()
    sys.excepthook(ValueError, ValueError("boom"), None)
    assert seen == [ValueError]
    assert json.load(open(tmp_path / "crash.json"))["reason"] == \
        "unhandled ValueError: boom"
    rec.uninstall()
    assert sys.excepthook is not None and not rec._installed


def _watchdog_run(m, path, hist):
    reg = m["registry"].registry()
    h = reg.histogram(hist)
    wd = m["watchdog"].Watchdog(factor=4.0, action="dump", floor_s=0.5,
                                path=str(path))
    tp = wd.touchpoint("test.loop", hist=hist)
    decisions = []
    for beat in range(60):
        if beat < 20 or 40 <= beat < 45:
            tp.beat()
            h.observe(100_000.0 + 1000.0 * (beat % 5))   # ~0.1 s a beat
        newly = wd.tick(0.25)
        decisions.append([{k: v for k, v in d.items()}
                          for d in newly])
    bundle = json.load(open(path)) if os.path.exists(path) else None
    return decisions, bundle, wd.touchpoints()


def test_watchdog_tick_decisions_and_postmortem_keys_match(tmp_path):
    got = [_watchdog_run(m, tmp_path / f"pm{i}.json",
                         f"test.wd{i}_beat_us")
           for i, m in enumerate(BOTH)]
    (jd, jb, jt), (pd, pb, pt) = got
    assert jd == pd
    fired = [i for i, d in enumerate(pd) if d]
    assert len(fired) == 2          # once per quiet period: re-armed
    # "profile" rides along only when a package's global sampler has run
    assert sorted(set(jb) - {"profile"}) == sorted(set(pb) - {"profile"})
    assert pb["stalled"] == pd[fired[-1]]
    assert {"stacks", "flight", "trace_spans", "active_spans",
            "snapshot"} <= set(pb)
    assert [{k: v for k, v in t.items() if k != "hist"} for t in jt] == \
        [{k: v for k, v in t.items() if k != "hist"} for t in pt]


def test_watchdog_thread_and_stack_signal_restore(tmp_path, monkeypatch):
    import signal
    wd = P["watchdog"].Watchdog(factor=0.0, interval_s=0.01)
    assert wd.start() and wd.running
    wd.stop(timeout=5.0)
    assert not wd.running
    monkeypatch.setenv("MXTPU_STACKS_SIGNAL", "SIGUSR2")
    prev = signal.getsignal(signal.SIGUSR2)
    assert P["watchdog"].install_stack_signal()
    assert signal.getsignal(signal.SIGUSR2) is not prev
    assert P["watchdog"].uninstall_stack_signal()
    assert signal.getsignal(signal.SIGUSR2) == prev
    assert not P["watchdog"].uninstall_stack_signal()
    monkeypatch.setenv("MXTPU_STACKS_SIGNAL", "")
    assert not P["watchdog"].install_stack_signal()


def test_profile_window_collapsed_and_chrome_events_match():
    rs = np.random.RandomState(3)
    stacks = ["main;a.py:f;b.py:g", "main;a.py:f", "w0;c.py:h;d.py:k",
              "w1;c.py:h"]
    wins = []
    for m in BOTH:
        w = m["sampler"].ProfileWindow(hz=50.0)
        w.t0 = 1.7e9
        for _ in range(40):
            s = stacks[rs.randint(len(stacks))]
            w.add(s, "" if rs.rand() < 0.5 else "ab" * 16)
            w.samples += 1
        w.close()
        w.t1 = 1.7e9 + 1
        wins.append(w)
        rs = np.random.RandomState(3)
    assert wins[0].collapsed() == wins[1].collapsed()
    assert wins[0].by_trace() == wins[1].by_trace()
    assert wins[0].to_dict() == wins[1].to_dict()
    assert J["sampler"].chrome_events_from_window(wins[0]) == \
        P["sampler"].chrome_events_from_window(wins[1])
    assert J["sampler"].collapsed_from_windows(wins[:1] * 2) == \
        P["sampler"].collapsed_from_windows(wins[1:] * 2)


def test_sampler_tags_stacks_with_the_active_trace(monkeypatch):
    """An on-demand window and a stack dump carry the trace id of the
    span another thread has active; the daemon starts, samples, joins."""
    monkeypatch.setenv("MXTPU_TRACE", "1")
    trc = P["tracing"]
    tr = trc.Tracer(ring=8)
    go, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with tr.begin("serving.dispatch") as sp:
            seen["tid"] = sp.trace_id
            go.set()
            done.wait(10)

    trc.enable_thread_span_tracking()
    try:
        t = threading.Thread(target=worker, name="traced-worker")
        t.start()
        assert go.wait(10)
        stacks = P["sampler"].thread_stacks()
        win = P["sampler"].profile(seconds=0.05, hz=200.0)
    finally:
        done.set()
        t.join(10)
        trc.disable_thread_span_tracking()
    assert not t.is_alive()
    mine = [s for s in stacks if s["name"] == "traced-worker"]
    assert mine and mine[0]["trace_id"] == seen["tid"]
    assert win.by_trace().get(seen["tid"], 0) >= 1
    assert any(s.startswith("traced-worker;") for s, _ in win.counts)
    smp = P["sampler"].StackSampler(hz=200.0, window_secs=0.02, windows=3)
    assert smp.start()
    deadline = time.monotonic() + 10
    while not smp.windows() and time.monotonic() < deadline:
        time.sleep(0.01)
    smp.stop(timeout=5.0)
    assert not smp.running and smp.windows()


def test_debug_routes_follow_the_knob(monkeypatch):
    route = P["export"].debug_route
    monkeypatch.delenv("MXTPU_DEBUG_ENDPOINTS", raising=False)
    assert route("/metrics") is None
    assert route("/debug/stacks")[0] == 404
    monkeypatch.setenv("MXTPU_DEBUG_ENDPOINTS", "1")
    status, ctype, body = route("/debug/stacks")
    assert status == 200 and json.loads(body)["threads"]
    status, _, body = route("/debug/profile", "seconds=0.05&hz=100")
    assert status == 200
    assert route("/debug/profile", "seconds=0.05&format=json")[0] == 200
    assert route("/debug/profile", "windows=1")[0] == 200
    assert json.loads(route("/debug/flight")[2])["n_requests"] >= 0
    knobs = json.loads(route("/debug/vars")[2])
    assert knobs["MXTPU_DEBUG_ENDPOINTS"] is True
    assert "MXTPU_TRACE" in knobs and "MXTPU_WATCHDOG_FACTOR" in knobs
    assert route("/debug/trace/" + "0" * 32)[0] == 404
    assert route("/debug/nope")[0] == 404
    assert route("/debug")[0] == 200


def test_metrics_server_and_jsonl_writer(tmp_path, monkeypatch):
    reg = P["registry"].registry()
    reg.counter("test.obs_scraped").inc(3)
    srv = P["export"].MetricsServer(0, addr="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(url + "/metrics", timeout=10) \
            .read().decode()
        assert "mxtpu_test_obs_scraped 3" in text
        snap = json.loads(urllib.request.urlopen(
            url + "/metrics.json", timeout=10).read())
        assert snap["test.obs_scraped"] == 3
        om = urllib.request.urlopen(url + "/metrics?exemplars=1",
                                    timeout=10).read().decode()
        assert om.endswith("# EOF\n")
    finally:
        srv.stop()
    assert srv._thread is None
    path = tmp_path / "m.jsonl"
    w = P["export"].JsonlWriter(str(path), interval=0.01, max_bytes=10**6)
    w.start()
    deadline = time.monotonic() + 10
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.01)
    w.stop(final_write=True)
    lines = [json.loads(x) for x in open(path)]
    assert lines and lines[-1]["metrics"]["test.obs_scraped"] == 3


def test_env_knobs_start_and_stop_the_exporters(tmp_path, monkeypatch):
    """``MXTPU_METRICS_PORT=0`` binds an ephemeral port that
    ``env_server()`` reads back; ``stop_from_env()`` joins the endpoint
    and the JSONL writer (which writes once more) and lets the knobs
    start them anew."""
    ex = P["export"]
    path = tmp_path / "env.jsonl"
    monkeypatch.setenv("MXTPU_METRICS_PORT", "0")
    monkeypatch.setenv("MXTPU_METRICS_JSONL", str(path))
    monkeypatch.setenv("MXTPU_METRICS_INTERVAL", "3600")
    assert ex.env_server() is None
    ex.maybe_start_from_env()
    try:
        srv = ex.env_server()
        assert srv is not None and srv.port > 0
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read()
        assert text.decode().startswith("#")
        ex.maybe_start_from_env()                    # idempotent
        assert ex.env_server() is srv
    finally:
        ex.stop_from_env()
    assert ex.env_server() is None and srv._thread is None
    assert len(path.read_text().splitlines()) == 1
    monkeypatch.delenv("MXTPU_METRICS_JSONL")
    ex.maybe_start_from_env()
    try:
        assert ex.env_server() not in (None, srv)
    finally:
        ex.stop_from_env()


def test_watchdog_fallback_paths_follow_the_temp_dir(tmp_path, monkeypatch):
    """Without a flight recorder's path, the postmortem and the stack dump
    land in the process's temporary directory (``TMPDIR``), not a fixed
    one."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def no_recorder():
        raise RuntimeError("no recorder")
    monkeypatch.setattr(P["flight"], "recorder", no_recorder)
    wd = P["watchdog"].Watchdog(factor=4.0, path=None)
    wd._dump_postmortem("test", [])
    assert wd.last_postmortem == str(
        tmp_path / f"mxtpu_postmortem_{os.getpid()}.json")
    out = P["watchdog"]._dump_stacks_bundle()
    assert out == str(tmp_path / f"mxtpu_stacks_{os.getpid()}.json")
    assert json.load(open(out))["flight"] == {}


def _nd_sequence(pkg, nd, ctx):
    a = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4), ctx=ctx)
    b = nd.dot(a, a.T)
    c = nd.relu(b - 20.0)
    d = nd.softmax(c, axis=-1)
    e = nd.sum(d * 2.0, axis=0)
    return nd.tanh(e).asnumpy()


def test_profiler_op_rows_match_over_an_nd_sequence(tmp_path):
    rows = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        p = pkg.profiler.Profiler()
        p.filename = str(tmp_path / f"{pkg.__name__}.json")
        p.start()
        try:
            _nd_sequence(pkg, pkg.nd, ctx)
            with importlib.import_module(
                    f"{pkg.__name__}.observability.trace").span(
                    "test.profiled_us", args={"step": 1}):
                pass
        finally:
            p.stop()
        p.dump()
        table = p.dumps()
        rows.append(sorted((ln.split()[0], int(ln.split()[1]))
                           for ln in table.splitlines()[2:]
                           if ln.strip() and ln[0] != " "
                           and ln.split()[1].isdigit()))
        ev = json.load(open(p.filename))["traceEvents"]
        assert any(e.get("cat") == "operator" for e in ev)
        assert any(e.get("cat") == "span" and e["name"] ==
                   "test.profiled_us" for e in ev)
    assert rows[0] == rows[1]
    assert ("span:test.profiled_us", 1) in rows[1]


def test_profiler_device_trace_merges_on_one_clock(tmp_path):
    """profile_all: torch.profiler's trace lands in ``<filename>_cuda/`` and
    its ops sit inside the engine's op events on the merged timeline (on
    the CPU the trace has CPU ops only)."""
    p = mt.profiler.Profiler()
    p.filename = str(tmp_path / "all.json")
    p.profile_all = True
    p.start()
    try:
        with mt.cpu():
            a = mt.nd.array(np.ones((64, 64), np.float32))
            mt.nd.dot(a, a).asnumpy()
    finally:
        p.stop()
    p.dump()
    assert os.path.isdir(str(tmp_path / "all.json_cuda"))
    ev = json.load(open(p.filename))["traceEvents"]
    dot = next(e for e in ev if e.get("cat") == "operator"
               and e["name"] == "dot")
    mm = [e for e in ev if e.get("name") == "aten::mm"]
    assert mm and all(e["pid"] >= p.DEVICE_PID_BASE for e in mm)
    slack = p.marker_err_us + 50.0
    assert dot["ts"] - slack <= mm[0]["ts"] <= \
        dot["ts"] + dot["dur"] + slack
