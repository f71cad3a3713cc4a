"""The port's self-tuning controllers held against the JAX package's on
the CPU: each ported controller, fed the same synthetic metric stream
(made from a seed) for 30 or more ticks, makes the same decision
sequence (the decision records, reasons included), and every decision
lands in the ``tuning.*`` metrics and the flight recorder's tuning ring.

Each controller runs on a fresh ``MetricsRegistry`` (the controllers
module's ``registry`` is pointed at it) and a fresh ``FlightRecorder``;
its knobs (the loader overrides, the batch-window env var) are put back
after each run.  Controllers are driven by ``tick()``: nothing here
sleeps or reads the clock, and the one timer thread started is joined
with a timeout.
"""
import importlib
import warnings

import numpy as np
import pytest

PKGS = ("mxnet_tpu", "mxnet_tpu_torch")


def _pkg(name):
    ctl = importlib.import_module(f"{name}.tuning.controllers")
    return {"ctl": ctl,
            "tuning": importlib.import_module(f"{name}.tuning"),
            "reg": importlib.import_module(
                f"{name}.observability.registry"),
            "flight": importlib.import_module(
                f"{name}.observability.flight"),
            "dl": importlib.import_module(f"{name}.gluon.data.dataloader")}


@pytest.fixture()
def fresh(monkeypatch):
    """Per package: a fresh registry the controllers read, and a fresh
    flight recorder for their decisions."""
    def make(name):
        m = _pkg(name)
        reg = m["reg"].MetricsRegistry()
        monkeypatch.setattr(m["ctl"], "registry", lambda: reg)
        m["registry"] = reg
        m["rec"] = m["flight"].FlightRecorder(capacity=256)
        return m
    monkeypatch.delenv("MXTPU_TUNE_DRY_RUN", raising=False)
    return make


def _run(fresh, build, feed, ticks):
    """Both packages' decision sequences over the same stream."""
    out = []
    for name in PKGS:
        m = fresh(name)
        ctl = build(m)
        rs = np.random.RandomState(0)
        seq = []
        try:
            for t in range(ticks):
                feed(m, ctl, rs, t)
                seq.append(ctl.tick())
        finally:
            m["dl"].set_prefetch_override(None)
            m["dl"].set_device_prefetch_override(None)
        out.append((seq, m["rec"].tunings(), m))
    (js, jrec, _), (ps, prec, pm) = out
    assert js == ps
    assert jrec == prec
    return ps, pm


def _recorded(seq, m, name):
    made = [d for d in seq if d is not None]
    reg = m["registry"]
    assert reg.counter(f"tuning.{name}.decisions").n == len(made)
    assert reg.counter(f"tuning.{name}.applied").n == \
        sum(d["applied"] for d in made)
    assert m["rec"].tunings() == made
    return made


def test_prefetch_controller_matches(fresh):
    def build(m):
        return m["ctl"].PrefetchController(initial=4, flight=m["rec"])

    def feed(m, ctl, rs, t):
        reg = m["registry"]
        reg.counter("loader.batches").inc(int(rs.randint(4, 20)))
        cap = ctl.current()
        reg.gauge("loader.prefetch_capacity").set(cap)
        if t < 12 or t >= 30:
            depth = rs.uniform(0.0, 0.2 * cap)
        else:
            depth = cap * rs.uniform(0.92, 1.0)
        reg.gauge("loader.prefetch_depth").set(float(depth))

    seq, m = _run(fresh, build, feed, 40)
    made = _recorded(seq, m, "prefetch")
    dirs = {np.sign(d["to"] - d["from"]) for d in made if d["applied"]}
    assert dirs == {1.0, -1.0}


def test_device_prefetch_controller_matches(fresh):
    def build(m):
        return m["ctl"].DevicePrefetchController(initial=2, flight=m["rec"])

    def feed(m, ctl, rs, t):
        h = m["registry"].histogram("loader.device_put_us")
        n = int(rs.randint(2, 20))
        if (t // 8) % 2 == 0:
            vals = rs.lognormal(4.0, 1.6, n)       # a heavy tail
        else:
            vals = 60.0 * rs.uniform(0.97, 1.03, n)  # uniform puts
        for v in vals:
            h.observe(float(v))
        m["registry"].gauge("loader.device_buffer_depth").set(
            ctl.current())

    seq, m = _run(fresh, build, feed, 40)
    made = _recorded(seq, m, "device_prefetch")
    assert any(d["applied"] and d["to"] > d["from"] for d in made)
    assert any(d["applied"] and d["to"] < d["from"] for d in made)


def test_batch_window_controller_matches(fresh, monkeypatch):
    def build(m):
        monkeypatch.setenv("MXTPU_SERVING_BATCH_WINDOW_US", "2000.0")
        return m["ctl"].BatchWindowController(flight=m["rec"])

    def feed(m, ctl, rs, t):
        reg = m["registry"]
        phase = t // 10
        depth = [0.3, 6.0, 8.0, 0.5][phase]
        reg.gauge("serving.queue_depth").set(depth * rs.uniform(0.8, 1.2))
        h = reg.histogram("serving.request_us")
        win = ctl.current()
        # a wider window packs fuller batches, until it sets the tail
        p = 3000.0 + (win if phase == 2 else 0.2 * win)
        for v in rs.lognormal(np.log(p), 0.3, int(rs.randint(15, 40))):
            h.observe(float(v))

    seq, m = _run(fresh, build, feed, 40)
    made = _recorded(seq, m, "batch_window")
    assert any("light load" in d["reason"] for d in made)
    assert any("queued" in d["reason"] for d in made)


class _GenServer:
    def __init__(self, slots):
        self.decode_slots = slots

    def set_decode_slots(self, n):
        self.decode_slots = int(n)


def test_decode_slot_controller_matches(fresh):
    def build(m):
        m["srv"] = _GenServer(4)
        return m["ctl"].DecodeSlotController(m["srv"], vmax=64,
                                             enabled=True, flight=m["rec"])

    def feed(m, ctl, rs, t):
        reg = m["registry"]
        slots = m["srv"].decode_slots
        load = 10 if t < 26 else 3                 # the traffic shifts
        steps = int(rs.randint(10, 30))
        h = reg.histogram("serving.decode_step_us")
        for _ in range(steps):
            h.observe(float((1000.0 + 10.0 * slots)
                            * rs.uniform(0.99, 1.01)))
        reg.counter("serving.tokens_generated").inc(
            steps * min(slots, load))

    seq, m = _run(fresh, build, feed, 40)
    made = _recorded(seq, m, "decode_slots")
    assert any("bracketed" in d["reason"] for d in made)
    assert len([d for d in made if d["applied"]]) >= 3


class _Entry:
    def __init__(self, m, name, kind, priority, slo_ms, server):
        reg = m["registry"]
        self.name, self.kind, self.priority = name, kind, priority
        self.slo_ms, self.server = slo_ms, server
        self.h_request = reg.histogram(f"serving.model.{name}.request_us")
        self.c_shed = reg.counter(f"serving.model.{name}.shed")


class _Predict:
    def __init__(self):
        self.workers = 2

    def set_workers(self, n):
        self.workers = int(n)
        return self.workers


class _Registry:
    def __init__(self, entries):
        self._e = entries
        self.shed_level = 0

    def entries(self):
        return list(self._e)

    def priorities(self):
        return sorted({e.priority for e in self._e})

    def set_shed_level(self, level):
        self.shed_level = int(level)


def test_slo_controller_matches(fresh):
    def build(m):
        ents = [_Entry(m, "bert", "predict", 10, 50.0, _Predict()),
                _Entry(m, "lm", "generate", 1, 0.0, object()),
                _Entry(m, "aux", "predict", 5, 0.0, _Predict())]
        m["mreg"] = _Registry(ents)
        return m["ctl"].SloController(m["mreg"], workers_max=8,
                                      flight=m["rec"])

    def feed(m, ctl, rs, t):
        mreg = m["mreg"]
        bert, lm, aux = mreg.entries()
        overload = 3 <= t < 12
        p = 90_000.0 if overload and mreg.shed_level < 5 else (
            60_000.0 if overload else 15_000.0)
        for v in rs.lognormal(np.log(p), 0.2, int(rs.randint(6, 20))):
            bert.h_request.observe(float(v))
        for e in (lm, aux):
            for v in rs.lognormal(np.log(30_000.0), 0.2, 8):
                e.h_request.observe(float(v))
            if e.priority < mreg.shed_level:
                # the shed classes knock less and less once the surge ends
                e.c_shed.inc(int(40 if t < 16 else max(0, 40 - 6 * (t - 16))))

    seq, m = _run(fresh, build, feed, 36)
    made = _recorded(seq, m, "slo")
    ups = [d for d in made if d["to"] > d["from"]]
    downs = [d for d in made if d["to"] < d["from"]]
    assert ups and downs and m["mreg"].shed_level == 0
    assert any("bert.workers 2->4" in d["reason"] for d in made)
    assert m["mreg"].entries()[0].server.workers == 2


def test_dry_run_records_but_applies_nothing(fresh, monkeypatch):
    m = fresh("mxnet_tpu_torch")
    monkeypatch.setenv("MXTPU_TUNE_DRY_RUN", "1")
    srv = _GenServer(4)
    ctl = m["ctl"].DecodeSlotController(srv, min_steps=1, enabled=True,
                                        flight=m["rec"])
    reg = m["registry"]
    for t in range(6):
        reg.histogram("serving.decode_step_us").observe(1000.0)
        reg.counter("serving.tokens_generated").inc(4 + t)
        ctl.tick()
    made = m["rec"].tunings()
    assert made and all(d["dry_run"] and not d["applied"] for d in made)
    assert srv.decode_slots == 4
    assert reg.gauge("tuning.decode_slots.value").value == 4


def test_standard_controllers_and_what_they_leave_out(fresh):
    m = fresh("mxnet_tpu_torch")
    names = [c.name for c in m["tuning"].standard_controllers()]
    assert names == ["prefetch", "batch_window", "fleet_gather",
                     "device_prefetch"]
    jax_names = {c.__class__.__name__ for c in
                 _pkg("mxnet_tpu")["tuning"].standard_controllers()}
    port = {c.__class__.__name__ for c in
            m["tuning"].standard_controllers()}
    # no bulked dispatch in the port; CommBucketController waits for the
    # resilience layer's step times
    assert jax_names - port == {"BulkSizeController"}
    for gone in ("BulkSizeController", "CommBucketController"):
        assert not hasattr(m["ctl"], gone)
    # without a process group the fleet gather has nothing to do
    assert m["ctl"].FleetGatherController().tick() is None


def test_runtime_keeps_a_raising_controller_and_joins(fresh, monkeypatch):
    m = fresh("mxnet_tpu_torch")

    class Boom(m["ctl"].Controller):
        name = "boom"

        def current(self):
            return 0

        def decide(self):
            raise RuntimeError("bad")

    rt = m["tuning"].TuningRuntime()
    boom = rt.add(Boom(vmin=0, vmax=1, flight=m["rec"]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert rt.tick_all() == [] and rt.tick_all() == []
    assert len([w for w in caught if "boom" in str(w.message)]) == 1
    assert boom in rt.controllers
    monkeypatch.setenv("MXTPU_TUNE_INTERVAL", "0.05")
    rt.start()
    assert rt.running
    rt.stop(timeout=5.0)
    assert not rt.running
    rt.remove(boom)
    assert rt.controllers == []
