"""Generation serving in the port, held against the JAX package on the CPU:
the block-managed KV cache, ``CausalLM``'s three entries (the full
forward, the paged prefill and decode), and the token-level
``GenerationServer`` scheduler.

The JAX ``causal_lm_small`` is built once per module and its weights are
carried into the port's by ``load_reference_params`` (the tied
``out_proj``/``word_embed`` weight loads once).  The scheduler tests are
the counterparts of ``tests/test_generation.py``'s, run on the port's
server over that model.  On the CPU the generation entries run eagerly
(their captured graphs are held on the card, ``tests/test_torch_cuda.py``).

Tolerances, fp32: logits and pool 1e-5 (summation order differs between
XLA and torch); teacher forcing: each token a server chose within 1e-5 of
the other package's best logit at that step; batched against alone, bit
for bit.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.transformer import \
    causal_lm_small as jax_causal_lm_small
from mxnet_tpu.observability.registry import registry as jax_registry
from mxnet_tpu.serving import BlockKVCache as JaxBlockKVCache
from mxnet_tpu.serving import GenerationServer as JaxGenerationServer
from mxnet_tpu_torch import cpu, load_reference_params
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.transformer import causal_lm_small
from mxnet_tpu_torch.observability.registry import registry
from mxnet_tpu_torch.serving import (SCRATCH_BLOCK, BlockKVCache,
                                     DeadlineExceeded, GenerationServer,
                                     NoBucketError, ServerOverloaded)
from mxnet_tpu_torch.serving.server import DECODE_ROWS, decode_rows

TOL = 1e-5


# -- BlockKVCache against the JAX package's ---------------------------------

def _try(fn, *args):
    try:
        return fn(*args)
    except (ValueError, RuntimeError) as e:
        return ("raises", type(e).__name__)


def _table(t):
    return None if t is None else (list(t.blocks), t.reserved, t.seq_len)


def _case_blocks_needed(kv_cls, reg):
    kv = kv_cls(n_blocks=8, block_size=4)
    return [kv.capacity, kv.blocks_needed(1, 0), kv.blocks_needed(4, 0),
            kv.blocks_needed(5, 0), kv.blocks_needed(3, 6), kv.fits(4, 24),
            kv.fits(4, 25)]


def _case_constructor_args(kv_cls, reg):
    return [_try(kv_cls, 1, 4), _try(kv_cls, 8, 0)]


def _case_lazy_growth(kv_cls, reg):
    kv = kv_cls(n_blocks=8, block_size=4)
    trace = [_table(kv.reserve(1, prompt_len=5, max_new_tokens=6)),
             kv.used()]
    t = kv.ensure(1, 5)
    trace += [kv.used(), _table(t), t.padded(4), SCRATCH_BLOCK in t.blocks]
    t = kv.ensure(1, 9)
    trace += [kv.used(), _table(t), t.padded(5)]
    kv.release(1)
    return trace + [kv.used(), kv.reserved()]


def _case_release_returns_reservation(kv_cls, reg):
    kv = kv_cls(n_blocks=4, block_size=4)
    trace = [_table(kv.reserve(1, 4, 8)), _table(kv.reserve(2, 1, 1))]
    kv.ensure(1, 4)
    kv.release(1)
    return trace + [_table(kv.reserve(2, 4, 8)), kv.reserved()]


def _case_ensure_past_reservation(kv_cls, reg):
    kv = kv_cls(n_blocks=8, block_size=4)
    kv.reserve(1, 4, 0)
    return [_try(kv.ensure, 1, 5), kv.used()]


def _case_occupancy_gauge(kv_cls, reg):
    kv = kv_cls(n_blocks=8, block_size=2)
    kv.reserve(7, 4, 0)
    kv.ensure(7, 4)
    trace = [reg.snapshot()["serving.kv_blocks_used"]]
    kv.release(7)
    return trace + [reg.snapshot()["serving.kv_blocks_used"]]


def _case_double_release(kv_cls, reg):
    kv = kv_cls(n_blocks=8, block_size=4)
    kv.reserve(1, 4, 0)
    kv.ensure(1, 4)
    kv.release(1)
    kv.release(1)
    return [kv.used(), kv.reserved()]


def _case_interleaved_requests(kv_cls, reg):
    """Three requests growing and leaving in turn: the free list's order
    decides which block ids each table gets."""
    kv = kv_cls(n_blocks=10, block_size=2)
    trace = [_table(kv.reserve(r, 3, 2)) for r in (1, 2, 3)]
    for r, n in ((1, 3), (2, 1), (1, 5), (3, 6), (2, 4)):
        trace.append(_table(kv.ensure(r, n)))
    kv.release(1)
    trace += [_table(kv.reserve(4, 2, 2)), _table(kv.ensure(4, 4)),
              kv.used(), kv.reserved()]
    for r in (2, 3, 4):
        kv.release(r)
    return trace + [kv.used(), kv.reserved()]


KV_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
            if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(KV_CASES))
def test_block_kv_cache_matches_jax(case):
    """The same reserve/ensure/release sequence gives the same tables,
    counts, gauge readings and errors in both packages."""
    fn = KV_CASES[case]
    assert fn(BlockKVCache, registry()) == fn(JaxBlockKVCache,
                                                jax_registry())


# -- CausalLM's entries against the JAX package's ---------------------------

@pytest.fixture(scope="module")
def models():
    """The JAX ``causal_lm_small`` (seeded as ``bench.py`` seeds it) and
    the port's on its weights, on the CPU."""
    np.random.seed(0)
    mx.random.seed(0)
    ref = jax_causal_lm_small()
    ref.initialize()
    ref.hybridize()
    port = causal_lm_small()
    load_reference_params(
        port, {k: p.data().asnumpy() for k, p in
               ref.collect_params().items()}, ctx=cpu())
    port.hybridize()
    return ref, port


@pytest.fixture(scope="module")
def lm(models):
    return models[1]


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t)


def test_tied_weight_loads_once(models):
    ref, port = models
    assert not any(k.endswith("out_weight") for k in port.collect_params())
    assert port.out_proj.weight is port.word_embed.weight
    assert len(port.collect_params()) == len(ref.collect_params()) == 26


def test_forward_prefill_decode_match_jax(models):
    """``forward`` logits; ``hybrid_prefill``'s logits and pool; two
    ``hybrid_decode`` steps' logits and pool (three live rows and an empty
    one pointing at scratch), each within 1e-5 of the JAX package's, both
    through ``cached_graph(entry=...)``."""
    ref, port = models
    rng = np.random.default_rng(1)
    toks = rng.integers(1, 250, (2, 11)).astype(np.int32)
    want = ref(mx.nd.array(toks, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = port(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)

    bs, nb, bucket = 4, 16, 8
    jpool = ref.init_kv_pool(nb, bs)
    pool = port.init_kv_pool(nb, bs)
    assert isinstance(pool, torch.Tensor) and pool.dtype == torch.float32
    assert tuple(pool.shape) == jpool.shape == (4, nb, bs, 64)
    zeros = (np.zeros((1, bucket), np.int32), np.zeros((1,), np.int32),
             np.zeros((1, 2), np.int32))
    jpre = ref.cached_graph(*zeros, jpool, entry="prefill")
    pre = port.cached_graph(*zeros, pool, entry="prefill")
    prompts = [(5, [3, 7]), (7, [9, 2]), (3, [5, 0])]
    for n, table in prompts:
        t = np.zeros((1, bucket), np.int32)
        t[0, :n] = rng.integers(1, 250, n)
        args = (t, np.array([n], np.int32), np.array([table], np.int32))
        jl, jpool = jpre.raw(*args, jpool)
        pl, out = pre.raw(*args, pool)
        assert out is pool
        np.testing.assert_allclose(_np(pl), _np(jl), rtol=0, atol=TOL)
        np.testing.assert_allclose(_np(pool), _np(jpool), rtol=0, atol=TOL)

    tables = np.array([[3, 7, 11, 0], [9, 2, 12, 0], [5, 13, 0, 0],
                       [0, 0, 0, 0]], np.int32)
    positions = np.array([5, 7, 3, 0], np.int32)
    tokens = np.array([17, 42, 99, 0], np.int32)
    jdec = ref.cached_graph(np.zeros(4, np.int32), np.zeros(4, np.int32),
                            np.zeros((4, 4), np.int32), jpool,
                            entry="decode")
    dec = port.cached_graph(np.zeros(4, np.int32), np.zeros(4, np.int32),
                            np.zeros((4, 4), np.int32), pool,
                            entry="decode")
    for _ in range(2):
        jl, jpool = jdec.raw(tokens, positions, tables, jpool)
        pl, out = dec.raw(tokens, positions, tables, pool)
        assert out is pool
        np.testing.assert_allclose(_np(pl), _np(jl), rtol=0, atol=TOL)
        # scratch block 0 takes duplicate writes with no defined winner
        np.testing.assert_allclose(_np(pool)[:, 1:], _np(jpool)[:, 1:],
                                   rtol=0, atol=TOL)
        assert np.isfinite(_np(pool)[:, 0]).all()
        tokens = _np(pl).argmax(-1).astype(np.int32)
        tokens[3] = 0
        positions = positions + np.array([1, 1, 1, 0], np.int32)


def test_cached_graph_entries_key_apart_and_refuse_unknown(lm):
    """A generation entry is held apart from the forward's signatures: by
    its handle alone, never by the block's LRU (its graph holds the
    caller's pool), and it runs ``hybrid_<entry>``; a block without the
    method raises ``AttributeError``, as the JAX package's does."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import bert_small
    pool = lm.init_kv_pool(4, 4)
    before = lm._cached_graph.cache_info()["currsize"]
    pre = lm.cached_graph(np.zeros((1, 4), np.int32),
                          np.zeros((1,), np.int32),
                          np.zeros((1, 1), np.int32), pool, entry="prefill")
    assert lm._cached_graph.cache_info()["currsize"] == before
    logits, out = pre.raw(np.ones((1, 4), np.int32), np.array([2], np.int32),
                          np.array([[1]], np.int32), pool)
    assert out is pool and tuple(logits.shape) == (1, 257)
    assert pre.stats()["cpu_calls"] == 1
    lm.cached_graph(np.zeros((1, 4), np.int32))
    assert lm._cached_graph.cache_info()["currsize"] == before + 1
    with pytest.raises(AttributeError, match="hybrid_decode"):
        bert_small().cached_graph(np.zeros((1, 4), np.int32),
                                  entry="decode")


def test_decode_rows_are_padded_to_a_fixed_count():
    assert [decode_rows(n) for n in (1, 3, 4, 16, 17, 32, 33)] == \
        [16, 16, 16, 16, 32, 32, 48]


# -- generation through the servers -----------------------------------------

def _prompts(n, seed=3, lo=2, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, (int(rng.integers(lo, hi)),))
            .astype(np.int32) for _ in range(n)]


def _server(lm, cls=GenerationServer, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("kv_block", 16)
    kw.setdefault("kv_blocks", 64)
    kw.setdefault("max_new_tokens", 8)
    kw.setdefault("prompt_buckets", (16,))
    kw.setdefault("queue_depth", 64)
    kw.setdefault("deadline_ms", 0)
    return cls(lm, **kw)


def _generate(srv, prompts, caps):
    try:
        srv.start()
        srv.warmup()
        reqs = [srv.submit_generate(p, max_new_tokens=c)
                for p, c in zip(prompts, caps)]
        return [list(r.result(timeout=120)) for r in reqs]
    finally:
        srv.stop()


def _forced_logits(forward, prompt, tokens):
    """Logits of every generation step, teacher forced: one full causal
    forward over the prompt and the generated tokens but the last; row t
    scores the token generated at step t."""
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    return forward(seq[None].astype(np.int32))[0, len(prompt) - 1:]


def _shortfall(logits, chosen):
    """How far each chosen token's logit falls below the step's best."""
    return float(max(row.max() - row[t] for row, t in zip(logits, chosen)))


def test_greedy_generation_teacher_forced_against_jax(models):
    """The port's ``GenerationServer`` and the JAX package's over the same
    weights and prompts: every token either chose is within 1e-5 of the
    best logit of the other package's model at that step, teacher forced
    along that server's own tokens (the choices are the same)."""
    ref, port = models
    prompts = _prompts(5, seed=21, lo=3, hi=15)
    caps = [6, 3, 8, 5, 7]
    theirs = _generate(_server(ref, JaxGenerationServer, slots=2),
                       prompts, caps)
    ours = _generate(_server(port, slots=2), prompts, caps)

    def jax_forward(x):
        return ref(mx.nd.array(x, dtype="int32")).asnumpy()

    def port_forward(x):
        with torch.no_grad():
            return port(torch.as_tensor(x)).numpy()

    for p, j, o in zip(prompts, theirs, ours):
        assert _shortfall(_forced_logits(port_forward, p, j), j) <= TOL
        assert _shortfall(_forced_logits(jax_forward, p, o), o) <= TOL
    assert ours == theirs


def test_generate_batched_bitwise_equals_alone(lm):
    """Greedy tokens of each request are the same whether it decoded alone
    (slots=1) or batched with others joining and leaving mid-stream
    (staggered caps force slot turnover)."""
    prompts = _prompts(6)
    caps = [3, 8, 5, 8, 2, 6]
    batched = _generate(_server(lm, slots=3), prompts, caps)
    alone = _generate(_server(lm, slots=1), prompts, caps)
    assert batched == alone
    assert [len(t) for t in batched] == caps


def test_generate_past_one_decode_graph_bitwise_equals_alone(lm,
                                                             monkeypatch):
    """At 17 slots a decode step replays the one 16-row decode graph
    twice (rows 0-15, then row 16 with 15 padded rows): each request's
    greedy tokens are still the ones it gets alone."""
    monkeypatch.setenv("MXTPU_SERVING_PREFILL_MODE", "step")
    prompts = _prompts(20, seed=9)
    caps = [int(c) for c in np.random.default_rng(9).integers(2, 9, 20)]
    srv = _server(lm, slots=17)
    reqs = [srv.submit_generate(p, max_new_tokens=c)   # all queued, so
            for p, c in zip(prompts, caps)]            # 17 run at once
    steps = srv.stats()["decode_steps"]       # a process-wide counter
    try:
        srv.warmup()
        srv.start()
        batched = [list(r.result(timeout=120)) for r in reqs]
        steps = srv.stats()["decode_steps"] - steps
        st = srv.graph_stats()["decode"]
        assert list(st) == [DECODE_ROWS]
        assert st[DECODE_ROWS]["cpu_calls"] > steps
    finally:
        srv.stop()
    assert srv.stats()["kv_blocks_used"] == 0
    assert batched == _generate(_server(lm, slots=1), prompts, caps)
    assert [len(t) for t in batched] == caps


def test_stop_drops_the_graphs_and_unload_frees_the_pool(lm):
    """A generation server's graphs are its own: the block's LRU never
    holds them, ``stop()`` (here through ``ModelRegistry.unload``) drops
    them, and once the caller lets go of the server nothing holds its
    pool."""
    import gc
    import weakref
    from mxnet_tpu_torch.serving import ModelRegistry
    before = lm._cached_graph.cache_info()["currsize"]
    reg = ModelRegistry()
    srv = _server(lm)
    reg.load("lm", srv, warm=True)
    assert srv.stats()["executables"] == 2
    assert len(srv.generate(np.asarray([4, 2], np.int32), timeout=60)) == 8
    assert lm._cached_graph.cache_info()["currsize"] == before
    pool = weakref.ref(srv.pool)
    reg.unload("lm")
    assert srv.stats()["executables"] == 0
    assert srv.graph_stats() == {"prefill": {}, "decode": {}}
    del srv
    gc.collect()
    assert pool() is None


def test_decode_logits_are_bitwise_at_every_slot_count(lm):
    """The contract below the tokens: a row's decode logits are bit for
    bit the same with 1 and with 5 rows live at the server's row count
    (the other rows hold other requests' state)."""
    pool = lm.init_kv_pool(32, 4)
    dec = lm.cached_graph(np.zeros(16, np.int32), np.zeros(16, np.int32),
                          np.zeros((16, 3), np.int32), pool, entry="decode")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        pool.copy_(torch.randn(pool.shape, generator=torch.Generator()
                               .manual_seed(5)))
    outs = []
    for live in (1, 5):
        tokens = np.zeros(16, np.int32)
        positions = np.zeros(16, np.int32)
        tables = np.zeros((16, 3), np.int32)
        tokens[0], positions[0], tables[0] = 7, 6, [4, 9, 0]
        for i in range(1, live):
            tokens[i] = rng.integers(1, 250)
            positions[i] = rng.integers(0, 12)
            tables[i] = [10 + 3 * i, 11 + 3 * i, 12 + 3 * i]
        logits, _ = dec.raw(tokens, positions, tables, pool)
        outs.append(_np(logits)[0].copy())
    assert outs[0].tobytes() == outs[1].tobytes()


def test_iteration_level_turnover_batches_decodes(lm):
    """With 2 slots and 6 requests of 8 tokens the decode steps fall well
    below the serial 42 and no request is shorter than asked."""
    reg = registry()
    steps0 = reg.snapshot().get("serving.decode_steps", 0)
    srv = _server(lm, slots=2, max_new_tokens=8)
    outs = _generate(srv, _prompts(6, seed=5), [8] * 6)
    assert all(len(o) == 8 for o in outs)
    steps = reg.snapshot()["serving.decode_steps"] - steps0
    assert steps < 35, steps
    st = srv.stats()
    assert st["kv_blocks_used"] == 0
    assert st["tokens_generated"] >= 48


def test_drain_paths_release_kv_blocks(lm):
    """Occupancy returns to zero through every exit: normal finish,
    deadline expiry of queued work, and the 429 at admission."""
    srv = _server(lm, queue_depth=2)
    try:
        srv.submit_generate(np.asarray([1, 2, 3], np.int32))
        srv.submit_generate(np.asarray([4, 5], np.int32), deadline_ms=5)
        with pytest.raises(ServerOverloaded):
            srv.submit_generate(np.asarray([6], np.int32))
        time.sleep(0.05)        # the deadline_ms=5 request expires queued
        srv.start()
        srv.warmup()
        time.sleep(0.3)
    finally:
        srv.stop()
    st = srv.stats()
    assert st["kv_blocks_used"] == 0
    assert st["rejected_429"] >= 1
    assert registry().snapshot()["serving.kv_blocks_used"] == 0


def test_deadline_expired_queued_generation_raises(lm):
    srv = _server(lm)
    try:
        req = srv.submit_generate(np.asarray([1, 2, 3], np.int32),
                                  deadline_ms=5)
        time.sleep(0.05)
        srv.start()
        with pytest.raises(DeadlineExceeded):
            req.result(timeout=30)
    finally:
        srv.stop()
    assert srv.stats()["kv_blocks_used"] == 0


def test_admission_gates_on_block_availability(lm):
    """A request whose worst case can never fit the pool is rejected at
    submit; one that cannot fit now queues until blocks free up."""
    srv = _server(lm, kv_blocks=3, max_new_tokens=32)   # capacity 2
    try:
        with pytest.raises(NoBucketError):
            srv.submit_generate(np.arange(1, 15, dtype=np.int32),
                                max_new_tokens=32)
        srv.start()
        srv.warmup()
        r1 = srv.submit_generate(np.arange(1, 15, dtype=np.int32),
                                 max_new_tokens=16)
        r2 = srv.submit_generate(np.arange(1, 15, dtype=np.int32),
                                 max_new_tokens=16)
        assert len(r1.result(timeout=60)) == 16
        assert len(r2.result(timeout=60)) == 16
    finally:
        srv.stop()
    assert srv.stats()["kv_blocks_used"] == 0


def test_submit_validation(lm):
    srv = _server(lm)
    try:
        with pytest.raises(NoBucketError):
            srv.submit_generate(np.arange(30, dtype=np.int32))  # > bucket
        with pytest.raises(MXNetError):
            srv.submit_generate(np.asarray([1], np.int32),
                                max_new_tokens=10 ** 6)  # > the cap
        with pytest.raises(MXNetError):
            srv.submit_generate(np.asarray([], np.int32))
        with pytest.raises(MXNetError, match="hybrid_prefill"):
            GenerationServer(torch.nn.Linear(2, 2))
    finally:
        srv.stop(drain=False)


def test_set_decode_slots_retargets_between_iterations(lm):
    srv = _server(lm, slots=2)
    try:
        srv.start()
        srv.warmup()
        srv.set_decode_slots(4)
        outs = [srv.submit_generate(p) for p in _prompts(4, seed=9)]
        for r in outs:
            assert len(r.result(timeout=60)) == 8
        assert srv.decode_slots == 4
        assert srv.stats()["slots"] == 4
        assert srv.stats()["executables"] == 2    # one decode graph
    finally:
        srv.stop()
    assert srv.stats()["kv_blocks_used"] == 0


def test_stop_without_drain_sheds_and_releases(lm):
    srv = _server(lm)
    try:
        srv.start()
        srv.warmup()
        reqs = [srv.submit_generate(p, max_new_tokens=8)
                for p in _prompts(8, seed=11)]
    finally:
        srv.stop(drain=False)
    for r in reqs:
        assert r.done()
    assert srv.stats()["kv_blocks_used"] == 0


def test_generation_metrics_emitted(lm):
    reg = registry()
    base = reg.snapshot()
    t0 = base.get("serving.ttft_us", {}).get("count", 0)
    d0 = base.get("serving.decode_step_us", {}).get("count", 0)
    g0 = base.get("serving.tokens_generated", 0)
    srv = _server(lm)
    try:
        srv.start()
        srv.warmup()
        srv.generate(np.asarray([5, 6, 7], np.int32), timeout=60)
    finally:
        srv.stop()
    snap = reg.snapshot()
    assert snap["serving.ttft_us"]["count"] == t0 + 1
    assert snap["serving.decode_step_us"]["count"] - d0 >= 7
    assert snap["serving.tokens_generated"] - g0 == 8
    assert snap["serving.kv_blocks_used"] == 0


def test_eos_stops_a_generation_and_failed_steps_release(lm):
    """A generation stops at its EOS token (included); a decode step that
    raises fails the requests in it and releases their blocks, and the
    server serves on."""
    srv = _server(lm)
    try:
        srv.start()
        srv.warmup()
        free = srv.generate(np.asarray([5, 6, 7], np.int32), timeout=60)
        eos = free[2]
        got = srv.generate(np.asarray([5, 6, 7], np.int32), timeout=60,
                           eos=eos)
        assert got == free[:free.index(eos) + 1]
        graph = srv._decode

        class Boom:
            def raw(self, *args):
                raise RuntimeError("injected")

        srv._decode = Boom()
        req = srv.submit_generate(np.asarray([1, 2], np.int32))
        with pytest.raises(RuntimeError, match="injected"):
            req.result(timeout=60)
        assert srv.stats()["kv_blocks_used"] == 0
        srv._decode = graph
        assert len(srv.generate(np.asarray([1, 2], np.int32),
                                timeout=60)) == 8
    finally:
        srv.stop()
    assert srv.stats()["kv_blocks_used"] == 0
