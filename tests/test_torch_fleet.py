"""The fleet view across processes: ``snapshot(all_hosts=True)`` over
``parallel.dist.allgather_bytes``, the ``FleetGatherController`` over the
store's ``kv_publish``/``kv_collect``, and the aggregate endpoint, held
against the JAX package's merge of the same per-host states.  Two ranks
on the CPU over gloo, started by the port's launcher."""
import importlib
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

from tests._torch_launch import run_ranks

WORKER = """
import importlib
R = importlib.import_module("mxnet_tpu_torch.observability.registry")
from mxnet_tpu_torch.observability.export import prometheus_text_aggregate
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.tuning.controllers import FleetGatherController


def fill(reg, rank):
    reg.counter("serving.requests", "requests served").inc(10 + rank)
    reg.gauge("loader.prefetch_depth", "depth").set(2.5 * (rank + 1))
    h = reg.histogram("serving.request_us")
    for v in INPUTS["obs"][rank]:
        h.observe(float(v))


dist.init_process_group()
rank = dist.rank()
res = {}
reg = R.MetricsRegistry()
fill(reg, rank)
res["state"] = reg.export_state()
res["snapshot"] = reg.snapshot(all_hosts=True)
res["gathered"] = R.gather_host_states(reg)
# the timer-thread gather over the store, on the process registry
fill(R.registry(), rank)
ctl = FleetGatherController(enabled=True)
ctl.tick()
dist.barrier()
res["decision"] = ctl.tick()
dist.barrier()
res["hosts_gauge"] = R.registry().gauge("tuning.fleet_gather.hosts").value
res["last"] = [h for h, _ in R.last_host_states()]
res["text"] = prometheus_text_aggregate()
# publish/collect/purge under a prefix of its own
dist.kv_publish("test/pub", b"a%d" % rank)
dist.kv_publish("test/pub", b"b%d" % rank)
dist.barrier()
res["collect"] = dist.kv_collect("test/pub")
dist.barrier()
if rank == 0:
    res["purged"] = dist.kv_purge_rank("test/pub", 1)
dist.barrier()
res["after_purge"] = dist.kv_collect("test/pub")
dist.barrier()
dist.kv_publish("test/pub", b"c%d" % rank)
dist.barrier()
res["after_republish"] = dist.kv_collect("test/pub")
# the row-sparse exchange: slabs of different lengths from each rank
ids, rows = INPUTS["slabs"][rank]
res["pairs"] = dist.allgather_rows(ids, rows)
res["dedup"] = dist.dedup_sum_rows(res["pairs"])
dist.barrier()
save(res)
"""


def _fill(reg, rank, obs):
    reg.counter("serving.requests", "requests served").inc(10 + rank)
    reg.gauge("loader.prefetch_depth", "depth").set(2.5 * (rank + 1))
    h = reg.histogram("serving.request_us")
    for v in obs[rank]:
        h.observe(float(v))


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    rng = np.random.default_rng(2)
    obs = [rng.lognormal(6, 1, 40 + 9 * r) for r in range(2)]
    slabs = [(np.array([5, 1, 7][:3 - r], np.int64),
              rng.standard_normal((3 - r, 4)).astype(np.float32))
             for r in range(2)]
    results = run_ranks(2, WORKER, tmp_path_factory.mktemp("fleet"),
                        {"obs": obs, "slabs": slabs})
    return obs, results, slabs


def test_fleet_snapshot_equals_the_jax_merge(fleet):
    """Every rank's ``snapshot(all_hosts=True)`` is the JAX package's
    merge of the JAX registries filled the same way."""
    J = importlib.import_module("mxnet_tpu.observability.registry")
    obs, results, _ = fleet
    states = []
    for r in range(2):
        reg = J.MetricsRegistry()
        _fill(reg, r, obs)
        states.append((r, reg.export_state()))
        assert json.loads(json.dumps(results[r]["state"])) == \
            json.loads(json.dumps(states[-1][1]))
    want = J.merge_host_states(states)
    for res in results:
        assert [h for h, _ in res["gathered"]] == [0, 1]
        assert json.loads(json.dumps(res["snapshot"])) == \
            json.loads(json.dumps(want))
    assert want["serving.requests"]["total"] == 21


def test_fleet_gather_controller_streams_both_hosts(fleet):
    _, results, _ = fleet
    for res in results:
        assert res["decision"] is None or res["decision"]["hosts"] == "0,1"
        assert res["hosts_gauge"] == 2
        assert res["last"] == [0, 1]


def test_aggregate_endpoint_labels_every_host(fleet):
    _, results, _ = fleet
    for res in results:
        text = res["text"]
        assert 'mxtpu_serving_requests{host="0"} 10' in text
        assert 'mxtpu_serving_requests{host="1"} 11' in text


def test_kv_publish_collect_and_purge(fleet):
    _, results, _ = fleet
    for res in results:
        assert res["collect"] == {0: b"b0", 1: b"b1"}
        assert res["after_purge"] == {0: b"b0"}
        assert res["after_republish"] == {0: b"c0", 1: b"c1"}
    assert results[0]["purged"] >= 2


def test_row_exchange_matches_the_jax_dedup(fleet):
    """``allgather_rows`` hands every rank each rank's (ids, rows) slab
    (of its own length); ``dedup_sum_rows`` sums them as the JAX
    package's does."""
    from mxnet_tpu.parallel import dist as jdist
    _, results, slabs = fleet
    want = jdist.dedup_sum_rows(slabs)
    for res in results:
        for (i, r), (wi, wr) in zip(res["pairs"], slabs):
            np.testing.assert_array_equal(i, wi)
            np.testing.assert_array_equal(r, wr)
        np.testing.assert_array_equal(res["dedup"][0], want[0])
        np.testing.assert_array_equal(res["dedup"][1], want[1])


def test_gather_without_a_group_is_this_host():
    R = importlib.import_module("mxnet_tpu_torch.observability.registry")
    from mxnet_tpu_torch.parallel import dist
    assert not dist.is_initialized()
    reg = R.MetricsRegistry()
    reg.counter("serving.requests").inc(3)
    assert R.gather_host_states(reg) == [(0, reg.export_state())]
    assert dist.allgather_bytes(b"x") == [b"x"]
    assert dist.num_workers() == 1 and dist.rank() == 0
    dist.barrier()
    np.testing.assert_array_equal(dist.allreduce_host(np.ones(3)),
                                  np.ones(3))
    assert mt.tuning.FleetGatherController().tick() is None
    assert mx.tuning.FleetGatherController().tick() is None
