"""Rehearsal of ``chip_smoke.py`` phase 25 on the CPU: two ranks of
``chip_smoke.dist25_rank`` over gloo through the port's launcher, at a
small size (a bottleneck ResNet of widths 8..128 at 32 x 32, 4 rows a
rank), then (c) in this process.  On the CPU the momentum kernel's
launches and the CUDA check read false and every other check must pass;
a 1 % fault in one leaf's gradient on rank 1 must fail that leaf's
``leaf_check`` in (a) (both check steps, the local update's and
``update_on_kvstore``'s) and in every ``ShardedTrainer`` variant, and no
other leaf."""
import numpy as np
import pytest
import torch

from tests._torch_launch import run_ranks

FAULT_LEAF = 3          # a trainable leaf (in collect_params order)

WORKER = """
from pathlib import Path
import chip_smoke as cs
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet


def small(classes=1000):
    net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                          [8, 16, 32, 64, 128], classes=classes)
    fault = INPUTS["fault"]
    if fault is not None and RANK == 1:
        # a 1 % fault in one leaf's gradient on this rank alone: the
        # initialize draw below fills the data; the hook scales every
        # gradient the leaf receives
        p = [q for q in net.collect_params().values()
             if q.grad_req != "null"][fault]
        p._data.register_hook(lambda g: g * 1.01)
    return net


def batch(seed, n, dev):
    gen = torch.Generator().manual_seed(seed + 25)
    return (torch.randn(n, 3, 32, 32, generator=gen),
            torch.randint(0, 1000, (n,), generator=gen).float())


cs.resnet50_v1 = small
cs.global_batch = batch
cs.gpu = lambda i=0: mt.cpu()
cs.DIST_BATCH = 4
cs.SHARDED_STEPS = 1
cs.DIST_STEPS = 1
# buckets of the small net's size
cs.SHARDED_VARIANTS["bucket25"] = {"comm_bucket_mb": 0.05}
torch.cuda.synchronize = lambda *a, **k: None
save(cs.dist25_rank(0, Path(WORK)))
"""

#: what cannot hold on the CPU: the kernel's launch counts (its plain
#: version runs) and the CUDA tensors of the invariants
CPU_FALSE = {"launches_exact", "on_cuda"} | {
    f"{v}_launches_exact" for v in ("zero0", "zero1", "zero2", "accum2",
                                    "bucket25")}


def _failed(report):
    return {k for k, ok in report["checks"].items() if not ok}


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    return run_ranks(2, WORKER, tmp_path_factory.mktemp("p25"),
                     {"fault": None}, timeout=110)


def test_phase25_checks_pass_on_the_cpu(clean):
    for rep in clean:
        assert _failed(rep) == CPU_FALSE, _failed(rep)
        d = rep["dist_store"]
        assert d["compression"]["bitwise"] and d["compression"]["nonzero"]
        assert d["update_on_kvstore_vs_local_max_abs"] < 1e-5
        assert 0.45 < rep["zero1_state_ratio"] < 0.6
    leaves = clean[0]["leaf_checks"]
    assert set(leaves) == {"dist_store", "update_on_kvstore", "zero0",
                           "zero1", "zero2", "accum2", "bucket25"}
    assert all(v["ok"] for v in leaves.values())
    # the variants agree with ZeRO 0 at the check step; accumulation
    # normalizes each microbatch alone
    diffs = clean[0]["variant_vs_zero0_max_abs"]
    assert max(diffs[k] for k in ("zero1", "zero2", "bucket25")) < 1e-5
    assert diffs["accum2"] > 1e-4


def test_phase25_leaf_checks_fail_on_a_faulted_rank(tmp_path):
    reps = run_ranks(2, WORKER, tmp_path, {"fault": FAULT_LEAF},
                     timeout=110)
    leaves = reps[0]["leaf_checks"]
    for name, brief in leaves.items():
        assert not brief["ok"], name
        assert len(brief["failed"]) == 1, (name, brief["failed"])
    # the faulted sum is the same on both ranks: replicas stay equal
    assert reps[1]["checks"]["zero0_replicas_bitwise"]


def test_one_process_sharded_rehearses_on_the_cpu(monkeypatch):
    import chip_smoke as cs
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    monkeypatch.setattr(cs, "resnet50_v1", lambda classes=1000:
                        resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                                        [8, 16, 32, 64, 128],
                                        classes=classes))
    monkeypatch.setattr(cs, "global_batch", lambda seed, n, dev: (
        torch.randn(n, 3, 32, 32, generator=torch.Generator()
                    .manual_seed(seed)),
        torch.randint(0, 1000, (n,)).float()))
    monkeypatch.setattr(cs, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(cs, "DIST_BATCH", 4)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    res = cs.one_process_sharded(0, "cpu")
    assert res["dp"] == 1 and res["batch"] == 8
    assert {k for k, ok in res["checks"].items() if not ok} == \
        {"launches_exact"}
    assert np.isfinite(res["losses"]).all()


def test_phase25_launches_two_ranks_of_the_script(monkeypatch, tmp_path):
    """``dist25_phase`` starts the ranks through the port's launcher
    (``tools/launch.py -n 2``) as this script with ``--rank-task``, reads
    each rank's report, and fails with the launch's output when a rank
    fails; ``main`` runs the task and names the report by the rank."""
    import inspect
    import json
    import chip_smoke as cs
    calls = []

    class FakeLaunch:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            self.pid, self.returncode = 0, int(len(calls) > 1)
            if not self.returncode:
                for r in range(2):
                    (tmp_path / f"phase25_rank{r}.json").write_text(
                        json.dumps({"ok": True, "rank": r,
                                    "dist_store": {"launches": 205},
                                    "sharded": {"zero0": {"launches": 15}}}))

        def communicate(self, timeout=None):
            return "a rank failed", None

    monkeypatch.setattr(cs.subprocess, "Popen", FakeLaunch)
    monkeypatch.setattr(cs, "one_process_sharded",
                        lambda seed, card: {"ok": True, "launches": 15})
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    res = cs.dist25_phase(0, "cpu", tmp_path)
    assert res["ok"] and res["dist_launches"] == [205, 205]
    cmd = calls[0]
    assert cmd[1].endswith("mxnet_tpu_torch/tools/launch.py")
    assert cmd[2:4] == ["-n", "2"] and cmd[5].endswith("chip_smoke.py")
    assert cmd[-2:] == [cs.RANK_FLAG, "phase25_rank"]
    with pytest.raises(AssertionError, match="a rank failed"):
        cs.dist25_phase(0, "cpu", tmp_path)
    src = inspect.getsource(cs.main)
    assert "RANK_TASKS[args.rank_task](args.seed, out)" in src
    assert "dist25_phase(args.seed, card, Path(args.out))" in src
