"""``chip_smoke.py`` phase 24 rehearsed on the CPU at toy sizes: the int8
path (a small bottleneck ResNet at 32 x 32, entropy calibration,
``quantize_net``, ``ModelServer``, the accumulators against the CPU's and
the logits of a CPU run given the "card's" roundings), the sliding-window
check and a 2-layer Longformer trained through ``Estimator``.  Only what
the card alone can show reads false here (the momentum kernel's launches:
its wrappers run their plain versions on CPU tensors).  Also the
``RoundDecisions`` mode the phase hands the card's int8 roundings over
with, and ``quantize_like``.  Also how a failing phase names its false
checks, and the quiet tick on which phase 23's SLO controller is due to
step its shed down.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch import cpu, gluon, load_reference_params
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet


def _small_resnet():
    return resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                           [8, 16, 32, 64, 128], classes=1000)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, iters: (
        fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "q_model", _small_resnet)
    for name, value in (
            ("Q_BATCH", 4), ("Q_SIZE", 32), ("Q_CALIB", (2, 2)),
            ("Q_BUCKETS", (2, 4)), ("LF_SERVE_BATCH", 2),
            ("LF", {"vocab": 50, "layers": 2, "units": 64, "ffn": 128,
                    "heads": 4, "w": 4, "length": 32})):
        monkeypatch.setattr(chip_smoke, name, value)


def test_slice24_phase_rehearses_on_the_cpu(small):
    out = chip_smoke.slice24_phase(0, "cpu")
    q = out["int8_resnet"]
    assert q["ok"], q["checks"]
    assert q["layers"] == {"QuantizedConv2D": 17, "QuantizedDense": 1}
    assert q["accumulators"]["bitwise"] == q["accumulators"]["layers"] == 18
    assert q["cpu_int8"]["flips"] == 0 and q["cpu_int8"]["rel_err"] == 0.0
    assert q["cpu_int8"]["rounded"] > 0
    assert q["served"]["bitwise_eager"]
    sw = out["sldwin"]
    assert sw["ok"] and sw["kept_bytes"] < sw["band_bytes"] <= \
        sw["plain_kept_bytes"]
    lf = out["longformer"]
    assert sorted(k for k, v in lf["checks"].items() if not v) == [
        "launches"]
    assert lf["launches"] == 0 and lf["expected_launches"] == \
        3 * -(-lf["trainable_params"] // chip_smoke.AGG)
    assert lf["steps"] == 3 and len(lf["step_ms"]) == 3
    assert lf["served"]["bitwise_eager"]
    assert out["other_launches"] == 0 and not out["ok"]


def test_round_decisions_record_then_force_the_roundings():
    x = torch.tensor([0.5, 1.5, 2.4, -0.5, 3.5])
    with chip_smoke.RoundDecisions() as card:
        a = torch.round(x)
        b = x.round()
    assert card.units == 10 and len(card.masks) == 2
    masks = [m.clone() for m in card.masks]
    masks[0][2] = 3.0                      # the "card" rounded 2.4 up
    with chip_smoke.RoundDecisions(masks) as forced:
        c = torch.round(x)
        d = x.round()
    assert forced.flips == 1
    assert torch.equal(c, masks[0]) and torch.equal(d, b)
    assert torch.equal(a, torch.tensor([0.0, 2.0, 2.0, -0.0, 4.0]))


def test_quantize_like_gives_the_twin_its_ranges():
    net = _small_resnet()
    net.initialize(ctx=cpu(), seed=0)
    weights = {k: p._tensor().detach().numpy().copy()
               for k, p in net.collect_params().items()}
    calib = [torch.randn(2, 3, 32, 32, generator=torch.Generator()
                         .manual_seed(i)) for i in range(2)]
    quantize_net(net, calib_data=calib, calib_mode="minmax")
    twin = _small_resnet()
    load_reference_params(twin, weights, ctx=cpu())
    chip_smoke.quantize_like(twin, net)
    ours = [m for m in twin.modules() if hasattr(m, "_calib")]
    theirs = [m for m in net.modules() if hasattr(m, "_calib")]
    assert len(ours) == len(theirs) == 18
    assert [m._calib for m in ours] == [m._calib for m in theirs]
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(chip_smoke._predict(twin, x).numpy(),
                                  chip_smoke._predict(net, x).numpy())
    assert isinstance(twin, gluon.HybridBlock)


def test_failed_checks_names_every_false_check():
    """A failing phase's report names each false entry of each nested
    ``checks`` dict by its dotted path; true ones and other keys stay
    out."""
    report = {"ok": False, "checks": {"a": True, "b": False},
              "front_door": {"checks": {"slo": False, "trees": True},
                             "slo": {"checks": {"quiet_unsheds": False,
                                                "workers_back": True}}},
              "rows": [{"checks": {"bitwise": 0}}, {"ok": False}]}
    assert chip_smoke.failed_checks(report) == [
        "checks.b", "front_door.checks.slo",
        "front_door.slo.checks.quiet_unsheds", "rows[0].checks.bitwise"]
    assert chip_smoke.failed_checks({"checks": {"a": True}}) == []


@pytest.mark.parametrize("p99_ms, due", [
    ([10.0, 11.0], 1), ([19.9, 11.0, 12.0], 2), ([11.0, 16.0, 12.0], None),
    ([11.0, 16.0, 12.0, 13.0, 9.0], 3), ([], None), ([15.0, 14.9, 1.0], 2)])
def test_unshed_due_is_the_second_of_two_quiet_intervals(p99_ms, due):
    """The SLO controller steps down on the second consecutive interval
    whose served p99 is under the threshold (15 ms, 0.6 x 25 ms), and not
    on a tie."""
    assert chip_smoke.unshed_due(p99_ms, 15.0) == due
