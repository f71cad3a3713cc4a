"""The card-vs-CPU training check of ``chip_smoke.py``, rehearsed on the
CPU: a small ResNet's fp32 step held leaf by leaf against its float64
step by ``chip_smoke.leaf_check``.  The fp32 step passes as the "card"; a
fault of 1 % in one leaf's gradient, the size of a card-only fault the
check must see, fails that leaf and no other.  And ``device_ms``, which
must not report a trace without device time as 0 ms."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch import cpu, gluon, load_reference_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
from mxnet_tpu_torch.initializer import Xavier


def _net():
    return resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                           [8, 16, 32, 64, 128], classes=10)


@pytest.fixture(scope="module")
def steps():
    """Initial weights, data, and the fp32 and float64 steps of a small
    ResNet at batch 2 (the check's batch)."""
    net = _net()
    net.initialize(Xavier("gaussian", "in", 2), ctx=cpu(), seed=0)
    init = chip_smoke._snapshot(net)
    arrays = {k: v.numpy() for k, v in init.items()}
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 3, 32, 32),
                                            dtype=np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 2).astype(np.float32))

    def run(dtype, fault=None):
        model = _net()
        load_reference_params(model, arrays, ctx=cpu())
        model = model.to(dtype)
        if fault is not None:          # an index: prefixes differ by net
            params = list(model.collect_params().values())
            params[fault].data().register_hook(lambda g: g * 1.01)
        return chip_smoke.one_step(model, x.to(dtype), y,
                                   gluon.loss.SoftmaxCrossEntropyLoss())

    return init, run, run(torch.float32)[1], run(torch.float64)[1]


def test_leaf_check_passes_the_fp32_step(steps):
    init, _, cpu32, cpu64 = steps
    out = chip_smoke.leaf_check(cpu32, cpu32, cpu64, init)
    assert out["ok"] and out["leaves"] == len(init)
    assert out["tight"] == len(init)    # every limit within 1e-2 here


@pytest.mark.parametrize("leaf", [
    "conv2_d0_weight", "stage1_batch_norm0_gamma", "stage3_conv2_d1_weight",
    "dense0_bias"])
def test_leaf_check_flags_a_one_percent_gradient_fault(steps, leaf):
    init, run, cpu32, cpu64 = steps
    index, name = next((i, k) for i, k in enumerate(init)
                       if k.endswith("_" + leaf))
    out = chip_smoke.leaf_check(run(torch.float32, fault=index)[1], cpu32,
                                cpu64, init)
    assert [r["leaf"] for r in out["failed"]] == [name]


class _Event:
    def __init__(self, us):
        self.device_type = torch.autograd.DeviceType.CUDA
        self.self_device_time_total = us


def _fake_profiler(monkeypatch, traces):
    """torch.profiler.profile handing out ``traces`` (lists of device
    microseconds), one per ``with``."""
    class Profile:
        def __init__(self, *args, **kwargs):
            self.events = [_Event(us) for us in traces.pop(0)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)


def test_device_ms_retakes_a_trace_that_lost_its_records(monkeypatch):
    _fake_profiler(monkeypatch, [[], [300.0, 100.0]])
    assert chip_smoke.device_ms(lambda: None, 2) == 0.2


def test_device_ms_never_reports_zero(monkeypatch):
    _fake_profiler(monkeypatch, [[], [0.0], []])
    with pytest.raises(AssertionError, match="no device time"):
        chip_smoke.device_ms(lambda: None, 2)
