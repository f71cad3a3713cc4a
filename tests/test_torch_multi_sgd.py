"""The launch plan of the multi-tensor SGD kernels
(``kernels/multi_sgd.py``, ``_launch_plans``) on the CPU, at the shapes of
the main paths: ResNet-50 v1's 161 trainable tensors in the Trainer's
groups of 4 (and as one group), the MNIST MLP's 6, and the odd sizes of
``chip_smoke.py``.  ``_walk`` is the kernel's walk (``csrc/multi_sgd.cu``:
block b takes tiles b, b + grid, ...; a tile's tensor is the last one
whose first tile is at or before it) over the plan's own prefix sums,
which the wrapper hands to the kernel as they are, so the tests show that
the launches cover every element exactly once.  Also: the SM count is read
once per device, and the wrapper hands the whole plan to the C entry
point."""
from __future__ import annotations

import bisect
import ctypes
import importlib
import math
import types

import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.base import MXNetError

ms = importlib.import_module("mxnet_tpu_torch.kernels.multi_sgd")

H100_SMS = 132
ODD_SHAPES = [(1,), (3,), (7, 5), (1023,), (4097,), (8191,), (8193,),
              (3, 33333)]


@pytest.fixture(scope="module")
def resnet_sizes():
    return [math.prod(s) for s in chip_smoke.resnet50_trainable_shapes()]


def _sizes(name, resnet_sizes):
    """Groups (tuples of element counts) as the Trainer hands them over."""
    mlp = [math.prod(s) for s in chip_smoke.MLP_SHAPES]
    odd = [math.prod(s) for s in ODD_SHAPES]
    sets = {"resnet50 groups of 4": (resnet_sizes, chip_smoke.AGG),
            "resnet50 one group": (resnet_sizes, len(resnet_sizes)),
            "mlp groups of 4": (mlp, chip_smoke.AGG),
            "odd x72 groups of 4": (odd * 9, chip_smoke.AGG),
            "odd x72 one group": (odd * 9, 72)}
    sizes, agg = sets[name]
    return [tuple(sizes[i:i + agg]) for i in range(0, len(sizes), agg)]


def _walk(plan, sizes):
    """How often the launch ``plan`` touches each element of the tensors
    ``sizes[plan.lo:plan.hi]``, walking its tiles as the kernel does;
    fails if a tile reaches past its tensor's end."""
    part = sizes[plan.lo:plan.hi]
    cover = [np.zeros(n, np.int8) for n in part]
    for b in range(plan.grid):
        for tile in range(b, plan.starts[-1], plan.grid):
            t = bisect.bisect_right(plan.starts, tile) - 1
            begin = (tile - plan.starts[t]) * plan.tile
            end = min(begin + plan.tile, part[t])
            assert begin < end, (tile, t, begin, part[t])
            cover[t][begin:end] += 1
    return cover


SETS = ["resnet50 groups of 4", "resnet50 one group", "mlp groups of 4",
        "odd x72 groups of 4", "odd x72 one group"]


@pytest.mark.parametrize("num_sms", [H100_SMS, 114, 1])
@pytest.mark.parametrize("name", SETS)
def test_plan_covers_every_element_once(resnet_sizes, name, num_sms):
    """Every element of every tensor exactly once; no tile spans two
    tensors; the tile a power of two in [512, 8192]; at most
    ``BLOCKS_PER_SM`` blocks per SM and no block without a tile."""
    for group in _sizes(name, resnet_sizes):
        plans = ms._launch_plans(group, num_sms)
        covered = set()
        for plan in plans:
            assert plan.tile in (512, 1024, 2048, 4096, 8192)
            assert 1 <= plan.grid <= min(plan.starts[-1],
                                         ms.BLOCKS_PER_SM * num_sms)
            assert plan.hi - plan.lo <= ms.MAX_TENSORS
            for t, n in enumerate(group[plan.lo:plan.hi]):
                assert (plan.starts[t + 1] - plan.starts[t]
                        == -(-n // plan.tile))
            for cover in _walk(plan, group):
                assert (cover == 1).all()
            covered.update(range(plan.lo, plan.hi))
        assert covered >= {i for i, n in enumerate(group) if n}


@pytest.mark.parametrize("name", SETS)
def test_plan_spreads_every_large_enough_group_over_all_sms(resnet_sizes,
                                                            name):
    """A group of at least 132 x 512 elements gets at least 132 tiles and
    at least 132 blocks; the tile is the largest that gives 2 x 132 tiles,
    else 512."""
    for group in _sizes(name, resnet_sizes):
        for plan in ms._launch_plans(group, H100_SMS):
            part = group[plan.lo:plan.hi]
            tiles = plan.starts[-1]
            if sum(part) >= H100_SMS * ms.MIN_TILE:
                assert tiles >= H100_SMS and plan.grid >= H100_SMS
            assert tiles >= 2 * H100_SMS or plan.tile == ms.MIN_TILE
            if plan.tile < ms.MAX_TILE:
                bigger = sum(-(-n // (2 * plan.tile)) for n in part)
                assert bigger < 2 * H100_SMS


def test_resnet50_groups_spread_where_they_can(resnet_sizes):
    """Of ResNet-50's 41 groups of 4, one 8192-element block per chunk
    would run 36 on fewer than 132 blocks; the plan puts every group of
    at least 67,584 elements (28 of 41) on all 132 SMs."""
    groups = _sizes("resnet50 groups of 4", resnet_sizes)
    old_blocks = [sum(-(-n // 8192) for n in g) for g in groups]
    assert sum(b < H100_SMS for b in old_blocks) == 36
    grids = [p.grid for g in groups for p in ms._launch_plans(g, H100_SMS)]
    assert sum(g >= H100_SMS for g in grids) == 28
    assert sum(sum(g) < H100_SMS * ms.MIN_TILE for g in groups) == 13


@pytest.mark.parametrize("name,launches", [("resnet50 groups of 4", 41),
                                           ("mlp groups of 4", 2),
                                           ("odd x72 one group", 2)])
def test_planned_launches_per_step(resnet_sizes, name, launches):
    """One launch per group of up to 64 tensors: 41 a ResNet-50 step, 2 an
    MLP step, as before the launch plan."""
    groups = _sizes(name, resnet_sizes)
    assert sum(len(ms._launch_plans(g, H100_SMS)) for g in groups) \
        == launches


def test_plan_tiles_at_the_group_sizes_of_the_main_path():
    (big,) = ms._launch_plans((2359296, 2048, 2048, 1048576), H100_SMS)
    assert (big.tile, big.starts[-1], big.grid) == (8192, 418, 396)
    (mid,) = ms._launch_plans((65536, 256, 256, 65536), H100_SMS)
    assert (mid.tile, mid.starts[-1], mid.grid) == (512, 258, 258)
    (small,) = ms._launch_plans((1000,), H100_SMS)
    assert (small.tile, small.starts[-1], small.grid) == (512, 2, 2)
    (mlp,) = ms._launch_plans((100352, 128, 8192, 64), H100_SMS)
    assert (mlp.tile, mlp.grid) == (512, 214)


def test_plan_skips_empty_slices_and_splits_at_64_tensors():
    sizes = (0,) * 64 + (5,) * 10
    (plan,) = ms._launch_plans(sizes, H100_SMS)
    assert (plan.lo, plan.hi, plan.starts[-1]) == (64, 74, 10)
    assert ms._launch_plans((0, 0), H100_SMS) == ()
    plans = ms._launch_plans((7,) * 65, H100_SMS)
    assert [(p.lo, p.hi) for p in plans] == [(0, 64), (64, 65)]
    (empty_between,) = ms._launch_plans((5000, 0, 7000), H100_SMS)
    assert empty_between.starts == (0, 10, 10, 24)


def test_sm_count_is_read_once_per_device(monkeypatch):
    calls = []

    def props(index):
        calls.append(index)
        return types.SimpleNamespace(multi_processor_count=132 + index)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(ms, "_sms", {})
    for _ in range(3):
        assert ms._num_sms(torch.device("cuda", 0)) == 132
    assert ms._num_sms(torch.device("cuda", 1)) == 133
    assert calls == [0, 1]


def _record_launches(monkeypatch, err=0):
    """Bind a recording stand-in for the C entry point and a stream, so
    that ``_launch`` runs on CPU tensors."""
    seen = []

    def fn(count, w, g, m, w32, n, starts, lr, wd, dtype, mode, mu,
           rescale, clip, tile, grid, stream):
        sizes = list((ctypes.c_longlong * count).from_address(n))
        starts = tuple((ctypes.c_int * (count + 1)).from_address(starts))
        seen.append((count, sizes, starts, dtype, mode, tile, grid, stream))
        return err

    monkeypatch.setattr(ms, "_kernel", lambda: fn)
    monkeypatch.setattr(ms, "_num_sms", lambda dev: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return seen


def _scalars(k, momentum=0.9):
    return ms._scalars(torch.float32, torch.float32, [0.1] * k, [0.0] * k,
                       momentum, 1.0, -1.0)


def test_launch_hands_the_plan_to_the_kernel(monkeypatch):
    seen = _record_launches(monkeypatch)
    shapes = [(3, 33333), (0,), (8193,)] + [(5,)] * 64
    w = [torch.zeros(s) for s in shapes]
    before = ms.multi_sgd_mom.launches
    ms._launch(ms.multi_sgd_mom, ms.SGD_MOM, w, w, w, None, _scalars(67))
    plans = ms._launch_plans(tuple(t.numel() for t in w), H100_SMS)
    assert seen == [(p.hi - p.lo, [t.numel() for t in w[p.lo:p.hi]],
                     p.starts, 0, ms.SGD_MOM, p.tile, p.grid, 7)
                    for p in plans]
    assert ms.multi_sgd_mom.launches - before == len(plans) == 2


def test_launch_raises_on_a_kernel_error_and_counts_nothing(monkeypatch):
    _record_launches(monkeypatch, err=700)
    w = [torch.zeros(10)]
    before = ms.multi_sgd.launches
    with pytest.raises(MXNetError, match="CUDA error 700"):
        ms._launch(ms.multi_sgd, ms.SGD, w, w, None, None, _scalars(1, 0.0))
    assert ms.multi_sgd.launches == before


@pytest.mark.parametrize("name", SETS)
def test_plan_in_a_two_byte_dtype_covers_every_element_once(resnet_sizes,
                                                            name):
    """In bf16/fp16 a 16-byte vector holds 8 elements: tiles of 1024 to
    16384 elements (the fp32 plan's bytes), each a multiple of 8, still
    covering every element exactly once and spreading as the fp32 plan
    does."""
    for group in _sizes(name, resnet_sizes):
        for plan in ms._launch_plans(group, H100_SMS, 8):
            assert plan.tile in (1024, 2048, 4096, 8192, 16384)
            assert 1 <= plan.grid <= ms.BLOCKS_PER_SM * H100_SMS
            assert plan.starts[-1] >= 2 * H100_SMS or plan.tile == 1024
            for cover in _walk(plan, group):
                assert (cover == 1).all()


@pytest.mark.parametrize("dtype,mode,code", [
    (torch.bfloat16, "SGD_MOM", 1), (torch.float16, "SGD", 2),
    (torch.bfloat16, "MP_SGD_MOM", 1), (torch.float16, "MP_SGD", 2)])
def test_launch_hands_a_two_byte_plan_dtype_and_mode(monkeypatch, dtype,
                                                     mode, code):
    """bf16/fp16 weights go with their dtype code, the mode, and the plan
    of 8-element vectors; the mixed modes take fp32 momenta and masters,
    and refuse fp32 weights."""
    seen = _record_launches(monkeypatch)
    shapes = [(3, 33333), (8193,), (5,)]
    w = [torch.zeros(s, dtype=dtype) for s in shapes]
    f = [torch.zeros(s) for s in shapes]
    m = f if mode.startswith("MP") else w
    w32 = f if mode.startswith("MP") else None
    wrapper = {"SGD": ms.multi_sgd, "SGD_MOM": ms.multi_sgd_mom,
               "MP_SGD": ms.multi_mp_sgd,
               "MP_SGD_MOM": ms.multi_mp_sgd_mom}[mode]
    ms._launch(wrapper, getattr(ms, mode), w, w,
               m if mode.endswith("MOM") else None, w32, _scalars(3))
    (plan,) = ms._launch_plans(tuple(t.numel() for t in w), H100_SMS, 8)
    assert seen == [(3, [t.numel() for t in w], plan.starts, code,
                     getattr(ms, mode), plan.tile, plan.grid, 7)]
    if mode.startswith("MP"):
        with pytest.raises(MXNetError, match="dtype"):
            ms._launch(wrapper, getattr(ms, mode), f, f,
                       f if mode.endswith("MOM") else None, f, _scalars(3))
