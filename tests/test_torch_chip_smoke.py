"""The card-vs-CPU training check of ``chip_smoke.py``, rehearsed on the
CPU: a small ResNet's fp32 step held leaf by leaf against its float64
step by ``chip_smoke.leaf_check``.  The fp32 step passes as the "card"; a
fault of 1 % in one leaf's gradient, the size of a card-only fault the
check must see, fails that leaf and no other.  ``device_ms``, which
must not report a trace without device time as 0 ms.  The flash bound at
the tensor cores' peaks on ``kernel_phase``'s own seed-0 draws, and the
SASS census's parser on a ``cuobjdump -sass`` excerpt."""
from __future__ import annotations

import types

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
            params[fault]._tensor().register_hook(lambda g: g * 1.01)
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
    """An entry of ``key_averages()``: a kernel's name, its launches and
    their summed device microseconds."""
    def __init__(self, us, count=2, key="kernel", annotation=False):
        self.device_type = torch.autograd.DeviceType.CUDA
        self.self_device_time_total = us
        self.count = count
        self.key = key
        self.is_user_annotation = annotation    # a record_function span


def _fake_profiler(monkeypatch, traces):
    """torch.profiler.profile handing out ``traces`` (lists of device
    microseconds, or of ``_Event`` arguments), one per ``with``."""
    class Profile:
        def __init__(self, *args, **kwargs):
            self.events = [_Event(*e) if isinstance(e, tuple) else _Event(e)
                           for e in traces.pop(0)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *args: None)


def test_device_ms_retakes_a_trace_that_lost_its_records(monkeypatch):
    _fake_profiler(monkeypatch, [[], [300.0, 100.0]])
    assert chip_smoke.device_ms(lambda: None, 2) == 0.2


def test_device_ms_leaves_out_the_sentinel(monkeypatch):
    """The sentinel that opens each trace is no part of ``fn``'s time."""
    _fake_profiler(monkeypatch, [[(50.0, 1, "at::cuda::(anonymous "
                                   "namespace)::spin_kernel(long)"),
                                  (300.0, 2, "flash_fwd_kernel")]])
    seen = {}
    assert chip_smoke.device_ms(lambda: None, 2, kernels=seen) == 0.15
    assert seen == {"flash_fwd_kernel": 1}


def test_device_ms_never_reports_zero(monkeypatch):
    _fake_profiler(monkeypatch, [[], [0.0], []])
    with pytest.raises(AssertionError, match="no device time"):
        chip_smoke.device_ms(lambda: None, 2)


def test_device_sums_leave_out_record_function_spans(monkeypatch):
    """The device span of a ``record_function`` range (the flash
    backward's) holds its kernels and the gaps between them: summed with
    the kernels it would count them twice.  With ``lost=1`` a trace in
    which a kernel lost one record is kept, that kernel's time scaled up
    to its full count."""
    span = (5000.0, 2, "flash_attention_backward", True)
    _fake_profiler(monkeypatch, [[(300.0, 2, "bmm"), span],
                                 [(300.0, 2, "bmm"), (100.0, 3, "copy"),
                                  span]])
    assert chip_smoke.device_ms(lambda: None, 2) == 0.15
    seen = {}
    got = chip_smoke.device_ms(lambda: None, 2, kernels=seen, lost=1)
    assert got == pytest.approx((300.0 + 100.0 * 4 / 3) / 2 / 1e3)
    assert seen == {"bmm": 1, "copy": 2}


def test_device_ms_retakes_a_trace_that_lost_more_than_allowed(
        monkeypatch):
    """``lost=1`` keeps one lost record per kernel, not two: a kernel
    two records short retakes the trace, and after ``attempts`` such
    traces ``device_ms`` raises."""
    _fake_profiler(monkeypatch, [[(300.0, 18, "bmm")],
                                 [(300.0, 20, "bmm"), (50.0, 19, "copy")]])
    assert chip_smoke.device_ms(lambda: None, 10, lost=1) == \
        pytest.approx((300.0 + 50.0 * 20 / 19) / 10 / 1e3)
    _fake_profiler(monkeypatch, [[(300.0, 18, "bmm")]] * 3)
    with pytest.raises(AssertionError, match="partial"):
        chip_smoke.device_ms(lambda: None, 10, lost=1)


def test_device_ms_with_a_known_count_takes_the_records_that_arrive(
        monkeypatch):
    """``per_call``: a kernel launched a known number of times a call is
    timed from the records that arrived (their mean times the known
    count), while at least half arrived; fewer, more than the count, or a
    second kernel under ``only`` retake the trace and then raise."""
    _fake_profiler(monkeypatch, [[(320.0, 16, "flash_fwd_kernel")]])
    assert chip_smoke.device_ms(lambda: None, 20, only="flash_fwd_kernel",
                                per_call=1) == pytest.approx(0.02)
    for bad in ([(300.0, 9, "flash_fwd_kernel")],
                [(300.0, 21, "flash_fwd_kernel")],
                [(300.0, 20, "flash_fwd_kernel<float"),
                 (300.0, 20, "flash_fwd_kernel<bf16")]):
        _fake_profiler(monkeypatch, [bad] * 3)
        with pytest.raises(AssertionError, match="partial"):
            chip_smoke.device_ms(lambda: None, 20, only="flash_fwd_kernel",
                                 per_call=1)


def test_train_flash_cases_take_the_training_shape():
    """The flash rows at the training phase's shape: B=8, H=12, L=256,
    D=64, fp32 and bf16, with lengths as ``bert_batch`` draws them."""
    assert [c[1:] for c in chip_smoke.TRAIN_FLASH_CASES] == [
        (8, 12, 256, 256, 64, dtype, False, 50)
        for dtype in (torch.float32, torch.bfloat16)]
    vl = chip_smoke.bert_batch(0, 8, 256)[2]
    assert vl.shape == (8,) and 128 <= vl.min() and vl.max() <= 256


def test_bert_step_classes_put_range_kernels_in_their_class():
    """A kernel launched inside the ``flash_attention_backward`` or
    ``trainer_step`` range (through its CPU op's ancestors) leaves its
    name's class for the range's; a range's device span is reported
    apart and summed nowhere."""
    from collections import namedtuple
    Kernel = namedtuple("Kernel", ["name", "device", "duration"])
    cpu_type = torch.autograd.DeviceType.CPU

    class Op:
        def __init__(self, name, parent=None, kernels=()):
            self.name, self.cpu_parent = name, parent
            self.kernels = list(kernels)
            self.device_type = cpu_type

    bwd, step = Op("flash_attention_backward"), Op("trainer_step")
    ops = [bwd, step,
           Op("aten::bmm", bwd, [Kernel("sm80_xmma_gemm_f32", 0, 30.0)]),
           Op("aten::mul", Op("aten::add_", step),
              [Kernel("vectorized_elementwise_kernel", 0, 10.0)]),
           Op("aten::mm", None, [Kernel("sm80_xmma_gemm_f32", 0, 100.0)])]

    class Prof:
        def key_averages(self):
            return [_Event(130.0, 2, "sm80_xmma_gemm_f32"),
                    _Event(10.0, 1, "vectorized_elementwise_kernel"),
                    _Event(5.0, 1, "flash_fwd_kernel<float, 64>"),
                    _Event(500.0, 1, "flash_attention_backward", True)]

        def events(self):
            return ops

    got = chip_smoke.bert_step_classes(Prof(), 1.0, n_params=1)
    ms = got["device_ms"]
    assert ms["gemm"] == pytest.approx(0.1)
    assert ms["flash_backward"] == pytest.approx(0.03)
    assert ms["adam"] == pytest.approx(0.01)
    assert ms["other"] == pytest.approx(0.0)
    assert ms["flash_forward"] == pytest.approx(0.005)
    assert got["device_busy_ms"] == pytest.approx(0.145)
    assert got["range_spans_ms"] == {"flash_backward": 0.5}
    assert got["kernels_in_ranges"] == {"flash_backward": 1, "adam": 1}
    assert got["adam_kernels_per_param"] == 1.0


def test_device_ms_retakes_a_trace_with_partial_records(monkeypatch):
    """A kernel seen 3 times in a trace of 2 calls lost records: the trace
    is taken again; ``only`` keeps the kernels whose name holds it, and
    ``kernels`` gets their launches per call."""
    _fake_profiler(monkeypatch, [
        [(300.0, 3, "flash_fwd_kernel")],
        [(300.0, 2, "flash_fwd_kernel<float, 64>"), (100.0, 4, "copy")]])
    seen = {}
    assert chip_smoke.device_ms(lambda: None, 2, only="flash_fwd_kernel",
                                kernels=seen) == 0.15
    assert seen == {"flash_fwd_kernel<float, 64>": 1}


def test_flash_bound_takes_the_tensor_core_peaks():
    """fp32 at 495 TFLOP/s (TF32), bf16 and fp16 at 989; at kernel_phase's
    seed-0 draws both B=8, L=512 cases are bound by bytes: 0.0109 ms
    (3.29 GFLOP, 36.4 MB) and 0.0048 ms (2.27 GFLOP, 16.2 MB)."""
    assert chip_smoke.TENSOR_FLOPS == {torch.float32: 495e12,
                                       torch.bfloat16: 989e12,
                                       torch.float16: 989e12}
    gen = torch.Generator().manual_seed(0)
    bounds = {}
    for name, b, h, lq, lk, d, dtype, _, _ in chip_smoke.FLASH_CASES:
        vl = chip_smoke.flash_inputs(gen, b, h, lq, lk, d)[3]
        bounds[name] = chip_smoke.flash_bound(vl.repeat_interleave(h), lq,
                                              lk, d, dtype)
    ms, by, flops, nbytes = bounds["bert_base B=8 L=512 float32"]
    assert (round(ms, 4), by) == (0.0109, "bytes")
    assert (round(flops / 1e9, 2), round(nbytes / 1e6, 1)) == (3.29, 36.4)
    assert flops / 495e12 < nbytes / 3.35e12
    ms, by, flops, nbytes = bounds["bert_base B=8 L=512 bfloat16"]
    assert (round(ms, 4), by) == (0.0048, "bytes")
    assert (round(flops / 1e9, 2), round(nbytes / 1e6, 1)) == (2.27, 16.2)


# lines of a ``cuobjdump -sass`` listing of csrc/flash_attention.cu built
# for sm_90a (two of its kernels), and of a kernel of another library
SASS = """
\t\tFunction : _ZN51_GLOBAL__N__e09e4dff_18_flash_attention_cu_f2eeda7216flash_fwd_kernelI13__nv_bfloat16Li32EEEvPKT_S4_S4_PKfPS2_iiif
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_ACCELERATORS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                              /* 0x00000a00ff017b82 */
                                                                                                       /* 0x000e620000000800 */
        /*07d0*/                   LDGSTS.E.BYPASS.128 [R11+0x8800], desc[UR8][R8.64], !P4 ;           /* 0x08800000080b7fae */
        /*0b30*/                   LDGSTS.E.BYPASS.128 [R25+0x8800], desc[UR8][R10.64], !P4 ;          /* 0x088000000a197fae */
        /*1f70*/                   LDSM.16.M88.4 R24, [R4+0x8800] ;                                    /* 0x008800000418783b */
        /*3650*/                   HMMA.16816.F32.BF16 R8, R24.reuse, R12, RZ ;                        /* 0x0000000c1808723c */
        /*3670*/                   HMMA.16816.F32.BF16 R12, R24.reuse, R14, RZ ;                       /* 0x0000000e180c723c */
        /*52e0*/               @P6 MUFU.EX2 R146, R21 ;                                                /* 0x0000001500926308 */
        /*6b70*/                   F2FP.BF16.F32.PACK_AB R68, R145, R146 ;                             /* 0x000000929144723e */
        /*6b80*/                   FFMA R146, R149, R150, R146 ;                                       /* 0x0000009695927223 */
\t\t..........


\t\tFunction : _ZN51_GLOBAL__N__e09e4dff_18_flash_attention_cu_f2eeda7216flash_fwd_kernelIfLi32EEEvPKT_S3_S3_PKfPS1_iiif
        /*4cb0*/                   HMMA.1688.F32.TF32 R164, R168, R4, RZ ;                             /* 0x00000004a8a4723c */
        /*4d50*/                   HMMA.1688.F32.TF32 R164, R20, R8, R164 ;                            /* 0x0000000814a4723c */
        /*4d60*/              @!P0 FFMA R3, R2, R2, R3 ;                                               /* 0x0000000202037223 */
\t\tFunction : other_kernel
        /*0000*/              @!UP1 FFMA R3, R2, R2, R3 ;
"""


def test_sass_census_counts_instruction_families():
    census = chip_smoke.sass_census(SASS)
    bf16, fp32, other = census.values()
    assert bf16 == {"tensor_core_mma": 2, "async_copy": 2, "ldmatrix": 1,
                    "ffma": 1}
    assert fp32 == {"tensor_core_mma": 2, "async_copy": 0, "ldmatrix": 0,
                    "ffma": 1}
    assert other == {"tensor_core_mma": 0, "async_copy": 0, "ldmatrix": 0,
                     "ffma": 1}


def test_flash_sass_fails_without_async_copies(monkeypatch):
    """The census labels each flash instantiation by dtype and D, and the
    run fails when one has no tensor-core MMA or no asynchronous copy (the
    fp32 kernel's lines above have no LDGSTS)."""
    import subprocess
    import types
    monkeypatch.setattr(chip_smoke, "cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=SASS))
    with pytest.raises(AssertionError, match="float32 D=32"):
        chip_smoke.flash_sass()
    only_bf16 = SASS[:SASS.index("\t\tFunction", 10)]
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=only_bf16))
    assert list(chip_smoke.flash_sass()) == ["bfloat16 D=32"]


# a multi-SGD kernel of a ``cuobjdump -sass`` listing: its name, and
# ``loads`` 16-byte loads (every other one marked .CONSTANT, which counts
# too), a 4-byte load and a 16-byte store, which do not
SGD_MANGLED = {"float32": "f", "bfloat16": "13__nv_bfloat16",
               "float16": "6__half"}


def _sgd_listing(dtype, mode, loads):
    lines = ["\t\tFunction : _ZN45_GLOBAL__N__3f86046f_12_multi_sgd_cu_8d1939"
             f"4816multi_sgd_kernelI{SGD_MANGLED[dtype]}Li"
             f"{chip_smoke.SGD_MODES.index(mode)}EEEvNS_5TableENS_7ScalarsE"]
    for i in range(loads):
        lines.append(f"        /*{i:04x}*/              @!P0 LDG.E.128"
                     f"{'.CONSTANT' if i % 2 else ''} R4, desc[UR6][R2.64] ;")
    lines += ["        /*0c00*/                   LDG.E R16, desc[UR6]"
              "[R14.64] ;",
              "        /*0c10*/                   STG.E.128 desc[UR6]"
              "[R8.64], R12 ;"]
    return "\n".join(lines) + "\n"


KERNELS = [(dt, mode) for dt in ("float32", "bfloat16", "float16")
           for mode in chip_smoke.SGD_MODES
           if dt != "float32" or not mode.startswith("mp")]


def test_sgd_sass_fails_without_the_staged_loads(monkeypatch):
    """The census names the 10 multi-SGD kernels by storage type and mode,
    counts 16-byte loads by their whole mnemonic, and fails when one has
    fewer than it stages (``sgd_words``: 4 fp32 vectors or 2 of 8
    elements, each a word of every array and two of an fp32 array on the
    mixed path) or when one is missing."""
    import subprocess
    import types
    monkeypatch.setattr(chip_smoke, "cuobjdump", lambda: "cuobjdump")
    words = {k: chip_smoke.sgd_words(*k) for k in KERNELS}
    assert words == {
        ("float32", "sgd"): 8, ("float32", "sgd_mom"): 12,
        ("bfloat16", "sgd"): 4, ("bfloat16", "sgd_mom"): 6,
        ("bfloat16", "mp_sgd"): 6, ("bfloat16", "mp_sgd_mom"): 10,
        ("float16", "sgd"): 4, ("float16", "sgd_mom"): 6,
        ("float16", "mp_sgd"): 6, ("float16", "mp_sgd_mom"): 10}

    def listing(short=None, drop=None):
        return "".join(_sgd_listing(dt, mode, n - (k == short))
                       for k, n in words.items() if k != drop
                       for dt, mode in (k,))

    for text in (listing(short=("bfloat16", "mp_sgd_mom")),
                 listing(drop=("float16", "sgd"))):
        monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                            types.SimpleNamespace(stdout=text))
        with pytest.raises(AssertionError, match="staged 16-byte loads"):
            chip_smoke.sgd_sass()
    full = listing()
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout=full))
    census = chip_smoke.sgd_sass()
    assert census == {f"{dt} {mode}": {"load_128": n}
                      for (dt, mode), n in words.items()}


def test_sgd_bytes_take_each_array_once():
    """Bytes per element of each update, as the kernel's bound counts
    them: fp32 12 and 20; bf16/fp16 6 and 10; the mixed path 12 and 20
    (the unfused route it replaces moved 32)."""
    got = {(mode, isz): chip_smoke.sgd_bytes(mode, isz)
           for mode in chip_smoke.SGD_MODES for isz in (4, 2)
           if isz == 2 or not mode.startswith("mp")}
    assert got == {("sgd", 4): 12, ("sgd_mom", 4): 20, ("sgd", 2): 6,
                   ("sgd_mom", 2): 10, ("mp_sgd", 2): 12,
                   ("mp_sgd_mom", 2): 20}


def test_fp16_flash_cases_keep_bert_base_width():
    cases = chip_smoke.FP16_FLASH_CASES
    assert len(cases) == 9
    assert {(c[3], c[5]) for c in cases} == {
        (lq, d) for lq in (128, 256, 512) for d in (32, 64, 128)}
    assert all(c[1] == 8 and c[2] * c[5] == 768 and c[6] == torch.float16
               for c in cases)


@pytest.fixture(scope="module")
def cast_step():
    """A small ResNet cast to bf16 and one SGD-momentum step with
    ``multi_precision`` on the CPU (the plain version of the mixed
    path): the trainer, whose states hold the fp32 masters."""
    from mxnet_tpu_torch import autograd
    net = _net()
    net.initialize(Xavier("gaussian", "in", 2), ctx=cpu(), seed=0)
    net.cast("bfloat16")
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9,
                        "multi_precision": True})
    x = torch.randn(2, 3, 32, 32,
                    generator=torch.Generator().manual_seed(0)).bfloat16()
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(x), torch.tensor([1.0, 7.0]))
    autograd.backward(loss)
    tr.step(2)
    return tr


def test_masters_check_fails_on_a_master_one_ulp_off(cast_step):
    """Phase 10 (b)'s check: after the step every weight is its master
    rounded; a master moved by one bf16 ulp (or a weight by one) fails
    that parameter alone."""
    tr = cast_step
    assert chip_smoke.masters_mismatched(tr) == []
    i, p = 5, tr._params[5]
    w32 = tr._states[i][1]
    saved = w32.clone()
    ulp = torch.frexp(w32)[1].float().sub(8).exp2()     # 2^(e - 8)
    w32.add_(ulp)
    assert chip_smoke.masters_mismatched(tr) == [p.name]
    w32.copy_(saved)
    assert chip_smoke.masters_mismatched(tr) == []


def _update_prof(names):
    """A fake profile: a forward kernel, then a ``trainer_step`` range
    whose device span holds the kernels ``names`` (launched by ctypes, so
    no CPU op carries them), then a kernel after it."""
    cuda = torch.autograd.DeviceType.CUDA

    def event(name, start, end, annotation=False, device=cuda):
        return types.SimpleNamespace(
            name=name, device_type=device, is_user_annotation=annotation,
            kernels=[], time_range=types.SimpleNamespace(
                start=start, end=end, elapsed_us=lambda: end - start))

    t = 100.0 + 2.0 * len(names)
    events = [event("sm90_xmma_fprop", 0.0, 90.0),
              event("trainer_step", 95.0, t + 5.0, True,
                    torch.autograd.DeviceType.CPU),
              event("trainer_step", 100.0, t, True)]
    events += [event(n, 100.0 + 2 * i, 101.0 + 2 * i)
               for i, n in enumerate(names)]
    events.append(event("vectorized_elementwise_kernel", t + 10, t + 11))
    return types.SimpleNamespace(events=lambda: events)


def test_update_range_check_fails_when_a_per_tensor_copy_comes_back():
    """Phase 10's update range holds exactly the 41 launches of the
    mixed-path kernel; one ``copy_`` of a master into its weight (a
    direct_copy kernel), or a launch short, fails it."""
    mixed = "void (anonymous namespace)::multi_sgd_kernel<__nv_bfloat16, 3>"
    ok = chip_smoke.update_range_check(_update_prof([mixed] * 41),
                                       "multi_sgd_kernel", 41)
    assert ok["ok"] and ok["kernel_launches"] == 41
    copy = ("void at::native::unrolled_elementwise_kernel<at::native::"
            "direct_copy_kernel_cuda>")
    bad = chip_smoke.update_range_check(
        _update_prof([mixed] * 41 + [copy]), "multi_sgd_kernel", 41)
    assert not bad["ok"] and bad["other_kernels"] == [copy[:90]]
    short = chip_smoke.update_range_check(_update_prof([mixed] * 40),
                                          "multi_sgd_kernel", 41)
    assert not short["ok"]


def test_ptxas_report_reads_registers_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kILb0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1kILb0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 28 registers, used 1 barriers
ptxas info    : Function properties for _Z1kILb1EEvv
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""
    assert chip_smoke.ptxas_report(log) == {
        "_Z1kILb0EEvv": {"registers": 28, "spill_stores": 0,
                         "spill_loads": 0},
        "_Z1kILb1EEvv": {"registers": 255, "spill_stores": 8,
                         "spill_loads": 4}}


class _Interval:
    def __init__(self, start, us):
        self.start, self._us = start, us

    def elapsed_us(self):
        return self._us


class _KernelEvent:
    """An entry of ``events()``: one launch on the device."""
    def __init__(self, name, start, us):
        self.device_type = torch.autograd.DeviceType.CUDA
        self.is_user_annotation = False
        self.name = name
        self.time_range = _Interval(start, us)


def _fake_event_profiler(monkeypatch, traces):
    """torch.profiler.profile whose ``events()`` hand out ``traces`` (lists
    of (name, start, us)), one per ``with``."""
    class Profile:
        def __init__(self, *args, **kwargs):
            self.trace = [_KernelEvent(*e) for e in traces.pop(0)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.trace

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: "cpu")


def test_launch_ms_orders_launches_and_retakes_partial_traces(monkeypatch):
    """Launch i of each call is the i-th matching kernel by start time,
    averaged over the calls; a trace with a launch missing is taken
    again, and other kernels are left out."""
    k = "multi_sgd_kernel<true>"
    _fake_event_profiler(monkeypatch, [
        [(k, 0, 5.0), (k, 10, 7.0), (k, 20, 5.0)],
        [(k, 30, 9.0), (k, 0, 4.0), ("memcpy", 5, 100.0), (k, 10, 6.0),
         (k, 20, 2.0)]])
    assert chip_smoke.launch_ms(lambda: None, 2, 2, "multi_sgd_kernel") \
        == [0.003, 0.0075]


def test_launch_ms_raises_after_partial_traces(monkeypatch):
    _fake_event_profiler(monkeypatch, [[("multi_sgd_kernel", 0, 1.0)]] * 5)
    with pytest.raises(AssertionError, match="saw 1"):
        chip_smoke.launch_ms(lambda: None, 2, 1, "multi_sgd_kernel")


def test_launch_bins_sum_each_bin_beside_its_bound():
    rows = chip_smoke.launch_bins([1000, 70000, 2000000, 60000],
                                  [0.003, 0.004, 0.02, 0.002], True)
    assert [(r["bin"], r["launches"], r["elements"]) for r in rows] == [
        ("< 64K", 2, 61000), ("64K-1M", 1, 70000), ("> 1M", 1, 2000000)]
    assert rows[0]["ms"] == pytest.approx(0.005)
    assert rows[2]["bound_ms"] == pytest.approx(20 * 2e6 / 3.35e12 * 1e3)
    assert rows[2]["bound_share"] == pytest.approx(
        rows[2]["bound_ms"] / 0.02)


# --------------------------------------------------------------- phase 12

def _small_nmt(seed=0):
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerNMT
    net = TransformerNMT(60, num_layers=2, units=32, hidden_size=64,
                         num_heads=2, max_length=32)
    net.initialize(ctx=cpu(), seed=seed)
    return net


@pytest.mark.parametrize("beam", [1, 3])
def test_decoder_calls_count_each_translate_step(beam):
    """``DecoderCalls`` counts one call per decoder run of ``translate``
    (greedy: one per step for the batch; beam: one per live hypothesis),
    records each prefix with its memory row, and leaves the model as it
    was; ``translate_flash_launches`` is the encoder's layers plus the
    decoder's per call."""
    net = _small_nmt()
    src = torch.as_tensor(np.random.RandomState(0).randint(3, 60, (3, 5)))
    with chip_smoke.DecoderCalls(net, record=True) as rec:
        toks, _ = net.translate(src, 1, 2, max_len=4, beam_size=beam)
    assert "_step_logp" not in vars(net)
    assert rec.calls == len(rec.records) > 0
    if beam == 1:
        assert rec.calls <= 4
        assert [r[0].shape for r in rec.records] == \
            [(3, n) for n in range(1, rec.calls + 1)]
        assert {r[1] for r in rec.records} == {0}
    else:
        assert {r[1] for r in rec.records} == {0, 1, 2}
        assert rec.calls <= 3 * (1 + 3 * 3)
    assert chip_smoke.translate_flash_launches(6, rec.calls) == \
        6 + 6 * rec.calls


def test_teacher_forcing_passes_itself_and_flags_a_wrong_choice():
    """The replay of the model's own decoder calls on the same model
    passes (errors 0); a record whose log-probabilities would have made
    another token the greedy choice fails the choice check, and an
    offset of 1e-3 fails the log-probability check."""
    net = _small_nmt()
    src = np.random.RandomState(1).randint(3, 60, (2, 6))
    with chip_smoke.DecoderCalls(net, record=True) as rec:
        net.translate(torch.as_tensor(src), 1, 2, max_len=5)
    good = chip_smoke.teacher_forcing(net, src, rec.records, 1, 1e-4)
    assert good["ok"] and good["logp_max_abs_err"] <= 1e-6
    tgt, row, rows, logp = rec.records[2]
    wrong = logp.copy()
    wrong[0, np.argmin(wrong[0])] = wrong[0].max() + 1.0
    bad = chip_smoke.teacher_forcing(
        net, src, rec.records[:2] + [(tgt, row, rows, wrong)], 1, 1e-4)
    assert not bad["ok"] and bad["bad_choices"] == 1
    off = chip_smoke.teacher_forcing(
        net, src, [(tgt, row, rows, logp + 1e-3)], 1, 1e-4)
    assert not off["ok"] and off["bad_choices"] == 0


def _lm_bucketing(monkeypatch):
    from mxnet_tpu_torch import random as mx_random
    for name, value in (("LM_VOCAB", 40), ("LM_EMB", 8), ("LM_HIDDEN", 8),
                        ("LM_BATCH", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    mx_random.seed(0)
    bmod = chip_smoke.lm_module(cpu(), 20)
    bmod.init_params()
    bmod.init_optimizer(optimizer="sgd",
                        optimizer_params=dict(chip_smoke.LM_OPT))
    for b in chip_smoke.lm_iter(0, 120):
        bmod.forward_backward(b)
        bmod.update()
    return bmod


def test_parameter_sharing_check_flags_a_copied_tensor(monkeypatch):
    """Every bucket's module holds the master's parameter and gradient
    tensors after training; a bucket given its own copy of one weight is
    flagged, that weight alone."""
    bmod = _lm_bucketing(monkeypatch)
    assert len(bmod.buckets) >= 3
    assert chip_smoke.unshared_parameters(bmod) == []
    key = next(k for k in bmod.buckets if k != bmod.default_bucket_key)
    arr = bmod.buckets[key]._arg_params["pred_weight"]
    bmod.buckets[key]._arg_params["pred_weight"] = type(arr)(
        arr._data.clone())
    assert chip_smoke.unshared_parameters(bmod) == [(key, "pred_weight")]


def test_lm_data_spans_the_buckets_with_a_zipf_law():
    sents = chip_smoke.lm_sentences(0, 3000)
    lengths = np.array([len(s) for s in sents])
    assert lengths.min() >= 2 and lengths.max() <= 60
    ids = np.concatenate([np.asarray(s) for s in sents])
    assert ids.min() >= 1 and ids.max() < chip_smoke.LM_VOCAB
    counts = np.bincount(ids, minlength=10)
    assert counts[1] > 1.8 * counts[2] > 1.8 * 1.2 * counts[4]
    assert chip_smoke.lm_sentences(0, 3000) == sents


def test_nmt_data_is_bench_nmts_shapes():
    data = chip_smoke.nmt_data(0, 16, (32, 48, 64), 32000)
    assert sorted(data) == [32, 48, 64]
    for s, (src, tgt, lab) in data.items():
        assert src.shape == tgt.shape == lab.shape == (16, s)
        assert src.dtype == torch.float32
        assert src.min() >= 1 and src.max() < 32000
    again = chip_smoke.nmt_data(0, 16, (32, 48, 64), 32000)
    assert torch.equal(again[48][2], data[48][2])


def test_nmt_flash_cases_and_kernel_classes():
    shapes = {c[0]: c[1:6] for c in chip_smoke.NMT_FLASH_CASES}
    assert shapes["nmt B=16 H=8 L=64"] == (16, 8, 64, 64, 64)
    assert shapes["nmt cross Lq=48 Lk=64"] == (16, 8, 48, 64, 64)
    assert shapes["nmt decode Lq=1 Lk=64"][2:] == (1, 64, 64)
    cls = chip_smoke._nmt_kernel_class
    assert cls("void at::native::(anonymous namespace)::cunn_SoftMaxForward"
               "<4, float, float, float, LogSoftMaxForwardEpilogue>") == \
        "log_softmax_ce"
    assert cls("cunn_SoftMaxForward<4, float, float, float, "
               "SoftMaxForwardEpilogue>") == "masked_softmax"
    assert cls("void at::native::_scatter_gather_elementwise_kernel") == \
        "log_softmax_ce"
    assert cls("flash_fwd_kernel<float, 64>") == "flash_forward"
    assert cls("sm90_xmma_gemm_f32f32") == "gemm"


def test_nmt_leaf_check_passes_a_small_model_on_the_cpu(monkeypatch):
    """``nmt_leaf_check`` with the CPU standing in for the card: the fp32
    step against itself and float64 passes, and the weights are put
    back."""
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    monkeypatch.setattr(chip_smoke, "NMT_VOCAB", 60)
    net = _small_nmt(2)
    before = chip_smoke._snapshot(net)
    out = chip_smoke.nmt_leaf_check(net, 0, _small_nmt)
    assert out["ok"], out
    assert out["weights"]["leaves"] == len(before)
    after = chip_smoke._snapshot(net)
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_relu_decisions_record_force_and_count_flips():
    """``Decisions`` records each ReLU call's mask (the small NMT's: one
    a position-wise FFN); forcing the masks back reproduces the forward
    and its gradients exactly, forcing a mask with one unit flipped in
    the last FFN counts that one flip and moves the gradients, and no
    mode is left active after."""
    net = _small_nmt(3)
    src = torch.as_tensor(np.random.RandomState(2).randint(3, 60, (2, 5)))
    lab = torch.as_tensor(np.random.RandomState(3).randint(3, 60, (2, 5)))

    def grads(masks=None):
        with chip_smoke.Decisions(masks) as rd:
            loss = chip_smoke.nmt_check_step(net, [src, src, lab])
        load_reference_params(net, init, ctx=cpu())
        return rd, loss[0].item(), loss[1]

    init = {k: v.numpy() for k, v in chip_smoke._snapshot(net).items()}
    rec, loss, g = grads()
    assert len(rec.masks) == 4 and rec.units == 4 * 2 * 5 * 64
    same, loss2, g2 = grads(rec.masks)
    assert same.flips == 0 and loss2 == loss
    assert all(torch.equal(g[k], g2[k]) for k in g)
    flipped = [m.clone() for m in rec.masks]
    flipped[3].view(-1)[0] = ~flipped[3].view(-1)[0]
    one, _, g3 = grads(flipped)
    assert one.flips == 1
    assert any(not torch.equal(g[k], g3[k]) for k in g)
    assert not torch._C._is_torch_function_mode_enabled()


# ---- phase 13 (config #5) at toy sizes -----------------------------------
def _toy_detection(monkeypatch):
    """Phase 13 with the CPU for the card, ``ssd_toy`` at 64 x 64 for
    SSD-512 (1,344 anchors) and ``mask_rcnn_toy`` at 64 x 64 for the
    ResNet-18 Mask-RCNN, 1 warm and 2 timed steps, ``device_ms`` (the
    card's profiler) stubbed."""
    from mxnet_tpu_torch.gluon.model_zoo import rcnn, ssd
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, iters, **kw: 1.0)
    monkeypatch.setattr(chip_smoke, "ssd_512_resnet50_v1",
                        lambda classes=20: ssd.ssd_toy(classes=classes))
    monkeypatch.setattr(chip_smoke, "mask_rcnn_resnet18_v1",
                        lambda classes=20: rcnn.mask_rcnn_toy(
                            classes=classes, img_size=64))
    for name, value in (("SSD_SIZE", 64), ("SSD_BATCH", 2),
                        ("SSD_ANCHORS", 1344), ("SSD_WARM", 1),
                        ("SSD_STEPS", 2), ("RCNN_IMG", 64),
                        ("RCNN_BATCH", 2), ("RCNN_WARM", 1),
                        ("RCNN_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_detection_phase_rehearses_on_the_cpu(monkeypatch):
    """Every check of phase 13 but the kernel's launches (0 on CPU
    tensors) passes with toy models: deferred shapes settled, the leaf
    checks (no ReLU or target decision flipped between two CPU runs),
    the detection against the CPU and a greedy loop, in fewer NMS
    passes than anchors."""
    _toy_detection(monkeypatch)
    out = chip_smoke.detection_phase(0, "cpu")
    for name in ("ssd", "rcnn"):
        checks = dict(out[name]["checks"])
        assert not checks.pop("momentum_launches")   # no kernel on the CPU
        assert not checks.pop("update_bitwise")      # (its launches)
        assert all(checks.values()), (name, checks)
        flips = out[name]["leaf_check"]["flips"]["cpu"]
        assert set(flips.values()) == {0}
    det = out["ssd"]["detection"]
    assert det["anchors"] == 1344 and det["nms_passes"]["run"] < 1344
    assert out["ssd"]["deferred_params"] > 0
    assert out["rcnn"]["train"]["profile"]["device_ms"].keys() >= {
        "proposal", "roi_align", "heads", "loss", "update"}


@pytest.mark.parametrize("model,leaf", [("ssd", 0), ("rcnn", 14)])
def test_detection_leaf_checks_flag_a_one_percent_gradient_fault(
        monkeypatch, model, leaf):
    """A 1 % fault in one leaf's gradient of the "card" step (SSD: the
    first conv's weight; RCNN: the box head's first Dense weight) fails
    exactly that leaf in both ``leaf_check``s of the phase-13 checks."""
    _toy_detection(monkeypatch)
    check_step = chip_smoke.check_step
    calls = []

    def faulty(net, run, opt):
        calls.append(net)
        if len(calls) == 1:
            param = list(net.collect_params().values())[leaf]
            hook = param._data.register_hook(lambda g: g * 1.01)
            try:
                return check_step(net, run, opt)
            finally:
                hook.remove()
        return check_step(net, run, opt)

    monkeypatch.setattr(chip_smoke, "check_step", faulty)
    if model == "ssd":
        net = chip_smoke.ssd_512_resnet50_v1(classes=20)
        x = chip_smoke.ssd_batch(0, 1)[0]
        check = chip_smoke.ssd_leaf_check
    else:
        net = chip_smoke.mask_rcnn_resnet18_v1(classes=20)
        x = chip_smoke.rcnn_batch(0, 1)[0]
        check = chip_smoke.rcnn_leaf_check
    net.initialize(ctx=cpu())
    net(x)
    arrays = {k: v.numpy() for k, v in chip_smoke._snapshot(net).items()}
    out = check(net, arrays, 0)
    assert not out["ok"]
    name = list(net.collect_params())[leaf]
    for part in ("weights", "grads"):
        assert [r["leaf"] for r in out[part]["failed"]] == [name], part


# ---- phase 14 (hybridize on CUDA graphs): what the CPU can check --------
def test_graph_summary_counts_entries_and_eager_calls():
    """``graph_summary`` of a hybridized net on the CPU: one entry per
    signature, its calls all eager (no graph, no warm call: those are
    the card's), the deferred-shape call counted apart;
    ``free_graphs`` empties the cache."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(4), nn.Dense(2))
    net.initialize(ctx=cpu())
    net.hybridize()
    for n in (3, 3, 5):
        net(torch.ones(n, 6))
    g = chip_smoke.graph_summary(net)
    assert (g["entries"], g["graphs"], g["replays"], g["warm_calls"],
            g["deferred_calls"]) == (2, 0, 0, 0, 1)
    chip_smoke.free_graphs(net)
    assert net.graph_stats()["entries"] == 0


def test_replay_leaf_check_rehearses_on_the_cpu(monkeypatch):
    """``replay_leaf_check`` with the CPU for the card on phase 12's
    check step of a small NMT: the eager step repeats bit for bit, the
    hybridized step (eager on the CPU) equals it, both leaf checks pass,
    and only ``replayed`` (a card's count) reads 0; the weights are put
    back."""
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    monkeypatch.setattr(chip_smoke, "NMT_VOCAB", 60)
    net = _small_nmt(4)
    before = chip_smoke._snapshot(net)
    arrays = {k: v.numpy() for k, v in before.items()}
    kept = {}
    assert chip_smoke.nmt_leaf_check(net, 0, _small_nmt, kept)["ok"]
    out = chip_smoke.replay_leaf_check(net, arrays, chip_smoke.nmt_check_step,
                                       kept)
    assert out["replayed"] == 0 and not out["ok"]
    assert out["eager_bitwise_run_to_run"] and out["replay_bitwise_eager"]
    assert all(r["ok"] for part in ("vs_float64", "vs_eager")
               for r in out[part].values())
    after = chip_smoke._snapshot(net)
    assert all(torch.equal(before[k], after[k]) for k in before)
    brief = chip_smoke._leaf_brief(out)
    assert brief["vs_eager_grads"]["ok"] and not brief["ok"]


def test_host_reading_rcnn_rehearses_on_the_cpu(monkeypatch):
    """Phase 14 (d) with the toy Mask-RCNN on the CPU: ``hybridize()``
    warns once, each step is counted as an eager call, no entry is made,
    and the losses equal phase 13's eager run from the same weights."""
    _toy_detection(monkeypatch)
    eager = chip_smoke.rcnn_phase(0, "cpu")["train"]["losses"]
    out = chip_smoke.rcnn_graph_run(0, "cpu", eager)
    assert out["ok"], out["checks"]
    assert out["warnings"] == 1 and out["eager_calls"] == 2
    assert out["first_loss_bitwise_eager"]


# -- phase 15: generation serving --------------------------------------------

def _small_generation(monkeypatch):
    """Phase 15 at toy sizes on the CPU: (b)'s model 2 layers 64 wide,
    12 requests a cell, BERT-base replaced by a small BERT."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import bert_small
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    monkeypatch.setattr(chip_smoke, "GEN_SMALL_REQUESTS", 12)
    monkeypatch.setattr(chip_smoke, "GEN_BASE_REQUESTS", 12)
    monkeypatch.setattr(chip_smoke, "GEN_BASE_MODEL", dict(
        chip_smoke.GEN_BASE_MODEL, num_layers=2, units=64, hidden_size=128,
        num_heads=4))
    monkeypatch.setattr(chip_smoke, "GEN_BASE", dict(
        chip_smoke.GEN_BASE, slots=4, kv_blocks=64,
        prompt_buckets=(16, 32), max_new_tokens=16))
    monkeypatch.setattr(chip_smoke, "GEN_BASE_PROMPT", (4, 32))
    monkeypatch.setattr(chip_smoke, "GEN_BASE_NEW", (2, 16))
    monkeypatch.setattr(chip_smoke, "LAYERS", 2)
    monkeypatch.setattr(chip_smoke, "bert_base", lambda **kw: bert_small(
        vocab_size=chip_smoke.VOCAB, **kw))
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)


def test_generation_phase_rehearses_on_the_cpu(monkeypatch):
    """Every check of phase 15 but the captured graphs' and BERT-base's
    flash launches (none on the CPU) passes at toy sizes: batched equals
    alone, tokens and logits, in both prefill modes; no block left; the
    pool in place; teacher forcing; the front door's SSE, disconnect,
    predict and GET checks; and no kernel launched."""
    _small_generation(monkeypatch)
    out = chip_smoke.generation_phase(0, "cpu")
    assert out["checks"] == {"no_kernel_launches": True}
    assert all(out["small"]["checks"].values()), out["small"]["checks"]
    assert all(out["base"]["checks"].values()), out["base"]["checks"]
    front = dict(out["frontdoor"]["checks"])
    assert not front.pop("bert_flash_launches")   # no kernel on the CPU
    assert all(front.values()), front
    runs = out["small"]["runs"]
    assert set(runs) == {"interleave", "step", "recorded", "alone"}
    assert all(r["tokens_generated"] == 12 * 48 for r in runs.values())
    assert out["small"]["teacher_forcing"]["steps"] == 12 * 48
    assert out["base"]["teacher_forcing"]["requests"] == 2
    assert out["base"]["runs"]["alone"]["requests"] == 8


@pytest.fixture(scope="module")
def gen_runs():
    """A recorded batched run and an alone run of 6 requests through
    ``causal_lm_small`` on the CPU, and the alone run teacher forced."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import causal_lm_small
    net = causal_lm_small()
    net.initialize(ctx=cpu(), seed=0)
    prompts, caps = chip_smoke.gen_requests(3, 6, (4, 15), (2, 12))
    kw = dict(chip_smoke.GEN_SMALL, max_new_tokens=12)
    every = range(6)
    runs = {"recorded": chip_smoke.gen_serve(net, prompts, caps, kw,
                                             "step", track=every),
            "alone": chip_smoke.gen_serve(net, prompts, caps,
                                          {**kw, "slots": 1}, "interleave",
                                          track=every, keep=every)}
    forced = chip_smoke.teacher_forced(net, prompts, runs["alone"]["tokens"],
                                       runs["alone"]["rows"], 1e-4)
    return runs, forced


def _faulted(gen_runs, fault):
    import copy
    runs, forced = copy.deepcopy(gen_runs)
    rec = runs["recorded"]
    if fault == "flipped_token":
        rec["tokens"][3][-1] ^= 1
    elif fault == "flipped_logit":
        rec["digests"][2][-1] = "0" * 40
    elif fault == "leaked_block":
        rec["stats"]["kv_blocks_used"] = 1
    elif fault == "copied_pool":
        rec["pool_moved"] = True
    elif fault == "pool_copied_out":
        rec["graphs"]["decode"] = {16: {"graphs": [
            {"copy_bytes": 16 * 257 * 4 + 4 * 128 * 16 * 64 * 4}]}}
    elif fault == "teacher_forcing":
        forced = dict(forced, ok=False)
    return chip_smoke.gen_checks(runs, forced, 16 * 257 * 4, False)


@pytest.mark.parametrize("fault,check", [
    ("flipped_token", "batched_equals_alone_tokens"),
    ("flipped_logit", "batched_equals_alone_logits"),
    ("leaked_block", "no_block_leaked"),
    ("copied_pool", "pool_in_place"),
    ("pool_copied_out", "pool_in_place"),
    ("teacher_forcing", "teacher_forcing")])
def test_generation_checks_fail_on_an_injected_fault(gen_runs, fault,
                                                      check):
    """Phase 15's checks pass the CPU runs and fail exactly the check a
    fault is for: a flipped token, a logits row that differs from alone,
    a block left allocated, a pool that moved or was copied out by a
    decode replay, a teacher-forcing miss."""
    assert all(chip_smoke.gen_checks(*gen_runs, 16 * 257 * 4,
                                     False).values())
    out = _faulted(gen_runs, fault)
    assert [k for k, v in out.items() if not v] == [check]


def test_teacher_forcing_flags_a_drifted_row(gen_runs):
    """A card row 1e-3 off the CPU's fails the teacher forcing (whose
    tolerance is 1e-4); the rows as recorded pass it."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import causal_lm_small
    runs, forced = gen_runs
    assert forced["ok"] and forced["logits_max_abs_err"] < 1e-5
    net = causal_lm_small()
    net.initialize(ctx=cpu(), seed=0)
    rows = {r: [x.copy() for x in v]
            for r, v in runs["alone"]["rows"].items()}
    rows[1][2] = rows[1][2] + 1e-3
    prompts, _ = chip_smoke.gen_requests(3, 6, (4, 15), (2, 12))
    out = chip_smoke.teacher_forced(net, prompts, runs["alone"]["tokens"],
                                    rows, 1e-4)
    assert not out["ok"] and out["logits_max_abs_err"] > 9e-4


# -- phase 16: the training surface around gluon.Trainer ----------------------

@pytest.fixture
def one_thread():
    """One intra-op thread for the test (the CPU's convolutions slow down
    many times over when tier-1's workers share the cores), restored
    after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_surface(monkeypatch):
    """Phase 16 at toy sizes on the CPU: the small ResNet at batch 4 on
    32 x 32 images, a small BERT (vocabulary 1000, 2 layers) at batch 2,
    sequence 32, 3 steps; (c) on a 96 -> 384 -> 96 stack, SGLD's moments
    over its 74 K elements within 3e-2."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import bert_small
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    monkeypatch.setattr(chip_smoke, "resnet50_v1", lambda classes: _net())
    monkeypatch.setattr(chip_smoke, "RESNET_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "VOCAB", 1000)
    monkeypatch.setattr(chip_smoke, "bert_base", lambda **kw: bert_small(
        vocab_size=1000, **kw))
    monkeypatch.setattr(chip_smoke, "BERT_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "BERT_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "BERT_CHECK", (2, 16))
    monkeypatch.setattr(chip_smoke, "SURFACE_BERT_WARM", 1)
    monkeypatch.setattr(chip_smoke, "SURFACE_BERT_TIMED", 2)
    monkeypatch.setattr(chip_smoke, "ZOO_WIDTHS", (96, 384))
    monkeypatch.setattr(chip_smoke, "SGLD_ELEMENTS", 96 * 384 * 2 + 480)
    monkeypatch.setattr(chip_smoke, "SGLD_MOMENT_TOL", 3e-2)
    randn = torch.randn

    def small_images(*shape, **kw):
        if shape[1:] == (3, 224, 224):
            shape = (shape[0], 3, 32, 32)
        return randn(*shape, **kw)
    monkeypatch.setattr(chip_smoke.torch, "randn", small_images)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache",
                 "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)


def test_surface_phase_rehearses_on_the_cpu(monkeypatch, one_thread):
    """Every check of phase 16 passes at toy sizes but those only the
    card can meet (kernel launches, host reads, which read 0 on the
    CPU): the schedule's rates and the 0 multipliers in each group, the
    resume and steps 7-12 bit for bit, LAMB's leaf check, and every
    optimizer's CPU run against itself, SGLD's moments."""
    _small_surface(monkeypatch)
    adam = {"step_ms": 1.0, "sequences_per_s": 1.0, "profile": {
        "device_busy_ms": 1.0, "device_idle_share": 0.0,
        "host_launches": 1}}
    out = chip_smoke.resnet_surface_run(0, "cpu")
    card_only = {"momentum_launches"}
    assert [k for k, v in out["checks"].items() if not v] == \
        sorted(card_only)
    assert out["rates"][:4] == pytest.approx([0.05 / 3, 0.1 / 3, 0.05,
                                              0.05])
    assert out["checkpoint_bytes"]["states"] > 0
    out = chip_smoke.bert_lamb_run(0, "cpu", adam)
    assert [k for k, v in out["checks"].items() if not v] == \
        ["flash_launches", "one_host_read_a_step"]
    assert out["host_reads_per_step"] == [0] * 3    # none on the CPU
    out = chip_smoke.optimizer_zoo_run(0, "cpu")
    assert out["optimizers"] == sorted(
        ["sgd", "nag", "adam", "adagrad", "rmsprop", "ftrl", "signum",
         "adadelta", "adamw", "lars", "lbsgd", "ftml", "lamb", "adamax",
         "nadam", "sgld", "dcasgd"])
    assert out["sgld"]["ok"]
    for row in out["rows"]:
        assert row["max_rel_err"] == 0.0 and row["rates_follow_the_schedule"]
        sgd_kernel = row["optimizer"] == "sgd"
        assert row["ok"] != sgd_kernel, row     # no launch on the CPU


@pytest.fixture(scope="module")
def lamb_steps():
    """A small BERT's LAMB check step on the CPU in fp32 and float64 and
    its initial weights."""
    from mxnet_tpu_torch.gluon.model_zoo.transformer import bert_small
    net = bert_small(vocab_size=1000, dropout=0.0)
    net.initialize(ctx=cpu(), seed=0)
    init = chip_smoke._snapshot(net)
    arrays = {k: v.numpy() for k, v in init.items()}
    batch = [torch.as_tensor(a) for a in
             chip_smoke.bert_batch(1, 2, 16, vocab=1000)]

    def run(dtype):
        model = bert_small(vocab_size=1000, dropout=0.0)
        load_reference_params(model, arrays, ctx=cpu())
        return chip_smoke.lamb_check_step(model.to(dtype), batch)
    return init, run, run(torch.float32), run(torch.float64)


def test_lamb_leaf_check_flags_a_one_percent_trust_ratio_fault(
        lamb_steps, monkeypatch):
    """The LAMB check step passes ``leaf_check`` as the card; with every
    trust ratio 1 % too large it fails on the weights, and its gradients
    still pass."""
    from mxnet_tpu_torch.ndarray import ops_optimizer
    init, run, cpu32, cpu64 = lamb_steps
    zeros = {k: torch.zeros_like(v) for k, v in init.items()}
    assert chip_smoke.leaf_check(cpu32[2], cpu32[2], cpu64[2], init)["ok"]
    real = ops_optimizer.lamb_update_phase2

    def faulty(weight, g, r1, r2, lr, **kw):
        return real(weight, g, r1 * 1.01, r2, lr, **kw)
    monkeypatch.setattr(ops_optimizer, "lamb_update_phase2", faulty)
    faulted = run(torch.float32)
    weights = chip_smoke.leaf_check(faulted[2], cpu32[2], cpu64[2], init)
    assert not weights["ok"] and len(weights["failed"]) > len(init) // 2
    assert chip_smoke.leaf_check(faulted[1], cpu32[1], cpu64[1],
                                 zeros)["ok"]


def test_resume_check_flags_a_checkpoint_without_one_momentum(tmp_path,
                                                             one_thread):
    """``resume_mismatches`` passes a full checkpoint and names the one
    parameter whose momentum the file lacks."""
    import pickle
    from mxnet_tpu_torch import autograd
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 3, 32, 32),
                                            dtype=np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 2).astype(np.float32))

    def make(seed):
        net = _net()
        net.initialize(Xavier("gaussian", "in", 2), ctx=cpu(), seed=seed)
        return net, chip_smoke.resnet_surface_trainer(net)
    net_a, tr_a = make(0)
    for _ in range(2):
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net_a(x), y)
        autograd.backward(loss)
        tr_a.step(2)
    net_a.save_parameters(str(tmp_path / "a.params"))
    tr_a.save_states(str(tmp_path / "a.states"))
    net_b, tr_b = make(1)
    net_b.load_parameters(str(tmp_path / "a.params"))
    tr_b.load_states(str(tmp_path / "a.states"))
    assert chip_smoke.resume_mismatches(net_a, tr_a, net_b, tr_b) == []
    blob = pickle.loads((tmp_path / "a.states").read_bytes())
    del blob["states"]["5"]
    (tmp_path / "b.states").write_bytes(pickle.dumps(blob))
    net_c, tr_c = make(2)
    net_c.load_parameters(str(tmp_path / "a.params"))
    tr_c.load_states(str(tmp_path / "b.states"))
    assert chip_smoke.resume_mismatches(net_a, tr_a, net_c, tr_c) == [
        f"state {tr_a._params[5].name}"]


def test_data_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, one_thread):
    """Phase 17 on the CPU at a toy size (32 records of 40-56 pixels, crop
    32, batch 8, a small ResNet, one usable core and one intra-op
    thread), with the io core standing for one built without JPEG, as on
    the card's machine (``RAWN`` records): every check but the kernel's
    launches (0 on CPU tensors), the pinned batches and the batches on the
    card passes: the native core's first batch bit for bit on one thread,
    the leaf check against float64, the labels against the ``.idx``, the
    resume bit for bit, and (d)'s loader yielding two batches a worker at
    every thread count."""
    import json
    import os
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "resnet50_v1",
                        lambda classes=1000: resnet.ResNetV1(
                            resnet.BottleneckV1, [1, 1, 1, 1],
                            [8, 16, 32, 64, 128], classes=classes))
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    monkeypatch.setattr(chip_smoke.native, "has_jpeg", lambda: False)
    for name, value in (("DATA_IMAGES", 32), ("DATA_SHORT", (40, 56)),
                        ("DATA_RESIZE", 36), ("DATA_CROP", 32),
                        ("RESNET_BATCH", 8), ("DATA_WARM", 1),
                        ("DATA_RESUME_AT", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.data_phase(0, "cpu", tmp_path)
    assert out["payload"] == "rawn"
    assert sorted(out["scaling"]["dataloader"]) == [1, 2, 4]
    assert all(r["batches"] == 2 * t and r["build_ms_per_batch"] > 0
               for t, r in out["scaling"]["dataloader"].items())
    assert out["copy"]["pinned_ms"] is None
    checks = dict(out["checks"])
    for name in ("launches_fp32", "launches_bf16", "launches_dataloader",
                 "dataloader_pinned", "dataloader_on_card"):
        assert not checks.pop(name), name
    assert all(checks.values()), checks
    assert out["dataloader"]["resume_state"]["global"] == 2
    assert set(out["part_seconds"]) == {"probe_and_records", "a", "b_fp32",
                                        "leaf_check", "c", "b_bf16", "d"}
    json.dumps(out)


def test_data_phase_jpeg_records_feed_the_native_core(tmp_path,
                                                      monkeypatch):
    """Where the io core decodes JPEG, phase 17 packs JPEG records (a
    smooth image compresses as a photograph does: far below its raw
    bytes) and reuses them; the recipe's iterator reads them natively."""
    import numpy as np
    data = chip_smoke.phase17_records(3, tmp_path, True, 6)
    again = chip_smoke.phase17_records(3, tmp_path, True, 6)
    assert data["payload"] == "jpeg" and data["made"] and not again["made"]
    img = chip_smoke.phase17_image(3, 0)
    assert 300 <= min(img.shape[:2]) <= 500 and img.dtype == np.uint8
    assert data["mean_record_bytes"] < img.nbytes / 4
    if not chip_smoke.native.has_jpeg():
        pytest.skip("the io core was built without libjpeg here")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rate = chip_smoke.iter_rate(lambda: chip_smoke.record_iter(
        data, 1, 0, 3))
    assert rate["native"] and rate["images"] == 6
    assert rate["first"][0].shape == (3, 3, chip_smoke.DATA_CROP,
                                      chip_smoke.DATA_CROP)


# -- phase 18: Gluon's model surface ----------------------------------------

def test_model_surface_phase_rehearses_on_the_cpu(monkeypatch, one_thread):
    """Phase 18 at toy sizes on the CPU: every check passes but those only
    the card can meet (kernel launches, captured graphs and their replays,
    cuDNN's weight buffer): finite losses, the predict-mode shape, the
    decision leaf checks against float64, the language model's first
    window against the CPU, and the tied decoder."""
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "ZOO_FAMILIES", (
        ("resnet18_v2", 32, 0.1), ("mobilenet_v2_0_25", 32, 0.1),
        ("squeezenet1_1", 32, 0.01)))
    monkeypatch.setattr(chip_smoke, "ZOO_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "WORD_LM", dict(
        chip_smoke.WORD_LM, vocab=50, emb=16, hidden=16, bptt=5, batch=2))
    out = chip_smoke.model_surface_phase(0, "cpu")
    card_only = ["launches_exact", "leaf_check", "one_train_graph",
                 "predict_replayed"]
    for name, r in out["zoo"].items():
        assert sorted(k for k, v in r["checks"].items() if not v) == \
            card_only, name
        check = r["check"]
        assert check["replayed"] == 0 and check["weights"]["ok"] and \
            check["grads"]["ok"] and check["loss_abs_err_vs_cpu"] <= 1e-4
        assert check["decisions"]["decisions"] > 0
        assert r["launches"] == 0 and r["expected_launches_per_step"] > 0
    lm = out["word_lm"]
    assert sorted(k for k, v in lm["checks"].items() if not v) == [
        "launches_exact", "no_cudnn_weight_copy", "one_train_graph",
        "replayed"]
    assert lm["expected_launches_per_window"] == 3   # 9 tensors, tied
    assert not out["ok"]


def test_zoo_decisions_force_pools_clamps_and_dropout():
    """``ZooDecisions`` records a max pool's winners, a ReLU6's two masks
    and a dropout mask on one run and hands them to another: a float64
    run forced with them gives the fp32 run's output within rounding and
    counts no flip; forcing another run's masks changes the output."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, in_channels=2), nn.MaxPool2D(2),
            nn.HybridLambda(lambda F, x: F.clip(x, a_min=0.0, a_max=0.1)),
            nn.Dropout(0.5), nn.Flatten(), nn.Dense(3, in_units=36))
    net.initialize(ctx=cpu(), seed=0)
    x = torch.randn(2, 2, 8, 8, generator=torch.Generator().manual_seed(1))
    with autograd.train_mode():
        with chip_smoke.ZooDecisions(seed=0) as rec:
            y32 = net(x)
        with chip_smoke.ZooDecisions(rec.masks) as forced:
            y64 = net.to(torch.float64)(x.double())
        net.to(torch.float32)
        with chip_smoke.ZooDecisions(seed=5) as other:
            net(x)
        with chip_smoke.ZooDecisions(other.masks) as wrong:
            y_other = net(x)
    assert len(rec.masks) == 3 and forced.flips == 0
    torch.testing.assert_close(y64.float(), y32, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(y_other, y32) and wrong.flips == 0


def test_symbolic_builders_give_one_graph_in_either_namespace():
    """Phase 19's builders take the ``sym`` namespace: the port's and the
    JAX package's give the same graph JSON (encoder with and without its
    loss head, both attention routes, the MLP under each output layer)."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt
    kw = dict(units=64, heads=2, ffn=128)
    graphs = [
        lambda s: chip_smoke.sym_encoder(s, 2, **kw),
        lambda s: chip_smoke.sym_encoder(s, 1, head="infer", **kw),
        lambda s: s.Group(list(chip_smoke.sym_attention_routes(s, 2)))]
    graphs += [lambda s, h=h: chip_smoke.sym_mlp(s, h)
               for h in chip_smoke.HEAD_OPS]
    for build in graphs:
        assert build(mt.sym).tojson() == build(mx.sym).tojson()


def _small_symbolic(monkeypatch):
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name, value in (("SYM_UNITS", 64), ("SYM_HEADS", 2),
                        ("SYM_FFN", 128), ("SYM_SEQ", 16),
                        ("SYM_BATCH", 2), ("SYM_LAYERS", 2),
                        ("SYM_WARM", 1), ("SYM_TIMED", 1),
                        ("LM_VOCAB", 50), ("LM_EMB", 16),
                        ("LM_HIDDEN", 16), ("HEAD_SAMPLES", 128),
                        ("HEAD_HELD_OUT", 64)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_symbolic_phase_rehearses_on_the_cpu(monkeypatch, tmp_path,
                                             one_thread):
    """Phase 19 at toy widths on the CPU: every check passes but those
    only the card can meet (the flash kernel's launches): the encoder's
    Module steps and leaf check, the converted encoder within its bound of
    fp32, both attention routes, the converted LM and its checkpoint, each
    head, the 43 ops (the CPU against itself) and ``multi_all_finite``."""
    _small_symbolic(monkeypatch)
    from mxnet_tpu_torch import random as mx_random
    mx_random.seed(0)
    lm = chip_smoke.lm_module(cpu(), chip_smoke.LM_BUCKETS[-1])
    lm.init_params(initializer=Xavier())
    arg, aux = lm.get_params()
    out = chip_smoke.symbolic_phase(0, "cpu", tmp_path,
                                    {"arg": arg, "aux": aux})
    train = out["encoder_train"]
    assert sorted(k for k, v in train["checks"].items() if not v) == [
        "flash_12_per_forward", "no_flash_in_backward"]
    assert train["check"]["ok"] and train["flash_launches"] == 0
    amp = out["amp_encoder"]
    assert sorted(k for k, v in amp["checks"].items() if not v) == [
        "bf16_flash", "fp32_flash"]
    assert amp["amp_cast_nodes"] == 2 * 18 + 3
    assert amp["amp_multicast_nodes"] == 2 * 2
    routes = out["attention_routes"]
    assert routes["checks"]["within_bound"]
    assert routes["flash_launches"] == routes["interleaved_launches"] == 0
    assert out["amp_lm"]["ok"]
    assert set(out["amp_lm"]["logits_rel_l2_by_bucket"]) == set(
        chip_smoke.LM_BUCKETS)
    assert all(r["ok"] for r in out["heads"].values())
    ops = out["new_ops"]
    assert ops["ops"] == 43 and ops["failed"] == []
    finite = ops["multi_all_finite"]
    assert finite["clean"] == 1.0 and finite["with_inf"] == 0.0
    assert ops["flash_launches"] == 0     # host reads: counted on the card
    assert not out["ok"]


def test_head_step_check_flags_a_one_percent_gradient_fault(monkeypatch):
    """``held_step`` on a head's Module step: a 1 % fault in the card
    run's output-layer gradient fails the gradient and weight checks."""
    from mxnet_tpu_torch.ndarray import ops_misc
    monkeypatch.setattr(chip_smoke, "gpu", lambda i=0: cpu())
    head = "LinearRegressionOutput"
    x, y = chip_smoke.head_data(1, chip_smoke.HEAD_BATCH, head)
    mod = chip_smoke.head_module(head, cpu())
    mod.init_params(initializer=Xavier())
    arg, _ = mod.get_params()
    make = lambda ctx: chip_smoke.head_module(head, ctx)  # noqa: E731
    clean = chip_smoke.held_step(make, arg, ([x], [y]),
                                 chip_smoke.HEAD_OPT, relu=True)
    assert clean["ok"]
    real, calls = ops_misc._OutputLayer.backward, []

    def faulty(ctx, head_grad):
        grads = real(ctx, head_grad)
        calls.append(1)
        return (grads[0] * 1.01,) + grads[1:] if len(calls) == 1 \
            else grads
    monkeypatch.setattr(ops_misc._OutputLayer, "backward",
                        staticmethod(faulty))
    bad = chip_smoke.held_step(make, arg, ([x], [y]), chip_smoke.HEAD_OPT,
                               relu=True)
    assert len(calls) == 3 and not bad["ok"]
    assert not bad["grads"]["ok"] and not bad["weights"]["ok"]
