"""``mxnet_tpu_torch.rtc`` without a card: signature parsing, the argument
checks that run before any driver call, the refusals (no NVRTC or card,
Pallas), and the JAX package's Pallas ``rtc`` kernels against the plain
versions that ``chip_smoke.py`` holds the CUDA kernels against (exact:
one addition or doubling).  The kernels themselves run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu, gpu
from mxnet_tpu_torch.kernels import _nvrtc

import chip_smoke


@pytest.mark.parametrize("sig,want", [
    ("const float *x, float* y, const int n",
     [("float", True), ("float", True), ("int", False)]),
    ("float*, int", [("float", True), ("int", False)]),
    ("__half *h, int64_t k, uint8_t *u, int8_t c, char *s, double d, "
     "int32_t i", [("__half", True), ("int64_t", False), ("uint8_t", True),
                   ("int8_t", False), ("char", True), ("double", False),
                   ("int32_t", False)]),
    ("  ", []),
])
def test_signature_accepts_upstream_forms(sig, want):
    args = rtc.parse_signature(sig)
    assert [(a.ctype, a.is_tensor) for a in args] == want
    dtypes = {"float": torch.float32, "int": torch.int32,
              "__half": torch.float16, "int64_t": torch.int64,
              "uint8_t": torch.uint8, "int8_t": torch.int8,
              "char": torch.int8, "double": torch.float64,
              "int32_t": torch.int32}
    assert [a.dtype for a in args] == [dtypes[c] for c, _ in want]


@pytest.mark.parametrize("sig", [
    "float **x", "unsigned int n", "const", "float &x", "bfloat16 *x",
    "size_t n", "float x y", "const const float x", "float *x,",
    "std::int64_t n",
])
def test_signature_rejects_other_forms(sig):
    with pytest.raises(MXNetError):
        rtc.parse_signature(sig)


class _NoDriver:
    """A module that fails the test if a launch reaches it."""

    def _function(self, symbol, device):
        raise AssertionError("a driver call before the argument checks")


@pytest.fixture
def kernel(monkeypatch):
    for name in ("launch", "get_function", "load_module",
                 "set_max_dynamic_shared"):
        monkeypatch.setattr(_nvrtc, name, _NoDriver()._function)
    return rtc.CudaKernel(_NoDriver(), "k", "k", rtc.parse_signature(
        "const float *x, float *y, int n, __half h"))


def _cuda_meta(*shape, dtype=torch.float32):
    """A tensor that is not on cuda:0 (the sandbox has no card)."""
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", [
    "cpu_ctx", "arg_count", "cpu_tensor", "wrong_dtype", "scalar_for_tensor",
    "tensor_for_scalar", "float_for_int", "int_out_of_range", "grid_dims",
    "block_dims", "negative_shared_mem",
])
def test_launch_checks_arguments_before_any_driver_call(kernel, case):
    x = torch.zeros(4)
    y = torch.zeros(4)
    ctx = gpu(0)
    args = [x, y, 4, 1.0]
    grid, block, smem = (1, 1, 1), (32, 1, 1), 0
    if case == "cpu_ctx":
        ctx = cpu()
    elif case == "arg_count":
        args = args[:3]
    elif case == "wrong_dtype":
        args[0] = x.double()
    elif case == "scalar_for_tensor":
        args[1] = 2.0
    elif case == "tensor_for_scalar":
        args[2] = torch.tensor(4)
    elif case == "float_for_int":
        args[2] = 4.5
    elif case == "int_out_of_range":
        args[2] = 2 ** 31
    elif case == "grid_dims":
        grid = (1, 1)
    elif case == "block_dims":
        block = (0, 1, 1)
    elif case == "negative_shared_mem":
        smem = -1
    before = rtc.launches
    with pytest.raises(MXNetError):
        kernel.launch(args, ctx, grid, block, smem)
    assert kernel.launches == 0 and rtc.launches == before


def test_launch_refuses_tensors_off_the_launch_device(kernel):
    """On this machine every tensor is off cuda:0: a CPU tensor, and one
    on the meta device, are both refused."""
    for t in (torch.zeros(4), _cuda_meta(4)):
        with pytest.raises(MXNetError, match="is on"):
            kernel.launch([t, t, 4, 1.0], gpu(0), (1, 1, 1), (32, 1, 1))


def test_scalar_storage_has_the_c_type():
    args = rtc.parse_signature("int64_t a, __half h, uint8_t u, double d")
    stored = [rtc._scalar(a, v, i) for i, (a, v) in
              enumerate(zip(args, [2 ** 40, 1.5, 255, 0.1]))]
    assert stored[0].value == 2 ** 40
    assert stored[1].value == int(np.float16(1.5).view(np.uint16))
    assert stored[2].value == 255 and stored[3].value == 0.1
    with pytest.raises(MXNetError):
        rtc._scalar(args[2], 256, 2)


def test_cuda_module_raises_without_a_card(monkeypatch):
    """No CPU fallback: a module compiled by NVRTC still needs a card."""
    monkeypatch.setattr(_nvrtc, "compile_program",
                        lambda *args: (b"", {}, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        rtc.CudaModule(chip_smoke.ELEMENTWISE_SRC)


def test_nvrtc_not_found_names_where_it_looked(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvrtc, "_nvrtc_dirs", lambda: [tmp_path])
    monkeypatch.setattr(_nvrtc, "_libs", {})
    monkeypatch.setattr(_nvrtc.ctypes, "CDLL", _raise_oserror)
    with pytest.raises(MXNetError, match="NVRTC not found"):
        _nvrtc.compile_program(chip_smoke.ELEMENTWISE_SRC)


def _raise_oserror(*args, **kwargs):
    raise OSError("not here")


def test_unload_is_skipped_before_the_driver_is_loaded(monkeypatch):
    monkeypatch.setattr(_nvrtc, "_libs", {})
    _nvrtc.unload_module(1234, 0)          # no driver: nothing to unload


@pytest.mark.parametrize("cls", [rtc.PallasModule, rtc.PallasKernel])
def test_pallas_names_point_to_cuda_module(cls):
    with pytest.raises(MXNetError, match="CudaModule"):
        cls()


def test_jax_pallas_kernels_equal_the_plain_versions():
    """tests/test_aux.py's add_one (fp32) and twice (int32) through the
    JAX package's PallasModule, against chip_smoke's plain versions of
    the CUDA kernels on the same inputs."""
    from mxnet_tpu import rtc as jrtc

    def add_one_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    def twice_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2

    mod = jrtc.PallasModule()
    xf = np.arange(8, dtype=np.float32).reshape(2, 4)
    xi = np.arange(6, dtype=np.int32).reshape(2, 3)
    jf = mod.add_kernel("add_one", add_one_kernel).launch(
        [mx.nd.array(xf)]).asnumpy()
    ji = mod.add_kernel("twice", twice_kernel).launch(
        [mx.nd.array(xi, dtype="int32")]).asnumpy()
    pf = chip_smoke.add_one_plain(torch.from_numpy(xf)).numpy()
    pi = chip_smoke.twice_plain(torch.from_numpy(xi)).numpy()
    assert pi.dtype == ji.dtype == np.int32
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pi, ji)


def test_plain_versions_of_the_other_user_kernels():
    x = torch.arange(12, dtype=torch.float32)
    assert chip_smoke.smem_reverse_plain(x, 4).tolist() == \
        [3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8]
    assert chip_smoke.axpy_plain(2.0, x, x).tolist() == (3 * x).tolist()
