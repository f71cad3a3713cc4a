"""The port's optimizer update operators beyond SGD and Adam (18 of them)
and ``multi_sum_sq``, held against the JAX package's on the CPU with the
same numpy inputs.

Each op runs in the port on tensors (in place, the form
``gluon.Trainer`` calls) with its learning rate (and LARS's ``wd``,
LAMB's ``r1``/``r2``) as a host number and as a 0-d tensor, and in the
JAX package on 0-d arrays.  Tolerances: fp32 outputs within 1e-6 (atol)
+ 1e-6 (rtol, for FTML's ``d`` of order 1e3); on the ``mp_`` ops the
bf16 weight within one bf16 ulp (2^-8 relative) of the JAX result, the
fp32 masters and states within 1e-6.  The ``NDArray`` form follows
MXNet: states in place, the weight only through ``out=``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import nd as pnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import ops_optimizer as ops

SHAPE = (6, 5)
LR = 0.05
BF16_ULP = 2 ** -8

# name -> (input kinds, kwargs); kinds: w weight, g gradient, s signed
# state, p positive state, lr learning rate, c a positive 0-d input
CASES = {
    "nag_mom_update": ("w g s lr", {"momentum": 0.9, "wd": 0.01,
                                    "rescale_grad": 0.5,
                                    "clip_gradient": 0.4}),
    "ftrl_update": ("w g s p lr", {"lamda1": 0.02, "beta": 1.5, "wd": 0.01,
                                   "rescale_grad": 0.5}),
    "signsgd_update": ("w g lr", {"wd": 0.01, "rescale_grad": 0.5}),
    "signum_update": ("w g s lr", {"momentum": 0.9, "wd": 0.01,
                                   "wd_lh": 0.1, "clip_gradient": 0.4}),
    "rmsprop_update": ("w g p lr", {"gamma1": 0.9, "epsilon": 1e-8,
                                    "wd": 0.01, "clip_weights": 0.9}),
    "rmspropalex_update": ("w g p s s lr", {"gamma1": 0.9, "gamma2": 0.8,
                                            "wd": 0.01,
                                            "clip_gradient": 0.4}),
    "adagrad_update": ("w g p lr", {"epsilon": 1e-7, "wd": 0.01,
                                    "rescale_grad": 0.5}),
    "group_adagrad_update": ("w g p1 lr", {"epsilon": 1e-5,
                                           "rescale_grad": 0.5,
                                           "clip_gradient": 0.4}),
    "adamw_update": ("w g s p lr", {"beta1": 0.9, "beta2": 0.99,
                                    "epsilon": 1e-8, "wd": 0.01, "eta": 0.7,
                                    "rescale_grad": 0.5,
                                    "clip_gradient": 0.4}),
    "ftml_update": ("w g p p s lr", {"beta1": 0.6, "beta2": 0.999, "t": 3,
                                     "wd": 0.01, "clip_grad": 0.4}),
    "lamb_update_phase1": ("w g s p", {"beta1": 0.9, "beta2": 0.99, "t": 2,
                                       "wd": 0.01, "rescale_grad": 0.5,
                                       "clip_gradient": 0.4}),
    "lamb_update_phase2": ("w g c c lr", {"lower_bound": 0.5,
                                          "upper_bound": 3.0}),
    "lars_trust": ("w g c", {"eta": 0.002, "epsilon": 1e-8,
                             "rescale_grad": 0.5}),
}
# the JAX package's name of an op the port also calls by its short name
JAX_NAME = {"group_adagrad_update": "_contrib_group_adagrad_update",
            "adamw_update": "_contrib_adamw_update"}


def _inputs(kinds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in kinds.split():
        if k in ("w", "g", "s"):
            out.append(rng.standard_normal(SHAPE, dtype=np.float32))
        elif k == "p":
            out.append(rng.uniform(0.5, 2.0, SHAPE).astype(np.float32))
        elif k == "p1":                      # one history value per row
            out.append(rng.uniform(0.5, 2.0, (SHAPE[0], 1))
                       .astype(np.float32))
        elif k == "lr":
            out.append(np.float32(LR))
        else:
            out.append(np.float32(rng.uniform(0.5, 2.0)))
    return out


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               err_msg=err_msg)


@pytest.mark.parametrize("scalar_as", ["number", "tensor"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name, scalar_as):
    kinds, kw = CASES[name]
    arrays = _inputs(kinds, seed=sorted(CASES).index(name))
    want = getattr(mx.nd, JAX_NAME.get(name, name))(
        *[mx.nd.array(a) for a in arrays], **kw)
    want = want if isinstance(want, (list, tuple)) else [want]
    args = [torch.from_numpy(np.array(a)) if a.ndim or scalar_as ==
            "tensor" else float(a) for a in arrays]
    got = getattr(ops, name)(*args, **kw)
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.numpy(), b.asnumpy(), f"{name} output {i}")
    if ops.__dict__[name].updates_weight:
        assert got[0] is args[0]                       # in place


def test_multi_lars_and_multi_sum_sq_match_jax():
    rng = np.random.default_rng(20)
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in [(3, 4), (7,), (2, 2, 2)]]
    want = mx.nd.multi_sum_sq(*[mx.nd.array(a) for a in arrays],
                              num_arrays=3)
    got = ops.multi_sum_sq(*[torch.from_numpy(a) for a in arrays],
                           num_arrays=3)
    _close(got.numpy(), want.asnumpy())
    with pytest.raises(MXNetError, match="num_arrays"):
        ops.multi_sum_sq(torch.ones(2), num_arrays=2)
    lrs = np.array([0.1, 0.2, 0.3], np.float32)
    wds = np.array([0.0, 1e-3, 1e-2], np.float32)
    gsq = np.array([1.0, 0.0, 4.0], np.float32)        # a zero norm: 1
    kw = {"eta": 0.002, "eps": 1e-8, "rescale_grad": 0.5}
    want = mx.nd.multi_lars(*[mx.nd.array(a) for a in
                              (lrs, want.asnumpy(), gsq, wds)], **kw)
    got = ops.multi_lars(*[torch.from_numpy(a) for a in (lrs, got.numpy(),
                                                         gsq, wds)], **kw)
    _close(got.numpy(), want.asnumpy())
    assert got[1].item() == pytest.approx(0.2)


MP_CASES = {
    "mp_nag_mom_update": ("s", {"momentum": 0.9, "wd": 0.01,
                                "rescale_grad": 0.5}),
    "mp_adamw_update": ("s p", {"beta1": 0.9, "beta2": 0.99, "wd": 0.01,
                                "eta": 0.7, "clip_gradient": 0.4}),
}


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _jax_bf16(t):
    return mx.nd.array(t.float().numpy()).astype("bfloat16")


def _bf16_close(got, want, err_msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               want.astype("float32").asnumpy(),
                               rtol=BF16_ULP, atol=1e-6, err_msg=err_msg)


@pytest.mark.parametrize("name", sorted(MP_CASES))
def test_mp_op_matches_jax(name):
    kinds, kw = MP_CASES[name]
    rng = np.random.default_rng(30)
    w, g = (rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(2))
    states = _inputs(kinds, seed=31)
    w16, g16 = _bf16(w), _bf16(g)
    w32 = w16.float()
    jax_name = {"mp_adamw_update": "_contrib_mp_adamw_update"}.get(name,
                                                                   name)
    want = getattr(mx.nd, jax_name)(
        _jax_bf16(w16), _jax_bf16(g16), *[mx.nd.array(s) for s in states],
        mx.nd.array(w32.numpy().copy()), mx.nd.array(np.float32(LR)), **kw)
    got = getattr(ops, name)(w16, g16, *[torch.from_numpy(s.copy())
                                         for s in states], w32, LR, **kw)
    assert got[0] is w16 and got[0].dtype == torch.bfloat16
    _bf16_close(got[0], want[0], name)
    for i, (a, b) in enumerate(zip(got[1:], want[1:]), 1):
        _close(a.numpy(), b.asnumpy(), f"{name} output {i}")
    assert torch.equal(got[0], got[-1].bfloat16())     # the master rounded


def test_mp_lamb_phases_match_jax():
    rng = np.random.default_rng(40)
    w, g = (rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(2))
    m = rng.standard_normal(SHAPE, dtype=np.float32)
    v = rng.uniform(0.5, 2.0, SHAPE).astype(np.float32)
    w16, g16 = _bf16(w), _bf16(g)
    w32 = w16.float()
    kw = {"beta1": 0.9, "beta2": 0.99, "t": 2, "wd": 0.01}
    jm, jv, jw32 = (mx.nd.array(a.copy()) for a in (m, v, w32.numpy()))
    jd = mx.nd.mp_lamb_update_phase1(_jax_bf16(w16), _jax_bf16(g16), jm, jv,
                                     jw32, **kw)
    pm, pv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    d, m_out, v_out = ops.mp_lamb_update_phase1(w16, g16, pm, pv, w32, **kw)
    assert d.dtype == torch.float32 and m_out is pm and v_out is pv
    for a, b in zip((d, pm, pv), jd):
        _close(a.numpy(), b.asnumpy())
    r1, r2 = ops._norm32(w32), ops._norm32(d)
    jw = mx.nd.mp_lamb_update_phase2(
        _jax_bf16(w16), jd[0], mx.nd.array(r1.numpy().copy()),
        mx.nd.array(r2.numpy().copy()), jw32, mx.nd.array(np.float32(LR)),
        lower_bound=0.5)
    jw[0].wait_to_read()
    got = ops.mp_lamb_update_phase2(w16, d, r1, r2, w32, LR,
                                    lower_bound=0.5)
    assert got[0] is w16 and got[1] is w32
    _bf16_close(w16, jw[0])
    _close(w32.numpy(), jw[1].asnumpy())
    assert torch.equal(w16, w32.bfloat16())


def test_ndarray_form_updates_states_in_place_and_weight_through_out():
    rng = np.random.default_rng(50)
    w, g, m = (rng.standard_normal(SHAPE, dtype=np.float32)
               for _ in range(3))
    ref = [torch.from_numpy(a.copy()) for a in (w, g, m)]
    ops.nag_mom_update(*ref, LR, momentum=0.9)
    nw, ng, nm = (pnd.array(a, ctx="cpu") for a in (w, g, m))
    new = pnd.nag_mom_update(nw, ng, nm, pnd.array(np.float32(LR),
                                                   ctx="cpu"), momentum=0.9)
    np.testing.assert_array_equal(nw.asnumpy(), w)     # weight untouched
    np.testing.assert_array_equal(new.asnumpy(), ref[0].numpy())
    np.testing.assert_array_equal(nm.asnumpy(), ref[2].numpy())
    nw2, nm2 = pnd.array(w, ctx="cpu"), pnd.array(m, ctx="cpu")
    out = pnd.nag_mom_update(nw2, ng, nm2, LR, momentum=0.9, out=nw2)
    assert out is nw2
    np.testing.assert_array_equal(nw2.asnumpy(), ref[0].numpy())
    # LAMB's first phase returns the direction; its moments move in place
    nv = pnd.array(np.abs(m), ctx="cpu")
    d = pnd.lamb_update_phase1(pnd.array(w, ctx="cpu"), ng,
                               pnd.array(m, ctx="cpu"), nv, t=1)
    assert d.shape == SHAPE and not np.array_equal(nv.asnumpy(), np.abs(m))


def test_registry_names_match_the_jax_package():
    """174 ops (161, and the 13 ``_image_*`` ops of ``nd.image``); each new
    one under the JAX package's name and aliases, callable through the
    registry with MXNet's NDArray convention."""
    new = ["nag_mom_update", "mp_nag_mom_update", "ftrl_update",
           "signsgd_update", "signum_update", "rmsprop_update",
           "rmspropalex_update", "adagrad_update",
           "_contrib_group_adagrad_update", "_contrib_adamw_update",
           "_contrib_mp_adamw_update", "lars_trust", "multi_lars",
           "ftml_update", "lamb_update_phase1", "lamb_update_phase2",
           "mp_lamb_update_phase1", "mp_lamb_update_phase2",
           "multi_sum_sq"]
    ours, theirs = set(pnd.list_ops()), set(mx.nd.list_ops())
    assert len(ours) == 174 and set(new) <= ours and ours <= theirs
    for alias in ("group_adagrad_update", "adamw_update", "mp_adamw_update"):
        assert pnd.get_op(alias) is pnd.get_op("_contrib_" + alias)
        assert getattr(pnd.contrib, alias) is getattr(pnd, alias)
    from mxnet_tpu_torch.ndarray.register import invoke_by_name
    w, g = (pnd.array(np.ones(4, np.float32), ctx="cpu") for _ in range(2))
    new_w = invoke_by_name("signsgd_update", [w, g, pnd.array(
        np.float32(0.5), ctx="cpu")], {})
    np.testing.assert_array_equal(w.asnumpy(), np.ones(4))
    np.testing.assert_array_equal(new_w.asnumpy(), np.full(4, 0.5))


def test_device_scalar_is_not_read_back(monkeypatch):
    """A tensor learning rate (LARS's ``lr * trust``) enters the SGD ops
    as a tensor: the update equals the host-number one and reads nothing
    back (``item``, ``float`` and ``tolist`` of a tensor raise here)."""
    rng = np.random.default_rng(60)
    w, g, m = (rng.standard_normal(SHAPE, dtype=np.float32)
               for _ in range(3))
    want = [torch.from_numpy(a.copy()) for a in (w, g, m)]
    ops.sgd_mom_update(*want, LR, momentum=0.9, wd=0.01)
    got = [torch.from_numpy(a.copy()) for a in (w, g, m)]

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was read back")
    for attr in ("item", "__float__", "tolist"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    ops.sgd_mom_update(*got, torch.tensor(LR), momentum=0.9, wd=0.01)
    trust = ops.lars_trust(got[0], got[1], 0.01)
    ops.sgd_update(got[0].clone(), got[1], LR * trust)
    monkeypatch.undo()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
