"""ShardedTrainer: data-parallel training over the process group.

Counterpart of ``mxnet_tpu/parallel/trainer.py`` (``ShardedTrainer``,
:68).  The JAX package traces the whole step, ``(params, aux, opt_state,
key, t, lr, rescale, x, y) -> (params', aux', opt_state', loss)``, as
one ``jit`` over a mesh and lets XLA insert the collectives.  Here every
rank of ``parallel.dist`` runs the same step eagerly on its shard of the
global batch, and the collectives are explicit:

- **data parallelism**: ``step(x, y)`` takes the global batch (or what
  ``shard_batch`` made of it); rank ``r`` of ``dp`` takes rows ``[r *
  B/dp, (r + 1) * B/dp)`` (of each microbatch under accumulation), runs
  forward and backward on them, and the gradients are summed over the
  ranks.  The loss differentiated is the batch's sum (MXNet's seed of
  ones); the update rescales by ``1 / batch_size``; the mean loss is
  returned, over the global batch;
- **BatchNorm over the global batch**: while the step runs, every
  ``BatchNorm`` in training mode takes the global batch's statistics
  (one all-reduce of the moments in forward, one of the two gradient sums
  in backward, on a process group of their own), as the JAX step does
  because it is one computation over the global batch; the running
  statistics move by the global statistics, once a microbatch;
- **ZeRO** (``zero_stage``, ``MXTPU_ZERO_STAGE``): at 0 the gradients are
  all-reduced and every rank updates every parameter (optimizer state
  replicated); at 1 each parameter whose dim 0 splits over ``dp``
  (``mesh.zero_sharding``) has its gradient reduce-scattered, the rank
  updates its slice of rows with its slice of the optimizer state, and
  the updated slices are all-gathered (one reduce-scatter and one
  all-gather for all of them, the rest all-reduced); at 2 the
  accumulation buffer is sharded too: under accumulation each
  microbatch's gradient is reduce-scattered at once and only the rank's
  slice is accumulated;
- **accumulation** (``accum_steps``, ``MXTPU_ACCUM_STEPS``): the global
  batch runs as N microbatches of ``B/N`` rows (each split over ``dp``),
  whose gradients add up to the full batch's;
- **communication buckets** (``comm_bucket_mb``,
  ``MXTPU_COMM_BUCKET_MB``): gradients grouped by ``mesh.comm_buckets``
  (reverse parameter order), each bucket all-reduced asynchronously from
  a hook as soon as backward has produced its last gradient (during the
  last microbatch), so the collectives overlap the rest of backward; at
  ZeRO >= 1 the rank then updates its slice of each summed gradient.
  One bucket is the fused path;
- **the non-finite guard** (``enable_nonfinite_guard``): the loss is
  scaled by the (dynamic) loss scale, the update unscales, and a step
  whose mean loss or any summed gradient is not finite leaves the
  parameters, the optimizer state and the running statistics as they
  were.  The decision reads the summed gradients, so every rank takes
  the same one.

The update runs in ``parallel.optim``'s functional optimizer: SGD in the
hand-written multi-tensor kernels (on the rank's slices under ZeRO).  The
trainer updates the block's own parameters in place, so ``sync_params``
has nothing to copy.  ``save_checkpoint``/``load_checkpoint`` use the
JAX package's host-local layout (``state-<t>/host_local.npz`` with
``p{i}``, ``a{i}``, ``s{i}`` for the optimizer state's leaves in tree
order, ``rng``, ``t`` and the guard's ``g0``/``g1``, a commit marker and
an atomic rename), so a checkpoint of either package loads in the other;
the port adds ``torch_rng``, the device generator's state.  Capturing the
step in a CUDA graph is later work.  Row-sparse gradients (ROADMAP
Queue A 3b) and the model-parallel axes (Queue A 3c) are not ported.
"""
from __future__ import annotations

import os
import re as _re
import shutil
import weakref
from typing import Callable, List, Optional, Sequence

import numpy as _np
import torch

from ..base import MXNetError, get_env
from .. import autograd as _autograd
from .. import optimizer as opt_mod
from ..context import current_context, as_device
from ..ndarray.ndarray import NDArray
from ..gluon.nn import basic_layers as _bn
from . import dist
from .mesh import (ShardingRules, axis_size, comm_buckets, default_mesh,
                   zero_sharding)
from .optim import make_functional_optimizer

__all__ = ["ShardedTrainer"]

_STEP_DIR_RE = _re.compile(r"^state-(\d+)$")
_COMMIT_MARKER = "_CHECKPOINT_METADATA"


class ShardedBatch:
    """A batch placed for the trainer (``shard_batch``): this rank's rows
    of each microbatch, in microbatch order, and the global batch size."""

    def __init__(self, local, global_size: int):
        self.local = local
        self.global_size = int(global_size)
        self.shape = (self.global_size,) + tuple(local.shape[1:])
        self.ndim = local.ndim


class ShardedTrainer:
    """Data-parallel trainer over the process group (see the module
    docstring).

    Parameters
    ----------
    block : gluon.Block, the model (run eagerly).
    loss : callable, ``loss(out, y) -> NDArray`` (a gluon loss works).
    optimizer : str or Optimizer, lowered by ``parallel.optim``.
    mesh : ``parallel.Mesh`` over the ranks, default every rank on
        ``dp``; its ``dp`` must equal the group's size.
    rules : ``ShardingRules``; a rule may not split a parameter over an
        axis above size 1 (model parallelism, ROADMAP Queue A 3c).
    data_spec / label_spec : default ``("dp",)``: the batch dimension on
        ``dp``, the only layout ported.
    zero_stage, accum_steps, comm_bucket_mb : default the
        ``MXTPU_ZERO_STAGE``, ``MXTPU_ACCUM_STEPS`` and
        ``MXTPU_COMM_BUCKET_MB`` knobs.
    guard_nonfinite, dynamic_loss_scale, ... : the non-finite guard and
        the dynamic loss scale, as ``enable_nonfinite_guard`` sets them.
    """

    def __init__(self, block, loss: Callable, optimizer,
                 optimizer_params: Optional[dict] = None, mesh=None,
                 rules: Optional[ShardingRules] = None,
                 data_spec: Sequence = ("dp",),
                 label_spec: Optional[Sequence] = None,
                 zero_stage: Optional[int] = None,
                 accum_steps: Optional[int] = None,
                 comm_bucket_mb: Optional[float] = None,
                 guard_nonfinite: bool = False,
                 dynamic_loss_scale: bool = False,
                 init_loss_scale: float = 2.0 ** 15,
                 scale_growth_interval: int = 2000,
                 scale_backoff: float = 0.5,
                 min_loss_scale: float = 1.0,
                 max_loss_scale: float = 2.0 ** 24):
        self._block = block
        self._loss = loss
        self._mesh = mesh if mesh is not None else default_mesh()
        self._rules = rules if rules is not None else ShardingRules()
        self._data_spec = tuple(data_spec)
        self._label_spec = tuple(label_spec) if label_spec is not None \
            else (self._data_spec[0],)
        for spec in (self._data_spec, self._label_spec):
            if tuple(spec[:1]) not in ((), ("dp",), (None,)) or \
                    any(e is not None for e in spec[1:]):
                raise MXNetError(
                    f"data/label spec {spec}: only the batch dimension on "
                    f"'dp' is ported (sequence parallelism: ROADMAP Queue "
                    f"A 3c)")
        self._check_mesh(self._mesh)
        if zero_stage is None:
            zero_stage = int(get_env("MXTPU_ZERO_STAGE"))
        if zero_stage not in (0, 1, 2):
            raise MXNetError(
                f"zero_stage must be 0, 1 or 2, got {zero_stage!r}")
        self._zero = int(zero_stage)
        if accum_steps is None:
            accum_steps = int(get_env("MXTPU_ACCUM_STEPS"))
        if int(accum_steps) < 1:
            raise MXNetError(
                f"accum_steps must be >= 1, got {accum_steps!r}")
        self._accum = int(accum_steps)
        if comm_bucket_mb is None:
            comm_bucket_mb = float(get_env("MXTPU_COMM_BUCKET_MB"))
        if float(comm_bucket_mb) < 0:
            raise MXNetError(
                f"comm_bucket_mb must be >= 0 (0 = one fused "
                f"reduction), got {comm_bucket_mb!r}")
        self._bucket_mb = float(comm_bucket_mb)
        self._grad_buckets = None
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._built = False
        self._t = 0
        self._guard = bool(guard_nonfinite)
        self._dyn_scale = bool(dynamic_loss_scale)
        self._init_ls = float(init_loss_scale) if dynamic_loss_scale \
            else 1.0
        self._growth_interval = int(scale_growth_interval)
        self._scale_backoff = float(scale_backoff)
        self._min_ls = float(min_loss_scale)
        self._max_ls = float(max_loss_scale)
        self._gstate = None          # [loss_scale, clean_step_count]
        self._last_finite = None

    @staticmethod
    def _check_mesh(mesh) -> None:
        if mesh.size != dist.num_workers() or \
                tuple(mesh.devices.flat) != dist.active_members():
            raise MXNetError(
                f"{mesh!r} does not lay out the process group's "
                f"{dist.num_workers()} rank(s) (one device a rank)")

    def enable_nonfinite_guard(self, dynamic_loss_scale: bool = False,
                               init_loss_scale: float = 2.0 ** 15,
                               scale_growth_interval: int = 2000,
                               scale_backoff: float = 0.5) -> None:
        """Turn on the all-finite guard (see the module docstring) before
        the first step."""
        if self._built:
            raise MXNetError("enable_nonfinite_guard() must be called "
                             "before the first step() builds the jit")
        self._guard = True
        self._dyn_scale = bool(dynamic_loss_scale)
        self._init_ls = float(init_loss_scale) if dynamic_loss_scale \
            else 1.0
        self._growth_interval = int(scale_growth_interval)
        self._scale_backoff = float(scale_backoff)

    # -- lazy build --------------------------------------------------------
    def _block_device(self) -> torch.device:
        for p in self._block.collect_params().values():
            if p._initialized:
                return p._data.device
            if p._deferred is not None:
                return p._deferred[1]
        return as_device(current_context())

    def _ensure_built(self, xs, y) -> None:
        if self._built:
            return
        self._device = self._block_device()
        # one eager forward of a row to settle deferred shapes
        with _autograd.pause():
            self._block(*[NDArray(self._to_device(_local(v)[:1]))
                          for v in xs])
        all_params = list(self._block.collect_params().values())
        self._train_params = [p for p in all_params
                              if p.grad_req != "null"]
        self._aux_params = [p for p in all_params if p.grad_req == "null"]
        self._optimizer.param_dict = dict(enumerate(self._train_params))
        self._fopt = make_functional_optimizer(
            self._optimizer, [p.name for p in self._train_params])
        self._x_ndims = tuple(v.ndim for v in xs)
        self._y_multi = isinstance(y, tuple)
        self._make_shardings()
        self._state = self._fopt.init(self._slices(
            [p._tensor().detach() for p in self._train_params]))
        self._stat_group = None
        if self._dp > 1:
            # BatchNorm's collectives run on a group of their own, so they
            # never interleave with the gradient buckets' in one queue
            self._stat_group = torch.distributed.new_group(
                backend=dist.backend())
        hooks = [p._data.register_post_accumulate_grad_hook(
            self._make_hook(i)) for i, p in enumerate(self._train_params)]
        # the hooks hold the trainer weakly and go with it
        weakref.finalize(self, _remove_hooks, hooks)
        if self._guard and self._gstate is None:
            self._gstate = [self._init_ls, 0]
        self._make_buckets()
        self._built = True

    def _make_shardings(self) -> None:
        """Every parameter's ZeRO layout from the current mesh: which ones
        split their rows over ``dp`` (``_split[i]``)."""
        mesh = self._mesh
        self._dp = axis_size(mesh, "dp")
        sizes = mesh.shape
        for p in self._train_params + self._aux_params:
            spec = self._rules.spec_for(p.name, p.shape)
            for e in spec:
                names = e if isinstance(e, (tuple, list)) else (e,)
                if any(n is not None and sizes.get(n, 1) > 1
                       for n in names):
                    raise MXNetError(
                        f"rule {tuple(spec)} splits Parameter {p.name!r} "
                        f"over a mesh axis: model parallelism is not "
                        f"ported yet (ROADMAP Queue A 3c)")
        self._split = [
            self._zero >= 1 and zero_sharding(
                mesh, self._rules.spec_for(p.name, p.shape),
                p.shape).spec[:1] == ("dp",)
            for p in self._train_params]

    def _make_buckets(self) -> None:
        cap = self._bucket_mb * 2 ** 20 if self._bucket_mb else 0
        nbytes = [p._tensor().numel() * p._tensor().element_size()
                  for p in self._train_params]
        bks = comm_buckets(nbytes, cap)
        self._grad_buckets = bks if len(bks) > 1 else None
        self._bucket_of = {}
        if self._grad_buckets is not None:
            for b, idx in enumerate(self._grad_buckets):
                for i in idx:
                    self._bucket_of[i] = b
        self._armed = False

    def _slices(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's rows of each split tensor (a view), the others
        whole."""
        r, dp = dist.rank(), self._dp
        return [t.view(dp, -1)[r].view((t.shape[0] // dp,) + t.shape[1:])
                if s else t for t, s in zip(tensors, self._split)]

    # -- the step ----------------------------------------------------------
    def _to_device(self, v) -> torch.Tensor:
        if isinstance(v, NDArray):
            v = v._data
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(_np.asarray(v))
        if v.is_floating_point():
            ref = next((p._tensor() for p in
                        self._block.collect_params().values()
                        if p._initialized and p.dtype.is_floating_point),
                       None)
            if ref is not None and v.dtype != ref.dtype and \
                    v.dtype == torch.float64:
                v = v.to(ref.dtype)
        return v.to(self._device)

    def _rows(self, v, n: int) -> torch.Tensor:
        """This rank's rows of each of ``n`` microbatches of the global
        batch ``v``, in microbatch order (a ``ShardedBatch`` holds them
        already)."""
        if isinstance(v, ShardedBatch):
            return v.local
        t = self._to_device(v)
        b = t.shape[0]
        s = b // n // self._dp
        return t.reshape((n, self._dp, s) + tuple(t.shape[1:]))[
            :, dist.rank()].reshape((n * s,) + tuple(t.shape[1:]))

    def _make_hook(self, i: int):
        ref = weakref.ref(self)

        def hook(param):
            tr = ref()
            if tr is not None and tr._armed and \
                    tr._grad_buckets is not None:
                b = tr._bucket_of[i]
                tr._ready[b].add(i)
                if len(tr._ready[b]) == len(tr._grad_buckets[b]):
                    tr._launch_bucket(b)
        return hook

    def _grad(self, i: int) -> torch.Tensor:
        """Parameter ``i``'s local gradient of the step so far: the last
        microbatch's plus what accumulated before it."""
        p = self._train_params[i]
        g = p._data.grad
        if g is None:
            g = torch.zeros_like(p._data)
        acc = self._acc[i] if self._acc is not None else None
        return g if acc is None else g + acc

    def _launch_bucket(self, b: int) -> None:
        idx = self._grad_buckets[b]
        flat = torch.cat([self._grad(i).reshape(-1) for i in idx])
        work = torch.distributed.all_reduce(flat, async_op=True) \
            if dist.is_initialized() and self._dp > 1 else None
        self._inflight[b] = (work, flat)

    def _reduce_buckets(self) -> List[torch.Tensor]:
        """Wait for every bucket (launching any whose hook did not fire,
        in bucket order) and hand out the summed gradients."""
        for b in range(len(self._grad_buckets)):
            if b not in self._inflight:
                self._launch_bucket(b)
        out: List[torch.Tensor] = [None] * len(self._train_params)
        for b, idx in enumerate(self._grad_buckets):
            work, flat = self._inflight[b]
            if work is not None:
                dist._collective("bucket all_reduce", work.wait)
            off = 0
            for i in idx:
                t = self._train_params[i]._data
                out[i] = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()
        return out

    def _reduce_fused(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum local gradients over the group after backward: split
        parameters in one reduce-scatter (rank-major layout, so each rank
        receives its rows of every one), the rest in one all-reduce.
        Returns each parameter's summed gradient (its rows only if
        split)."""
        dp = self._dp
        out: List[torch.Tensor] = [None] * len(grads)
        split = [i for i, s in enumerate(self._split) if s]
        whole = [i for i, s in enumerate(self._split) if not s]
        if split:
            buf = torch.cat([grads[i].reshape(dp, -1) for i in split],
                            dim=1).reshape(-1)
            mine = dist.reduce_scatter(buf)
            off = 0
            for i in split:
                g = grads[i]
                n = g.numel() // dp
                out[i] = mine[off:off + n].view((g.shape[0] // dp,)
                                                + g.shape[1:])
                off += n
        if whole:
            flat = torch.cat([grads[i].reshape(-1) for i in whole])
            dist.all_reduce(flat)
            off = 0
            for i in whole:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view(grads[i].shape)
                off += n
        return out

    def _gather_params(self) -> None:
        """All-gather the updated rows of every split parameter into the
        whole (one collective)."""
        split = [i for i, s in enumerate(self._split) if s]
        if not split or self._dp == 1:
            return
        ws = [self._train_params[i]._data.detach() for i in split]
        mine = torch.cat([w.view(self._dp, -1)[dist.rank()] for w in ws])
        full = dist.all_gather(mine).view(self._dp, -1)
        off = 0
        with torch.no_grad():
            for w in ws:
                n = w.numel() // self._dp
                w.view(self._dp, -1).copy_(full[:, off:off + n])
                off += n

    def _microbatch(self, xs, y, scale: float):
        """Forward and backward of this rank's rows; returns the local
        loss sum (a 0-d tensor)."""
        with _bn.global_batch_stats(self._stat_group, self._dp), \
                _autograd.record(True):
            out = self._block(*[NDArray(x) for x in xs])
            if isinstance(y, tuple):
                l_nd = self._loss(out, tuple(NDArray(v) for v in y))
            else:
                l_nd = self._loss(out, NDArray(y))
            lraw = l_nd._data if isinstance(l_nd, NDArray) else l_nd
            total = lraw.sum()
        torch.autograd.backward(total * scale if scale != 1.0 else total)
        return lraw.detach().sum().float(), lraw.numel()

    def step(self, x, y, batch_size: Optional[int] = None):
        """Run one data-parallel step; returns the mean loss over the
        global batch (an ``NDArray``).  ``x`` may be one array or a tuple
        of inputs; ``y`` one label array or a tuple of label streams."""
        xv = _to_vals(x)
        yv = _to_val(y)
        self._ensure_built(xv, yv)
        if len(xv) != len(self._x_ndims):
            raise MXNetError(
                f"step() got {len(xv)} inputs but the trainer was built "
                f"with {len(self._x_ndims)} — optional inputs must be "
                f"passed consistently from the first call")
        if isinstance(yv, tuple) != self._y_multi:
            raise MXNetError(
                "step() label structure changed: labels must keep the "
                "first call's shape")
        gsize = int(xv[0].shape[0])
        n = self._accum
        if gsize % n or (gsize // n) % self._dp:
            raise MXNetError(
                f"step() batch of {gsize} does not divide into "
                f"accum_steps={n} microbatches of whole shards over "
                f"dp={self._dp} — pad the batch or change accum_steps")
        if batch_size is None:
            batch_size = gsize
        self._t += 1
        self._optimizer.num_update = self._t
        xs = [self._rows(v, n) for v in xv]
        ys = tuple(self._rows(v, n) for v in yv) if self._y_multi \
            else self._rows(yv, n)
        mb = xs[0].shape[0] // n
        ls = self._gstate[0] if self._guard else 1.0
        aux_before = [p._tensor().detach().clone() for p in
                      self._aux_params] if self._guard else None
        tparams = [p._data for p in self._train_params]
        tdata = [t.detach() for t in tparams]
        self._acc = None
        self._inflight, self._ready = {}, {}
        if self._grad_buckets is not None:
            self._ready = {b: set() for b in range(len(self._grad_buckets))}
        sharded_acc = self._zero >= 2 and self._grad_buckets is None
        acc_slices = None
        losses, count = [], 0
        for m in range(n):
            last = m == n - 1
            self._armed = last
            sl = slice(m * mb, (m + 1) * mb)
            xm = [x[sl] for x in xs]
            ym = tuple(v[sl] for v in ys) if self._y_multi else ys[sl]
            lsum, numel = self._microbatch(xm, ym, ls)
            losses.append(lsum)
            count += numel
            if last:
                break
            local = [t.grad if t.grad is not None else torch.zeros_like(t)
                     for t in tparams]
            if sharded_acc:
                # ZeRO-2: reduce now, keep only this rank's rows
                red = self._reduce_fused(local)
                acc_slices = red if acc_slices is None else \
                    [a + r for a, r in zip(acc_slices, red)]
            elif self._acc is None:
                self._acc = [g.detach().clone() for g in local]
            else:
                for a, g in zip(self._acc, local):
                    a.add_(g)
        self._armed = False
        if self._grad_buckets is not None:
            summed = self._reduce_buckets()
            grads = self._slices(summed)
        else:
            local = [self._grad(i) for i in range(len(tparams))]
            grads = self._reduce_fused(local)
            if acc_slices is not None:
                grads = [a + g for a, g in zip(acc_slices, grads)]
        # the mean loss over the global batch: every microbatch's sum in
        # one all-reduce
        lbuf = dist.all_reduce(torch.stack(losses))
        lval = (lbuf / (count * self._dp / n)).mean() if n > 1 else \
            lbuf[0] / (count * self._dp)
        rescale = self._scale / batch_size
        finite = True
        if self._guard:
            finite = bool(torch.isfinite(lval)) and all(
                bool(torch.isfinite(g).all()) for g in grads)
            rescale = rescale / ls
        if finite:
            self._fopt.update(self._slices(tdata), grads, self._state,
                              self._t, self._optimizer.learning_rate,
                              rescale)
            self._gather_params()
        else:
            with torch.no_grad():
                for p, a in zip(self._aux_params, aux_before):
                    p._tensor().copy_(a)
        if self._guard:
            self._update_scale(finite)
            self._last_finite = finite
        for p in self._train_params:
            p.fresh = True
        self._acc = None
        self._inflight = {}
        return NDArray(lval.detach())

    def _update_scale(self, finite: bool) -> None:
        ls, good = self._gstate
        if self._dyn_scale:
            good = good + 1 if finite else 0
            grow = finite and good >= self._growth_interval
            if grow:
                ls, good = min(ls * 2.0, self._max_ls), 0
            elif not finite:
                ls = max(ls * self._scale_backoff, self._min_ls)
        else:
            good = good + 1 if finite else 0
        self._gstate = [float(_np.float32(ls)), int(good)]

    # -- public surface ----------------------------------------------------
    @property
    def mesh(self):
        return self._mesh

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def built(self) -> bool:
        """True once the first step() has built the trainer."""
        return self._built

    @property
    def num_update(self) -> int:
        """The optimizer update counter (steps taken or restored)."""
        return self._t

    @property
    def guard_enabled(self) -> bool:
        return self._guard

    @property
    def zero_stage(self) -> int:
        return self._zero

    @property
    def accum_steps(self) -> int:
        return self._accum

    @property
    def dp_size(self) -> int:
        return axis_size(self._mesh, "dp")

    @property
    def comm_bucket_mb(self) -> float:
        return self._bucket_mb

    @property
    def grad_buckets(self):
        """The bucket partition (index lists in reverse parameter order),
        or None on the fused path."""
        return None if self._grad_buckets is None \
            else [list(b) for b in self._grad_buckets]

    def set_comm_bucket_mb(self, mb: float) -> None:
        """Change the bucket cap on a live trainer; the training state is
        untouched."""
        mb = float(mb or 0.0)
        if mb < 0:
            raise MXNetError(
                f"comm_bucket_mb must be >= 0 (0 = one fused "
                f"reduction), got {mb!r}")
        if mb == self._bucket_mb:
            return
        self._bucket_mb = mb
        if self._built:
            self._make_buckets()

    def opt_state_bytes_per_device(self) -> dict:
        """Optimizer-state bytes this rank holds, ``{rank: bytes}``: the
        whole state at ZeRO 0, about ``1/dp`` of every split tensor's at
        ZeRO >= 1."""
        if not self._built:
            raise MXNetError("run at least one step() before "
                             "opt_state_bytes_per_device()")
        total = sum(t.numel() * t.element_size()
                    for t in _leaves(self._state))
        return {dist.rank(): int(total)}

    def peak_opt_state_bytes(self) -> int:
        """max over devices of :meth:`opt_state_bytes_per_device`."""
        per_dev = self.opt_state_bytes_per_device()
        return max(per_dev.values()) if per_dev else 0

    def reshard(self, mesh=None) -> None:
        """Lay the live state out again on ``mesh`` (every rank
        together); an equal mesh, or None, is a no-op.  The mesh must lay
        out the same process group (re-forms: ROADMAP Queue A 3c)."""
        unchanged = mesh is None or mesh == self._mesh
        if mesh is not None:
            self._check_mesh(mesh)
            self._mesh = mesh
        if not self._built or unchanged:
            return
        full = self._full_state()
        self._make_shardings()
        self._state = self._restate(full)

    @property
    def last_step_finite(self):
        """False when the last guarded step skipped its update; None
        before one or with the guard off."""
        return self._last_finite

    @property
    def loss_scale(self) -> float:
        """The current (dynamic) loss scale; 1.0 unless the guard runs
        with ``dynamic_loss_scale``."""
        if self._gstate is None:
            return self._init_ls if self._guard else 1.0
        return float(self._gstate[0])

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self._optimizer.set_learning_rate(lr)

    def shard_batch(self, x, y):
        """Place a batch for :meth:`step`: this rank's rows of each
        microbatch on the trainer's device, as ``ShardedBatch``es (one
        input alone, or a tuple)."""
        xv = _to_vals(x)
        yv = _to_val(y)
        self._ensure_built(xv, yv)
        n = self._accum

        def place(v):
            return ShardedBatch(self._rows(v, n), int(v.shape[0]))

        xs = tuple(place(v) for v in xv)
        ys = tuple(place(v) for v in yv) if isinstance(yv, tuple) \
            else place(yv)
        return (xs if len(xs) > 1 else xs[0], ys)

    def place_batch(self, batch):
        """Placement of one loader batch (``loader.set_device_put_fn(
        trainer.place_batch)``): an ``(x, y)`` pair through
        :meth:`shard_batch`, anything else to the default device."""
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            return self.shard_batch(batch[0], batch[1])
        from ..gluon.data.dataloader import default_device_put
        return default_device_put(batch)

    def step_state(self):
        """What a failed ``step()`` may have advanced: the update count and
        the device generator's state."""
        from ..random import generator
        return (self._t, generator(self._device_ctx()).get_state())

    @property
    def donation_consumed(self) -> bool:
        """False: the step updates in place and never gives its buffers
        away, so a failed step can always be rolled back."""
        return False

    def rollback_step(self, state) -> None:
        """Restore a :meth:`step_state` snapshot so a retry replays the
        attempt."""
        from ..random import generator
        t, gen_state = state
        self._t = t
        self._optimizer.num_update = t
        generator(self._device_ctx()).set_state(gen_state)

    def _device_ctx(self):
        from ..context import context_of
        dev = self._device if self._built else self._block_device()
        return context_of(dev)

    def forward(self, x):
        """Inference forward with the trainer's weights (the whole batch
        on this rank)."""
        xv = _to_vals(x)
        if not self._built:
            raise MXNetError("run at least one step() before forward(), or "
                             "use the block directly")
        if len(xv) != len(self._x_ndims):
            raise MXNetError(
                f"forward() got {len(xv)} inputs but the trainer was built "
                f"with {len(self._x_ndims)}")
        with _autograd.pause():
            return self._block(*[NDArray(self._to_device(_local(v)))
                                 for v in xv])

    def sync_params(self) -> None:
        """The block's parameters are the trainer's (updated in place):
        nothing to copy.  Kept for the JAX package's call sites."""

    # -- checkpoints -------------------------------------------------------
    def _full_state(self) -> list:
        """The optimizer state with every split tensor gathered whole
        (a collective)."""
        out = []
        for i, st in enumerate(self._state):
            if not self._split[i]:
                out.append(st)
                continue
            one = isinstance(st, torch.Tensor)
            leaves = [st] if one else list(st)
            full = [dist.all_gather(t.reshape(-1)).view(
                self._train_params[i]._data.shape) for t in leaves]
            out.append(full[0] if one else tuple(full))
        return out

    def _restate(self, full: list) -> list:
        """Whole state tensors cut to this rank's rows where split."""
        out = []
        r, dp = dist.rank(), self._dp
        for i, st in enumerate(full):
            if not self._split[i]:
                out.append(st)
                continue
            one = isinstance(st, torch.Tensor)
            leaves = [st] if one else list(st)
            cut = [t.reshape(dp, -1)[r].reshape(
                (t.shape[0] // dp,) + tuple(t.shape[1:])).clone()
                for t in leaves]
            out.append(cut[0] if one else tuple(cut))
        return out

    _HOST_LOCAL_NPZ = "host_local.npz"

    def save_checkpoint(self, directory: str) -> None:
        """Write the trainer's state in the host-local layout (see the
        module docstring): ``directory/state-<t>``, committed by its
        marker and an atomic rename, so an interrupted write never
        replaces the previous checkpoint.  Every rank calls it (the ZeRO
        slices are gathered) and writes its own directory."""
        if not self._built:
            raise MXNetError("run at least one step() before "
                             "save_checkpoint()")
        from ..random import generator
        directory = os.path.abspath(directory)
        state = self._full_state()
        flat = {f"p{i}": _host(p._tensor())
                for i, p in enumerate(self._train_params)}
        flat.update({f"a{i}": _host(p._tensor())
                     for i, p in enumerate(self._aux_params)})
        flat.update({f"s{i}": _host(t)
                     for i, t in enumerate(_leaves(state))})
        gen = generator(self._device_ctx())
        flat["rng"] = _np.array([0, gen.initial_seed() & 0xFFFFFFFF],
                                _np.uint32)
        flat["torch_rng"] = gen.get_state().numpy()
        flat["t"] = _np.asarray(self._t)
        if self._guard and self._gstate is not None:
            flat["g0"] = _np.float32(self._gstate[0])
            flat["g1"] = _np.int32(self._gstate[1])
        final = os.path.join(directory, f"state-{self._t:08d}")
        tmp = f"{final}.mxtpu-tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        _np.savez(os.path.join(tmp, self._HOST_LOCAL_NPZ), **flat)
        with open(os.path.join(tmp, _COMMIT_MARKER), "w") as f:
            f.write("mxtpu host-local checkpoint\n")
        if os.path.isdir(final):
            shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def wait_checkpoint(self) -> None:
        """Checkpoints are written synchronously: nothing in flight."""

    @staticmethod
    def committed_checkpoints(directory: str) -> List[str]:
        """Committed step directories under ``directory``, oldest first:
        named exactly ``state-<digits>`` and holding the commit marker."""
        if not os.path.isdir(directory):
            return []
        steps = [d for d in os.listdir(directory)
                 if _STEP_DIR_RE.match(d) and os.path.exists(
                     os.path.join(directory, d, _COMMIT_MARKER))]
        return [os.path.join(directory, d) for d in sorted(steps)]

    @staticmethod
    def latest_checkpoint(directory: str):
        """The newest committed step directory under ``directory``, or
        None."""
        steps = ShardedTrainer.committed_checkpoints(directory)
        return steps[-1] if steps else None

    def load_checkpoint(self, directory: str) -> None:
        """Restore the newest committed checkpoint under ``directory``
        (either package's host-local layout) into this built trainer."""
        if not self._built:
            raise MXNetError("build the trainer (one step on dummy data) "
                             "before load_checkpoint()")
        path = self.latest_checkpoint(directory)
        if path is None:
            raise MXNetError(f"no checkpoint under {directory!r}")
        npz = os.path.join(path, self._HOST_LOCAL_NPZ)
        if not os.path.exists(npz):
            raise MXNetError(
                f"{path!r} is not a host-local checkpoint (the JAX "
                f"package's sharded orbax layout is not read by the port)")
        from ..random import generator
        data = _np.load(npz)
        with torch.no_grad():
            for i, p in enumerate(self._train_params):
                p._tensor().copy_(_tensor_like(data[f"p{i}"], p._tensor()))
            for i, p in enumerate(self._aux_params):
                p._tensor().copy_(_tensor_like(data[f"a{i}"], p._tensor()))
        full = self._full_state()
        leaves = _leaves(full)
        loaded = [_tensor_like(data[f"s{i}"], t)
                  for i, t in enumerate(leaves)]
        self._state = self._restate(_unflatten(full, loaded))
        if "torch_rng" in data:
            generator(self._device_ctx()).set_state(
                torch.from_numpy(data["torch_rng"].copy()))
        self._t = int(data["t"])
        self._optimizer.num_update = self._t
        if "g0" in data and self._guard:
            self._gstate = [float(data["g0"]), int(data["g1"])]


def _remove_hooks(handles) -> None:
    for h in handles:
        h.remove()


def _host(t: torch.Tensor) -> _np.ndarray:
    return t.detach().cpu().numpy().copy()


def _tensor_like(arr, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_np.ascontiguousarray(arr)).to(
        device=like.device, dtype=like.dtype).reshape(like.shape)


def _leaves(state) -> List[torch.Tensor]:
    out = []
    for st in state:
        if isinstance(st, torch.Tensor):
            out.append(st)
        else:
            out.extend(st)
    return out


def _unflatten(like, leaves) -> list:
    out, k = [], 0
    for st in like:
        if isinstance(st, torch.Tensor):
            out.append(leaves[k])
            k += 1
        else:
            n = len(st)
            out.append(tuple(leaves[k:k + n]))
            k += n
    return out


def _local(v):
    return v.local if isinstance(v, ShardedBatch) else v


def _one(v):
    if isinstance(v, (NDArray, torch.Tensor, ShardedBatch)):
        return v
    return _np.asarray(v)


def _to_val(y):
    """The label side: a tuple is several label streams, a list one array
    of values (``mx.nd.array(list)``)."""
    if isinstance(y, tuple):
        return tuple(_one(v) for v in y)
    return _one(y)


def _to_vals(x):
    """One array, or a tuple or list of inputs, as a tuple."""
    xs = x if isinstance(x, (tuple, list)) else (x,)
    return tuple(_one(v) for v in xs)
