"""Multi-process runtime over ``torch.distributed``.

Counterpart of ``mxnet_tpu/parallel/dist.py``.  Processes are wired up
from the launcher's ``DMLC_*`` environment, as ps-lite's were and as the
JAX package reads it:

- ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT``: the coordinator's address
  (rank 0 serves the process group's ``TCPStore`` there);
- ``DMLC_NUM_WORKER``: the number of worker processes;
- ``DMLC_WORKER_ID``: this process's rank.

The ``TCPStore`` plays the JAX coordination service: the barrier, the
key-value publish/collect and the narrowed group's gathers go through it.
The data collectives go through the process group, whose backend is
chosen once at the join and recorded (:func:`backend`):

- **NCCL** when every rank of this host has a card of its own
  (``torch.cuda.device_count()`` at least the host's ranks,
  ``LOCAL_WORLD_SIZE`` or else every rank); rank ``r`` works on card
  ``r % device_count``.  A failed NCCL join raises; it never turns into
  gloo.
- **gloo** otherwise: on the CPU, and for ranks that share a card.  Gloo
  runs ``all_reduce`` and ``broadcast`` on CUDA tensors, and nothing
  else, so the reduce-scatter and the all-gather of the data plane
  (:func:`reduce_scatter`, :func:`all_gather`) are built from one
  ``all_reduce`` each under gloo (each rank adds its slice into zeros;
  ``x + 0`` is exact, so the gather is exact), and the host collectives
  (numpy in and out) run on CPU tensors.

Every entry point is a collective: every rank calls it, in the same
order, or none does.  Each carries a deadline (``MXTPU_DIST_TIMEOUT``,
the process group's own timeout for the data collectives): a peer that
never arrives raises :class:`~mxnet_tpu_torch.faults.DeadlineExceeded`
instead of hanging the job, and a peer that died ends the collective at
once with gloo's error.  ``kv_publish``/``kv_collect`` are not
collectives: each rank publishes and reads at its own pace.

A world of one joins nothing, as in the JAX package: the collectives
then answer for this process alone.  ``dist_async`` has no counterpart
(synchronous data parallelism replaces stale parameter-server updates),
and elastic groups (host loss, re-forms) are not ported: ``elastic=True``
raises.  ``set_active_members`` keeps the JAX package's bookkeeping of a
narrowed group, whose gathers and barriers then go over the store.
"""
from __future__ import annotations

import datetime
import io
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError, get_env

__all__ = ["init_process_group", "is_initialized", "rank", "num_workers",
           "phys_rank", "active_members", "fence_generation",
           "set_active_members", "reset_active_members",
           "allreduce_host", "allgather_host", "allgather_bytes",
           "allgather_rows", "dedup_sum_rows",
           "reduce_scatter_host", "broadcast_host", "barrier",
           "kv_publish", "kv_collect", "kv_purge_rank", "backend",
           "rank_device", "shutdown"]

_ELASTIC_MSG = ("elastic process groups (host loss and fleet re-forms) are "
                "not ported yet: ROADMAP Queue A 3c")

_state_lock = threading.Lock()
_backend: Optional[str] = None
_store = None
_device: Optional[torch.device] = None
_timeout = 300.0


def is_initialized() -> bool:
    """True if this process has joined a multi-process group."""
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def backend() -> Optional[str]:
    """The backend chosen at the join (``"nccl"`` or ``"gloo"``), None
    before one."""
    return _backend


def rank_device() -> torch.device:
    """The device this rank works on: its card under NCCL, card
    ``rank % device_count`` under gloo when CUDA is there (ranks may share
    it), else the CPU."""
    if _device is not None:
        return _device
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def _choose_backend(num_processes: int) -> str:
    """NCCL when every rank of this host has a card of its own, else
    gloo."""
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def init_process_group(coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       timeout: Optional[float] = None,
                       retries: int = 2,
                       backoff: float = 1.0,
                       elastic: Optional[bool] = None) -> None:
    """Join the multi-process group (idempotent).

    Arguments default to the launcher's ``DMLC_*`` variables; a world of
    one joins nothing.  Each join attempt waits at most ``timeout``
    seconds (default ``MXTPU_DIST_TIMEOUT``) and is retried up to
    ``retries`` times with exponential backoff from ``backoff`` seconds
    (under a launcher the coordinator may come up after the workers).
    The last failure is an :class:`MXNetError` naming the coordinator and
    the rank.  ``elastic`` (default ``MXTPU_ELASTIC``) raises: elastic
    groups are not ported."""
    if is_initialized():
        return
    if coordinator is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9099")
        coordinator = f"{uri}:{port}" if uri else None
    if num_processes is None:
        nw = os.environ.get("DMLC_NUM_WORKER")
        num_processes = int(nw) if nw else None
    if process_id is None:
        wid = os.environ.get("DMLC_WORKER_ID")
        process_id = int(wid) if wid else None
    if elastic is None:
        elastic = bool(get_env("MXTPU_ELASTIC"))
    if elastic:
        raise MXNetError(_ELASTIC_MSG)
    if num_processes == 1:
        return  # single worker: nothing to join
    if coordinator is None or num_processes is None or process_id is None:
        missing = []
        if coordinator is None:
            missing.append("DMLC_PS_ROOT_URI (+ optional DMLC_PS_ROOT_PORT)")
        if num_processes is None:
            missing.append("DMLC_NUM_WORKER")
        if process_id is None:
            missing.append("DMLC_WORKER_ID")
        raise MXNetError(
            "multi-process kvstore requires the process group to be "
            "initialized, but these launcher env vars are unset: "
            + ", ".join(missing) +
            " — set them (reference launcher env vars) or call "
            "mxnet_tpu_torch.parallel.dist.init_process_group(coordinator, "
            "num_processes, process_id) before kv.create('dist_sync')")
    if timeout is None:
        timeout = float(get_env("MXTPU_DIST_TIMEOUT"))
    _join(coordinator, int(num_processes), int(process_id),
          _choose_backend(int(num_processes)), timeout, retries, backoff)


def _join(coordinator: str, world: int, me: int, backend_name: str,
          timeout: float, retries: int = 0, backoff: float = 1.0) -> None:
    """Join ``world`` ranks as rank ``me`` over ``backend_name``, rank 0
    serving the store at ``coordinator`` (``host:port``)."""
    global _backend, _store, _device, _timeout
    from ..faults import retry_call
    from ..observability.registry import registry as _metrics_registry
    host, _, port = coordinator.rpartition(":")
    delta = datetime.timedelta(seconds=max(1.0, timeout))
    if backend_name == "nccl":
        device = torch.device("cuda", me % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif torch.cuda.is_available():
        device = torch.device("cuda", me % torch.cuda.device_count())
    else:
        device = torch.device("cpu")

    def attempt():
        store = torch.distributed.TCPStore(
            host or "127.0.0.1", int(port), world, is_master=(me == 0),
            timeout=delta)
        torch.distributed.init_process_group(
            backend_name, store=store, rank=me, world_size=world,
            timeout=delta,
            **({"device_id": device} if backend_name == "nccl" else {}))
        return store

    def _count_retry(attempt_no, exc, delay):
        _metrics_registry().counter("dist.init_retries").inc()

    try:
        store = retry_call(attempt, retries=retries, base_delay=backoff,
                           max_delay=30.0,
                           retry_on=(RuntimeError, ConnectionError,
                                     TimeoutError, OSError),
                           on_retry=_count_retry)
    except Exception as exc:
        raise MXNetError(
            f"could not join the process group at {coordinator!r} as rank "
            f"{me}/{world} over {backend_name} after {retries + 1} "
            f"attempt(s) ({timeout:.0f}s connect timeout each): "
            f"{exc}") from exc
    with _state_lock:
        _backend, _store, _device, _timeout = \
            backend_name, store, device, float(timeout)


def shutdown() -> None:
    """Leave the process group (every rank together)."""
    global _backend, _store, _device
    if is_initialized():
        torch.distributed.destroy_process_group()
    with _state_lock:
        _backend, _store, _device = None, None, None
    reset_active_members()


# -- the active process group (the narrowed group's bookkeeping) -----------

_group_lock = threading.Lock()
_members: Optional[Tuple[int, ...]] = None   # original ids, sorted; None =
_fence = 0                                   # the full launcher world


def phys_rank() -> int:
    """This process's rank at the join: stable when a group is narrowed
    (logical :func:`rank` is not)."""
    return torch.distributed.get_rank() if is_initialized() else 0


def rank() -> int:
    """Logical rank: contiguous in the active member set, equal to
    :func:`phys_rank` until :func:`set_active_members` narrows the
    group."""
    with _group_lock:
        members = _members
    if members is None:
        return phys_rank()
    return members.index(phys_rank())


def num_workers() -> int:
    """Logical world size: the active member count."""
    with _group_lock:
        members = _members
    if members is None:
        return torch.distributed.get_world_size() if is_initialized() \
            else 1
    return len(members)


def active_members() -> Tuple[int, ...]:
    """The original ranks of the active group, sorted (logical rank r is
    ``active_members()[r]``)."""
    with _group_lock:
        members = _members
    if members is not None:
        return members
    return tuple(range(torch.distributed.get_world_size()
                       if is_initialized() else 1))


def fence_generation() -> int:
    """The fencing generation, bumped by every narrowing: store keys of
    an older generation belong to a fenced-out incarnation."""
    with _group_lock:
        return _fence


def set_active_members(members, fence: int) -> None:
    """Install a narrowed group (every survivor calls this with the same
    member set); ``members`` are original ranks and must hold this
    process."""
    global _members, _fence
    members = tuple(sorted(int(m) for m in members))
    if not members:
        raise MXNetError("set_active_members: empty member set")
    me = phys_rank()
    if me not in members:
        raise MXNetError(
            f"set_active_members: this process (id {me}) is not in the "
            f"re-formed member set {members} — it has been fenced out "
            f"and must exit, not install the group")
    with _group_lock:
        _members = members
        _fence = int(fence)


def reset_active_members() -> None:
    """Drop the narrowed group (back to the full launcher world)."""
    global _members, _fence
    with _group_lock:
        _members = None
        _fence = 0


def _narrowed() -> bool:
    with _group_lock:
        return _members is not None


def _deadline_error(what: str, exc: BaseException):
    """Turn a collective's or a store wait's timeout into the typed
    ``DeadlineExceeded``; other errors pass through."""
    from ..faults import DeadlineExceeded
    text = str(exc).lower()
    if isinstance(exc, TimeoutError) or "timed out" in text or \
            "timeout" in text or "deadline" in text:
        return DeadlineExceeded(
            f"{what} timed out after {_timeout:.1f}s (MXTPU_DIST_TIMEOUT) "
            f"— a peer never arrived")
    return exc


def _collective(what: str, fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as exc:   # noqa: BLE001 — re-raised, typed if a timeout
        err = _deadline_error(what, exc)
        if err is exc:
            raise
        raise err from exc


# -- data-plane collectives on tensors --------------------------------------


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group, in place, on its device (NCCL, or gloo
    on CPU and CUDA tensors alike); every rank receives the same sum."""
    if is_initialized():
        _collective("all_reduce", torch.distributed.all_reduce, t,
                    group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` onto every rank, in place."""
    if is_initialized():
        _collective("broadcast", torch.distributed.broadcast, t, src,
                    group=group)
    return t


def reduce_scatter(flat: torch.Tensor) -> torch.Tensor:
    """Sum the 1-d ``flat`` over the group and return this rank's
    ``1/num_workers`` slice (its length must divide).  NCCL runs its
    reduce-scatter; gloo an ``all_reduce`` of the whole buffer."""
    n = num_workers()
    if not is_initialized() or n == 1:
        return flat
    chunk = flat.numel() // n
    if _backend == "nccl":
        out = torch.empty(chunk, dtype=flat.dtype, device=flat.device)
        _collective("reduce_scatter",
                    torch.distributed.reduce_scatter_tensor, out,
                    flat.contiguous())
        return out
    total = all_reduce(flat.clone())
    r = rank()
    return total[r * chunk:(r + 1) * chunk]


def all_gather(piece: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's 1-d ``piece`` (equal lengths) in rank
    order.  NCCL runs its all-gather; gloo an ``all_reduce`` of a zero
    buffer into which each rank writes its piece (exact)."""
    n = num_workers()
    if not is_initialized() or n == 1:
        return piece
    m = piece.numel()
    if _backend == "nccl":
        out = torch.empty(m * n, dtype=piece.dtype, device=piece.device)
        _collective("all_gather",
                    torch.distributed.all_gather_into_tensor, out,
                    piece.contiguous())
        return out
    out = torch.zeros(m * n, dtype=piece.dtype, device=piece.device)
    r = rank()
    out[r * m:(r + 1) * m] = piece
    return all_reduce(out)


# -- host collectives (numpy in, numpy out) ---------------------------------


def _host_device() -> torch.device:
    return rank_device() if _backend == "nccl" else torch.device("cpu")


def allgather_host(x):
    """Gather each process's numpy array (equal shapes); returns an array
    with a leading ``num_workers`` axis, this process's slot included."""
    arr = np.ascontiguousarray(np.asarray(x))
    if not is_initialized():
        return arr[None]
    if _narrowed():
        return _gather_arrays_kv(arr)
    t = torch.from_numpy(arr.copy()).to(_host_device())
    outs = [torch.empty_like(t) for _ in range(num_workers())]
    _collective("allgather_host", torch.distributed.all_gather, outs, t)
    return np.stack([o.cpu().numpy() for o in outs])


def allreduce_host(x):
    """Sum a numpy array across all processes (in rank order, so every
    rank gets the same bits)."""
    return np.sum(allgather_host(x), axis=0)


def reduce_scatter_host(x):
    """Sum a numpy array across all processes and return this rank's
    ``1/num_workers`` slice along dim 0 (which must divide)."""
    if not is_initialized():
        return np.asarray(x)
    total = allreduce_host(x)
    n = num_workers()
    if total.shape[0] % n:
        raise MXNetError(
            f"reduce_scatter_host: dim 0 of {total.shape} does not "
            f"divide by the world size {n}")
    chunk = total.shape[0] // n
    r = rank()
    return total[r * chunk:(r + 1) * chunk]


def broadcast_host(x):
    """Broadcast rank 0's numpy array to all processes (equal shapes)."""
    arr = np.ascontiguousarray(np.asarray(x))
    if not is_initialized():
        return arr
    if _narrowed():
        return _gather_arrays_kv(arr)[0]
    t = torch.from_numpy(arr.copy()).to(_host_device())
    broadcast(t, 0)
    return t.cpu().numpy()


def allgather_bytes(data: bytes, timeout: Optional[float] = None):
    """Gather one variable-length byte payload from every process; a list
    of ``num_workers`` byte strings indexed by rank (one element without a
    process group).  The lengths are gathered first, then the payloads
    padded to the longest."""
    data = bytes(data)
    if not is_initialized():
        return [data]
    if _narrowed():
        return _allgather_bytes_kv(data, timeout)
    sizes = allgather_host(np.asarray([len(data)], np.int64))[:, 0]
    cap = int(sizes.max())
    if cap == 0:
        return [b""] * len(sizes)
    buf = np.zeros((cap,), np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    gathered = allgather_host(buf)
    return [gathered[i, :int(sizes[i])].tobytes() for i in range(len(sizes))]


def allgather_rows(ids, rows, timeout: Optional[float] = None):
    """Gather one ``(ids, rows)`` row-sparse slab from every process; a
    list of ``num_workers`` ``(ids, rows)`` numpy pairs indexed by rank
    (slabs may differ in length).  Counts the payload in the
    ``sparse.exchange_bytes`` counter."""
    from ..observability.registry import registry as _registry
    ids = np.ascontiguousarray(np.asarray(ids))
    rows = np.ascontiguousarray(np.asarray(rows))
    if ids.shape[0] != rows.shape[0]:
        raise MXNetError(
            f"allgather_rows: {ids.shape[0]} ids vs {rows.shape[0]} rows")
    buf = io.BytesIO()
    np.savez(buf, ids=ids, rows=rows)
    payload = buf.getvalue()
    _registry().counter(
        "sparse.exchange_bytes",
        "bytes of (ids, rows) row-sparse gradient payload "
        "exchanged instead of dense table reductions").inc(len(payload))
    out = []
    for blob in allgather_bytes(payload, timeout=timeout):
        z = np.load(io.BytesIO(blob))
        out.append((z["ids"], z["rows"]))
    return out


def dedup_sum_rows(pairs):
    """Reduce :func:`allgather_rows` output: union the id sets and sum the
    rows that collide; one ``(ids, rows)`` pair with ids sorted unique."""
    pairs = [p for p in pairs if p[0].size]
    if not pairs:
        return np.zeros((0,), np.int64), np.zeros((0, 0), np.float32)
    all_ids = np.concatenate([p[0] for p in pairs])
    all_rows = np.concatenate([p[1] for p in pairs], axis=0)
    uids, inv = np.unique(all_ids, return_inverse=True)
    out = np.zeros((uids.size, all_rows.shape[1]), all_rows.dtype)
    np.add.at(out, inv, all_rows)
    return uids, out


# -- the store: barrier, the narrowed group's gathers, publish/collect -----

_gen_lock = threading.Lock()
_agb_gen = 0
_barrier_gen = 0


def _require_store(what: str):
    if not is_initialized() or _store is None:
        raise MXNetError(f"{what} requires an initialized process "
                         f"group (init_process_group)")
    return _store


def _wait_key(store, key: str, what: str, timeout: float) -> bytes:
    """``store.get(key)`` once the key exists, bounded by ``timeout``."""
    from ..faults import DeadlineExceeded
    deadline = time.monotonic() + timeout
    pause = 0.001
    while not store.check([key]):
        if time.monotonic() > deadline:
            raise DeadlineExceeded(
                f"{what} timed out after {timeout:.1f}s "
                f"(MXTPU_DIST_TIMEOUT) — a peer never arrived")
        time.sleep(pause)
        pause = min(0.05, pause * 2)
    return store.get(key)


def _allgather_bytes_kv(data: bytes, timeout: Optional[float] = None):
    """Byte gather over the store, over the active member set: each rank
    sets its payload under a generation-unique key and reads every
    peer's, each read bounded by ``timeout``."""
    global _agb_gen
    from ..observability.trace import span as _span
    store = _require_store("allgather_bytes")
    if timeout is None:
        timeout = float(get_env("MXTPU_DIST_TIMEOUT"))
    with _gen_lock:
        gen = _agb_gen
        _agb_gen += 1
    key = f"mxtpu/agb/{fence_generation()}/{gen}"
    store.set(f"{key}/{phys_rank()}", data)
    with _span("dist.allgather_kv_us", args={"gen": gen}):
        return [_wait_key(store, f"{key}/{i}",
                          f"allgather_bytes gen {gen}: waiting for rank {i}",
                          timeout) for i in active_members()]


def _gather_arrays_kv(arr):
    """Each rank's numpy array through :func:`_allgather_bytes_kv`,
    stacked in rank order."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    blobs = _allgather_bytes_kv(buf.getvalue())
    return np.stack([np.load(io.BytesIO(b), allow_pickle=False)
                     for b in blobs])


def barrier(name: str = "mxnet_tpu_barrier",
            timeout: Optional[float] = None) -> None:
    """Barrier over the active member set, through the store, bounded by
    ``timeout`` (default ``MXTPU_DIST_TIMEOUT``): an absent peer raises
    :class:`~mxnet_tpu_torch.faults.DeadlineExceeded`.  Nothing to wait
    for without a process group."""
    global _barrier_gen
    if not is_initialized():
        return
    from ..faults import DeadlineExceeded
    from ..observability.trace import span as _span
    store = _require_store("barrier")
    if timeout is None:
        timeout = float(get_env("MXTPU_DIST_TIMEOUT"))
    with _gen_lock:
        gen = _barrier_gen
        _barrier_gen += 1
    members = active_members()
    key = f"mxtpu/barrier/{fence_generation()}/{name}/{gen}"
    deadline = time.monotonic() + timeout
    with _span("dist.barrier_kv_us", args={"name": name, "gen": gen}):
        arrived = store.add(key, 1)
        pause = 0.001
        while arrived < len(members):
            if time.monotonic() > deadline:
                raise DeadlineExceeded(
                    f"barrier '{name}' gen {gen} over ranks "
                    f"{list(members)} timed out after {timeout:.1f}s "
                    f"(MXTPU_DIST_TIMEOUT) — {len(members) - arrived} "
                    f"peer(s) never arrived")
            time.sleep(pause)
            pause = min(0.05, pause * 2)
            arrived = store.add(key, 0)


_kv_pub_lock = threading.Lock()
_kv_pub_gens = {}      # prefix -> next generation for THIS process


def kv_publish(prefix: str, payload: bytes) -> None:
    """Publish this rank's ``payload`` under ``prefix`` (overwrite: a new
    generation-stamped key, the generation before it kept for readers in
    flight, older ones deleted).  Not a collective.  A fresh process
    resumes above the generation a predecessor of its rank left."""
    store = _require_store("kv_publish")
    own = f"{prefix}/{phys_rank()}"
    with _kv_pub_lock:
        gen = _kv_pub_gens.get(prefix)
        if gen is None:
            gen = 0
            if store.check([f"{own}/latest"]):
                try:
                    gen = int(store.get(f"{own}/latest")) + 1
                except ValueError:
                    gen = 0
        _kv_pub_gens[prefix] = gen + 1
    store.set(f"{own}/{gen:012d}", bytes(payload))
    store.set(f"{own}/latest", str(gen))
    for old in (gen - 2, gen - 3):
        if old >= 0:
            try:
                store.delete_key(f"{own}/{old:012d}")
            except RuntimeError:   # cleanup is best-effort
                pass


def kv_collect(prefix: str):
    """Every rank's most recently published payload under ``prefix`` as
    ``{rank: bytes}``; a rank that has not published is absent.  Never
    waits on a peer."""
    store = _require_store("kv_collect")
    out = {}
    for r in range(torch.distributed.get_world_size()):
        latest = f"{prefix}/{r}/latest"
        if not store.check([latest]):
            continue
        try:
            gen = int(store.get(latest))
            key = f"{prefix}/{r}/{gen:012d}"
            if store.check([key]):
                out[r] = bytes(store.get(key))
        except (RuntimeError, ValueError):
            continue
    return out


def kv_purge_rank(prefix: str, dead_rank: int) -> int:
    """Delete every key under ``prefix`` of ``dead_rank`` (its original
    rank); returns the count removed (best-effort)."""
    if not is_initialized() or _store is None:
        return 0
    own = f"{prefix}/{int(dead_rank)}"
    try:
        if not _store.check([f"{own}/latest"]):
            return 0
        gen = int(_store.get(f"{own}/latest"))
    except (RuntimeError, ValueError):
        return 0
    removed = 0
    for key in [f"{own}/{g:012d}" for g in range(max(0, gen - 3), gen + 1)
                ] + [f"{own}/latest"]:
        try:
            removed += bool(_store.delete_key(key))
        except RuntimeError:
            continue
    return removed
