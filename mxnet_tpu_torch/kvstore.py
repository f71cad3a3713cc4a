"""KVStore: the one-process stores ``local`` and ``device``.

Counterpart of ``mxnet_tpu/kvstore.py`` for one process: ``init`` keeps
a copy of each key's value, ``push`` sums the values pushed for a key
(the replicas of a gradient) and either stores the sum or, with an
optimizer set (``set_optimizer``), applies the update to the stored
value; ``pull`` copies the stored value out; ``pushpull`` is both;
``save_optimizer_states``/``load_optimizer_states`` keep the updater's
states in a file (``gluon.Trainer`` with ``update_on_kvstore``).
``local`` and ``device`` are the same store here (one device).  The
distributed stores (``dist_*``) and ``nccl`` raise: they belong to the
multi-card slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]


def _pair(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value) if value is not None \
            else [None] * len(key)
    return [key], [value]


def _reduce(values: List[NDArray]) -> NDArray:
    if len(values) == 1:
        return values[0]
    acc = values[0].copy()
    for v in values[1:]:
        acc += v.as_in_context(acc.context)
    return acc


class KVStore:
    """In-process key-value store with an optional optimizer."""

    def __init__(self, kv_type: str = "local"):
        self._type = kv_type
        self._store: Dict[Any, NDArray] = {}
        self._updater = None

    @property
    def type(self) -> str:
        return self._type

    def init(self, key, value) -> None:
        for k, v in zip(*_pair(key, value)):
            v = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = v.copy()

    def push(self, key, value, priority: int = 0) -> None:
        for k, v in zip(*_pair(key, value)):
            reduced = _reduce(list(v) if isinstance(v, (list, tuple))
                              else [v])
            if k in self._store and self._updater is not None:
                self._updater(k, reduced, self._store[k])
            else:
                self._store[k] = reduced

    def pull(self, key, out=None, priority: int = 0,
             ignore_sparse: bool = True):
        keys, outs = _pair(key, out)
        results = []
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k!r} not initialized in kvstore")
            src = self._store[k]
            if o is None:
                results.append(src.copy())
                continue
            for tgt in (o if isinstance(o, (list, tuple)) else [o]):
                src.copyto(tgt)
            results.append(o)
        if out is None:
            return results if isinstance(key, (list, tuple)) \
                else results[0]
        return out

    def pushpull(self, key, value, out=None, priority: int = 0):
        self.push(key, value, priority)
        return self.pull(key, out if out is not None else value, priority)

    def set_optimizer(self, optimizer) -> None:
        from .optimizer import get_updater
        self._updater = get_updater(optimizer)

    def save_optimizer_states(self, fname: str,
                              dump_optimizer: bool = False) -> None:
        """Write the updater's states (``Updater.get_states``)."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname: str) -> None:
        """Read :meth:`save_optimizer_states`' file, the states onto the
        device of the stored values."""
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        held = next(iter(self._store.values()), None)
        with open(fname, "rb") as f:
            self._updater.set_states(
                f.read(), None if held is None else held._data.device)


def create(name: str = "local") -> KVStore:
    if name in ("local", "device"):
        return KVStore(name)
    if name == "nccl" or name.startswith("dist"):
        raise MXNetError(f"kvstore {name!r} is not ported yet: the "
                         f"multi-card stores come with the distributed "
                         f"slice (ROADMAP Queue A 9)")
    raise MXNetError(f"unknown kvstore type {name!r}")
