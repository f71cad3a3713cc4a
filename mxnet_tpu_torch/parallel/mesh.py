"""The process group laid out on named axes: the port's device mesh.

Counterpart of ``mxnet_tpu/parallel/mesh.py``.  A mesh here is the ranks
of ``parallel.dist`` (one device a rank) arranged on named axes in
``MESH_AXES`` order:

    dp  — data parallel (the batch dimension; gradients summed over it)
    tp  — tensor parallel
    sp  — sequence/context parallel
    pp  — pipeline parallel
    ep  — expert parallel

Only ``dp`` is ported: an axis other than ``dp`` of a size above 1 raises
(model parallelism comes with ROADMAP Queue A 3c).  A ``NamedSharding``
is a mesh with a ``PartitionSpec`` (a tuple of axis names or None, one
entry a dimension); ``ShardingRules`` map parameter names to specs,
first match wins.  ``zero_sharding`` and ``comm_buckets`` decide, as the
JAX functions do, which optimizer-state tensors split over ``dp`` and
how gradients group into communication buckets.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as _np

from ..base import MXNetError

__all__ = ["make_mesh", "default_mesh", "ShardingRules", "replicated",
           "shard", "zero_sharding", "axis_size", "comm_buckets",
           "MESH_AXES", "Mesh", "NamedSharding", "PartitionSpec"]

#: canonical axis order: dp outermost, then pipeline, then the
#: intra-layer axes
MESH_AXES = ("dp", "pp", "tp", "sp", "ep")

_MODEL_PARALLEL_MSG = ("model parallelism (the tp/sp/ep/pp mesh axes) is "
                       "not ported yet: ROADMAP Queue A 3c")


class PartitionSpec(tuple):
    """One entry a dimension: an axis name, a tuple of names, or None
    (not split)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """Ranks on named axes: ``devices`` is the grid of rank ids,
    ``axis_names`` the names, ``shape`` ``{name: size}``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = _np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MXNetError(f"mesh of {self.devices.ndim} dims but axis "
                             f"names {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other):
        return isinstance(other, Mesh) and \
            self.axis_names == other.axis_names and \
            self.devices.shape == other.devices.shape and \
            bool((self.devices == other.devices).all())

    def __repr__(self):
        return f"Mesh({self.shape})"


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """A :class:`Mesh` over ``devices`` (default: the ranks of the process
    group, one rank without one).  ``axes`` is an ordered ``{name:
    size}`` whose product must equal the number of devices; default all
    on ``dp``.  An axis other than ``dp`` above size 1 raises."""
    if devices is None:
        from . import dist
        devices = list(dist.active_members())
    devices = list(devices)
    if axes is None:
        axes = {"dp": len(devices)}
    names = tuple(axes.keys())
    sizes = tuple(int(s) for s in axes.values())
    for name, size in zip(names, sizes):
        if name not in MESH_AXES:
            raise MXNetError(f"unknown mesh axis {name!r}; the axes are "
                             f"{MESH_AXES}")
        if name != "dp" and size > 1:
            raise MXNetError(f"mesh axis {name!r} of size {size}: "
                             + _MODEL_PARALLEL_MSG)
    n = 1
    for s in sizes:
        n *= s
    if n != len(devices):
        raise MXNetError(
            f"mesh {dict(axes)} covers {n} devices but {len(devices)} were "
            f"given — pass an explicit device subset if underfilling is "
            f"intended")
    grid = _np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(sizes), names)


_default_mesh = None


def default_mesh() -> Mesh:
    """The process-wide default mesh (every rank on ``dp``), remade when
    the group's size changed."""
    global _default_mesh
    from . import dist
    if _default_mesh is None or \
            _default_mesh.size != dist.num_workers():
        _default_mesh = make_mesh()
    return _default_mesh


def replicated(mesh: Mesh) -> NamedSharding:
    """The fully replicated sharding on ``mesh``."""
    return NamedSharding(mesh, PartitionSpec())


def shard(mesh: Mesh, *spec) -> NamedSharding:
    """A sharding from a PartitionSpec-like tuple, e.g. ``shard(mesh,
    'dp')`` for the batch dimension."""
    return NamedSharding(mesh, PartitionSpec(*spec))


def axis_size(mesh: Mesh, name: str) -> int:
    """Size of mesh axis ``name`` (1 when the mesh has no such axis)."""
    return int(mesh.shape[name]) if name in mesh.axis_names else 1


def zero_sharding(mesh: Mesh, spec, shape, axis: str = "dp"
                  ) -> NamedSharding:
    """The ZeRO sharding of one parameter's optimizer state (or gradient
    accumulation buffer): dim 0 split over ``axis`` on top of the
    parameter's own spec, so each rank owns a ``1/dp`` slice.  Falls back
    to the parameter's own sharding when no split can be formed: no or
    size-1 ``axis``, a scalar, dim 0 not divisible by the axis size, dim
    0 already ruled, or the axis already taken by another dim."""
    dp = axis_size(mesh, axis)
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def uses(entry, name):
        if entry is None:
            return False
        if isinstance(entry, (tuple, list)):
            return name in entry
        return entry == name

    if (dp <= 1 or not shape or int(shape[0]) % dp != 0 or
            entries[0] is not None or
            any(uses(e, axis) for e in entries)):
        return NamedSharding(mesh, PartitionSpec(*spec))
    entries[0] = axis
    return NamedSharding(mesh, PartitionSpec(*entries))


def comm_buckets(nbytes, cap_bytes) -> List[List[int]]:
    """Gradient indices in size-capped communication buckets, in REVERSE
    parameter order (the order backward produces the gradients), so the
    first bucket's collective can start while earlier layers' gradients
    are still being computed.  Greedy fill: a bucket closes once it holds
    a gradient and the next would pass ``cap_bytes``; a gradient larger
    than the cap has a bucket of its own.  A cap of 0/None/inf (or one
    that swallows everything) gives ONE bucket: the fused path."""
    n = len(nbytes)
    if not n:
        return []
    if not cap_bytes or cap_bytes <= 0 or cap_bytes == float("inf"):
        return [list(range(n - 1, -1, -1))]
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in range(n - 1, -1, -1):
        b = int(nbytes[i])
        if cur and cur_bytes + b > cap_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
    if cur:
        buckets.append(cur)
    return buckets


class ShardingRules:
    """Name pattern -> PartitionSpec table for parameters, first match
    wins, no match replicated:

        rules = ShardingRules([
            (r".*_qkv_weight$",  ("tp", None)),   # column parallel
            (r".*_proj_weight$", (None, "tp")),   # row parallel
        ])
    """

    def __init__(self, rules: Optional[Sequence[Tuple[str, tuple]]] = None):
        self._rules: List[Tuple[re.Pattern, tuple]] = [
            (re.compile(pat), tuple(spec)) for pat, spec in (rules or [])]

    def spec_for(self, name: str, shape=None) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(name):
                return PartitionSpec(*spec)
        return PartitionSpec()

    def sharding_for(self, mesh: Mesh, name: str, shape=None
                     ) -> NamedSharding:
        return NamedSharding(mesh, self.spec_for(name, shape))
