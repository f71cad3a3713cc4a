"""mxnet_tpu_torch.parallel: data-parallel training across processes.

Counterpart of ``mxnet_tpu/parallel``: ``dist`` (the process group over
``torch.distributed``, its collectives and its store), ``mesh`` (the
ranks on named axes, ``ShardingRules``, ``zero_sharding``,
``comm_buckets``), ``optim`` (the functional optimizer) and ``trainer``
(``ShardedTrainer``: data parallelism with ZeRO, accumulation,
communication buckets and BatchNorm over the global batch).  Ring
attention, resilience and membership come with ROADMAP Queue A 3c:
their names raise ``MXNetError`` on access.
"""
from ..base import MXNetError
from .mesh import (MESH_AXES, Mesh, NamedSharding, PartitionSpec,
                   ShardingRules, axis_size, comm_buckets, default_mesh,
                   make_mesh, replicated, shard, zero_sharding)
from .optim import FunctionalOptimizer, make_functional_optimizer
from .trainer import ShardedBatch, ShardedTrainer
from . import dist

__all__ = ["MESH_AXES", "ShardingRules", "default_mesh", "make_mesh",
           "replicated", "shard", "FunctionalOptimizer",
           "make_functional_optimizer", "ShardedTrainer", "dist",
           "Mesh", "NamedSharding", "PartitionSpec", "axis_size",
           "comm_buckets", "zero_sharding", "ShardedBatch"]

_LATER = ("ring_attention", "ResilientTrainer", "TrainingPreempted",
          "MembershipManager", "FleetReformed", "FleetLost", "HostFenced")


def __getattr__(name):
    if name in _LATER:
        raise MXNetError(
            f"parallel.{name} is not ported yet: resilience, membership "
            f"and ring attention come with ROADMAP Queue A 3c")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
