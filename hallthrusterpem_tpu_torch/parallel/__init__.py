"""Parallelism over devices and processes (the JAX package's ``parallel``).

The only parallel axis is independent samples: a batch is split into
contiguous shards over a 1-D :class:`~.mesh.Mesh` of devices, each shard
solved on its own device (the K-step kernel per shard on CUDA), and over
processes by :mod:`.distributed` on ``torch.distributed``. The solve has no
traffic between samples, so a sharded run gives the numbers of the unsharded
one.
"""

from hallthrusterpem_tpu_torch.parallel.mesh import (
    BatchExecutor,
    Mesh,
    make_mesh,
    pad_to_multiple,
    shard_batch,
    sharded_call,
)
from hallthrusterpem_tpu_torch.parallel import distributed

__all__ = ["make_mesh", "shard_batch", "sharded_call", "pad_to_multiple", "BatchExecutor", "Mesh",
           "distributed"]
