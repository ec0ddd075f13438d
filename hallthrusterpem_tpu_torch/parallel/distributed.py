"""Multi-process distribution on ``torch.distributed`` (the JAX package's
``parallel/distributed.py``).

Every process runs the same program on its own rows of the global batch
(:func:`local_batch_slice`), solves them on its own devices
(:func:`global_mesh`, :func:`process_local_batch`, ``mesh.sharded_call``) and
gathers the results to the host (:func:`gather_to_host`). The solve has no
traffic between samples, so that gather is the only collective; it runs over
the ``gloo`` backend on host tensors and returns numpy, as JAX's
``process_allgather`` does. (NCCL would also refuse two ranks on one card.)

Typical use under ``torchrun --nproc-per-node N``::

    from hallthrusterpem_tpu_torch.parallel import distributed as dist
    from hallthrusterpem_tpu_torch.parallel import sharded_call
    dist.initialize()                          # MASTER_ADDR/PORT, WORLD_SIZE, RANK, LOCAL_RANK
    mesh = dist.global_mesh()                  # this process's device(s)
    sl = dist.local_batch_slice(global_n)
    local = dist.process_local_batch({k: v[sl] for k, v in inputs.items()}, mesh)
    host = dist.gather_to_host(sharded_call(pem, mesh)(local))   # numpy on every rank

A two-process CPU test lives in ``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional

import torch
import torch.distributed as tdist

from hallthrusterpem_tpu_torch.parallel.mesh import BATCH_AXIS, Mesh, Shards, _tree_map, make_mesh, shard_batch

__all__ = [
    "initialize",
    "is_distributed",
    "global_mesh",
    "batch_sharding",
    "process_local_batch",
    "gather_to_host",
    "local_batch_slice",
]

#: how long the rendezvous waits for every process (``jax.distributed``'s default)
INIT_TIMEOUT = datetime.timedelta(seconds=300)

_initialized = False
#: this process's devices, set by :func:`initialize` when the caller or the environment names them
_local_devices: Optional[tuple] = None


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Join the process group (idempotent).

    Arguments not given are read from the environment: ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (torchrun), or
    ``SLURM_NTASKS``, ``SLURM_PROCID`` and ``SLURM_LOCALID``. With one process,
    or no cluster in the environment, nothing is joined. A cluster that names
    no coordinator address is run as a single process, with a warning. A named
    cluster that cannot be reached within :data:`INIT_TIMEOUT` raises.

    :param coordinator_address: ``host:port`` of rank 0's rendezvous store
    :param local_device_ids: this process's devices: CUDA ordinals, or device
        names (``["cpu"]``); by default the CUDA device ``LOCAL_RANK`` names,
        else every CUDA device of the process. The first becomes the current
        CUDA device.
    """
    global _initialized, _local_devices
    if _initialized:
        return
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "SLURM_NTASKS")
    if process_id is None:
        process_id = _env_int("RANK", "SLURM_PROCID")
    if local_device_ids is None and (local_rank := _env_int("LOCAL_RANK", "SLURM_LOCALID")) is not None:
        local_device_ids = [local_rank]

    if local_device_ids is not None:
        devices = tuple(torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
                        for d in local_device_ids)
        if devices[0].type == "cuda":
            torch.cuda.set_device(devices[0])
        _local_devices = devices

    if num_processes is not None and num_processes > 1:
        if coordinator_address is None:
            warnings.warn(f"{num_processes} processes named but no coordinator address "
                          "(MASTER_ADDR/MASTER_PORT): running as a single process", stacklevel=2)
        else:
            if process_id is None:
                raise ValueError("a process group of several processes needs this process's id (RANK)")
            tdist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                     world_size=num_processes, rank=process_id, timeout=INIT_TIMEOUT)
    _initialized = True


def _world() -> tuple[int, int]:
    """(process count, this process's index)."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def is_distributed() -> bool:
    return _world()[0] > 1


def global_mesh(axis_name: str = BATCH_AXIS) -> Mesh:
    """This process's devices as a 1-D mesh; the job's global mesh is the
    rank-ordered concatenation of every process's."""
    if _local_devices is not None:
        return Mesh(_local_devices, axis_name)
    return make_mesh(axis_name=axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = BATCH_AXIS) -> tuple:
    """The ``(mesh, axis_name)`` pair that :func:`process_local_batch` and
    ``mesh.sharded_call`` split a batch by."""
    return mesh, axis_name


def local_batch_slice(global_n: int) -> slice:
    """This process's contiguous row range of a ``global_n``-row batch."""
    count, index = _world()
    per = global_n // count
    if per * count != global_n:
        raise ValueError(f"global batch {global_n} must divide evenly over {count} processes")
    return slice(per * index, per * (index + 1))


def process_local_batch(tree, mesh: Mesh, axis_name: str = BATCH_AXIS) -> Shards:
    """This process's rows (``local_batch_slice(global_n)`` of the global batch)
    onto its devices: one contiguous shard per entry of ``mesh``."""
    return shard_batch(tree, mesh, axis_name)


def gather_to_host(tree):
    """Every process's rows of each leaf (tensors or numpy arrays, split along
    dim 0), concatenated in rank order, as numpy on every process."""

    def gather(x):
        local = torch.as_tensor(x).detach().cpu().contiguous()
        if not is_distributed():
            return local.numpy()
        parts = [torch.empty_like(local) for _ in range(_world()[0])]
        tdist.all_gather(parts, local)
        return torch.cat([p.reshape(-1, *local.shape[1:]) for p in parts]).numpy()

    return _tree_map(gather, tree)
