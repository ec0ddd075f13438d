"""Device mesh and batch sharding (the JAX package's ``parallel/mesh.py``).

The solve has no traffic between samples, so a batch splits into contiguous
shards, one per entry of a :class:`Mesh`, each solved on its own device; the
outputs are concatenated in batch order on the mesh's first device. Shards on
distinct devices run at once, one host thread per device inside
``torch.cuda.device(d)`` (a kernel launch releases the interpreter lock); shards
on the same device run one after another on that device's current stream.
"""

from __future__ import annotations

import contextlib
import inspect
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["BATCH_AXIS", "Mesh", "Shards", "make_mesh", "pad_to_multiple", "shard_batch", "replicate",
           "sharded_call", "BatchExecutor"]

BATCH_AXIS = "batch"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: an explicit tuple of devices under one axis name. A device may
    appear more than once (``Mesh(["cpu"] * 8)``, ``Mesh(["cuda:0", "cuda:0"])``):
    each entry holds one shard."""

    devices: Sequence
    axis_name: str = BATCH_AXIS

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}

    @property
    def n_devices(self) -> int:
        return len(self.devices)


class Shards(tuple):
    """Per-entry trees of a batch split over a :class:`Mesh`, in mesh order."""


def make_mesh(n_devices: Optional[int] = None, axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA devices of the process (all of
    them by default). There is no CPU fallback: a CPU mesh is built explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: build a Mesh of CPU devices explicitly, "
                           "e.g. Mesh(['cpu'] * 8)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"n_devices={n_devices}: the process sees {count} CUDA device(s)")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)


def pad_to_multiple(arr, multiple: int, axis: int = 0):
    """Pad ``axis`` up to a multiple of ``multiple``: NaN for floating types (padded
    rows read as failed samples and are dropped by the caller), 0 otherwise.
    Takes a numpy array or a tensor and returns the same kind, with the
    original length: ``(padded, n)``."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    if isinstance(arr, torch.Tensor):
        fill = torch.nan if arr.is_floating_point() or arr.is_complex() else 0
        shape = list(arr.shape)
        shape[axis] = rem
        return torch.cat([arr, torch.full(shape, fill, dtype=arr.dtype, device=arr.device)], dim=axis), n
    arr = np.asarray(arr)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    fill = np.nan if np.issubdtype(arr.dtype, np.floating) else 0
    return np.pad(arr, pad, constant_values=fill), n


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def shard_batch(tree, mesh: Mesh, axis_name: str = BATCH_AXIS) -> Shards:
    """Split dim 0 of every leaf of ``tree`` (tensors or numpy arrays) into
    ``mesh.shape[axis_name]`` contiguous pieces, each on its own device of the
    mesh. The batch must divide the mesh (pad with :func:`pad_to_multiple`).
    :class:`Shards` pass through unchanged."""
    n_shards = mesh.shape[axis_name]
    if isinstance(tree, Shards):
        if len(tree) != n_shards:
            raise ValueError(f"{len(tree)} shards given for a {axis_name}-axis of size {n_shards}")
        return tree
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("shard_batch: the tree holds no arrays")
    batch = leaves[0].shape[0]
    if batch % n_shards or any(x.shape[0] != batch for x in leaves):
        raise ValueError(f"batch {batch} must divide the {axis_name}-axis size {n_shards} along dim 0 "
                         "of every leaf (pad with parallel.mesh.pad_to_multiple)")
    per = batch // n_shards
    return Shards(_tree_map(lambda x, i=i, d=d: torch.as_tensor(x)[i * per:(i + 1) * per].to(d), tree)
                  for i, d in enumerate(mesh.devices))


def replicate(tree, mesh: Mesh) -> list:
    """A copy of ``tree`` on each device of the mesh (tensor leaves moved, every
    other leaf shared), in mesh order."""
    return [_tree_map(lambda x, d=d: x.to(d) if isinstance(x, torch.Tensor) else x, tree)
            for d in mesh.devices]


def _device_context(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _concat(outs: list, device: torch.device):
    """Concatenate per-shard output trees in batch order on ``device``: tensor
    leaves of at least one dimension along dim 0; every other leaf is the first
    shard's."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat([o[j] for o in outs], device) for j in range(len(first)))
    if isinstance(first, torch.Tensor) and first.ndim > 0:
        return torch.cat([o.to(device) for o in outs])
    return first


def sharded_call(fn: Callable, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """Wrap a batched ``fn(batch_tree, *args, **kwargs)`` so that each shard of the
    batch runs on its own device of the mesh, with the tensors among ``args``
    copied there; outputs come back concatenated in batch order on
    ``mesh.devices[0]``. ``fn`` must be elementwise over the batch: each shard
    sees only its own rows, so whatever ``fn`` derives from the whole batch (a
    time step, a grid) is built by the caller once, before the call, as
    ``models.thruster.simulate_batch_sharded`` takes its config. Distinct
    devices run at once, one host thread each; shards on the same device run in
    turn."""

    def wrapper(batch_tree, *args, **kwargs):
        shards = shard_batch(batch_tree, mesh, axis_name)
        per_device: dict = {}
        for i, d in enumerate(mesh.devices):
            per_device.setdefault(d, []).append(i)
        args_on = dict(zip(mesh.devices, replicate(list(args), mesh)))
        outs: list = [None] * len(shards)

        def run(device):
            with _device_context(device):
                for i in per_device[device]:
                    outs[i] = fn(shards[i], *args_on[device], **kwargs)

        if len(per_device) == 1:
            run(mesh.devices[0])
        else:
            with ThreadPoolExecutor(max_workers=len(per_device)) as pool:
                for future in [pool.submit(run, d) for d in per_device]:
                    future.result()
        return _concat(outs, mesh.devices[0])

    return wrapper


def _takes_mesh(fn: Callable) -> bool:
    try:
        return "mesh" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class BatchExecutor:
    """The executor slot of ``System.predict(executor=...)``: instead of one
    subprocess per sample, the whole batch is padded to a multiple of the mesh,
    sharded over it and run by :func:`sharded_call`, then trimmed back. A
    function that takes a ``mesh`` keyword (``models.thruster.hallthruster_jl``)
    is called once on the whole batch with the mesh instead, and shards its own
    solve."""

    def __init__(self, mesh: Optional[Mesh] = None, axis_name: str = BATCH_AXIS):
        self.mesh = mesh or make_mesh()
        self.axis_name = axis_name

    @property
    def n_devices(self) -> int:
        return self.mesh.n_devices

    def run(self, fn: Callable, batch_tree: dict, *args, **kwargs):
        """``fn`` over ``batch_tree`` (a dict of (batch, ...) arrays or tensors).

        If ``fn`` takes a ``mesh`` keyword, it is called once,
        ``fn(batch_tree, *args, mesh=self.mesh, **kwargs)``: it derives what it
        needs from the whole batch and shards its own solve. Otherwise ``fn``
        must be elementwise over the batch: the batch is NaN-padded to a
        multiple of the mesh, each shard is called on its own
        (:func:`sharded_call`), and every output with at least ``n`` rows is
        trimmed to the first ``n``."""
        if _takes_mesh(fn):
            return fn(batch_tree, *args, mesh=self.mesh, **kwargs)
        n = None
        padded = {}
        for k, v in batch_tree.items():
            padded[k], n0 = pad_to_multiple(v, self.n_devices)
            n = n0 if n is None else n
        out = sharded_call(fn, self.mesh, self.axis_name)(padded, *args, **kwargs)
        return _tree_map(lambda x: x[:n] if isinstance(x, torch.Tensor) and x.ndim and x.shape[0] >= n
                         else x, out)

    # executor-protocol shims (the reference passes concurrent.futures executors)
    def map(self, fn, iterable):
        return [fn(x) for x in iterable]

    def shutdown(self, wait: bool = True):
        return None
