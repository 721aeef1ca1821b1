"""Device meshes — ``repro/launch/mesh.py`` in the port.

A :class:`Mesh` is a numpy object array of ``torch.device`` shaped like the
mesh plus its ``axis_names``, so ``dict(zip(mesh.axis_names,
mesh.devices.shape))`` reads as it does on a jax mesh. It is a plain
single-process description: the serving process addresses every entry
itself, as the reference's single-controller mesh does.
``torch.distributed.device_mesh.DeviceMesh`` needs a process group and one
rank per device, so it does not fit here.

Axes:
  pod    data-parallel across pods (gradient all-reduce crosses the DCI)
  data   data parallel / FSDP within a pod
  model  tensor/expert parallel within a pod (the fastest links)

``make_production_mesh`` needs the 256 (or 512) devices of the reference's
(16, 16) / (2, 16, 16) mesh and raises where they are absent; it never
builds a mesh of repeated devices. ``make_placeholder_mesh`` builds those
meshes (and one H100's) with ``meta`` entries, for the dry run only: it
reads a mesh's axis sizes and runs nothing on it, as XLA's forced host
devices stand in for the pods in the reference's dry run.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An n-D arrangement of devices under named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} with axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def _cuda_devices():
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
    ``("pod", "data", "model")`` with ``multi_pod``.

    Raises:
        ValueError: fewer CUDA devices than the mesh needs.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    found = torch.cuda.device_count()
    if found < need:
        raise ValueError(f"the production mesh {shape} needs {need} "
                         f"devices; found {found}")
    return Mesh(np.array(_cuda_devices()[:need], dtype=object).reshape(
        shape), axes)


PLACEHOLDER_MESHES = {
    "pod256": ((16, 16), ("data", "model")),
    "pod512": ((2, 16, 16), ("pod", "data", "model")),
    "h100": ((1, 1, 1), ("pod", "data", "model")),
}


def make_placeholder_mesh(name: str) -> Mesh:
    """The dry run's mesh ``name`` (``PLACEHOLDER_MESHES``: the reference's
    two production meshes and one H100) with a ``meta`` device at every
    entry."""
    shape, axes = PLACEHOLDER_MESHES[name]
    arr = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        arr[idx] = torch.device("meta")
    return Mesh(arr, axes)


def make_debug_mesh(n_devices: int = 1, *,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A ``(1, n, 1)`` mesh over ``("pod", "data", "model")``: the first
    ``n = min(n_devices, torch.cuda.device_count())`` CUDA devices, or the
    explicit ``devices`` list (which may repeat one device, as the CPU
    tests' four CPU entries do)."""
    if devices is None:
        devices = _cuda_devices()[:n_devices]
    devices = list(devices)
    if not devices:
        raise ValueError("make_debug_mesh: no device (pass devices= on a "
                         "machine without CUDA)")
    arr = np.empty((1, len(devices), 1), dtype=object)
    for i, d in enumerate(devices):
        arr[0, i, 0] = torch.device(d)
    return Mesh(arr, ("pod", "data", "model"))


def dp_axes(mesh) -> tuple:
    """The axes a global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh) -> str:
    return "model"


def rank_coordinates(mesh, rank: int) -> dict:
    """The mesh coordinates of process ``rank``: ranks run over the mesh in
    row-major order, the last axis (``model``) fastest."""
    idx = np.unravel_index(rank, mesh.devices.shape)
    return {a: int(i) for a, i in zip(mesh.axis_names, idx)}


def rank_context(mesh, *, device=None):
    """This process's :class:`~repro_torch.distributed.partition.RankContext`
    on ``mesh`` from the initialised default process group (whose world
    size must be the mesh's): its coordinates and, for every mesh axis,
    the group of the ranks that share its other coordinates (made on every
    rank, in one order). The device is ``cuda:<local rank>`` (``LOCAL_RANK``,
    else the rank modulo the cards) unless the caller passes one."""
    import os

    import torch.distributed as dist

    from repro_torch.core.device import resolve_device
    from repro_torch.distributed.partition import AXES, RankContext
    world, rank = dist.get_world_size(), dist.get_rank()
    n = int(np.prod(mesh.devices.shape))
    if world != n:
        raise ValueError(f"a mesh of {n} devices {mesh.shape} under a world "
                         f"of {world} ranks")
    shape = mesh.devices.shape
    ranks = np.arange(n).reshape(shape)
    groups = {}
    for ax, name in enumerate(mesh.axis_names):
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        groups[name], _ = dist.new_subgroups_by_enumeration(
            [[int(r) for r in line] for line in lines])
    if device is None:
        count = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", rank % max(count, 1)))
        device = f"cuda:{local}"
    coords = dict.fromkeys(AXES, 0)
    coords.update(rank_coordinates(mesh, rank))
    sizes = dict.fromkeys(AXES, 1)
    sizes.update(mesh.shape)
    return RankContext(rank=rank, sizes=sizes, coords=coords, groups=groups,
                       device=resolve_device(device))
