"""Device meshes of the launch stack (the counterpart of
``repro.launch.mesh``).

Each function builds a :class:`torch.distributed.device_mesh.DeviceMesh`
over the default process group, which the caller creates and owns: NCCL
at world size 1 on one card, ``gloo`` or the fake backend in the tests,
the fake backend at 256 or 512 ranks in the dry run
(:mod:`repro_torch.launch.dryrun`). Importing this module creates no
process group. The shapes and axis names are the reference's, so that
cells and records compare with its.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
               device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (16, 16) = 256 ranks on ("data", "model"). Multi-pod:
    (2, 16, 16) = 512 on ("pod", "data", "model")."""
    if multi_pod:
        return _make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _make_mesh((16, 16), ("data", "model"), device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, pod: int = 0,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small mesh, (n_data, n_model) or (pod, n_data, n_model)."""
    if pod:
        return _make_mesh((pod, n_data, n_model), ("pod", "data", "model"),
                          device_type)
    return _make_mesh((n_data, n_model), ("data", "model"), device_type)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes the batch dimension shards over (pod included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)
