"""The model kernels on DTensor inputs: each rank runs the kernel on its
local shards, through ``torch.distributed.tensor.experimental.local_map``.

The batch dimension is sharded over the data axes (``pod``, ``data``)
while it divides them, the head or channel dimension over ``model`` when
the caller says it divides; every other mesh axis is replicated. The
inputs are redistributed to those placements first (the collectives that
takes are the step's), and autograd carries the gradients back through
the same placements. Plain tensors never come here.
"""

from __future__ import annotations

from typing import Callable, Sequence

from torch import Tensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_DATA = ("pod", "data")


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def model_ranks(t: DTensor) -> int:
    """The size of the ``model`` axis of ``t``'s mesh (1 without one)."""
    mesh = t.device_mesh
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get("model", 1)


def role_placements(mesh, batch: int, split_model: bool, batch_dim,
                    model_dim) -> tuple:
    """Placements of one tensor whose batch sits at ``batch_dim`` and whose
    head or channel dimension at ``model_dim`` (either None)."""
    out, sharded = [], 1
    for name, size in zip(mesh.mesh_dim_names, tuple(mesh.shape)):
        if (name in _DATA and batch_dim is not None
                and batch % (sharded * size) == 0):
            sharded *= size
            out.append(Shard(batch_dim))
        elif name == "model" and split_model and model_dim is not None:
            out.append(Shard(model_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def call_local(fn: Callable, args: Sequence, roles: Sequence, out_roles:
               Sequence, *, batch: int, split_model: bool,
               out_placements: Sequence | None = None):
    """``fn(*local_args)`` on every rank's shards. ``roles`` gives each
    argument's (batch_dim, model_dim), or None for a non-tensor;
    ``out_roles`` each output's, unless ``out_placements`` gives them."""
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    place = lambda r: None if r is None else role_placements(  # noqa: E731
        mesh, batch, split_model, *r)
    # a plain tensor beside the DTensors is every rank's whole copy
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(a, Tensor) and not isinstance(a, DTensor) else a
            for a in args]
    if out_placements is None:
        out_placements = tuple(place(r) for r in out_roles)
    wrapped = local_map(fn, out_placements=tuple(out_placements),
                        in_placements=tuple(place(r) for r in roles),
                        device_mesh=mesh, redistribute_inputs=True)
    return wrapped(*args)
