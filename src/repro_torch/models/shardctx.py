"""Activation-sharding context for model code (the counterpart of
``repro.models.shardctx``).

Sharding propagation loses the batch sharding at a few ops: DTensor
replicates where it has no rule that keeps it (the embedding gather over
a vocab-sharded table, the cross-entropy chunks, the MoE dispatch), as
XLA's SPMD pass falls back to a replicated result in the reference. Every
activation downstream would then compute replicated over the data axes.

The launcher installs the mesh here before it runs a sharded step; model
code calls :func:`anchor_batch` at the reference's propagation roots
(post-embedding, post layer-stack, the cross-entropy chunks, the encoder
and decoder inputs, the MoE input and output) and, since DTensor places
each operator greedily where XLA propagates over the whole step, at each
block's input, on each row-parallel product before its residual add and
on the cross-entropy's logits. Each block gathers its parameters'
data-axis shards before use (:func:`unshard`: FSDP, as XLA all-gathers
the ZeRO-3 weights in the reference), and :func:`embed_rows` looks the
embedding up on local shards. Without a mesh (one card, the tests) the
context is unset and every call returns its input, or ``table[index]``.
"""

from __future__ import annotations

import math

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_MESH = None
_DP: tuple[str, ...] = ("data",)


def set_mesh(mesh, dp_axes: tuple[str, ...]) -> None:
    global _MESH, _DP
    _MESH = mesh
    _DP = tuple(dp_axes)


def clear() -> None:
    global _MESH
    _MESH = None


def dp_size() -> int:
    if _MESH is None:
        return 1
    sizes = dict(zip(_MESH.mesh_dim_names, tuple(_MESH.shape)))
    return math.prod(sizes.get(a, 1) for a in _DP)


def anchor_batch(x, batch_axis: int = 0):
    """Redistribute a DTensor ``x`` to its dim ``batch_axis`` sharded over
    the data axes and replicated over every other axis (the reference's
    ``P(dp, None, ...)`` constraint) when the dimension divides them;
    anything else is returned as it is."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    n = dp_size()
    if x.shape[batch_axis] % n or x.shape[batch_axis] < n:
        return x
    dim = batch_axis % x.ndim
    want = [Shard(dim) if name in _DP else Replicate()
            for name in _MESH.mesh_dim_names]
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def unshard(tree):
    """A block's parameters with their data-axis shards gathered (FSDP):
    every DTensor leaf keeps its ``model`` placement and is replicated
    over the data axes; autograd reduce-scatters the gradients back to
    the stored sharding. Without a mesh the tree comes back as it is."""
    if _MESH is None:
        return tree
    if isinstance(tree, dict):
        return {k: unshard(v) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    want = [Replicate() if name in _DP else p
            for name, p in zip(_MESH.mesh_dim_names, tree.placements)]
    if want == list(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, want)


def embed_rows(table, index):
    """``table[index]``. With a DTensor table each rank looks its own rows
    of ``index`` (sharded over the data axes) up in the whole table
    (gathered over the mesh), and the table's gradient comes back as a
    partial sum over the data axes: DTensor's own rule for the lookup's
    backward (``index_put``) does not hold on every torch release."""
    if not isinstance(table, DTensor):
        return table[index]
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    n = dp_size() if _MESH is not None else 1
    rows = index.shape[0]
    split = _MESH is not None and rows % n == 0 and rows >= n
    idx_pl = [Shard(0) if split and name in _DP else Replicate()
              for name in mesh.mesh_dim_names]
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if split and name in _DP else Replicate()
            for name in mesh.mesh_dim_names]
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, whole, run_check=False)
    look = local_map(lambda t, i: t[i], out_placements=(idx_pl,),
                     in_placements=(whole, idx_pl),
                     in_grad_placements=(grad, idx_pl), device_mesh=mesh,
                     redistribute_inputs=True)
    return look(table, index)
