"""Sharded checkpointing with HRS-selected restore sources (the
counterpart of ``repro.checkpoint.ckpt``).

Layout, the reference's byte for byte: every leaf of a dict/list tree is
split along axis 0 into ``n_shards`` chunks, each saved as its own ``.npy``
under ``<dir>/step_<k>/`` (bf16 carried as its ``uint16`` bit pattern);
``manifest.json`` records the tree paths, shapes, dtypes and the replica
placement of each chunk (which sites hold a copy). A checkpoint written by
either package restores in the other. Restore:

  * works for any shard count (elastic): chunks are reassembled, so a
    checkpoint of 8 shards restores whatever the writer's layout was;
  * picks each chunk's source with the paper's HRS rule
    (:func:`choose_restore_sources`): intra-region replica first,
    max-available-bandwidth holder, cross-region only as a fallback.

:func:`reshard_for_mesh` places restored tensors on a device mesh
(elastic re-shard) as DTensors.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..device import resolve_device

if TYPE_CHECKING:                      # core imports fault, which imports this
    from ..core.topology import GridTopology

#: torch dtypes by the numpy name the manifest records
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float64": torch.float64,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` and its dtype's name; bf16, which numpy cannot
    hold, as its bit pattern in ``uint16``."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def _from_numpy(a: np.ndarray, dtype: str,
                device: torch.device) -> torch.Tensor:
    a = np.require(a, requirements="C")     # keeps 0-d arrays 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    elif tree is None:
        return
    else:
        yield prefix, tree


def _set_path(out, path, value):
    cur = out
    for k in path[:-1]:
        cur = cur.setdefault(k, {})
    cur[path[-1]] = value


@dataclasses.dataclass
class Manifest:
    step: int
    n_shards: int
    leaves: dict            # name -> {shape, dtype, chunks: [file, ...]}
    replicas: dict          # file -> [site, ...]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        return cls(**json.loads(s))


def save_checkpoint(tree, ckpt_dir: str, step: int, *, n_shards: int = 4,
                    replicate_to: list[int] | None = None) -> Manifest:
    """Write ``tree`` (dict/list tree of tensors or arrays) as step
    ``step``. Tensors are copied to the host."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    leaves = {}
    replicas = {}
    for path, leaf in _leaf_paths(tree):
        name = "/".join(path)
        if isinstance(leaf, torch.Tensor):
            arr, dtype = _to_numpy(leaf)
        else:
            arr = np.asarray(leaf)
            dtype = str(arr.dtype)
        chunks = (np.array_split(arr, min(n_shards, max(1, arr.shape[0])),
                                 axis=0) if arr.ndim else [arr])
        files = []
        for i, c in enumerate(chunks):
            fn = name.replace("/", ".") + f".{i}.npy"
            np.save(os.path.join(d, fn), c)
            files.append(fn)
            replicas[fn] = list(replicate_to or [0])
        leaves[name] = {"shape": list(arr.shape), "dtype": dtype,
                        "chunks": files}
    m = Manifest(step=step, n_shards=n_shards, leaves=leaves,
                 replicas=replicas)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write(m.to_json())
    return m


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
             if n.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like=None, *,
                       device: "str | torch.device" = "cuda"):
    """Reassemble the tree of step ``step`` as tensors on ``device``;
    returns ``(tree, manifest)``. ``like`` (optional) restores list/tuple
    types by structure."""
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        m = Manifest.from_json(f.read())
    out: dict = {}
    for name, info in m.leaves.items():
        chunks = [np.load(os.path.join(d, fn)) for fn in info["chunks"]]
        arr = np.concatenate(chunks, axis=0) if chunks[0].ndim else chunks[0]
        leaf = _from_numpy(arr.reshape(info["shape"]), info["dtype"], dev)
        _set_path(out, tuple(name.split("/")), leaf)
    if like is not None:
        out = _match_structure(like, out)
    return out, m


def _match_structure(like, loaded):
    if isinstance(like, dict):
        return {k: _match_structure(like[k], loaded.get(k, {}))
                for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_match_structure(v, loaded.get(str(i), {})
                                 if isinstance(loaded, dict) else loaded)
                for i, v in enumerate(like)]
        return type(like)(vals)
    if like is None:
        return None
    return loaded


def choose_restore_sources(manifest: Manifest, topology: "GridTopology",
                           dst_site: int) -> dict[str, int]:
    """HRS replica selection per chunk (paper §3.3, applied to restart).

    Intra-region holders first; among candidates, max available bandwidth.
    """
    out = {}
    for fn, sites in manifest.replicas.items():
        region = topology.region_of(dst_site)
        local = [s for s in sites if topology.region_of(s) == region]
        cands = local if local else sites
        out[fn] = max(cands,
                      key=lambda s: (topology.point_bandwidth(s, dst_site), -s))
    return out


def reshard_for_mesh(tree, mesh, sharding_fn):
    """Elastic re-shard: place restored tensors on a (new) mesh.

    ``sharding_fn(path, leaf)`` gives a leaf's DTensor placements on
    ``mesh`` (e.g. ``launch.shardings.placements(param_pspec(...),
    mesh)``), or None to leave the leaf as it is. Each placed leaf is
    ``torch.distributed.tensor.distribute_tensor(leaf, mesh, placements)``
    (every rank holds the whole restored tree and keeps its shard). The
    tree keeps its structure; a path is a tuple of strings, as
    :func:`_leaf_paths` gives."""
    from torch.distributed.tensor import distribute_tensor

    def place(node, path):
        if isinstance(node, dict):
            return {k: place(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(place(v, path + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        pl = sharding_fn(path, node)
        return node if pl is None else distribute_tensor(node, mesh, pl)

    return place(tree, ())
