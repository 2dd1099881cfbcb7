"""Sharding rules: parameter, batch and cache specs on a mesh (the
counterpart of ``repro.launch.shardings``).

Strategy (the reference's): FSDP (ZeRO-3) over ``data`` x tensor parallel
over ``model``; the batch over (pod, data); experts over ``model``; KV
caches shard the batch over (pod, data) and the KV heads or the head dim
over ``model``; the long-context (batch 1) cells shard the cache sequence
over the data axes.

Every spec passes a divisibility guard: a mesh axis that does not divide
its dimension is dropped (replicated) rather than failing, with the
reference's fallbacks for the big tables (embed and lm_head shard d_model
when the vocab does not divide).

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry a
tensor dimension: ``None`` (replicated), an axis name, or a tuple of axis
names (the data axes). :func:`placements` turns one into DTensor
placements on a ``DeviceMesh``. The port's parameter tree splits the
reference's stacked ``groups`` (and the encoder-decoder's ``enc_blocks`` /
``dec_blocks``) per group or layer (``models.model.params_from_jax``), so
a port leaf has no leading stacked axis: the rules apply to its trailing
dimensions, as the reference's ``lead`` padding does.
"""

from __future__ import annotations

from typing import Callable

from torch.distributed.tensor import Replicate, Shard

from .mesh import axis_sizes, data_axes, dp_size, model_size

# trailing-dims spec tables keyed by parameter leaf name ------------------
_DENSE_2D = {
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "wo": ("model", "data"),
    "w1": ("data", "model"), "w2": ("model", "data"),
    "in_proj": ("data", "model"), "x_proj": ("model", None),
    "dt_proj": (None, "model"), "out_proj": ("model", "data"),
    "in_z": ("data", "model"), "in_x": ("data", "model"),
    "in_B": ("data", None), "in_C": ("data", None), "in_dt": ("data", "model"),
    "conv_w": ("model", None), "conv_x_w": ("model", None),
    "conv_B_w": (None, None), "conv_C_w": (None, None),
    "router": ("data", None),
    # embed: vocab over model, d replicated
    "embed": ("model", None), "lm_head": (None, "model"),
    "enc_pos": (None, None), "dec_pos": (None, None),
}
_VEC = {
    "bq": ("model",), "bk": ("model",), "bv": ("model",), "bo": (None,),
    "b1": ("model",), "b2": (None,),
    "conv_b": ("model",), "conv_x_b": ("model",),
    "conv_B_b": (None,), "conv_C_b": (None,),
    "dt_bias": ("model",), "D_skip": ("model",), "norm_w": ("model",),
}
# fallbacks when the primary spec does not divide (vocab not % 16)
_FALLBACK_2D = {
    "embed": (None, "model"),       # shard d_model instead
    "lm_head": ("data", None),
}


def _fits(spec: tuple, shape: tuple, sizes: dict) -> tuple:
    """Drop axes that don't divide their dim."""
    return tuple(None if ax is None or dim % sizes.get(ax, 1) else ax
                 for dim, ax in zip(shape, spec))


def param_pspec(path: tuple[str, ...], shape: tuple[int, ...],
                sizes: dict) -> tuple:
    """The spec of the parameter leaf at ``path`` (its last entry names
    it; ``moe`` in the path, without ``res``, marks an expert leaf), given
    the mesh's {axis: size}."""
    name = path[-1]
    in_moe = "moe" in path and "res" not in path
    spec: tuple | None = None
    if name in ("wg", "wu"):
        spec = ("model", "data", None) if in_moe else ("data", "model")
    elif name == "wd":
        spec = ("model", None, "data") if in_moe else ("model", "data")
    elif name == "A_log":
        # mamba1: (..., Di, N) with Di >> N; mamba2: (..., nh)
        spec = ("model", None) if len(shape) >= 2 and shape[-2] > shape[-1] \
            else ("model",)
    elif name in _DENSE_2D:
        spec = _DENSE_2D[name]
    elif name in _VEC:
        spec = _VEC[name]
    if spec is None:
        return ()                                # norms, scalars: replicate
    lead = len(shape) - len(spec)
    if lead < 0:
        return ()
    full = (None,) * lead + tuple(spec)
    fitted = _fits(full, shape, sizes)
    if name in _FALLBACK_2D and all(a is None for a in fitted[lead:]):
        fb = (None,) * lead + _FALLBACK_2D[name]
        fitted = _fits(fb, shape, sizes)
    return fitted


def batch_pspec(name: str, shape: tuple[int, ...], mesh) -> tuple:
    """The batch dimension over the data axes when it divides them."""
    dp = data_axes(mesh)
    n = dp_size(mesh)
    b_ax = dp if shape[0] % n == 0 and shape[0] >= n else None
    return (b_ax,) + (None,) * (len(shape) - 1)


def cache_pspec(path: tuple[str, ...], shape: tuple[int, ...], mesh,
                cfg) -> tuple:
    """KV and state cache specs (decode and prefill). ``path`` may end in
    list indices (the port keeps one cache a layer); the leaf's name is
    its last key that is not one."""
    dp = data_axes(mesh)
    n_dp = dp_size(mesh)
    m = model_size(mesh)
    name = next((p for p in reversed(path) if not p.isdigit()), "")
    if name in ("k", "v") or name.startswith(("self_", "cross_")):
        # trailing dims: (B, S, KV, hd)
        B, S, KV, hd = shape[-4], shape[-3], shape[-2], shape[-1]
        b_ax = dp if B % n_dp == 0 and B >= n_dp else None
        s_ax = dp if b_ax is None and S % n_dp == 0 else None
        kv_ax = "model" if KV % m == 0 else None
        hd_ax = None
        if kv_ax is None and s_ax is None and S % m == 0:
            # GQA with fewer KV heads than the model axis: shard the cache
            # sequence over the model axis (flash-decoding style)
            s_ax = "model"
        elif kv_ax is None and hd % m == 0:
            hd_ax = "model"
        lead = len(shape) - 4
        return (None,) * lead + (b_ax, s_ax, kv_ax, hd_ax)
    if name == "ssm" or "ssm" in path:
        # mamba1: (..., B, Di, N); mamba2: (..., B, nh, P, N)
        trailing = 4 if (cfg.ssm is not None and cfg.ssm.version == 2) else 3
        lead = len(shape) - trailing
        body = shape[lead:]
        b_ax = dp if body[0] % n_dp == 0 and body[0] >= n_dp else None
        c_ax = "model" if body[1] % m == 0 else None
        return (None,) * lead + (b_ax, c_ax) + (None,) * (trailing - 2)
    if "conv" in path or name.startswith("conv"):
        # (B, K-1, C)
        lead = len(shape) - 3
        B, _, C = shape[lead:]
        b_ax = dp if B % n_dp == 0 and B >= n_dp else None
        c_ax = "model" if C % m == 0 else None
        return (None,) * lead + (b_ax, None, c_ax)
    return ()


# --------------------------------------------------------------------------
# specs as DTensor placements, over the port's trees
# --------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: a mesh axis named at
    tensor dimension i becomes ``Shard(i)``, every other axis
    ``Replicate()``. An axis named twice raises."""
    where: dict[str, int] = {}
    for i, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is None:
                continue
            if ax in where:
                raise ValueError(f"axis {ax!r} named twice in {spec}")
            where[ax] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard: each dimension divided by the sizes
    of the axes that shard it (the rules shard only what divides)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                dim //= sizes[ax]
        out.append(dim)
    return tuple(out)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over dict/list trees; a path is a tuple of
    strings (dict keys, list indices as digits); ``None`` leaves stay."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def param_shardings(mesh, params_tree):
    """The placements of every parameter leaf (a tree of tuples)."""
    sizes = axis_sizes(mesh)
    return tree_map_with_path(
        lambda path, leaf: placements(
            param_pspec(path, tuple(leaf.shape), sizes), mesh), params_tree)


def opt_shardings(mesh, opt_tree):
    """master / m / v mirror the parameters; the step is replicated."""
    return param_shardings(mesh, opt_tree)


def batch_shardings(mesh, batch_tree):
    return tree_map_with_path(
        lambda path, leaf: placements(
            batch_pspec(path[-1] if path else "", tuple(leaf.shape), mesh),
            mesh), batch_tree)


def cache_shardings(mesh, cache_tree, cfg):
    return tree_map_with_path(
        lambda path, leaf: placements(
            cache_pspec(path, tuple(leaf.shape), mesh, cfg), mesh),
        cache_tree)


def replicated(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim
