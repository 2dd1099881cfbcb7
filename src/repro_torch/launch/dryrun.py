"""Dry run: trace every (arch x shape x mesh) cell on fake H100 ranks (the
counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder devices and
reads the compiled module. The port runs the cell's step once, eagerly,
as one rank of a fake process group at the mesh's world size: the
parameters, optimizer state, batch and caches are DTensors of fake
tensors (``FakeTensorMode``: shapes and dtypes, no memory, no card; see
:data:`FAKE_DEVICE`), placed by :mod:`.shardings`, with
:mod:`..models.shardctx` set, and
:class:`.traceanalysis.TraceCounter` records the rank's work. The model
kernels take their shape-only route (:mod:`..kernels.shapeonly`) and are
counted by formula. Run it as a script (it creates the process group)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k --mesh single,multi --out results/dryrun_torch

Per cell it writes one JSON record (see :func:`run_cell`), which
:mod:`.roofline` turns into the three roofline terms with H100 figures.
``--mesh`` also takes a small mesh as ``DxM`` (data x model ranks), and
``--batch`` / ``--seq`` replace the named shapes' batch and length, so a
cell the card can run whole (``--mesh 1x1``) is predicted by the same code
(``chip_smoke.py`` phase 18 (c)).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import SHAPES, ArchConfig, ShapeConfig, arch_ids, cells
from ..configs.base import get_config
from ..models import model as M
from ..models import shardctx
from ..train.train_step import TrainConfig, make_train_step
from .mesh import (axis_sizes, data_axes, dp_size, make_debug_mesh,
                   make_production_mesh)
from .shardings import (batch_pspec, cache_pspec, local_shape, param_pspec,
                        placements, tree_map_with_path)
from .traceanalysis import ReplicateOnFailure, TraceCounter

MESHES = {"single": 256, "multi": 512}
#: The fake tensors' device. A CPU build cannot run autograd on fake
#: ``cuda`` tensors, so the dry run traces on the CPU device on every host;
#: a fake tensor takes the model kernels' shape-only route whatever its
#: device, so the step still runs the card's kernels, counted by formula.
FAKE_DEVICE = "cpu"


def pick_n_micro(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Gradient-accumulation depth: target ~4k (8k for small d_model) tokens
    per device per microbatch; must divide the per-device batch."""
    bd = max(1, shape.global_batch // dp_size(mesh))
    seq = shape.seq_len if not cfg.enc_dec else shape.seq_len
    target = 8192 if cfg.d_model <= 2048 else 4096
    n = max(1, min(bd, (bd * seq) // target))
    while bd % n:
        n -= 1
    return n


def _fake(meta: torch.Tensor, mesh, spec: tuple, dtype=None) -> DTensor:
    """A fake DTensor of ``meta``'s shape (and dtype, unless given),
    placed by ``spec``: only its local shard is allocated."""
    local = torch.empty(local_shape(tuple(meta.shape), spec, mesh),
                        dtype=dtype or meta.dtype, device=FAKE_DEVICE)
    stride = torch.empty(meta.shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=meta.shape,
                              stride=stride)


def fake_params(cfg: ArchConfig, mesh, meta: dict, dtype=None) -> dict:
    """The parameter tree ``meta`` as fake DTensors placed by the rules."""
    sizes = axis_sizes(mesh)
    return tree_map_with_path(
        lambda path, m: _fake(m, mesh, param_pspec(path, tuple(m.shape),
                                                   sizes), dtype), meta)


def abstract(fn, *args, **kwargs):
    """What ``fn(..., device="cpu")`` builds (``init_params``,
    ``init_caches``), as meta tensors: traced under a ``FakeTensorMode``,
    so nothing is allocated."""
    with FakeTensorMode():
        fake = fn(*args, device="cpu", **kwargs)
    return tree_map_with_path(
        lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def _step(cfg: ArchConfig, shape: ShapeConfig, mesh, counter: TraceCounter,
          *, n_micro, remat: bool, grad_rs: bool) -> dict:
    """Build the cell's DTensors and run its step under ``counter``."""
    B, S = shape.global_batch, shape.seq_len
    meta = abstract(M.init_params, cfg, max_enc=S, max_dec=max(1, S // 8))
    params = fake_params(cfg, mesh, meta)
    spec = lambda t: batch_pspec("", tuple(t.shape), mesh)  # noqa: E731
    batch = {k: _fake(t, mesh, spec(t))
             for k, t in M.input_specs(cfg, shape).items()}
    if shape.kind == "train":
        nm = n_micro if n_micro is not None else pick_n_micro(cfg, shape,
                                                              mesh)
        tcfg = TrainConfig(n_microbatches=nm, remat=remat)
        f32 = torch.float32
        opt = {"master": fake_params(cfg, mesh, meta, f32),
               "m": fake_params(cfg, mesh, meta, f32),
               "v": fake_params(cfg, mesh, meta, f32),
               "step": _fake(torch.empty((), dtype=torch.int32,
                                         device="meta"), mesh, ())}
        grads = (tree_map_with_path(lambda _, p: p.placements, params)
                 if grad_rs else None)
        step = make_train_step(cfg, tcfg, mesh=mesh, dp_axes=data_axes(mesh),
                               grad_shardings=grads)
        counter.track((params, opt, batch))
        with counter, ReplicateOnFailure(counter.stats):
            out = step(params, opt, batch)
        del out
        return {"mode": "train", "n_micro": nm}
    caches_meta = abstract(M.init_caches, cfg, B, S)
    caches = tree_map_with_path(
        lambda path, m: _fake(m, mesh, cache_pspec(path, tuple(m.shape), mesh,
                                                   cfg)), caches_meta)
    counter.track((params, caches, batch))
    if shape.kind == "prefill":
        kw = ({"frames": batch["frames"]} if cfg.enc_dec
              else {"tokens": batch["tokens"],
                    "vision_embeds": batch.get("vision_embeds")})
        with counter, ReplicateOnFailure(counter.stats), torch.no_grad():
            out = M.prefill(cfg, params, caches=caches, **kw)
        del out
        return {"mode": "prefill"}
    # the last slot: the encoder-decoder's self caches hold S // 8
    pos = (max(1, S // M.DEC_RATIO) if cfg.enc_dec else S) - 1
    with counter, ReplicateOnFailure(counter.stats), torch.no_grad():
        out = M.decode_step(cfg, params, caches, batch["tokens"], pos)
    del out
    return {"mode": "decode"}


@contextlib.contextmanager
def _alltoall_as_on_cards():
    """DTensor turns a shard-to-shard redistribution on a CPU mesh into an
    all-gather and a chunk (gloo has no all-to-all); the dry run's mesh is
    a CPU one (:data:`FAKE_DEVICE`), so this restores the all-to-all an
    NCCL mesh runs."""
    from torch.distributed.tensor import placement_types

    orig = getattr(placement_types, "shard_dim_alltoall", None)
    try:
        op = torch.ops._dtensor.shard_dim_alltoall
    except (AttributeError, RuntimeError):
        op = None
    if orig is None or op is None:      # a release without the op
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def trace_cell(arch: str, shape, mesh, *, n_micro: int | None = None,
               remat: bool = True, grad_rs: bool = False,
               cfg: ArchConfig | None = None) -> tuple[TraceCounter, dict]:
    """Trace one cell on ``mesh`` (whose process group the caller made):
    ``shape`` a :data:`SHAPES` name or a :class:`ShapeConfig`, ``cfg``
    the config to run in place of ``get_config(arch)``. Returns the
    counter and the step's meta (mode, n_micro)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    counter = TraceCounter()
    shardctx.set_mesh(mesh, data_axes(mesh))
    try:
        with FakeTensorMode(), implicit_replication(), \
                _alltoall_as_on_cards():
            meta = _step(cfg, shape, mesh, counter, n_micro=n_micro,
                         remat=remat, grad_rs=grad_rs)
    finally:
        shardctx.clear()
    return counter, meta


def record(counter: TraceCounter) -> dict:
    """The record fields of one traced step (per device)."""
    st = counter.stats
    return {
        "matmul_flops_per_device": st.matmul_flops,
        "kernel_flops_per_device": st.kernel_flops,
        "hbm_bytes_per_device": st.hbm_bytes,
        "peak_bytes": st.peak_bytes,
        "collective_result_bytes": dict(st.collective_result_bytes),
        "collective_counts": dict(st.collective_counts),
        "collective_wire_bytes_nvlink": st.collective_wire_bytes_nvlink,
        "collective_wire_bytes_ib": st.collective_wire_bytes_ib,
        "kernels": st.kernels,
        "replicated_ops": dict(st.replicated_ops),
    }


@contextlib.contextmanager
def fake_group(world_size: int):
    """The default process group as one rank (0) of a fake backend of
    ``world_size`` ranks: collectives are shapes only. Destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_ranks(mesh_kind: str) -> int:
    """Ranks of ``single``, ``multi`` or a ``DxM`` debug mesh."""
    if mesh_kind in MESHES:
        return MESHES[mesh_kind]
    d, m = (int(v) for v in mesh_kind.split("x"))
    return d * m


def _mesh(mesh_kind: str):
    if mesh_kind in MESHES:
        return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type=FAKE_DEVICE)
    d, m = (int(v) for v in mesh_kind.split("x"))
    return make_debug_mesh(d, m, device_type=FAKE_DEVICE)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             n_micro: int | None = None, remat: bool = True,
             grad_rs: bool = False, batch: int | None = None,
             seq: int | None = None) -> dict:
    """One cell's record on the mesh ``mesh_kind`` (``single``, ``multi``
    or ``DxM``); the default process group must be a fake one of the
    mesh's size. ``batch`` and ``seq`` replace the shape's."""
    mesh = _mesh(mesh_kind)
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(
        shape, global_batch=batch or shape.global_batch,
        seq_len=seq or shape.seq_len)
    t0 = time.perf_counter()
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "global_batch": shape.global_batch,
                 "seq_len": shape.seq_len, "trace_device": FAKE_DEVICE}
    try:
        counter, meta = trace_cell(arch, shape, mesh, n_micro=n_micro,
                                   remat=remat, grad_rs=grad_rs)
        rec.update(meta)
        rec.update({"ok": True})
        rec.update(record(counter))
    except Exception as e:  # an op DTensor cannot place is a port fault
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}"[:2000],
                    "traceback": traceback.format_exc()[-3000:]})
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="comma list or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--grad-rs", action="store_true",
                    help="pin microbatch grads to the ZeRO sharding "
                         "(reduce-scatter instead of all-reduce)")
    ap.add_argument("--batch", type=int, default=None,
                    help="replace the shapes' global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace the shapes' sequence length")
    args = ap.parse_args(argv)

    archs = arch_ids() if args.arch == "all" else args.arch.split(",")
    os.makedirs(args.out, exist_ok=True)
    for mesh_kind in args.mesh.split(","):
        with fake_group(mesh_ranks(mesh_kind)):
            for arch in archs:
                valid = cells(arch)
                shapes = valid if args.shape == "all" else \
                    [s for s in args.shape.split(",") if s in valid]
                for shape_name in shapes:
                    path = os.path.join(
                        args.out, f"{arch}__{shape_name}__{mesh_kind}.json")
                    if os.path.exists(path):
                        print(f"skip (exists): {path}", flush=True)
                        continue
                    print(f"=== {arch} x {shape_name} x {mesh_kind}",
                          flush=True)
                    rec = run_cell(arch, shape_name, mesh_kind,
                                   n_micro=args.n_micro,
                                   remat=not args.no_remat,
                                   grad_rs=args.grad_rs, batch=args.batch,
                                   seq=args.seq)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    status = "OK" if rec.get("ok") else "FAIL"
                    print(f"    -> {status} wall={rec['wall_s']:.1f}s "
                          f"flops/dev={rec.get('matmul_flops_per_device', 0):.3e} "
                          f"peak={rec.get('peak_bytes', 0) / 1e9:.2f}GB",
                          flush=True)
                    if not rec.get("ok"):
                        print(rec.get("error"), flush=True)


if __name__ == "__main__":
    main()
