"""Training step: loss -> gradients (microbatched) -> AdamW update (the
counterpart of ``repro.train.train_step``).

The step is functional: it returns new params and a new optimizer state
and leaves its inputs unchanged, so that ``TrainingSupervisor`` can
re-issue a straggling step on the same state
(:mod:`repro_torch.fault.failures`). Gradients are taken with
``torch.autograd.grad`` on detached views of the parameters (no copy, and
the caller's tensors are not marked). Microbatch gradients accumulate in
float32 and are divided by their count. With ``OptimizerConfig.
compress_grads`` the optimizer state carries the int8 quantizer's error
feedback under ``"ef"`` (``init_train_state(..., compress_grads=True)``),
so a checkpoint keeps it.

On a mesh (``make_train_step(..., mesh=)``; the parameters, optimizer
state and batch DTensors, :mod:`repro_torch.launch.dryrun`) the step
keeps the reference's two pins: each microbatch stays sharded over the
data axes (:func:`_split_micro` splits every rank's own rows, so no
microbatch is gathered), and ``grad_shardings`` (a params-shaped tree of
placements) redistributes each microbatch's gradients to the parameter
sharding inside the accumulation, so the cross-data reduction is a
reduce-scatter of the shard each rank owns. Without a mesh the step is
the single-device one, operator for operator.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import model as M
from ..models.moe import moe_aux_loss
from ..models.transformer import check_config
from .optimizer import (OptimizerConfig, adamw_update, init_compress_state,
                        init_opt_state, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    remat: bool = True
    moe_aux_weight: float = 0.01
    opt: OptimizerConfig = OptimizerConfig()


def check_trainable(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port does not train:
    :func:`check_config`'s refusals (a block kind or activation it does
    not know). The encoder-decoder (``enc_dec``) and the VLM front end
    (``vision_tokens``) train like every other family."""
    check_config(cfg)


def micro_loss(cfg: ArchConfig, tcfg: TrainConfig, params: dict,
               micro: dict, backend: str = "auto"):
    """Loss and metrics of one microbatch. For a MoE config, the
    reference's probe: the load-balancing loss of group 0's block ``b0``
    router on the embedded microbatch, weighted by ``moe_aux_weight`` and
    reported as ``moe_aux`` (every layer's router still feels it through
    the shared embeddings)."""
    loss, metrics = M.loss_fn(cfg, params, micro, remat=tcfg.remat,
                              backend=backend)
    if cfg.moe is not None:
        tokens = micro["tokens"].to(params["embed"].device, torch.int64)
        x = M._embed_tokens(cfg, params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = params["groups"][0].get("b0") if params["groups"] else None
        if block is not None and "moe" in block:
            aux = moe_aux_loss(block["moe"], x, top_k=cfg.moe.top_k)
        loss = loss + tcfg.moe_aux_weight * aux
        metrics = dict(metrics, moe_aux=aux)
    return loss, metrics


def _split_micro(batch: dict, n: int, mesh=None,
                 dp_axes: tuple = ("data",)) -> list[dict]:
    """(B, ...) -> n microbatches of B / n rows, every key alike
    (``tokens``, ``labels``, and ``frames`` or ``vision_embeds``). With a
    mesh, a DTensor whose rows are sharded splits each rank's own rows
    into n, so every microbatch keeps the sharding over ``dp_axes``
    (splitting the global rows would gather them: the reference pins
    ``P(None, dp)`` for the same reason); on one rank that is the plain
    split."""
    out = [{} for _ in range(n)]
    for key, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} microbatches")
        for i, part in enumerate(_micro_parts(x, n, mesh, dp_axes)):
            out[i][key] = part
    return out


def _micro_parts(x, n: int, mesh, dp_axes: tuple) -> list:
    if mesh is None or not isinstance(x, DTensor):
        return list(x.split(x.shape[0] // n))
    local = x.to_local()
    sharded = [p for p, name in zip(x.placements, mesh.mesh_dim_names)
               if p.is_shard(0) and name in dp_axes]
    if not sharded or local.shape[0] % n:
        return list(x.split(x.shape[0] // n))
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return [DTensor.from_local(part, mesh, x.placements, run_check=False,
                               shape=shape, stride=stride)
            for part in local.split(local.shape[0] // n)]


def _pin(grads: list, shardings: list | None) -> list:
    """Each gradient redistributed to its parameter's placements."""
    if shardings is None:
        return grads
    return [g.redistribute(g.device_mesh, p) if isinstance(g, DTensor)
            and tuple(g.placements) != tuple(p) else g
            for g, p in zip(grads, shardings)]


def grad_fn(cfg: ArchConfig, tcfg: TrainConfig, params: dict, batch: dict,
            backend: str = "auto", mesh=None, dp_axes: tuple = ("data",),
            grad_shardings=None):
    """Microbatched value and gradient. Returns (mean_loss, metrics,
    grads): with one microbatch the gradients in the parameters' dtypes,
    else their float32 mean. ``mesh``, ``dp_axes`` and ``grad_shardings``
    are the pins of :func:`make_train_step`."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat: list = []
    tree_map(flat.append, leaves)          # tree_map's own leaf order
    pins = None
    if grad_shardings is not None:       # leaves are placement tuples
        pins = []
        tree_map(lambda _, pl: pins.append(pl), params, grad_shardings)

    def value_and_grad(micro):
        loss, metrics = micro_loss(cfg, tcfg, leaves, micro, backend=backend)
        grads = _pin(list(torch.autograd.grad(loss, flat)), pins)
        return loss.detach(), metrics, grads

    n = tcfg.n_microbatches
    if n == 1:
        loss, metrics, grads = value_and_grad(batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
    else:
        acc, loss_sum = None, None
        for micro in _split_micro(batch, n, mesh, dp_axes):
            loss, _, grads = value_and_grad(micro)
            g32 = [g.to(torch.float32) for g in grads]
            acc = g32 if acc is None else [a + g for a, g in zip(acc, g32)]
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = [a / n for a in acc]
        loss = loss_sum / n
        metrics = {"loss": loss}
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), params)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh=None,
                    dp_axes: tuple = ("data",), grad_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics); ``batch`` holds (B, S) ``tokens`` and ``labels`` tensors on
    the parameters' device, plus ``frames`` for the encoder-decoder and
    ``vision_embeds`` for a VLM (``repro_torch.launch.train
    .family_batch``). ``mesh`` (with DTensor inputs) pins each
    microbatch's sharding over ``dp_axes``, and ``grad_shardings`` (a
    params-shaped tree of placements) each microbatch's gradients to the
    parameter sharding; without a mesh the step is the single-device one.
    Raises for a config :func:`check_trainable` refuses."""
    check_trainable(cfg)

    def train_step(params, opt_state, batch):
        if mesh is not None:
            # tensors the model makes (RoPE tables, masks) are every
            # rank's whole copy beside the DTensors
            with implicit_replication():
                return step(params, opt_state, batch)
        return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        if tcfg.opt.compress_grads and "ef" not in opt_state:
            raise ValueError("compress_grads needs the error-feedback state: "
                             "init_train_state(..., compress_grads=True)")
        loss, metrics, grads = grad_fn(cfg, tcfg, params, batch, mesh=mesh,
                                       dp_axes=dp_axes,
                                       grad_shardings=grad_shardings)
        state = {k: v for k, v in opt_state.items() if k != "ef"}
        params, state, ef, stats = adamw_update(tcfg.opt, grads, params,
                                                state, opt_state.get("ef"))
        if ef is not None:
            state["ef"] = ef
        return params, state, {**metrics, **stats, "loss": loss}

    return train_step


def init_train_state(cfg: ArchConfig, *, seed: int = 0,
                     device: "str | torch.device" = "cuda",
                     compress_grads: bool = False):
    """Seeded parameters (:func:`repro_torch.models.model.init_params`)
    and a fresh optimizer state on ``device``, with a zero error-feedback
    tree under ``"ef"`` when ``compress_grads``. Raises for a config
    :func:`check_trainable` refuses."""
    check_trainable(cfg)
    params = M.init_params(cfg, seed=seed, device=resolve_device(device))
    state = init_opt_state(params)
    if compress_grads:
        state["ef"] = init_compress_state(params)
    return params, state
