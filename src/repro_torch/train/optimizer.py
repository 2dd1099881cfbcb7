"""AdamW with float32 master weights and a cosine schedule, on dict trees
of tensors (the counterpart of ``repro.train.optimizer``).

State layout (trees mirroring params):
  master: float32 copy of params (the source of truth)
  m, v:   float32 first/second moments
  step:   scalar int32 tensor

Every function is written op for op as the reference's, in float32:
``b1 ** step`` as a float32 power, the global-norm clip factor, weight
decay on the master copy inside the update. ``torch.optim.AdamW`` would
not do: its decoupled decay rounds differently and it keeps neither a
master copy nor the global-norm clip. The update is functional: it
returns new trees and leaves its inputs unchanged (a re-issued step must
not apply twice).

``compress_grads`` quantizes each gradient to int8 with error feedback
before the update (``jnp.round`` and ``torch.round`` both round half to
even, so the payload matches the reference's bit for bit).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_grads: bool = False      # int8 + error feedback


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of dict/list trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves, dict keys in sorted order (as ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def cosine_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(1, cfg.warmup_steps)
    t = torch.clip((step - cfg.warmup_steps)
                   / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict[str, Any]:
    dev = tree_leaves(params)[0].device
    return {
        "master": tree_map(lambda p: p.to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def init_compress_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize_int8(g: torch.Tensor, err: torch.Tensor):
    """Gradient + carried error -> (dequantized int8 payload, new error)."""
    t = g + err
    scale = torch.clamp_min(t.abs().max(), 1e-12) / 127.0
    q = torch.clip(torch.round(t / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, t - deq


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(torch.float32)))
              for g in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def adamw_update(cfg: OptimizerConfig, grads, params, state,
                 compress_state=None):
    """Returns (new_params, new_state, new_compress_state, stats); the
    inputs are left unchanged."""
    # each leaf is cast to float32 where it is used (the norm, the update),
    # so the float32 copy of the whole gradient never exists at once
    if cfg.compress_grads and compress_state is not None:
        pairs = tree_map(lambda g, e: quantize_int8(g.to(torch.float32), e),
                         grads, compress_state)
        is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
        grads = _unzip(pairs, 0, is_pair)
        compress_state = _unzip(pairs, 1, is_pair)
    gn = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-12), 1.0)

    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(g, m, v, master):
        g = g.to(torch.float32) * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        new_master = master - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                    + cfg.weight_decay * master)
        return m, v, new_master

    out = tree_map(upd, grads, state["m"], state["v"], state["master"])
    is_triple = lambda x: isinstance(x, tuple) and len(x) == 3  # noqa: E731
    m, v = _unzip(out, 0, is_triple), _unzip(out, 1, is_triple)
    master = _unzip(out, 2, is_triple)
    new_params = tree_map(lambda mp, p: mp.to(p.dtype), master, params)
    new_state = {"master": master, "m": m, "v": v, "step": step}
    stats = {"grad_norm": gn, "lr": lr}
    return new_params, new_state, compress_state, stats


def _unzip(tree, i: int, is_leaf: Callable):
    """Field ``i`` of each tuple leaf of ``tree``."""
    if is_leaf(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _unzip(t, i, is_leaf) for k, t in tree.items()}
    return type(tree)(_unzip(t, i, is_leaf) for t in tree)
