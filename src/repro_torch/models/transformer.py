"""Decoder-only LM assembled from an ArchConfig.

The layer stack is ``n_groups`` repeats of the config's group pattern (e.g.
gemma3 = local x5, global; zamba2 = mamba2 x6, shared_attn) plus a
remainder, run as a Python loop. The parameters keep the reference's
layout with the stacked group axis unstacked: ``params["groups"][g]
[f"b{i}"]`` is block ``i`` of group ``g``, ``params["rest"][i]`` block
``i`` of the remainder. zamba2's ``shared_attn`` is one attention block,
``params["shared_attn"]``, that every group applies; the group dicts hold
no slot for it (the reference drops its placeholder). The caches mirror
the groups, and there each application of the shared block keeps its own
KV cache at ``caches["groups"][g][f"b{i}"]``.

Three modes share the block code:
  * train: causal forward, no caches, differentiable: attention goes
    through :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`
    (the CUDA forward and backward kernels on the card); ``remat=True``
    checkpoints each group and each remainder block
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``);
  * prefill: causal forward over the prompt, writing every layer's KV or
    state into the caches;
  * decode: one token against the caches (``pos`` = current length).

The caches are updated in place (the reference returns new ones): an
attention cache is allocated once at the serving length and each step
writes its token's K/V at slot ``pos``.

Blocks ``attn``, ``attn_local``, ``shared_attn``, ``mamba1`` and
``mamba2`` are ported, and an attention block's feed-forward is the MoE
one (:mod:`.moe`, with the dense residual MLP beside it where the config
has one) when ``cfg.moe`` is set, else the plain GELU MLP for
``act="gelu"`` and the gated one for the others. The encoder-decoder is
:mod:`.encdec`. In train mode ``mamba1`` runs its scan
through :class:`~repro_torch.kernels.selective_scan.SelectiveScanFn` (the
CUDA forward and backward kernels on the card); ``mamba2`` is plain
PyTorch under autograd (:func:`.mamba.mamba2_forward`).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import shardctx
from .attention import attention_blockwise, attention_decode, attention_train
from .common import ACTS, normal_init, rms_norm, rope
from .mamba import (init_mamba1, init_mamba2, mamba1_decode, mamba1_forward,
                    mamba2_decode, mamba2_forward)
from .mlp import gated_mlp, gelu_mlp, init_gated_mlp, init_gelu_mlp
from .moe import init_moe, moe_ffn

ATTN_KINDS = ("attn", "attn_local", "shared_attn")
SSM_KINDS = ("mamba1", "mamba2")
KINDS = ATTN_KINDS + SSM_KINDS
MODES = ("train", "prefill", "decode")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               "(ROADMAP queue 1)")


def check_config(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve: a
    block kind or activation it does not know."""
    for kind in cfg.layer_pattern:
        if kind not in KINDS:
            raise _not_ported(f"block kind {kind!r}")
    if cfg.act not in ACTS:
        raise _not_ported(f"act={cfg.act!r}")


# --------------------------------------------------------------------------
# per-block init
# --------------------------------------------------------------------------

def _init_attn_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D = cfg.d_model
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    f32, bf16, dev = torch.float32, torch.bfloat16, gen.device
    p = {
        "ln1": torch.zeros((D,), dtype=f32, device=dev),
        "wq": normal_init(gen, (D, H * hd)),
        "wk": normal_init(gen, (D, KV * hd)),
        "wv": normal_init(gen, (D, KV * hd)),
        "wo": normal_init(gen, (H * hd, D)),
        "ln2": torch.zeros((D,), dtype=f32, device=dev),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=bf16, device=dev)
        p["bk"] = torch.zeros((KV * hd,), dtype=bf16, device=dev)
        p["bv"] = torch.zeros((KV * hd,), dtype=bf16, device=dev)
    if cfg.moe is not None:
        p["moe"] = init_moe(gen, D, cfg.d_ff, cfg.moe.num_experts,
                            cfg.moe.dense_residual)
    elif cfg.act == "gelu":
        p["mlp"] = init_gelu_mlp(gen, D, cfg.d_ff)
    else:
        p["mlp"] = init_gated_mlp(gen, D, cfg.d_ff)
    return p


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    if kind in ATTN_KINDS:
        return _init_attn_block(gen, cfg)
    if kind in SSM_KINDS:
        init = init_mamba1 if kind == "mamba1" else init_mamba2
        return {"ln": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=gen.device),
                "mixer": init(gen, cfg.d_model, cfg.ssm)}
    raise _not_ported(f"block kind {kind!r}")


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, *,
                     device: torch.device,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """Zeroed cache of one block: K/V (batch, max_len, KV, hd) in the
    activation dtype for attention; for mamba1 and mamba2 the conv states
    in bf16 (as the reference stores them, even in a float32 run) and the
    float32 scan state (mamba2: conv states ``{x, B, C}``, state (batch,
    nh, P, N))."""
    if kind in ATTN_KINDS:
        shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim())
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind not in SSM_KINDS:
        raise _not_ported(f"block kind {kind!r}")
    ssm = cfg.ssm
    di = ssm.d_inner(cfg.d_model)
    N = ssm.state_dim
    conv = lambda n: torch.zeros((batch, ssm.conv_kernel - 1, n),  # noqa: E731
                                 dtype=torch.bfloat16, device=device)
    if kind == "mamba1":
        return {"conv": conv(di),
                "ssm": torch.zeros((batch, di, N), dtype=torch.float32,
                                   device=device)}
    P = ssm.head_dim
    return {"conv": {"x": conv(di), "B": conv(N), "C": conv(N)},
            "ssm": torch.zeros((batch, di // P, P, N), dtype=torch.float32,
                               device=device)}


# --------------------------------------------------------------------------
# per-block apply
# --------------------------------------------------------------------------

def apply_block(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor, *,
                mode: str, cache: dict | None = None, pos: int | None = None,
                backend: str = "auto") -> tuple[torch.Tensor, dict | None]:
    """Returns (x, cache); ``cache`` is updated in place (None in train
    mode)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (want one of {MODES})")
    p = shardctx.unshard(p)
    x = shardctx.anchor_batch(x)
    if kind in ATTN_KINDS:
        return _apply_attn(cfg, kind, p, x, mode=mode, cache=cache, pos=pos,
                           backend=backend)
    if kind == "mamba2":
        return _apply_mamba2(cfg, p, x, mode=mode, cache=cache)
    if kind != "mamba1":
        raise _not_ported(f"block kind {kind!r}")
    h = rms_norm(x, p["ln"])
    if mode == "train":
        y, _ = mamba1_forward(p["mixer"], h, cfg.ssm, backend=backend,
                              train=True)
        return x + shardctx.anchor_batch(y), None
    if mode == "prefill":
        y, (conv, ssm_state) = mamba1_forward(p["mixer"], h, cfg.ssm,
                                              backend=backend)
    else:
        y, (conv, ssm_state) = mamba1_decode(
            p["mixer"], h, (cache["conv"], cache["ssm"]), cfg.ssm,
            backend=backend)
    cache["conv"] = conv.to(torch.bfloat16)
    cache["ssm"] = ssm_state
    return x + shardctx.anchor_batch(y), cache


def _apply_mamba2(cfg: ArchConfig, p: dict, x: torch.Tensor, *, mode: str,
                  cache: dict | None) -> tuple[torch.Tensor, dict | None]:
    h = rms_norm(x, p["ln"])
    if mode == "decode":
        y, (conv, ssm_state) = mamba2_decode(
            p["mixer"], h, (cache["conv"], cache["ssm"]), cfg.ssm)
    else:
        y, (conv, ssm_state) = mamba2_forward(p["mixer"], h, cfg.ssm,
                                              chunk=cfg.scan_chunk)
        if mode == "train":
            return x + shardctx.anchor_batch(y), None
    cache["conv"] = {k: c.to(torch.bfloat16) for k, c in conv.items()}
    cache["ssm"] = ssm_state
    return x + shardctx.anchor_batch(y), cache


def _apply_attn(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor, *,
                mode: str, cache: dict, pos: int | None,
                backend: str) -> tuple[torch.Tensor, dict]:
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    window = cfg.local_window if kind == "attn_local" else None

    h = rms_norm(x, p["ln1"])
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.view(B, S, H, hd)
    k = k.view(B, S, KV, hd)
    v = v.view(B, S, KV, hd)
    if mode == "decode":
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode == "train":
        o = attention_train(q, k, v, window=window, softcap=cfg.attn_softcap,
                            backend=backend)
    elif mode == "prefill":
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        o = attention_blockwise(q, k, v, window=window,
                                softcap=cfg.attn_softcap, backend=backend)
    else:  # decode: the new token's k/v go to slot ``pos``
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        o = attention_decode(q, cache["k"], cache["v"], cache_len=pos,
                             window=window, softcap=cfg.attn_softcap,
                             backend=backend)
    x = x + shardctx.anchor_batch(o.reshape(B, S, H * hd) @ p["wo"])
    h2 = rms_norm(x, p["ln2"])
    if cfg.moe is not None:
        # SiLU experts (the reference's default act), cfg.act's residual
        y = moe_ffn(p["moe"], h2, top_k=cfg.moe.top_k,
                    capacity_factor=cfg.moe.capacity_factor)
        if cfg.moe.dense_residual:
            y = y + gated_mlp(p["moe"]["res"], h2, cfg.act)
    elif cfg.act == "gelu":
        y = gelu_mlp(p["mlp"], h2)
    else:
        y = gated_mlp(p["mlp"], h2, cfg.act)
    return x + shardctx.anchor_batch(y), cache


# --------------------------------------------------------------------------
# full stack
# --------------------------------------------------------------------------

def _group_block(tree: dict, g: int, i: int, kind: str) -> dict:
    """Block ``i`` of group ``g`` in a params or caches tree: the one
    shared attention block where the parameters hold it (every application
    reads it), else the group's own slot (caches keep one per
    application)."""
    if kind == "shared_attn" and "shared_attn" in tree:
        return tree["shared_attn"]
    return tree["groups"][g][f"b{i}"]


def _layers(cfg: ArchConfig, tree: dict):
    """(kind, params-or-cache of that block) for every layer, in order."""
    for g in range(cfg.n_groups):
        for i, kind in enumerate(cfg.layer_pattern):
            yield kind, _group_block(tree, g, i, kind)
    for i, kind in enumerate(cfg.remainder_pattern):
        yield kind, tree["rest"][i]


def init_lm_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    check_config(cfg)
    groups = [{f"b{i}": init_block(gen, cfg, k)
               for i, k in enumerate(cfg.layer_pattern)
               if k != "shared_attn"}
              for _ in range(cfg.n_groups)]
    params = {
        "embed": normal_init(gen, (cfg.vocab, cfg.d_model)),
        "groups": groups,
        "rest": [init_block(gen, cfg, k) for k in cfg.remainder_pattern],
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=gen.device),
    }
    if "shared_attn" in cfg.layer_pattern:
        params["shared_attn"] = init_block(gen, cfg, "shared_attn")
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab))
    return params


def _train_stack(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
                 remat: bool, backend: str) -> torch.Tensor:
    """The train-mode stack: one checkpointed segment per group and per
    remainder block under ``remat`` (each recomputed in the backward, so
    training holds one segment's activations at a time). Each segment runs
    inside a ``train_segment`` profiler range, so that a trace tells its
    recompute from the backward node that triggered it."""
    def run(blocks, h):
        with torch.profiler.record_function("train_segment"):
            for kind, p in blocks:
                h, _ = apply_block(cfg, kind, p, h, mode="train",
                                   backend=backend)
        return h

    segments = [[(kind, _group_block(params, g, i, kind))
                 for i, kind in enumerate(cfg.layer_pattern)]
                for g in range(cfg.n_groups)]
    segments += [[(kind, p)] for kind, p in zip(cfg.remainder_pattern,
                                                params["rest"])]
    for blocks in segments:
        x = (checkpoint(run, blocks, x, use_reentrant=False) if remat
             else run(blocks, x))
    return x


def lm_apply(cfg: ArchConfig, params: dict, x: torch.Tensor, *, mode: str,
             caches: dict | None = None, pos: int | None = None,
             backend: str = "auto",
             remat: bool = False) -> tuple[torch.Tensor, dict | None]:
    """Run the full stack on hidden states x (B, S, D); returns the final
    normed hidden states and the caches (updated in place; None in train
    mode, where ``remat`` checkpoints each group and remainder block)."""
    if mode == "train":
        x = _train_stack(cfg, params, x, remat=remat, backend=backend)
        return rms_norm(x, params["final_norm"]), None
    for (kind, p), (_, cache) in zip(_layers(cfg, params),
                                     _layers(cfg, caches)):
        x, _ = apply_block(cfg, kind, p, x, mode=mode, cache=cache, pos=pos,
                           backend=backend)
    return rms_norm(x, params["final_norm"]), caches


def init_lm_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                   device: torch.device,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    check_config(cfg)
    new = lambda k: init_block_cache(cfg, k, batch, max_len,  # noqa: E731
                                     device=device, dtype=dtype)
    return {"groups": [{f"b{i}": new(k) for i, k in enumerate(cfg.layer_pattern)}
                       for _ in range(cfg.n_groups)],
            "rest": [new(k) for k in cfg.remainder_pattern]}
