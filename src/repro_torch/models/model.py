"""Model facade of the serving and training paths, one entry point per
step.

  init_params(cfg, seed=, device=)             -> params
  train_logits(cfg, params, batch)             -> (B, S, V) float32
  loss_fn(cfg, params, batch)                  -> (loss, metrics)
  init_caches(cfg, batch, max_len, device=, dtype=) -> caches
  prefill(cfg, params, tokens, caches=)        -> (last_logits, caches)
  decode_step(cfg, params, caches, token, pos) -> (logits, caches)
  params_from_jax(cfg, tree)                   -> params

``batch`` is a dict of ``tokens`` and ``labels``, (B, S) integers.
Decoder-only models with ``attn``, ``attn_local``, ``shared_attn``,
``mamba1`` and ``mamba2`` blocks and dense or MoE feed-forwards, each
served and trained on the card through its hand-written kernels (Mamba-2's
SSD form has none in the reference and stays plain PyTorch), in bf16 or
float32. The encoder-decoder
and VLM front ends raise ``NotImplementedError`` (ROADMAP queue 1). On one card there is no activation sharding, so the
reference's ``shardctx.anchor_batch`` has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from .common import softcap
from .transformer import check_config, init_lm_caches, init_lm_params, lm_apply


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: "str | torch.device" = "cuda") -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the reference's layout and dtypes: bf16 matrices,
    float32 norms and SSM parameters."""
    check_config(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return init_lm_params(cfg, gen)


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                device: "str | torch.device" = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> dict:
    return init_lm_caches(cfg, batch, max_len, device=resolve_device(device),
                          dtype=dtype)


def _scaled(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Gemma's sqrt(d_model) embedding scale. The reference rounds the
    scale to the activation dtype first (sqrt(1152) becomes 34.0 in bf16,
    not 33.94); a Python float times a bf16 tensor would not."""
    if not cfg.embed_scale:
        return x
    return x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))


def _embed_tokens(cfg: ArchConfig, params: dict,
                  tokens: torch.Tensor) -> torch.Tensor:
    return _scaled(cfg, params["embed"][tokens])


def _lm_logits(cfg: ArchConfig, params: dict,
               hidden: torch.Tensor) -> torch.Tensor:
    """The product runs in the weights' dtype and is cast to float32
    afterwards, as in the reference (with a 262,144-token vocab the bf16
    rounding makes ties; ``argmax`` takes the first)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (hidden @ head).float()
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    return logits


# --------------------------------------------------------------------------
# train / loss
# --------------------------------------------------------------------------

def _train_hidden(cfg: ArchConfig, params: dict, batch: dict,
                  remat: bool = False, backend: str = "auto") -> torch.Tensor:
    tokens = batch["tokens"].to(params["embed"].device, torch.int64)
    x = _embed_tokens(cfg, params, tokens)
    hidden, _ = lm_apply(cfg, params, x, mode="train", remat=remat,
                         backend=backend)
    return hidden


def train_logits(cfg: ArchConfig, params: dict, batch: dict,
                 remat: bool = False, backend: str = "auto") -> torch.Tensor:
    """(B, S, V) float32 logits of the training forward."""
    return _lm_logits(cfg, params, _train_hidden(cfg, params, batch,
                                                 remat=remat, backend=backend))


def _head_matrix(cfg: ArchConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _chunk_nll(h: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
               cap: float | None) -> torch.Tensor:
    """Summed next-token NLL of one chunk: the logits in the weights'
    dtype, cast to float32, capped; the gold logit picked by an index mask
    over the vocab, as the reference does."""
    logits = (h @ head).float()
    if cap is not None:
        logits = softcap(logits, cap)
    logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(iota == labels[..., None], logits, 0.0).sum(-1)
    return (logz - gold).sum()


def chunked_cross_entropy(cfg: ArchConfig, params: dict, hidden: torch.Tensor,
                          labels: torch.Tensor,
                          chunk: int = 512) -> torch.Tensor:
    """Token-chunked mean cross-entropy: the (tokens x vocab) logits never
    exist in full. Each chunk of ``chunk`` positions (all of S when it does
    not divide S) is computed, reduced and, under ``checkpoint``,
    recomputed in the backward: at gemma3-1b's full width one chunk's
    float32 logits are 4 x 512 x 262,144 x 4 B = 2.1 GB, where the whole
    tensor would be 4.3 GB."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    nc = S // chunk if S % chunk == 0 else 1
    chunk = S // nc
    head = _head_matrix(cfg, params)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_nll, hidden[:, sl], labels[:, sl],
                                   head, cfg.final_softcap,
                                   use_reentrant=False)
    return total / (B * S)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, remat: bool = False,
            backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """Mean next-token NLL of ``batch`` and ``{"loss", "perplexity"}``."""
    hidden = _train_hidden(cfg, params, batch, remat=remat, backend=backend)
    labels = batch["labels"].to(hidden.device, torch.int64)
    nll = chunked_cross_entropy(cfg, params, hidden, labels)
    return nll, {"loss": nll, "perplexity": torch.exp(nll)}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            caches: dict, backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """Full-prompt forward. tokens: (B, S) int. Writes every layer's
    K/V or state into ``caches`` (:func:`init_caches`, at least S long)
    and returns the last position's logits (B, 1, V) float32."""
    tokens = tokens.to(params["embed"].device, torch.int64)
    x = _embed_tokens(cfg, params, tokens)
    hidden, caches = lm_apply(cfg, params, x, mode="prefill", caches=caches,
                              backend=backend)
    return _lm_logits(cfg, params, hidden[:, -1:]), caches


def decode_step(cfg: ArchConfig, params: dict, caches: dict,
                token: torch.Tensor, pos: int, *,
                backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """token: (B, 1) int; pos: the current cache length (the token's
    position). Returns (logits (B, 1, V) float32, caches)."""
    token = token.to(params["embed"].device, torch.int64)
    x = _embed_tokens(cfg, params, token)
    hidden, caches = lm_apply(cfg, params, x, mode="decode", caches=caches,
                              pos=pos, backend=backend)
    return _lm_logits(cfg, params, hidden), caches


# --------------------------------------------------------------------------
# parameters from the reference
# --------------------------------------------------------------------------

def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(cfg: ArchConfig, tree: dict, *,
                    device: "str | torch.device" = "cpu") -> dict:
    """The reference's parameter pytree (``repro.models.model
    .init_params``), its leaves given as numpy arrays, as the port's
    parameters. The stacked ``groups`` leaves (leading ``n_groups`` axis)
    are split per group; bf16 leaves (``ml_dtypes`` arrays, which
    ``torch.from_numpy`` refuses) are carried bit for bit through
    ``uint16``. ``shared_attn`` (zamba2's one shared attention block) is
    a plain block with no group axis."""
    check_config(cfg)
    dev = resolve_device(device)
    unknown = set(tree) - {"embed", "groups", "rest", "final_norm", "lm_head",
                           "shared_attn"}
    if unknown:
        raise NotImplementedError(f"parameters {sorted(unknown)} are not "
                                  "ported to repro_torch yet (ROADMAP queue 1)")
    conv = lambda a: _leaf(a, dev)  # noqa: E731
    out = {"embed": conv(tree["embed"]),
           "groups": [_map(lambda a, g=g: conv(np.asarray(a)[g]),
                           tree["groups"]) for g in range(cfg.n_groups)],
           "rest": [_map(conv, b) for b in tree["rest"]],
           "final_norm": conv(tree["final_norm"])}
    for key in ("lm_head", "shared_attn"):
        if key in tree:
            out[key] = _map(conv, tree[key])
    return out


# --------------------------------------------------------------------------
# analytic parameter counts
# --------------------------------------------------------------------------

def count_params_analytic(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of the blocks the port serves (the reference's count for
    those configs); ``active_only`` counts a MoE layer's top-k experts
    instead of all of them. The shared attention block counts once,
    however many groups apply it."""
    check_config(cfg)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.resolved_head_dim()
    H, KV = cfg.n_heads, cfg.n_kv_heads
    attn = D * H * hd * 2 + D * KV * hd * 2 + 2 * D
    if cfg.qkv_bias:
        attn += H * hd + 2 * KV * hd
    if cfg.moe is not None:
        e = cfg.moe.top_k if active_only else cfg.moe.num_experts
        attn += D * cfg.moe.num_experts + e * 3 * D * F
        if cfg.moe.dense_residual:
            attn += 3 * D * F
    else:
        attn += 3 * D * F
    ssm, per_kind = cfg.ssm, {}
    if ssm is not None:
        di = ssm.d_inner(D)
        N = ssm.state_dim
        dtr = ssm.resolved_dt_rank(D)
        nh = di // ssm.head_dim
        conv_dim = di + 2 * N
        per_kind = {
            "mamba1": (D * 2 * di + di * ssm.conv_kernel + di
                       + di * (dtr + 2 * N) + dtr * di + di + di * N + di
                       + di * D + D),
            "mamba2": (D * (2 * di + 2 * N + nh) + conv_dim * ssm.conv_kernel
                       + conv_dim + 3 * nh + di + di * D + D)}
    full = list(cfg.layer_pattern) * cfg.n_groups + list(
        cfg.remainder_pattern)
    total = attn if "shared_attn" in full else 0     # one block, counted once
    for kind in full:
        if kind in per_kind:
            total += per_kind[kind]
        elif kind != "shared_attn":
            total += attn
    total += V * D                       # embeddings
    if not cfg.tie_embeddings:
        total += D * V
    return total + D                     # final norm
