"""Model facade of the serving and training paths, one entry point per
step.

  init_params(cfg, seed=, device=)             -> params
  train_logits(cfg, params, batch)             -> (B, S, V) float32
  loss_fn(cfg, params, batch)                  -> (loss, metrics)
  init_caches(cfg, batch, max_len, device=, dtype=) -> caches
  prefill(cfg, params, tokens, caches=, frames=, vision_embeds=)
                                               -> (last_logits, caches)
  decode_step(cfg, params, caches, token, pos) -> (logits, caches)
  params_from_jax(cfg, tree)                   -> params

``batch`` is a dict of ``tokens`` and ``labels``, (B, S) integers, plus
``frames`` (B, S_enc, D) for the encoder-decoder (its tokens and labels
are the decoder's) and optionally ``vision_embeds`` (B, n, D) for a VLM.
Decoder-only models with ``attn``, ``attn_local``, ``shared_attn``,
``mamba1`` and ``mamba2`` blocks and dense or MoE feed-forwards, each
served and trained on the card through its hand-written kernels (Mamba-2's
SSD form has none in the reference and stays plain PyTorch), in bf16 or
float32. The encoder-decoder (whisper, :mod:`.encdec`: the encoder and
the cross-attention non-causal) and the VLM front end (a stub, as the
reference's: patch embeddings overwrite the first positions) are served
and trained the same way. With a mesh installed
(:mod:`.shardctx`, the sharded step of :mod:`repro_torch.launch.dryrun`)
the batch sharding is re-anchored where the reference anchors it: after
the embedding, after the layer stack and on each cross-entropy chunk;
without one those calls return their input.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, ShapeConfig
from ..device import resolve_device
from . import encdec, shardctx
from .common import softcap
from .transformer import check_config, init_lm_caches, init_lm_params, lm_apply

DEC_RATIO = encdec.DEC_RATIO
#: the encoder-decoder's parameter tree
ENCDEC_KEYS = ("enc_pos", "enc_blocks", "enc_norm", "embed", "dec_pos",
               "dec_blocks", "dec_norm")


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: "str | torch.device" = "cuda", max_enc: int = 4096,
                max_dec: int = 512) -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), in the reference's layout and dtypes: bf16 matrices,
    float32 norms and SSM parameters. ``max_enc`` and ``max_dec`` size
    the encoder-decoder's position tables."""
    check_config(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    if cfg.enc_dec:
        return encdec.init_encdec_params(cfg, gen, max_enc=max_enc,
                                         max_dec=max_dec)
    return init_lm_params(cfg, gen)


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                device: "str | torch.device" = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Zeroed caches for ``max_len`` positions in ``dtype``. For the
    encoder-decoder ``max_len`` is the encoder's frame count: cross caches
    of ``max_len`` slots and self caches of ``max_len // 8``, bf16 in every
    run as the reference's (another ``dtype`` raises)."""
    dev = resolve_device(device)
    if cfg.enc_dec:
        if dtype != torch.bfloat16:
            raise ValueError("the encoder-decoder's caches are bf16 in every "
                             f"run, as the reference's (got {dtype})")
        return encdec.init_decoder_caches(
            cfg, batch, max_dec=max(1, max_len // DEC_RATIO),
            max_enc=max_len, device=dev)
    return init_lm_caches(cfg, batch, max_len, device=dev, dtype=dtype)


def _scaled(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Gemma's sqrt(d_model) embedding scale. The reference rounds the
    scale to the activation dtype first (sqrt(1152) becomes 34.0 in bf16,
    not 33.94); a Python float times a bf16 tensor would not."""
    if not cfg.embed_scale:
        return x
    return x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))


def _embed_tokens(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                  vision_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The token embeddings; for a VLM config the stub front end's patch
    embeddings (B, n, D), cast to the activation dtype, replace positions
    ``[0, n)``."""
    x = _scaled(cfg, shardctx.embed_rows(params["embed"], tokens))
    if vision_embeds is None:
        return shardctx.anchor_batch(x)
    if not cfg.vision_tokens:
        raise ValueError(f"{cfg.name} has no vision front end "
                         "(vision_tokens = 0)")
    B, S, D = x.shape
    n = vision_embeds.shape[1]
    if vision_embeds.shape != (B, n, D) or n > S:
        raise ValueError(f"vision_embeds {tuple(vision_embeds.shape)} do not "
                         f"fit the embedded tokens {tuple(x.shape)}")
    v = vision_embeds.to(x.device, x.dtype)
    return shardctx.anchor_batch(torch.cat([v, x[:, n:]], dim=1))


def _head_matrix(cfg: ArchConfig, params: dict) -> torch.Tensor:
    return (params["embed"].T if cfg.tie_embeddings or cfg.enc_dec
            else params["lm_head"])


def _lm_logits(cfg: ArchConfig, params: dict,
               hidden: torch.Tensor) -> torch.Tensor:
    """The product runs in the weights' dtype and is cast to float32
    afterwards, as in the reference (with a 262,144-token vocab the bf16
    rounding makes ties; ``argmax`` takes the first)."""
    logits = (hidden @ _head_matrix(cfg, params)).float()
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    return logits


# --------------------------------------------------------------------------
# train / loss
# --------------------------------------------------------------------------

def _train_hidden(cfg: ArchConfig, params: dict, batch: dict,
                  remat: bool = False, backend: str = "auto") -> torch.Tensor:
    tokens = batch["tokens"].to(params["embed"].device, torch.int64)
    if cfg.enc_dec:
        frames = batch["frames"].to(tokens.device)
        enc_out = encdec.encode(cfg, params, frames, remat=remat,
                                backend=backend)
        return encdec.decode_train(cfg, params, enc_out, tokens, remat=remat,
                                   backend=backend)
    x = _embed_tokens(cfg, params, tokens, batch.get("vision_embeds"))
    hidden, _ = lm_apply(cfg, params, x, mode="train", remat=remat,
                         backend=backend)
    return shardctx.anchor_batch(hidden)


def train_logits(cfg: ArchConfig, params: dict, batch: dict,
                 remat: bool = False, backend: str = "auto") -> torch.Tensor:
    """(B, S, V) float32 logits of the training forward (the
    encoder-decoder's: the decoder's, teacher-forced over ``frames``)."""
    return _lm_logits(cfg, params, _train_hidden(cfg, params, batch,
                                                 remat=remat, backend=backend))


def _chunk_nll(h: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
               cap: float | None) -> torch.Tensor:
    """Summed next-token NLL of one chunk: the logits in the weights'
    dtype, cast to float32, capped; the gold logit picked by an index mask
    over the vocab, as the reference does. On a mesh the logits are
    anchored whole over ``model`` (each data rank its rows)."""
    logits = shardctx.anchor_batch(h @ head).float()
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
        total = total + checkpoint(_chunk_nll,
                                   shardctx.anchor_batch(hidden[:, sl]),
                                   labels[:, sl],
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

def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor | None = None,
            *, caches: dict, frames: torch.Tensor | None = None,
            vision_embeds: torch.Tensor | None = None,
            backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """Full-prompt forward. tokens: (B, S) int. Writes every layer's
    K/V or state into ``caches`` (:func:`init_caches`, at least S long)
    and returns the last position's logits (B, 1, V) float32. A VLM takes
    ``vision_embeds`` (B, n, D) for its first n positions.

    The encoder-decoder takes ``frames`` (B, S_enc, D) and no tokens, as
    the reference's: it encodes them, writes every layer's cross K/V into
    ``caches`` (``init_caches(cfg, B, S_enc)``: the cross caches must hold
    exactly S_enc slots, since decode attends over all of them) and runs one
    decode step at the BOS token 0, position 0, whose logits it returns."""
    if cfg.enc_dec:
        if frames is None or tokens is not None:
            raise ValueError("the encoder-decoder's prefill takes frames "
                             "(B, S_enc, D) and no tokens")
        return _prefill_encdec(cfg, params, frames, caches, backend)
    if tokens is None or frames is not None:
        raise ValueError(f"{cfg.name}'s prefill takes tokens, not frames")
    tokens = tokens.to(params["embed"].device, torch.int64)
    x = _embed_tokens(cfg, params, tokens, vision_embeds)
    hidden, caches = lm_apply(cfg, params, x, mode="prefill", caches=caches,
                              backend=backend)
    return _lm_logits(cfg, params, hidden[:, -1:]), caches


def _prefill_encdec(cfg: ArchConfig, params: dict, frames: torch.Tensor,
                    caches: dict, backend: str) -> tuple[torch.Tensor, dict]:
    frames = frames.to(params["embed"].device)
    enc_out = encdec.encode(cfg, params, frames, backend=backend)
    B, S, _ = enc_out.shape
    ks, vs = encdec.precompute_cross_caches(cfg, params, enc_out)
    for name, new in (("cross_k", ks), ("cross_v", vs)):
        for cache, t in zip(caches[name], new):
            if cache.shape != t.shape:
                raise ValueError(f"{name} cache {tuple(cache.shape)} does not "
                                 f"hold the {B} x {S} encoder frames "
                                 "(init_caches(cfg, B, S_enc))")
            cache.copy_(t)
    bos = torch.zeros((B, 1), dtype=torch.int64, device=enc_out.device)
    return encdec.decode_step(cfg, params, caches, bos, 0, backend=backend)


def decode_step(cfg: ArchConfig, params: dict, caches: dict,
                token: torch.Tensor, pos: int, *,
                backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """token: (B, 1) int; pos: the current cache length (the token's
    position). Returns (logits (B, 1, V) float32, caches)."""
    token = token.to(params["embed"].device, torch.int64)
    if cfg.enc_dec:
        return encdec.decode_step(cfg, params, caches, token, pos,
                                  backend=backend)
    x = _embed_tokens(cfg, params, token)
    hidden, caches = lm_apply(cfg, params, x, mode="decode", caches=caches,
                              pos=pos, backend=backend)
    return _lm_logits(cfg, params, hidden), caches


# --------------------------------------------------------------------------
# dry-run input specs
# --------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Every model input of a cell as a meta tensor (no memory) of the
    reference's shape and dtype (``repro.models.model.input_specs``).
    Decode's caches and position are built by the caller
    (:func:`init_caches`)."""
    B, S = shape.global_batch, shape.seq_len
    f = lambda s, dt: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        if cfg.enc_dec:
            return {"frames": f((B, S, cfg.d_model), bf16),
                    "tokens": f((B, S // DEC_RATIO), i32),
                    "labels": f((B, S // DEC_RATIO), i32)}
        batch = {"tokens": f((B, S), i32), "labels": f((B, S), i32)}
    elif shape.kind == "prefill":
        if cfg.enc_dec:
            return {"frames": f((B, S, cfg.d_model), bf16)}
        batch = {"tokens": f((B, S), i32)}
    else:
        batch = {"tokens": f((B, 1), i32)}
    if cfg.vision_tokens and not cfg.enc_dec and shape.kind != "decode":
        batch["vision_embeds"] = f((B, cfg.vision_tokens, cfg.d_model), bf16)
    return batch


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
    are split per group, the encoder-decoder's ``enc_blocks`` and
    ``dec_blocks`` per layer; bf16 leaves (``ml_dtypes`` arrays, which
    ``torch.from_numpy`` refuses) are carried bit for bit through
    ``uint16``. ``shared_attn`` (zamba2's one shared attention block) is
    a plain block with no group axis."""
    check_config(cfg)
    dev = resolve_device(device)
    known = (ENCDEC_KEYS if cfg.enc_dec else
             {"embed", "groups", "rest", "final_norm", "lm_head",
              "shared_attn"})
    unknown = set(tree) - set(known)
    if unknown:
        raise NotImplementedError(f"parameters {sorted(unknown)} are not "
                                  "ported to repro_torch yet (ROADMAP queue 1)")
    conv = lambda a: _leaf(a, dev)  # noqa: E731

    def split(stacked, n: int) -> list:
        """Row i of every leaf of a stacked tree, i < n."""
        return [_map(lambda a, i=i: conv(np.asarray(a)[i]), stacked)
                for i in range(n)]

    if cfg.enc_dec:
        out = {k: _map(conv, tree[k]) for k in ENCDEC_KEYS
               if k not in ("enc_blocks", "dec_blocks")}
        out["enc_blocks"] = split(tree["enc_blocks"], cfg.n_encoder_layers)
        out["dec_blocks"] = split(tree["dec_blocks"], cfg.n_layers)
        return out
    out = {"embed": conv(tree["embed"]),
           "groups": split(tree["groups"], cfg.n_groups),
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
    """The reference's analytic parameter count (``repro.models.model
    .count_params_analytic``), term for term: ``active_only`` counts a MoE
    layer's top-k experts instead of all of them; the shared attention
    block counts once, however many groups apply it; the encoder-decoder
    adds the reference's approximate encoder and cross-attention terms
    (not the exact size of :func:`init_params`' tree)."""
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
    elif cfg.act == "gelu":
        attn += 2 * D * F + F + D
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
    total += D                           # final norm
    if cfg.enc_dec:
        # the encoder's blocks (MHA, GELU MLP, norms) and each decoder
        # layer's cross-attention
        total += cfg.n_encoder_layers * (D * H * hd * 4 + 2 * D * F + F
                                         + D + 4 * D)
        total += cfg.n_layers * (D * H * hd * 4 + 4 * D)
    return total
