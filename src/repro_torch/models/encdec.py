"""Whisper-style encoder-decoder backbone (the counterpart of
``repro.models.encdec``).

The conv/mel front end is a stub, as in the reference: the caller passes
precomputed frame embeddings (B, S_enc, D). The encoder is the transformer
stack over those frames (non-causal MHA); the decoder is causal
self-attention, then cross-attention over the encoder's output. LayerNorm,
GELU and biases, per the published architecture; ``wk`` has no bias. Every
attention call goes through the flash attention op
(:func:`.attention.attention_blockwise`, :func:`.attention.attention_decode`,
:func:`.attention.attention_train`).

Layout: the reference's stacked ``enc_blocks`` / ``dec_blocks`` are lists
of per-layer blocks here, and the caches ``self_k``, ``self_v``,
``cross_k``, ``cross_v`` lists of per-layer (B, S, H, hd) tensors, written
in place. The caches are bf16 in every run, float32 runs included, as the
reference's; a float32 decode casts the keys it reads to float32 at the
call (the kernel takes one dtype for q, k and v), which is exact. On one
card there is no activation sharding, so the reference's
``shardctx.anchor_batch`` calls (the identity on one device) have no
counterpart.

Shape convention, as the reference's: for S encoder frames the decoder has
S // 8 positions (``DEC_RATIO``).

Training: where a gradient is wanted, every attention call goes through
:func:`.attention.attention_train` (the forward with lse and
``flash_attention_bwd`` on the card, their plain versions on the CPU or
with ``backend="plain"``): the encoder and the cross-attention
non-causal, the decoder's self-attention causal. The cross-attention's
K and V gradients flow into the encoder's output, so the encoder trains
through them. Under ``remat`` each block is checkpointed, as the
reference's scan body.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import shardctx
from .attention import attention_blockwise, attention_decode, attention_train
from .common import layer_norm, normal_init
from .mlp import gelu_mlp, init_gelu_mlp

DEC_RATIO = 8   # decoder length = encoder frames // DEC_RATIO
CACHE_KEYS = ("self_k", "self_v", "cross_k", "cross_v")


def _init_ln(D: int, device: torch.device) -> dict:
    return {"w": torch.ones((D,), dtype=torch.float32, device=device),
            "b": torch.zeros((D,), dtype=torch.float32, device=device)}


def _init_mha(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim()
    zeros = lambda n: torch.zeros((n,), dtype=torch.bfloat16,  # noqa: E731
                                  device=gen.device)
    return {"wq": normal_init(gen, (D, H * hd)), "bq": zeros(H * hd),
            "wk": normal_init(gen, (D, H * hd)),
            "wv": normal_init(gen, (D, H * hd)), "bv": zeros(H * hd),
            "wo": normal_init(gen, (H * hd, D)), "bo": zeros(D)}


def _init_enc_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, dev = cfg.d_model, gen.device
    return {"ln1": _init_ln(D, dev), "attn": _init_mha(gen, cfg),
            "ln2": _init_ln(D, dev), "mlp": init_gelu_mlp(gen, D, cfg.d_ff)}


def _init_dec_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    D, dev = cfg.d_model, gen.device
    return {"ln1": _init_ln(D, dev), "self_attn": _init_mha(gen, cfg),
            "ln2": _init_ln(D, dev), "cross_attn": _init_mha(gen, cfg),
            "ln3": _init_ln(D, dev), "mlp": init_gelu_mlp(gen, D, cfg.d_ff)}


def init_encdec_params(cfg: ArchConfig, gen: torch.Generator, *,
                       max_enc: int, max_dec: int) -> dict:
    """Random parameters from ``gen`` in the reference's layout and dtypes
    (bf16 matrices, biases and position tables; float32 LayerNorms): the
    learned position tables ``enc_pos`` (max_enc x D) and ``dec_pos``
    (max_dec x D), one block per layer."""
    D, dev = cfg.d_model, gen.device
    return {
        "enc_pos": normal_init(gen, (max_enc, D)),
        "enc_blocks": [_init_enc_block(gen, cfg)
                       for _ in range(cfg.n_encoder_layers)],
        "enc_norm": _init_ln(D, dev),
        "embed": normal_init(gen, (cfg.vocab, D)),
        "dec_pos": normal_init(gen, (max_dec, D)),
        "dec_blocks": [_init_dec_block(gen, cfg) for _ in range(cfg.n_layers)],
        "dec_norm": _init_ln(D, dev),
    }


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["w"], p["b"])


def _mha_qkv(cfg: ArchConfig, p: dict, xq: torch.Tensor, xkv: torch.Tensor):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    q = (xq @ p["wq"] + p["bq"]).view(B, Sq, H, hd)
    k = (xkv @ p["wk"]).view(B, Skv, H, hd)
    v = (xkv @ p["wv"] + p["bv"]).view(B, Skv, H, hd)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, backend: str) -> torch.Tensor:
    """Full-sequence attention: differentiable (:func:`attention_train`)
    where a gradient is wanted, the forward alone otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return attention_train(q, k, v, causal=causal, backend=backend)
    return attention_blockwise(q, k, v, causal=causal, backend=backend)


def _enc_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
               backend: str) -> torch.Tensor:
    B, S, _ = x.shape
    bp = shardctx.unshard(bp)
    x = shardctx.anchor_batch(x)
    h = _ln(bp["ln1"], x)
    q, k, v = _mha_qkv(cfg, bp["attn"], h, h)
    o = _attend(q, k, v, causal=False, backend=backend)
    x = x + shardctx.anchor_batch(o.reshape(B, S, -1) @ bp["attn"]["wo"]) \
        + bp["attn"]["bo"]
    return x + shardctx.anchor_batch(gelu_mlp(bp["mlp"], _ln(bp["ln2"], x)))


def _dec_block(cfg: ArchConfig, bp: dict, x: torch.Tensor,
               enc_out: torch.Tensor, backend: str) -> torch.Tensor:
    B, S, _ = x.shape
    bp = shardctx.unshard(bp)
    x = shardctx.anchor_batch(x)
    h = _ln(bp["ln1"], x)
    q, k, v = _mha_qkv(cfg, bp["self_attn"], h, h)
    o = _attend(q, k, v, causal=True, backend=backend)
    x = x + shardctx.anchor_batch(o.reshape(B, S, -1)
                                  @ bp["self_attn"]["wo"]) \
        + bp["self_attn"]["bo"]
    h = _ln(bp["ln2"], x)
    q, k, v = _mha_qkv(cfg, bp["cross_attn"], h, enc_out)
    o = _attend(q, k, v, causal=False, backend=backend)
    x = x + shardctx.anchor_batch(o.reshape(B, S, -1)
                                  @ bp["cross_attn"]["wo"]) \
        + bp["cross_attn"]["bo"]
    return x + shardctx.anchor_batch(gelu_mlp(bp["mlp"], _ln(bp["ln3"], x)))


def _run(block, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``block(x)``, checkpointed under ``remat`` (as the reference's
    ``jax.checkpoint`` of its scan body)."""
    return checkpoint(block, x, use_reentrant=False) if remat else block(x)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, *,
           remat: bool = False, backend: str = "auto") -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frame embeddings (the stub front
    end). Returns the encoder's normed output (B, S_enc, D)."""
    S = frames.shape[1]
    x = shardctx.anchor_batch(frames + params["enc_pos"][None, :S])
    for bp in params["enc_blocks"]:
        x = _run(lambda h, bp=bp: _enc_block(cfg, bp, h, backend), x, remat)
    return _ln(params["enc_norm"], x)


def decode_train(cfg: ArchConfig, params: dict, enc_out: torch.Tensor,
                 tokens: torch.Tensor, *, remat: bool = False,
                 backend: str = "auto") -> torch.Tensor:
    """Teacher-forced decoder forward. tokens: (B, S_dec) int. Returns the
    normed hidden states (B, S_dec, D)."""
    S = tokens.shape[1]
    x = shardctx.anchor_batch(shardctx.embed_rows(params["embed"], tokens)
                              + params["dec_pos"][None, :S])
    for bp in params["dec_blocks"]:
        x = _run(lambda h, bp=bp: _dec_block(cfg, bp, h, enc_out, backend),
                 x, remat)
    return _ln(params["dec_norm"], x)


def init_decoder_caches(cfg: ArchConfig, batch: int, max_dec: int,
                        max_enc: int, *, device: torch.device) -> dict:
    """Zeroed bf16 caches, one (batch, S, H, hd) tensor a layer: self K/V
    of ``max_dec`` slots, cross K/V of ``max_enc``."""
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    new = lambda n: [torch.zeros((batch, n, H, hd),  # noqa: E731
                                 dtype=torch.bfloat16, device=device)
                     for _ in range(cfg.n_layers)]
    return {"self_k": new(max_dec), "self_v": new(max_dec),
            "cross_k": new(max_enc), "cross_v": new(max_enc)}


def precompute_cross_caches(cfg: ArchConfig, params: dict,
                            enc_out: torch.Tensor):
    """Cross K (no bias) and V (with its bias) of every decoder layer from
    the encoder's output, once per request: two lists of (B, S_enc, H, hd)
    bf16 tensors."""
    B, S, _ = enc_out.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    ks, vs = [], []
    for bp in params["dec_blocks"]:
        p = bp["cross_attn"]
        ks.append((enc_out @ p["wk"]).view(B, S, H, hd).to(torch.bfloat16))
        vs.append((enc_out @ p["wv"] + p["bv"]).view(B, S, H, hd)
                  .to(torch.bfloat16))
    return ks, vs


def _as_query(cache: torch.Tensor, q: torch.Tensor, n: int) -> torch.Tensor:
    """The cache's first ``n`` slots in q's dtype: the cache itself when
    the dtypes agree, else a float32 copy of those slots (exact)."""
    return cache if cache.dtype == q.dtype else cache[:, :n].to(q.dtype)


def decode_step(cfg: ArchConfig, params: dict, caches: dict,
                token: torch.Tensor, pos: int, *,
                backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """One decoder token. token: (B, 1) int; pos: its position (the self
    caches' current length). Writes its self K/V at slot ``pos`` (bf16)
    and attends over every cross slot (``cache_len = S_enc - 1``, as the
    reference). Returns (logits (B, 1, V) float32, caches): the product
    with the embedding in the weights' dtype, cast afterwards (exact), and
    no softcap."""
    B = token.shape[0]
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    x = shardctx.embed_rows(params["embed"], token) \
        + params["dec_pos"][pos:pos + 1][None]
    for i, bp in enumerate(params["dec_blocks"]):
        sk, sv, ck, cv = (caches[key][i] for key in CACHE_KEYS)
        bp = shardctx.unshard(bp)
        p = bp["self_attn"]
        h = _ln(bp["ln1"], x)
        q = (h @ p["wq"] + p["bq"]).view(B, 1, H, hd)
        sk[:, pos] = (h @ p["wk"]).view(B, H, hd)
        sv[:, pos] = (h @ p["wv"] + p["bv"]).view(B, H, hd)
        o = attention_decode(q, _as_query(sk, q, pos + 1),
                             _as_query(sv, q, pos + 1), cache_len=pos,
                             backend=backend)
        x = x + o.reshape(B, 1, -1) @ p["wo"] + p["bo"]
        p = bp["cross_attn"]
        h = _ln(bp["ln2"], x)
        q = (h @ p["wq"] + p["bq"]).view(B, 1, H, hd)
        n = ck.shape[1]
        o = attention_decode(q, _as_query(ck, q, n), _as_query(cv, q, n),
                             cache_len=n - 1, backend=backend)
        x = x + o.reshape(B, 1, -1) @ p["wo"] + p["bo"]
        x = x + gelu_mlp(bp["mlp"], _ln(bp["ln3"], x))
    x = _ln(params["dec_norm"], x)
    return (x @ params["embed"].T).float(), caches
