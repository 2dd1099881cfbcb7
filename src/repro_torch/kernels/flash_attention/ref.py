"""Plain PyTorch version of the flash attention kernel
(``csrc/flash_attention.cu``).

The counterpart of ``flash_attention_ref``
(``src/repro/kernels/flash_attention/ref.py:11``): the scores of every
query against every key are materialised in float32, masked with the
finite ``-1e30`` sentinel, soft-maxed and contracted with the values, and
the result is cast back to the query's dtype. The CPU tests and the
``backend="plain"`` route run it; the CUDA kernel computes the same
function with an online softmax over key tiles.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, *, causal: bool, window: int | None,
                   q_offset: int, kv_len: int | None,
                   device: torch.device) -> torch.Tensor:
    """``(sq, skv)`` bool mask of the keys each query may see: causal
    (key position ≤ query position), inside the sliding window (key
    position > query position − window) and below ``kv_len``. Query ``i``
    sits at position ``q_offset + i``."""
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        mask &= k_pos[None, :] < kv_len
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd) with H = G * KV (query
    head ``h`` reads KV head ``h // G``). Returns (B, H, Sq, hd) in q's
    dtype."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.reshape(B, KV, G, Sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * (hd ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)
