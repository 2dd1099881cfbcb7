"""Plain PyTorch version of the flash attention kernel
(``csrc/flash_attention.cu``).

The counterpart of ``flash_attention_ref``
(``src/repro/kernels/flash_attention/ref.py:11``): the scores of every
query against every key are materialised in float32, masked with the
finite ``-1e30`` sentinel, soft-maxed and contracted with the values, and
the result is cast back to the query's dtype (float64 inputs compute in
float64). The CPU tests and the
``backend="plain"`` route run it; the CUDA kernels compute the same
function with an online softmax over key tiles (prefill) or over splits of
the key range merged by log-sum-exp (decode, whose plain version is
:func:`flash_attention_split_ref`).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def key_range(sq: int, kend: int, *, causal: bool, window: int | None,
              q_offset: int) -> tuple[int, int]:
    """The keys queries ``q_offset .. q_offset + sq - 1`` may see under
    the causal and window masks, with keys ``[0, kend)`` present: the
    window's lower edge for the first query, the causal edge of the last.
    Empty ranges come back as ``(lo, lo)``."""
    lo = 0 if window is None else max(0, q_offset - window + 1)
    hi = min(kend, q_offset + sq) if causal else kend
    return lo, max(lo, hi)


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


def _masked_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                  window: int | None, softcap: float | None, q_offset: int,
                  kv_len: int | None) -> torch.Tensor:
    """The scaled (and capped) scores of every query against every key,
    ``(B, KV, G, Sq, Skv)``, the keys a query may not see set to the finite
    ``-1e30``; in float32, float64 for float64 inputs."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    cdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.reshape(B, KV, H // KV, Sq, hd).to(cdt)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.to(cdt)) * (hd ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len, device=q.device)
    return torch.where(mask, s, NEG_INF)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd) with H = G * KV (query
    head ``h`` reads KV head ``h // G``). Returns (B, H, Sq, hd) in q's
    dtype."""
    return flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   kv_len=kv_len, with_lse=False)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int | None = None,
                            softcap: float | None = None, q_offset: int = 0,
                            kv_len: int | None = None, with_lse: bool = True):
    """:func:`flash_attention_ref` with each row's log-sum-exp of its
    masked scores (:func:`_masked_scores`) and the output before its
    rounding: ``(o, lse, o_wide)``, lse ``(B, H, Sq)`` and ``o_wide`` in
    float32 (float64 for float64 inputs; ``o`` itself unless the inputs are
    bf16), lse in natural log. The forward of the training path; the
    backward rebuilds ``P = exp(s - lse)`` from lse and takes ``Delta =
    rowsum(dO * o_wide)``."""
    B, H, Sq, hd = q.shape
    s = _masked_scores(q, k, causal=causal, window=window, softcap=softcap,
                      q_offset=q_offset, kv_len=kv_len)
    p = torch.softmax(s, dim=-1)
    wide = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(s.dtype))
    wide = wide.reshape(B, H, Sq, hd)
    o = wide.to(q.dtype)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq), wide


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int | None = None,
                              softcap: float | None = None, q_offset: int = 0,
                              kv_len: int | None = None,
                              split_len: int = 32) -> torch.Tensor:
    """Plain version of the split-KV decode kernel, same contract as
    :func:`flash_attention_ref`. The keys some query may see
    (:func:`key_range`) are cut into splits of ``split_len``; each
    split gives every row a float32 partial ``(m, l, acc)`` — its masked
    max, ``sum exp(s - m)`` and ``sum exp(s - m) v`` over its valid keys,
    ``(-1e30, 0, 0)`` when it has none — and the merge weighs split ``s``
    by ``exp(m_s - M)``, ``M`` the largest ``m_s``."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    kend = Skv if kv_len is None else max(0, min(Skv, kv_len))
    lo, hi = key_range(Sq, kend, causal=causal, window=window,
                       q_offset=q_offset)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len, device=q.device)
    qf = q.reshape(B, KV, G, Sq, hd).float()
    parts = []
    for a in range(lo, max(hi, lo + 1), split_len):
        e = min(hi, a + split_len)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, k[:, :, a:e].float()) * (
            hd ** -0.5)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        ok = mask[:, a:e].expand_as(s)
        s = torch.where(ok, s, NEG_INF)
        m = (s.amax(-1) if e > a
             else torch.full(s.shape[:-1], NEG_INF, device=q.device))
        p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgqs,bksd->bkgqd", p,
                                   v[:, :, a:e].float())))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - big) for m, _, _ in parts]
    total = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    acc = sum(wi[..., None] * a for wi, (_, _, a) in zip(w, parts))
    o = acc / total.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, Sq, hd).to(q.dtype)
