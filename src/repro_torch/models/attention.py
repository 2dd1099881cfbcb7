"""GQA attention of the serving and training paths, through the flash
attention op.

Both functions take the model's layout — q (B, Sq, H, hd), k and v
(B, Skv, KV, hd), H = G * KV — and hand the op ``(B, H, S, hd)`` views of
the same storage: no transpose is copied, the CUDA kernel reads through
strides. On CPU tensors the op runs its plain version; on CUDA tensors the
kernel (``backend`` overrides, see
:data:`repro_torch.kernels.flash_attention.BACKENDS`). On DTensor inputs
(a sharded step) each rank runs the call on its shards of the model's
layout (:mod:`repro_torch.kernels.sharded`): the batch over the data
axes, the heads over ``model`` when both H and KV divide it, else
replicated, so every redistribution happens in the (B, S, heads, hd)
layout the model's views expect.
"""

from __future__ import annotations

import torch

from ..kernels import sharded
from ..kernels.flash_attention import flash_attention, flash_attention_train


def _on_shards(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's shards of (B, S, heads, hd)."""
    H, KV = q.shape[2], k.shape[2]
    m = sharded.model_ranks(q)
    role = (0, 2)
    return sharded.call_local(fn, (q, k, v), (role,) * 3, (role,),
                              batch=q.shape[0],
                              split_model=H % m == 0 and KV % m == 0)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None,
                        backend: str = "auto") -> torch.Tensor:
    """Prefill attention (the reference's online-softmax
    ``attention_blockwise``): causal by default; ``causal=False`` for the
    encoder and for cross-attention, where Sq may differ from Skv. Returns
    (B, Sq, H, hd)."""
    if sharded.is_sharded(q):
        return _on_shards(lambda *a: attention_blockwise(
            *a, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, kv_len=kv_len, backend=backend), q, k, v)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        softcap=softcap, q_offset=q_offset, kv_len=kv_len,
                        backend=backend)
    return o.transpose(1, 2)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cache_len: int,
                     window: int | None = None, softcap: float | None = None,
                     backend: str = "auto") -> torch.Tensor:
    """One-token decode: q (B, 1, H, hd) against caches (B, max_len, KV,
    hd). The new token sits at position ``cache_len`` and its K/V must
    already be written at that slot; keys past it are masked
    (``q_offset=cache_len``, ``kv_len=cache_len + 1``)."""
    return attention_blockwise(q, k_cache, v_cache, window=window,
                               softcap=softcap,
                               q_offset=cache_len, kv_len=cache_len + 1,
                               backend=backend)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """Attention of the training path, differentiable: causal by default;
    ``causal=False`` for the encoder and for cross-attention, where Sq may
    differ from Skv. The same views as :func:`attention_blockwise`,
    through :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`
    (the CUDA forward and backward kernels on CUDA tensors). The gradients
    come back as views of ``(B, S, heads, hd)`` storage, so the head split
    and merge stay free. Returns (B, Sq, H, hd)."""
    if sharded.is_sharded(q):
        return _on_shards(lambda *a: attention_train(
            *a, causal=causal, window=window, softcap=softcap,
            backend=backend), q, k, v)
    o = flash_attention_train(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              softcap=softcap, backend=backend)
    return o.transpose(1, 2)
