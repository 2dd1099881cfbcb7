"""Flash attention as the models call it."""

from __future__ import annotations

import torch

from .kernel import flash_attention_kernel
from .ref import flash_attention_ref

#: ``"auto"``: the plain version for CPU tensors, the CUDA kernel for CUDA
#: tensors; ``"cuda"``: the kernel (raises on CPU tensors); ``"plain"``: the
#: plain version on any device (the reference route on the card)
BACKENDS = ("auto", "cuda", "plain")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0,
                    kv_len: int | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd) -> (B, H, Sq, hd) (see
    :func:`.ref.flash_attention_ref`). The kernel raises rather than fall
    back to the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want one of "
                         f"{BACKENDS})")
    plain = backend == "plain" or (backend == "auto" and q.device.type == "cpu")
    fn = flash_attention_ref if plain else flash_attention_kernel
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_len=kv_len)
