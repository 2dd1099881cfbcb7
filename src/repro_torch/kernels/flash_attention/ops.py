"""Flash attention as the models call it: the forward alone (serving) and
the differentiable forward and backward (training)."""

from __future__ import annotations

import torch

# the modules, not their functions: the backward's package imports this
# one's, so either may be imported first
from ..flash_attention_bwd import kernel as bwd_kernel
from ..flash_attention_bwd import ref as bwd_ref
from .. import shapeonly
from .kernel import flash_attention_kernel
from .ref import flash_attention_lse_ref, flash_attention_ref

#: ``"auto"``: the plain version for CPU tensors, the CUDA kernel for CUDA
#: tensors; ``"cuda"``: the kernel (raises on CPU tensors); ``"plain"``: the
#: plain version on any device (the reference route on the card)
BACKENDS = ("auto", "cuda", "plain")


def _plain(backend: str, q: torch.Tensor) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want one of "
                         f"{BACKENDS})")
    # a fake tensor (the dry run's) takes the kernel's shape-only route
    return backend == "plain" or (backend == "auto" and q.device.type == "cpu"
                                  and not shapeonly.is_fake(q))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0,
                    kv_len: int | None = None,
                    backend: str = "auto") -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd) -> (B, H, Sq, hd) (see
    :func:`.ref.flash_attention_ref`). The kernel raises rather than fall
    back to the plain version."""
    fn = flash_attention_ref if _plain(backend, q) else flash_attention_kernel
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_len=kv_len)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention. The forward keeps ``q, k, v``, its
    output in float32 before its rounding to the inputs' dtype, and each
    row's log-sum-exp; the backward hands them to ``flash_attention_bwd`` —
    the CUDA kernel for CUDA tensors, its plain version for CPU tensors or
    ``backend="plain"`` — and gives the non-tensor arguments no gradient.
    With bf16 inputs the float32 output makes the backward's ``Delta =
    rowsum(dO * O)`` exact: from the bf16 output it rounds away ``dP -
    Delta`` where a row's values nearly agree (on the reduced whisper's
    decoder, a 23% error in a gradient leaf; 3% with the float32 output,
    the reference's bf16 gradient 4%)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, kv_len,
                backend):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset, kv_len=kv_len)
        plain = _plain(backend, q)
        if plain:
            o, lse, o32 = flash_attention_lse_ref(q, k, v, **kw)
        else:
            o, lse, o32 = flash_attention_kernel(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.plain:
            grads = bwd_ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                    **ctx.kw)
        else:
            if do.stride(-1) != 1:      # the kernel reads rows of hd
                do = do.contiguous()
            grads = bwd_kernel.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                                          **ctx.kw)
        return (*grads, None, None, None, None, None, None)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          softcap: float | None = None, q_offset: int = 0,
                          kv_len: int | None = None,
                          backend: str = "auto") -> torch.Tensor:
    """:func:`flash_attention` under autograd (:class:`FlashAttentionFn`)."""
    return FlashAttentionFn.apply(q, k, v, causal, window, softcap, q_offset,
                                  kv_len, backend)
