"""Plain PyTorch version of the flash attention backward
(``csrc/flash_attention_bwd.cu``).

From the forward's inputs, its output ``o`` before its rounding (float32
for bf16 inputs) and its per-row log-sum-exp ``lse`` (both from
:func:`repro_torch.kernels.flash_attention.flash_attention_lse_ref`)
and the output's gradient ``do``: the scores ``s`` are recomputed, ``P =
exp(s - lse)`` on the keys a query may see, and

    dV = P^T dO;  dP = dO V^T;  Delta = rowsum(dO * O);
    dS = P * (dP - Delta) * (1 - (s / cap)^2 with a softcap) * scale;
    dQ = dS K;  dK = dS^T Q,

summed over the G query heads of each KV head for dK and dV. The sums run
in float32 (float64 for float64 inputs). ``P`` and ``dS`` are rounded to
the inputs' dtype before their products, where the CUDA kernel rounds them
to bf16 as tensor-core operands; for float32 and float64 inputs that
rounding is the identity, so the function is then the exact gradient of
:func:`~repro_torch.kernels.flash_attention.flash_attention_ref`.
"""

from __future__ import annotations

import torch

from ..flash_attention.ref import attention_mask


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int | None = None,
                            softcap: float | None = None, q_offset: int = 0,
                            kv_len: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """q, o, do: (B, H, Sq, hd); k, v: (B, KV, Skv, hd); lse: (B, H, Sq).
    Returns (dq, dk, dv) shaped and typed as q, k, v."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    cdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = hd ** -0.5
    rows = lambda t: t.reshape(B, KV, G, Sq, hd).to(cdt)  # noqa: E731
    qf, of, dof = rows(q), rows(o), rows(do)
    kf, vf = k.to(cdt), v.to(cdt)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    grad = scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        grad = (1 - t * t) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len, device=q.device)
    lse_f = lse.reshape(B, KV, G, Sq, 1).to(cdt)
    p = torch.where(mask, torch.exp(s - lse_f), 0.0)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta) * grad
    # the kernel's tensor-core operands: P and dS in the inputs' dtype
    p, ds = p.to(q.dtype).to(cdt), ds.to(q.dtype).to(cdt)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf)
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
