"""Launch of the CUDA flash attention backward
(``csrc/flash_attention_bwd.cu``): three kernels on the current stream,
``Delta = rowsum(dO * O)``, then dK/dV per key tile and dQ per row tile.
bf16 only: the float32 backward is not ported yet (ROADMAP queue 1)."""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from ..flash_attention.kernel import HEAD_DIMS


def _check(q, k, v, o, lse, do) -> None:
    if q.dtype != torch.bfloat16:
        raise ValueError(
            f"flash_attention_bwd: dtype {q.dtype}; the backward kernel is "
            "bf16 only (the float32 backward is not ported yet, ROADMAP "
            "queue 1)")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: the CUDA kernel takes CUDA "
                         f"tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_bwd: want q (B, H, Sq, hd) and k, "
                         f"v (B, KV, Skv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"flash_attention_bwd: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: o and do must be shaped as q")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"float32 (B, H, Sq) tensor on {q.device}")
    for label, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {label} must be "
                             f"{q.dtype} on {q.device}")
        # rows are read 16 bytes at a time
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s % 8 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention_bwd: {label} needs a unit "
                             "stride along hd and 16-byte aligned rows, got "
                             f"strides {t.stride()}")


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor, *,
                               causal: bool = True, window: int | None = None,
                               softcap: float | None = None, q_offset: int = 0,
                               kv_len: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Same contract as :func:`.ref.flash_attention_bwd_ref`, on CUDA bf16
    tensors, launched on the current stream (no synchronisation). The
    inputs may be strided views of ``(B, S, heads, hd)`` storage; dq, dk
    and dv come back as ``(B, heads, S, hd)`` views of such storage, so
    the model's gradients need no transpose. The float32 ``Delta`` scratch
    is allocated here; the kernels allocate nothing."""
    _check(q, k, v, o, lse, do)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention_bwd: softcap {softcap} <= 0")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    dev = q.device
    new = lambda s, n: torch.empty((B, s, n, hd), dtype=q.dtype,  # noqa: E731
                                   device=dev).transpose(1, 2)
    dq, dk, dv = new(Sq, H), new(Skv, KV), new(Skv, KV)
    if Sq == 0 or Skv == 0 or B == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    kend = Skv if kv_len is None else max(0, min(Skv, kv_len))
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()[:3]))
    err = _cuda.entry_point("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), strides, B, H, KV, Sq, Skv, kend, hd, int(causal),
        0 if window is None else window, 0.0 if softcap is None else softcap,
        q_offset, hd ** -0.5, _cuda.stream(dev), dev.index)
    _cuda.check("flash_attention_bwd", err)
    return dq, dk, dv
