"""Launch of the CUDA flash attention kernels (``csrc/flash_attention.cu``).

:func:`plan_launch` picks one of three routes per call from the shapes
alone, so the CPU tests hold the rule: the split-KV decode kernel when the
(head, query) rows of a KV group fit one row tile (``DECODE_ROWS``),
otherwise the tensor-core prefill kernel for bf16 and the SIMT prefill
kernel for float32.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import _cuda, shapeonly
from .ref import key_range
from .work import attention_work

#: head dims the kernel is compiled for (those of the repo's configs/tests;
#: 80 is the ~100M gemma3-family trainer's, 112 zamba2-7b's shared
#: attention block)
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 256)
#: the routes, by the id the C entry point takes
ROUTES = ("simt", "mma", "decode")
#: (head, query) rows of a KV group up to which a call is a decode
DECODE_ROWS = 16
#: keys per decode split (the kernel takes these two)
SPLIT_KEYS = (32, 64)
#: streaming multiprocessors of the H100 the decode splits aim to cover
SMS = 132


@dataclass(frozen=True)
class LaunchPlan:
    """``route`` (one of :data:`ROUTES`); the keys ``[key_lo, key_hi)``
    that some query of the call may see; for ``"decode"`` the split length
    and count (``n_split`` splits of ``split_len`` keys cover the range,
    the last one ragged), else 0."""

    route: str
    key_lo: int
    key_hi: int
    split_len: int = 0
    n_split: int = 0


def plan_launch(B: int, H: int, KV: int, Sq: int, kend: int, *,
                causal: bool, window: int | None, q_offset: int,
                dtype: torch.dtype) -> LaunchPlan:
    """The route of one call and, for a decode, its splits: 32 keys when
    ``B * KV`` blocks of 64-key splits would not cover the card's
    :data:`SMS` once, else 64."""
    lo, hi = key_range(Sq, kend, causal=causal, window=window,
                       q_offset=q_offset)
    if (H // KV) * Sq <= DECODE_ROWS:
        n = hi - lo
        long_split = SPLIT_KEYS[1]
        split = (long_split if B * KV * -(-n // long_split) >= SMS
                 else SPLIT_KEYS[0])
        return LaunchPlan("decode", lo, hi, split, max(1, -(-n // split)))
    return LaunchPlan("mma" if dtype == torch.bfloat16 else "simt", lo, hi)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: want q (B, H, Sq, hd) and k, v "
                         f"(B, KV, Skv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (batch, head dim, H % KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: dtype {q.dtype} (want bfloat16 "
                         "or float32)")
    dev = q.device
    if dev.type != "cuda" and not shapeonly.is_fake(q):
        raise ValueError(f"flash_attention: the CUDA kernel takes CUDA "
                         f"tensors, got {dev}")
    vec = 16 // q.element_size()
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {label} must be {q.dtype} on "
                             f"{dev}")
        # rows are read 16 bytes at a time: unit stride along hd, 16-byte
        # aligned rows (a fake tensor, on the shape-only route, has no
        # address)
        aligned = shapeonly.is_fake(t) or t.data_ptr() % 16 == 0
        if t.stride(3) != 1 or not aligned or any(
                s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {label} needs a unit stride "
                             "along hd and 16-byte aligned rows, got strides "
                             f"{t.stride()}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int | None = None,
                           softcap: float | None = None, q_offset: int = 0,
                           kv_len: int | None = None, with_lse: bool = False):
    """Same contract as :func:`.ref.flash_attention_ref`, on CUDA tensors,
    launched on the current stream (no synchronisation). q, k and v may be
    strided views (the model passes ``(B, S, H, hd)`` storage seen as
    ``(B, H, S, hd)``); the result is a ``(B, H, Sq, hd)`` view of a
    ``(B, Sq, H, hd)`` tensor, so the model's head merge is free. A decode
    call allocates its float32 split scratch here, on the current stream
    (valid under CUDA-graph capture); the kernels allocate nothing.

    ``with_lse``: the forward of the training path, as
    :func:`.ref.flash_attention_lse_ref`: ``(out, lse, out32)``, each row's
    log-sum-exp float32 ``(B, H, Sq)`` and the output in float32 before its
    rounding to bf16 (the bf16 route writes it beside ``out``; for float32
    inputs it is ``out``), which the backward reads; the call then takes a
    prefill route whatever its row count."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap {softcap} <= 0")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    out32 = out
    if with_lse and q.dtype == torch.bfloat16:
        out32 = torch.empty((B, Sq, H, hd), dtype=torch.float32,
                            device=dev).transpose(1, 2)
    done = (out, lse, out32) if with_lse else out
    kend = Skv if kv_len is None else max(0, min(Skv, kv_len))
    if out.numel() == 0:
        return done
    plan = plan_launch(B, H, KV, Sq, kend, causal=causal, window=window,
                       q_offset=q_offset, dtype=q.dtype)
    if with_lse and plan.route == "decode":     # the decode splits keep no lse
        plan = LaunchPlan("mma" if q.dtype == torch.bfloat16 else "simt",
                          plan.key_lo, plan.key_hi)
    scratch = None
    if plan.route == "decode":
        scratch = torch.empty((B, H, Sq, plan.n_split, hd + 2),
                              dtype=torch.float32, device=dev)
    if shapeonly.is_fake(q):
        bytes_, flops = attention_work(
            B, H, KV, hd, Sq, Skv, size=q.element_size(), causal=causal,
            window=window, q_offset=q_offset, kv_len=kv_len)
        shapeonly.report("flash_attention", flops, bytes_)
        return done
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    err = _cuda.entry_point("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        out32.data_ptr() if out32 is not out else None, strides,
        B, H, KV, Sq, Skv, kend, hd, int(q.dtype == torch.bfloat16),
        int(causal), 0 if window is None else window,
        0.0 if softcap is None else softcap, q_offset, hd ** -0.5,
        ROUTES.index(plan.route), plan.key_lo, plan.key_hi, plan.split_len,
        plan.n_split, None if scratch is None else scratch.data_ptr(),
        _cuda.stream(dev), dev.index)
    _cuda.check("flash_attention", err)
    return done
