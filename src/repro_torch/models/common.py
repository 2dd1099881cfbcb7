"""Shared layers: norms, RoPE, activations, initializers.

Dtype policy, as the reference's: parameters and activations in bf16;
norms, softmax and RoPE in float32, cast back to the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype. The variance is the
    population one (``jnp.var``'s; ``torch.var`` would divide by n - 1)."""
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding in float32. x: (B, S, H, hd); positions: (B, S)
    or (S,)."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = 1.0 / (theta ** exps)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq                   # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


ACTS = {"swiglu": silu, "geglu": gelu, "gelu": gelu}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


# -- initializers -----------------------------------------------------------

def normal_init(gen: torch.Generator, shape, scale: float = 0.02,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """N(0, scale²) drawn in float32 from ``gen`` on its device, cast to
    ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)
