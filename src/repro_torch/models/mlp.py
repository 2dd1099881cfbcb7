"""Feed-forward blocks: SwiGLU / GeGLU (gated) and plain GELU (whisper)."""

from __future__ import annotations

import torch

from .common import ACTS, gelu, normal_init


def init_gated_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    return {
        "wg": normal_init(gen, (d_model, d_ff), dtype=dtype),
        "wu": normal_init(gen, (d_model, d_ff), dtype=dtype),
        "wd": normal_init(gen, (d_ff, d_model), dtype=dtype),
    }


def gated_mlp(params: dict, x: torch.Tensor,
              act: str = "swiglu") -> torch.Tensor:
    g = ACTS[act](x @ params["wg"])
    u = x @ params["wu"]
    return (g * u) @ params["wd"]


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """``w1``, ``b1``, ``w2``, ``b2``: the biases zero, in ``dtype``."""
    return {
        "w1": normal_init(gen, (d_model, d_ff), dtype=dtype),
        "b1": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
        "w2": normal_init(gen, (d_ff, d_model), dtype=dtype),
        "b2": torch.zeros((d_model,), dtype=dtype, device=gen.device),
    }


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w1 + b1) @ w2 + b2``: each bias added in the activation
    dtype, the first before the (tanh-form) GELU."""
    h = gelu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]
