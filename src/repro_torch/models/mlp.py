"""Gated feed-forward block (SwiGLU / GeGLU)."""

from __future__ import annotations

import torch

from .common import ACTS, normal_init


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
