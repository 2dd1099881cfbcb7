"""Mamba-1 block (falcon-mamba) and its single-token decode step.

The recurrence runs through the selective-scan op: on CUDA tensors the
hand-written kernel (``csrc/selective_scan.cu``), on CPU tensors its plain
sequential version. In training (``train=True``) it runs through
:class:`~repro_torch.kernels.selective_scan.SelectiveScanFn` on every
device: the forward saves the state at the end of every 16-step round and
the backward is the hand-written ``csrc/selective_scan_bwd.cu`` on CUDA
tensors, its plain reverse loop on CPU tensors. The conv, projections,
softplus and gating stay plain PyTorch under autograd. The skip term
``D * x`` is folded into the op, as the TPU kernel folds it. Mamba-2
(zamba2) is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import selective_scan, selective_scan_train
from .common import normal_init, silu


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C), weight: (C, K), bias: (C,).

    With ``state`` (B, K-1, C) (decode) it is prepended and the new state
    returned; else zero left-padding (prefill). The float32 weights promote
    the output to float32, as in the reference; the state keeps x's dtype.
    """
    K = weight.shape[1]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(K):                      # K is 4: unrolled shifts
        out = out + xp[:, i:i + S, :] * weight[:, i]
    out = out + bias
    new_state = xp[:, xp.shape[1] - (K - 1):, :]
    return out, new_state


def init_mamba1(gen: torch.Generator, d_model: int, ssm,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    di = ssm.d_inner(d_model)
    dtr = ssm.resolved_dt_rank(d_model)
    N = ssm.state_dim
    K = ssm.conv_kernel
    f32 = torch.float32
    dev = gen.device
    return {
        "in_proj": normal_init(gen, (d_model, 2 * di), dtype=dtype),
        "conv_w": normal_init(gen, (di, K), scale=0.1, dtype=f32),
        "conv_b": torch.zeros((di,), dtype=f32, device=dev),
        "x_proj": normal_init(gen, (di, dtr + 2 * N), dtype=dtype),
        "dt_proj": normal_init(gen, (dtr, di), scale=dtr ** -0.5, dtype=f32),
        "dt_bias": torch.full((di,), -4.6, dtype=f32, device=dev),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=f32, device=dev)
                           ).repeat(di, 1),
        "D_skip": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": normal_init(gen, (di, d_model), dtype=dtype),
    }


def mamba1_forward(params: dict, x: torch.Tensor, ssm, *, state=None,
                   backend: str = "auto", train: bool = False):
    """x: (B, S, D). ``state``: optional (conv_state (B, K-1, Di),
    ssm_state (B, Di, N) float32) to continue from. ``train``: the scan
    under autograd (:func:`selective_scan_train`). Returns
    (y, (new_conv_state, h_last))."""
    B, S, D = x.shape
    N = ssm.state_dim
    dtr = ssm.resolved_dt_rank(D)
    xz = x @ params["in_proj"]
    xin, z = xz.chunk(2, dim=-1)                                 # (B, S, Di)
    xc, new_conv = causal_conv1d(xin, params["conv_w"], params["conv_b"],
                                 state=None if state is None else state[0])
    xc = silu(xc)                                                # float32
    proj = xc @ params["x_proj"].float()
    dt = F.softplus(proj[..., :dtr] @ params["dt_proj"] + params["dt_bias"])
    B_ssm = proj[..., dtr:dtr + N].contiguous()
    C_ssm = proj[..., dtr + N:].contiguous()
    A = -torch.exp(params["A_log"])
    h0 = (torch.zeros((B, xc.shape[-1], N), dtype=torch.float32,
                      device=x.device) if state is None else state[1])
    scan = selective_scan_train if train else selective_scan
    y, h_last = scan(xc, dt, B_ssm, C_ssm, A, params["D_skip"], h0,
                     backend=backend)
    y = (y.to(x.dtype) * silu(z)) @ params["out_proj"]
    return y, (new_conv, h_last)


def mamba1_decode(params: dict, x: torch.Tensor, state, ssm, *,
                  backend: str = "auto"):
    """One token: x (B, 1, D); ``state`` = (conv_state, h). The scan runs
    at S = 1 from the cached state."""
    return mamba1_forward(params, x, ssm, state=state, backend=backend)
