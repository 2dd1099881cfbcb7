"""Plain PyTorch version of the per-slot fair-share gather-min that both
network kernels share (``csrc/share_rate.cuh``).

A slot's rate is the min over its ``-1``-padded link path of
``bandwidth / max(1, active)``, or 0 when the path has no link. The
``-1`` padding indexes an ``inf`` sentinel appended to the share vector
(the oracle's trick, ``src/repro/kernels/event_engine/ref.py``), so no
validity mask is built. Divide and min are exact IEEE ops: the result is
bit-identical to the float64 oracles and to the CUDA device function.
"""

from __future__ import annotations

import math

import torch


def share_rates(idx: torch.Tensor, path: torch.Tensor,
                link_bw: torch.Tensor, link_act: torch.Tensor) -> torch.Tensor:
    """Rates of the slots ``idx`` (int32) of the ``(slots, depth)`` path
    matrix over the per-link float64 ``link_bw`` / ``link_act``."""
    shares = torch.empty(link_bw.shape[0] + 1, dtype=link_bw.dtype,
                         device=link_bw.device)
    shares[:-1] = link_bw / torch.clamp_min(link_act, 1.0)
    # where the -1 padding lands; fill_ writes on the device, where
    # `shares[-1] = inf` would copy a host scalar (no CUDA-graph capture)
    shares[-1:].fill_(math.inf)
    p = path[idx]
    rate = shares[p[:, 0]]
    for d in range(1, p.shape[1]):
        rate = torch.minimum(rate, shares[p[:, d]])
    # all-padding rows reduce to the bare sentinel: dead, rate 0
    return torch.where(torch.isfinite(rate), rate, 0.0)
