"""Plain PyTorch version of the incremental re-rate
(``csrc/net_rerate.cu``).

Mirrors the float64 oracle ``net_rerate_ref``
(``src/repro/kernels/net_rerate/ref.py:21``) the way the reference engine
uses it: re-rate the union batch of slots in place, then scan the *whole*
slot array for the earliest ``now + rem / rate`` over live slots
(``src/repro/core/network.py:439-444``). Exact IEEE ops on float64
tensors: bit-identical to the oracle and to the CUDA kernel.
"""

from __future__ import annotations

import math

import torch

from ..share import share_rates


def net_rerate_ref(idx: torch.Tensor, path: torch.Tensor, rem: torch.Tensor,
                   rate: torch.Tensor, link_bw: torch.Tensor,
                   link_act: torch.Tensor, now: float) -> torch.Tensor:
    """Re-rate the slots ``idx`` in place and return the next completion
    time over all live slots (``rate > 0``) as a 0-d tensor (``inf`` when
    none is live)."""
    if idx.numel():
        rate[idx] = share_rates(idx, path, link_bw, link_act)
    if rate.numel() == 0:
        return torch.full((), math.inf, dtype=rate.dtype, device=rate.device)
    live = rate > 0.0
    eta = torch.where(live, rem / torch.where(live, rate, 1.0) + now,
                      math.inf)
    return eta.min()
