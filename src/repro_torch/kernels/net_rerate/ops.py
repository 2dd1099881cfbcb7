"""The incremental re-rate as the network engine calls it."""

from __future__ import annotations

import torch

from .kernel import net_rerate_kernel
from .ref import net_rerate_ref


def net_rerate(idx: torch.Tensor, path: torch.Tensor, rem: torch.Tensor,
               rate: torch.Tensor, link_bw: torch.Tensor,
               link_act: torch.Tensor, now: float) -> float:
    """Re-rate the slots ``idx`` in place and return the next completion
    time on the host: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (it raises rather than fall back)."""
    fn = net_rerate_ref if rem.device.type == "cpu" else net_rerate_kernel
    return fn(idx, path, rem, rate, link_bw, link_act, now).item()
