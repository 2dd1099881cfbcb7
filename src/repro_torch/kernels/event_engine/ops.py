"""The event-engine flush as the network engine calls it."""

from __future__ import annotations

import torch

from .kernel import event_engine_kernel
from .ref import event_engine_ref


def event_engine(idx: torch.Tensor, path: torch.Tensor, rem: torch.Tensor,
                 rate: torch.Tensor, eta: torch.Tensor, due: torch.Tensor,
                 link_bw: torch.Tensor, link_act: torch.Tensor,
                 now: float) -> float:
    """Flush the dirty slots ``idx`` in place and return ``min(eta)`` on
    the host: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (it raises rather than fall back)."""
    fn = event_engine_ref if rem.device.type == "cpu" else event_engine_kernel
    return fn(idx, path, rem, rate, eta, due, link_bw, link_act, now).item()
