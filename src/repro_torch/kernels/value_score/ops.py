"""The value-scoring pass as the replication economy calls it."""

from __future__ import annotations

import torch

from .kernel import value_score_kernel
from .ref import MODES, value_score_ref

__all__ = ["MODES", "value_score"]


def value_score(demand: torch.Tensor, sizes: torch.Tensor,
                presence: torch.Tensor, bw: torch.Tensor, *,
                mode: str = "cost") -> torch.Tensor:
    """Score the ``(sites, files)`` value matrix (see
    :func:`.ref.value_score_ref`): the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (it raises rather than fall back). The
    result stays on the tensors' device."""
    fn = value_score_ref if demand.device.type == "cpu" else value_score_kernel
    return fn(demand, sizes, presence, bw, mode=mode)
