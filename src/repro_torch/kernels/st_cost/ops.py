"""The shortest-transfer cost pass as the batch broker calls it."""

from __future__ import annotations

import torch

from .kernel import st_cost_kernel
from .ref import st_cost_ref


def st_cost(bw: torch.Tensor, fetch_mask: torch.Tensor,
            presence: torch.Tensor, sizes: torch.Tensor,
            required: torch.Tensor, rel: torch.Tensor,
            online: torch.Tensor) -> torch.Tensor:
    """Cost one dispatch batch (see :func:`.ref.st_cost_ref`): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors (it raises
    rather than fall back). The result stays on the tensors' device."""
    fn = st_cost_ref if bw.device.type == "cpu" else st_cost_kernel
    return fn(bw, fetch_mask, presence, sizes, required, rel, online)
