"""The strategy plan pass as the batched planners call it."""

from __future__ import annotations

import torch

from .kernel import strategy_plan_kernel
from .ref import strategy_plan_ref


def strategy_plan(bw: torch.Tensor, fetch: torch.Tensor, local: torch.Tensor,
                  serve: torch.Tensor, free: torch.Tensor, size: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plan one burst (see :func:`.ref.strategy_plan_ref`): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors (it raises
    rather than fall back). Results stay on the tensors' device."""
    fn = strategy_plan_ref if bw.device.type == "cpu" else strategy_plan_kernel
    return fn(bw, fetch, local, serve, free, size)
