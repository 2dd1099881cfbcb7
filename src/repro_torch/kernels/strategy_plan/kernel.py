"""Launch of the CUDA strategy plan pass (``csrc/strategy_plan.cu``)."""

from __future__ import annotations

import torch

from .. import _cuda


def strategy_plan_kernel(bw: torch.Tensor, fetch: torch.Tensor,
                         local: torch.Tensor, serve: torch.Tensor,
                         free: torch.Tensor, size: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`.ref.strategy_plan_ref`, on CUDA tensors,
    launched on the current stream (no synchronisation)."""
    n_sites, n_pairs = bw.shape
    f64, b = torch.float64, torch.bool
    dev = _cuda.check_args("strategy_plan", (
        ("bw", bw, f64, (n_sites, n_pairs)),
        ("fetch", fetch, b, (n_sites, n_pairs)),
        ("local", local, b, (n_sites, n_pairs)),
        ("serve", serve, f64, (n_sites,)),
        ("free", free, f64, (n_pairs,)),
        ("size", size, f64, (n_pairs,))))
    if n_sites == 0 or n_pairs == 0:
        return (torch.zeros((2, n_pairs), dtype=torch.int32, device=dev),
                torch.zeros((3, n_pairs), dtype=b, device=dev))
    sources = torch.empty((2, n_pairs), dtype=torch.int32, device=dev)
    flags = torch.empty((3, n_pairs), dtype=b, device=dev)
    err = _cuda.entry_point("strategy_plan")(
        bw.data_ptr(), fetch.data_ptr(), local.data_ptr(), serve.data_ptr(),
        free.data_ptr(), size.data_ptr(), n_sites, n_pairs,
        sources.data_ptr(), flags.data_ptr(), _cuda.stream(dev), dev.index)
    _cuda.check("strategy_plan", err)
    return sources, flags
