"""Launch of the CUDA shortest-transfer cost pass (``csrc/st_cost.cu``)."""

from __future__ import annotations

import math

import torch

from .. import _cuda


def st_cost_kernel(bw: torch.Tensor, fetch_mask: torch.Tensor,
                   presence: torch.Tensor, sizes: torch.Tensor,
                   required: torch.Tensor, rel: torch.Tensor,
                   online: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`.ref.st_cost_ref`, on CUDA tensors,
    launched on the current stream (no synchronisation). A batch with no
    file costs queue time only, ``max(0, rel)`` at online sites, without
    a launch, as the TPU kernel's wrapper did."""
    n_sites, n_files = presence.shape
    n_jobs = required.shape[0]
    f64, b = torch.float64, torch.bool
    dev = _cuda.check_args("st_cost", (
        ("bw", bw, f64, (n_sites, n_sites)),
        ("fetch_mask", fetch_mask, b, (n_sites, n_files)),
        ("presence", presence, b, (n_sites, n_files)),
        ("sizes", sizes, f64, (n_files,)),
        ("required", required, b, (n_jobs, n_files)),
        ("rel", rel, f64, (n_sites,)),
        ("online", online, b, (n_sites,))))
    if n_files == 0 or n_jobs == 0 or n_sites == 0:
        zero = torch.zeros((n_jobs, n_sites), dtype=f64, device=dev)
        return torch.where(online[None, :], torch.maximum(zero, rel[None, :]),
                           math.inf)
    t_miss = torch.empty((n_files, n_sites), dtype=f64, device=dev)
    out = torch.empty((n_jobs, n_sites), dtype=f64, device=dev)
    err = _cuda.entry_point("st_cost")(
        bw.data_ptr(), fetch_mask.data_ptr(), presence.data_ptr(),
        sizes.data_ptr(), required.data_ptr(), rel.data_ptr(),
        online.data_ptr(), n_sites, n_files, n_jobs, t_miss.data_ptr(),
        out.data_ptr(), _cuda.stream(dev), dev.index)
    _cuda.check("st_cost", err)
    return out
