"""Launch of the CUDA value-scoring pass (``csrc/value_score.cu``)."""

from __future__ import annotations

import torch

from .. import _cuda
from .ref import MODES


def value_score_kernel(demand: torch.Tensor, sizes: torch.Tensor,
                       presence: torch.Tensor, bw: torch.Tensor, *,
                       mode: str = "cost") -> torch.Tensor:
    """Same contract as :func:`.ref.value_score_ref`, on CUDA tensors,
    launched on the current stream (no synchronisation)."""
    if mode not in MODES:
        raise ValueError(f"unknown value_score mode {mode!r} "
                         f"(want one of {MODES})")
    n_sites, n_files = demand.shape
    f64 = torch.float64
    dev = _cuda.check_args("value_score", (
        ("demand", demand, f64, (n_sites, n_files)),
        ("sizes", sizes, f64, (n_files,)),
        ("presence", presence, torch.bool, (n_sites, n_files)),
        ("bw", bw, f64, (n_sites, n_sites))))
    out = torch.empty((n_sites, n_files), dtype=f64, device=dev)
    if out.numel() == 0:
        return out
    err = _cuda.entry_point("value_score")(
        demand.data_ptr(), sizes.data_ptr(), presence.data_ptr(),
        bw.data_ptr(), n_sites, n_files, int(mode == "plain"),
        out.data_ptr(), _cuda.stream(dev), dev.index)
    _cuda.check("value_score", err)
    return out
