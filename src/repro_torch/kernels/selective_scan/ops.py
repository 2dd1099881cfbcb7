"""The selective scan as the Mamba-1 layers call it."""

from __future__ import annotations

import torch

from .kernel import selective_scan_kernel
from .ref import selective_scan_ref

#: ``"auto"``: the plain version for CPU tensors, the CUDA kernel for CUDA
#: tensors; ``"cuda"``: the kernel (raises on CPU tensors); ``"plain"``: the
#: plain version on any device (the reference route on the card)
BACKENDS = ("auto", "cuda", "plain")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor, *, backend: str = "auto"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, h_last) of the recurrence (see :func:`.ref.selective_scan_ref`).
    The kernel raises rather than fall back to the plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want one of "
                         f"{BACKENDS})")
    plain = backend == "plain" or (backend == "auto" and x.device.type == "cpu")
    fn = selective_scan_ref if plain else selective_scan_kernel
    return fn(x, dt, B, C, A, D, h0)
