"""Plain PyTorch version of the per-slot fair-share gather-min that both
network kernels share (``csrc/share_rate.cuh``).

A slot's rate is the min over its ``-1``-padded link path of
``bandwidth / max(1, active)``, or 0 when the path has no link. The
``-1`` padding indexes an ``inf`` sentinel appended to the share vector
(the oracle's trick, ``src/repro/kernels/event_engine/ref.py``), so no
validity mask is built. Divide and min are exact IEEE ops: the result is
bit-identical to the float64 oracles and to the CUDA device function.
"""

from __future__ import annotations

import math

import torch


def share_rates(idx: torch.Tensor, path: torch.Tensor,
                link_bw: torch.Tensor, link_act: torch.Tensor) -> torch.Tensor:
    """Rates of the slots ``idx`` (int32) of the ``(slots, depth)`` path
    matrix over the per-link float64 ``link_bw`` / ``link_act``."""
    shares = torch.empty(link_bw.shape[0] + 1, dtype=link_bw.dtype,
                         device=link_bw.device)
    shares[:-1] = link_bw / torch.clamp_min(link_act, 1.0)
    # where the -1 padding lands; fill_ writes on the device, where
    # `shares[-1] = inf` would copy a host scalar (no CUDA-graph capture)
    shares[-1:].fill_(math.inf)
    p = path[idx]
    rate = shares[p[:, 0]]
    for d in range(1, p.shape[1]):
        rate = torch.minimum(rate, shares[p[:, d]])
    # all-padding rows reduce to the bare sentinel: dead, rate 0
    return torch.where(torch.isfinite(rate), rate, 0.0)


def scatter_staged(staged, path: torch.Tensor, rem: torch.Tensor,
                   rate: torch.Tensor, eta: torch.Tensor, due: torch.Tensor,
                   active: torch.Tensor) -> None:
    """Apply staged alloc/release slot writes in place, as the kernels'
    phase (a) does (``scatter_staged`` in ``csrc/share_rate.cuh``):
    ``staged`` is ``(slot, rem, active, path_rows)``: slot ids, float64
    rem, active flags (nonzero is active) and ``(n, depth)`` path rows, of
    any dtype that holds their values exactly (the kernels' packed buffer
    has them int32, ``NetworkEngine._apply_staged`` float64); each slot
    gets its rem, active flag and path row, rate 0 and eta/due inf
    (unrated). The one scatter of the staged rows in PyTorch."""
    slot, st_rem, st_active, st_path = staged
    if not slot.numel():
        return
    if eta is None or due is None or active is None:
        raise ValueError("staged rows need the eta, due and active tensors")
    i = slot.long()
    rem[i] = st_rem
    # index_fill_, not `x[i] = scalar`: the latter copies the scalar to the
    # device and synchronises (no CUDA-graph capture)
    rate.index_fill_(0, i, 0.0)
    eta.index_fill_(0, i, math.inf)
    due.index_fill_(0, i, math.inf)
    active[i] = st_active != 0
    path[i] = st_path.to(path.dtype)
