"""Plain PyTorch version of the event-engine flush (``csrc/event_engine.cu``).

Mirrors the float64 oracle ``event_engine_core``
(``src/repro/kernels/event_engine/ref.py:62``) restricted to the dirty-slot
index list, plus the ``due`` deadline the reference engine derives right
after it (``src/repro/core/network.py:541-544``). Every step is an exact
IEEE op on float64 tensors, so on any device the result is bit-identical to
the oracle and to the CUDA kernel. With ``staged`` rows it first applies the
staged alloc/release slot writes, as the kernel's first phase does.
"""

from __future__ import annotations

import math

import torch

from ..share import scatter_staged, share_rates

#: a transfer is done once less than this many bytes remain
_DONE_EPS = 1.0


def event_engine_ref(idx: torch.Tensor, path: torch.Tensor,
                     rem: torch.Tensor, rate: torch.Tensor,
                     eta: torch.Tensor, due: torch.Tensor,
                     link_bw: torch.Tensor, link_act: torch.Tensor,
                     now: float, staged=None, *,
                     active=None) -> torch.Tensor:
    """Flush the slots ``idx`` in place and return ``min(eta)`` over the
    whole slot array as a 0-d tensor (``inf`` when no slot is live).
    ``staged`` (``(slot, rem, active, path_rows)``, see
    :func:`..share.scatter_staged`) is applied first; it needs the
    ``active`` slot tensor too.

    Per slot: re-rate (gather-min of link shares), reconstruct the
    remaining bytes from the cached ``(rate, eta)`` pair
    (``rate_old * (eta - now)``; the stored ``rem`` for a slot without a
    rate), then the new completion time ``eta = now + rem / rate`` and the
    deadline ``due = eta - 1 / rate`` (both ``inf`` for a dead slot).
    """
    if staged is not None:
        scatter_staged(staged, path, rem, rate, eta, due, active)
    if idx.numel():
        rate_new = share_rates(idx, path, link_bw, link_act)
        rate_old = rate[idx]
        carried = rate_old > 0.0
        # mask dead slots' inf etas before the multiply (no 0*inf NaNs)
        eta_c = torch.where(carried, eta[idx], 0.0)
        rem_now = torch.clamp_min(
            torch.where(carried, rate_old * (eta_c - now), rem[idx]), 0.0)
        live = rate_new > 0.0
        safe = torch.where(live, rate_new, 1.0)
        eta_new = torch.where(live, rem_now / safe + now, math.inf)
        due_new = torch.where(
            live, eta_new - torch.full_like(safe, _DONE_EPS) / safe, math.inf)
        rem[idx] = rem_now
        rate[idx] = rate_new
        eta[idx] = eta_new
        due[idx] = due_new
    if eta.numel() == 0:
        return torch.full((), math.inf, dtype=eta.dtype, device=eta.device)
    return eta.min()


def event_engine_packed(inputs, slots, now: float) -> torch.Tensor:
    """The plain version in the kernel's argument form: the packed call
    ``inputs`` (a :class:`..net_call.NetInputs`, read on the slot arrays'
    device) against the :class:`..net_call.SlotArrays` ``slots``; returns
    ``min(eta)`` as a 0-d tensor on that device."""
    idx, bw, act, staged = inputs.tensors(slots.device)
    return event_engine_ref(idx, slots.path, slots.rem, slots.rate,
                            slots.eta, slots.due, bw, act, now, staged,
                            active=slots.active)
