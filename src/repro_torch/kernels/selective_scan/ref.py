"""Plain PyTorch version of the selective scan (``csrc/selective_scan.cu``).

The counterpart of ``selective_scan_ref``
(``src/repro/kernels/selective_scan/ref.py:9``): a sequential loop over
time in float32 (float64 for float64 inputs), the state ``h`` (Bz, Di, N)
carried from step to step,

    h = exp(dt * A) * h + (dt * x) * B_t;   y_t = h . C_t + D * x_t

and ``y`` cast back to x's dtype. The CPU tests and the ``backend="plain"``
route run it; the CUDA kernel walks the same recurrence, four lanes per
(batch, channel), each holding four of the N states.
"""

from __future__ import annotations

import torch

from .kernel import ROUND


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                       h0: torch.Tensor, states: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bz, S, Di); B, C: (Bz, S, N); A: (Di, N); D: (Di,); h0:
    (Bz, Di, N). Returns (y (Bz, S, Di) in x's dtype, h_last (Bz, Di, N)
    float32, float64 for float64 x). ``states``, when given
    (:func:`.kernel.round_states`), receives h at the end of every
    ``ROUND``-step round, as the CUDA kernel writes it."""
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, bf, cf = (t.to(cdt) for t in (x, dt, B, C))
    af, df = A.to(cdt), D.to(cdt)
    h = h0.to(cdt)
    ys = []
    S = x.shape[1]
    for t in range(S):
        da = torch.exp(dtf[:, t, :, None] * af)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1) + df * xf[:, t])
        if states is not None and ((t + 1) % ROUND == 0 or t + 1 == S):
            states[:, t // ROUND] = h
    y = torch.stack(ys, 1) if ys else torch.empty_like(xf)
    return y.to(x.dtype), h
