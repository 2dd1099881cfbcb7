"""Plain PyTorch version of the selective scan's backward
(``csrc/selective_scan_bwd.cu``).

From the forward's inputs, the states it saved at the end of every round
(:func:`repro_torch.kernels.selective_scan.round_states`), the output's
gradient ``dy`` and the final state's ``dh_last``, an explicit reverse
loop in the kernel's order: the rounds last to first, each recomputed
forward from its starting state (the previous round's saved state, or h0)
and then walked back,

    g_t = dy_t C_t + G;   G = a_t g_t   (G starts at dh_last),
    dx_t = dt_t (g_t . B_t) + D dy_t;   ddt_t = x_t (g_t . B_t)
    + (g_t a_t h_{t-1}) . A;   dB_t = sum_d g_t dt_t x_t;
    dC_t = sum_d dy_t h_t;   dA += g_t a_t h_{t-1} dt_t;   dh0 = G,

dA summed over time per batch row, then over the rows; dD = sum dy x.
Arithmetic in float32 (float64 for float64 inputs), the stream gradients
cast back to their inputs' dtypes, so in float64 it is the exact gradient
of :func:`~repro_torch.kernels.selective_scan.selective_scan_ref`.
"""

from __future__ import annotations

import torch

from ..selective_scan.kernel import ROUND


def selective_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                           C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                           h0: torch.Tensor, states: torch.Tensor,
                           dy: torch.Tensor,
                           dh_last: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, ...]:
    """x, dt, dy: (Bz, S, Di); B, C: (Bz, S, N); A: (Di, N); D: (Di,);
    h0, dh_last (None: zero): (Bz, Di, N); states: (Bz, ceil(S / ROUND),
    Di, N). Returns (dx, ddt, dB, dC, dA, dD, dh0), each shaped and typed
    as its input."""
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dtf, bf, cf, dyf = (t.to(cdt) for t in (x, dt, B, C, dy))
    af, df = A.to(cdt), D.to(cdt)
    Bz, S, Di = x.shape
    G = (torch.zeros_like(h0, dtype=cdt) if dh_last is None
         else dh_last.to(cdt))
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(bf), torch.empty_like(cf)
    dA_rows = torch.zeros_like(G)
    for r in reversed(range(-(-S // ROUND))):
        t0, t1 = r * ROUND, min(S, (r + 1) * ROUND)
        h = h0.to(cdt) if r == 0 else states[:, r - 1].to(cdt)
        before = []                              # h_{t-1} of each step
        for t in range(t0, t1):
            before.append(h)
            a = torch.exp(dtf[:, t, :, None] * af)
            h = a * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
            dC[:, t] = (dyf[:, t, :, None] * h).sum(1)
        for t in reversed(range(t0, t1)):
            a = torch.exp(dtf[:, t, :, None] * af)
            g = dyf[:, t, :, None] * cf[:, t, None, :] + G
            gp = g * (a * before[t - t0])
            gb = (g * bf[:, t, None, :]).sum(-1)
            dx[:, t] = gb * dtf[:, t] + df * dyf[:, t]
            ddt[:, t] = gb * xf[:, t] + (gp * af).sum(-1)
            dA_rows += gp * dtf[:, t, :, None]
            dB[:, t] = (g * (dtf[:, t] * xf[:, t])[..., None]).sum(1)
            G = a * g
    dD = (dyf * xf).sum(1).sum(0)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dB.to(B.dtype), dC.to(C.dtype),
            dA_rows.sum(0).to(A.dtype), dD.to(D.dtype), G.to(h0.dtype))
