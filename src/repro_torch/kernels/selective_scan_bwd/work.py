"""The work of one selective scan backward call: ``chip_smoke.py`` bounds
the kernel's time by it and the dry run counts a traced step's calls with
it (:mod:`repro_torch.kernels.shapeonly`)."""

from __future__ import annotations


def scan_bwd_work(Bz: int, S: int, Di: int, N: int,
                  size: int) -> tuple[int, int, int]:
    """Bytes, float32 operations and exponentials the scan's backward must
    spend: each input read once and each output written once (x, dt, dy,
    dx, ddt per (b, t, d) in the streams' ``size``; B, C, dB, dC per
    (b, t, n); A, dA per (d, n), D, dD per d and h0, dh_last, dh0 per
    (b, d, n) in float32; the forward's round states are the kernel's own
    and not counted). Per (b, t, d, n) one exponential, 5 operations to
    recompute h and dC's term and 13 for g, its products and the
    carry."""
    bytes_ = (size * (5 * Bz * S * Di + 4 * Bz * S * N)
              + 4 * (2 * Di * N + 2 * Di + 3 * Bz * Di * N))
    return bytes_, 18 * Bz * S * Di * N, Bz * S * Di * N
