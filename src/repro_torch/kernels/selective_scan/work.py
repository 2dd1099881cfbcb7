"""The work of one selective scan call (forward): ``chip_smoke.py`` bounds
the kernel's time by it and the dry run counts a traced step's calls with
it (:mod:`repro_torch.kernels.shapeonly`)."""

from __future__ import annotations


def scan_work(Bz: int, S: int, Di: int, N: int) -> tuple[int, int, int]:
    """Bytes, float32 operations and exponentials of one scan call on
    float32 streams: x, dt, y per (b, t, d); B, C per (b, t, n); A per
    (d, n), D per d; h0, h_last per (b, d, n). Per (b, t, d, n) one
    exponential and six operations (dt * A, its product with h, dx * B,
    their sum, h * C and its sum into y); per (b, t, d) three more (dt * x,
    D * x and its sum into y)."""
    bytes_ = 4 * (3 * Bz * S * Di + 2 * Bz * S * N + Di * N + Di
                  + 2 * Bz * Di * N)
    return bytes_, 6 * Bz * S * Di * N + 3 * Bz * S * Di, Bz * S * Di * N
