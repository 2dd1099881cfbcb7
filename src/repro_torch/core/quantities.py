"""Canonical unit constants + conversions for the grid simulator.

Every quantity in the engine is carried in base units — **bytes** for
sizes, **bytes/s** for bandwidth, **seconds** for sim time — while the
configuration surface speaks the paper's units (Mbps links, GB storage
elements, MB files) and the telemetry probe reports wall time in
microseconds. The conversions between the two vocabularies used to be
scattered ``* 1e6 / 8``-style literals; they live here now, under names
the unit checker (:mod:`repro.analysis.units`, rule SL024) can recognize
as sanctioned dimension changes.

All constants are exact in float64 (powers of ten and ``1e6 / 8 ==
125000.0``), so replacing a literal with its named constant is
bit-identical — the golden suites pin that.
"""

from __future__ import annotations

BITS_PER_BYTE = 8.0

#: Decimal size prefixes (storage vendors' GB, the paper's convention).
KB = 1e3
MB = 1e6
GB = 1e9
TB = 1e12

#: Mbps -> bytes/s: ``10 Mbps * MBPS_TO_BYTES_PER_S == 1.25e6 bytes/s``.
MBPS_TO_BYTES_PER_S = 1e6 / BITS_PER_BYTE

#: Wall-clock microseconds per second (the obs probe's span unit).
US_PER_S = 1e6


def mbps_to_bytes_per_s(mbps: float) -> float:
    """Link bandwidth from the config vocabulary to engine base units."""
    return mbps * MBPS_TO_BYTES_PER_S


def bytes_to_gb(n_bytes: float) -> float:
    """Engine byte totals to the report vocabulary (decimal GB)."""
    return n_bytes / GB


def us_to_s(us: float) -> float:
    """Probe wall-clock spans (microseconds) to seconds."""
    return us / US_PER_S
