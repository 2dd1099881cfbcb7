"""repro_torch.analysis — the runtime analysis passes, run on the port.

* :mod:`~repro_torch.analysis.conserve` — the conservation auditor
  (invariants I1–I7 over a replayed scenario).
* :mod:`~repro_torch.analysis.tierace` — the tie-race sanitizer's
  runners (``canonical_records``, ``sanitize_smoke``).

Both run on the CUDA card by default (``device="cpu"`` for the kernels'
plain versions).
"""

from . import conserve, tierace

__all__ = ["conserve", "tierace"]
