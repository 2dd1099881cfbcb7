"""repro_torch — the PyTorch + CUDA port of ``repro``, the hierarchical
data-grid simulator (data-aware scheduling + HRS replication, Abdi et al.,
2010).

It keeps ``repro``'s module layout and results and never imports it or
JAX: ``repro`` stays the reference the port is tested against. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
