"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

``event_engine`` (the ``net="device"`` flush), ``net_rerate`` (the
incremental re-rate of the ``numpy``/``pallas``/``topmost`` engines),
``strategy_plan`` (the batched planners' burst pass), ``st_cost`` (the
shortest-transfer batch broker's costs) and ``value_score`` (the
replication economy's value matrix) replace the Pallas TPU kernels of the
same names in ``src/repro/kernels/``; so do ``flash_attention`` (every
attention layer of the serving path) and ``selective_scan`` (every Mamba-1
layer). Each package has ``kernel.py`` (the ctypes launch of
``csrc/<name>.cu``), ``ref.py`` (the plain PyTorch version) and ``ops.py``
(the wrapper the callers use: the plain version for CPU tensors, the kernel
for CUDA tensors), and exports its ``SPEC`` (:mod:`.spec`), which the
kernel audit finds through :func:`.registry.registered_kernels`. The
sources are compiled at first use (``_cuda.py``).
"""

from .registry import get_kernel_spec, registered_kernels
from .spec import KernelSpec

__all__ = ["KernelSpec", "get_kernel_spec", "registered_kernels"]
