"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

``event_engine`` (the ``net="device"`` flush), ``net_rerate`` (the
incremental re-rate of the ``numpy``/``pallas``/``topmost`` engines),
``strategy_plan`` (the batched planners' burst pass), ``st_cost`` (the
shortest-transfer batch broker's costs) and ``value_score`` (the
replication economy's value matrix) replace the Pallas TPU kernels of the
same names in ``src/repro/kernels/``; so do ``flash_attention`` (every
attention layer of the serving path) and ``selective_scan`` (every Mamba-1
layer). ``flash_attention_bwd`` and ``selective_scan_bwd`` are the training
path's backwards of the last two, which replace no TPU kernel. Each package
has ``kernel.py`` (the ctypes launch of ``csrc/<name>.cu``) and ``ref.py``
(the plain PyTorch version); the forward packages add ``ops.py`` (the
wrapper the callers use: the plain version for CPU tensors, the kernel for
CUDA tensors, and the ``autograd.Function`` over forward and backward).
Each exports its ``SPEC`` (:mod:`.spec`), which the
kernel audit finds through :func:`.registry.registered_kernels`. The
sources are compiled at first use (``_cuda.py``).
"""

from .registry import get_kernel_spec, registered_kernels
from .spec import KernelSpec

__all__ = ["KernelSpec", "get_kernel_spec", "registered_kernels"]
