"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

``event_engine`` (the ``net="device"`` flush) and ``net_rerate`` (the
incremental re-rate of the ``numpy``/``pallas``/``topmost`` engines) replace
the Pallas TPU kernels of the same names in ``src/repro/kernels/``. Each
package has ``kernel.py`` (the ctypes launch of ``csrc/<name>.cu``),
``ref.py`` (the plain PyTorch version) and ``ops.py`` (the wrapper the
engine calls: the plain version for CPU tensors, the kernel for CUDA
tensors). The sources are compiled at first use (``_cuda.py``).
"""
