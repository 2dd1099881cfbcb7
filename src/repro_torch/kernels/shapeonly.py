"""The shape-only route of the model kernels, for fake tensors.

The dry run (:mod:`repro_torch.launch.dryrun`) traces a step under a
``FakeTensorMode``, where nothing can be launched. The wrappers of
``flash_attention``, ``flash_attention_bwd``, ``selective_scan`` and
``selective_scan_bwd`` take this route only when their input is a
``FakeTensor``: they allocate their outputs as the launch would (fake
tensors of the kernel's shapes and dtypes, so the dry run sees the
kernel's memory) and report the kernel's FLOPs and bytes, by the formulas
of each package's ``work`` module, to the sinks installed with
:func:`collecting`. Real tensors never take it.
"""

from __future__ import annotations

import contextlib
from typing import Callable

from torch._subclasses.fake_tensor import FakeTensor

_SINKS: list[Callable[[str, float, float], None]] = []


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def report(name: str, flops: float, bytes_: float) -> None:
    """One shape-only call of kernel ``name``: its work by formula."""
    for sink in _SINKS:
        sink(name, flops, bytes_)


@contextlib.contextmanager
def collecting(sink: Callable[[str, float, float], None]):
    """Install ``sink(name, flops, bytes)`` for the block."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)
