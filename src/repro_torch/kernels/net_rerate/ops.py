"""The incremental re-rate as the network engine calls it."""

from __future__ import annotations

from ..net_call import NetInputs, SlotArrays
from .kernel import net_rerate_kernel
from .ref import net_rerate_packed


def net_rerate(inputs: NetInputs, slots: SlotArrays, now: float) -> float:
    """Apply the staged rows of ``inputs``, re-rate its listed slots in
    place and return the next completion time on the host: the plain
    version for CPU slot tensors (reading the packed buffer), the CUDA
    kernel for CUDA ones (it raises rather than fall back)."""
    if slots.device.type != "cpu":
        return net_rerate_kernel(inputs, slots, now)
    return net_rerate_packed(inputs, slots, now).item()
