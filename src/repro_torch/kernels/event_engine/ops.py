"""The event-engine flush as the network engine calls it."""

from __future__ import annotations

from ..net_call import NetInputs, SlotArrays
from .kernel import event_engine_kernel
from .ref import event_engine_packed


def event_engine(inputs: NetInputs, slots: SlotArrays, now: float) -> float:
    """Apply the staged rows of ``inputs``, flush its listed (dirty) slots
    in place and return ``min(eta)`` on the host: the plain version for CPU
    slot tensors (reading the packed buffer), the CUDA kernel for CUDA ones
    (it raises rather than fall back)."""
    if slots.device.type != "cpu":
        return event_engine_kernel(inputs, slots, now)
    return event_engine_packed(inputs, slots, now).item()
