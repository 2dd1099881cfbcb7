"""The event-engine flush as the network engine calls it."""

from __future__ import annotations

from ..net_call import NetInputs, SlotArrays
from .kernel import event_engine_kernel
from .ref import event_engine_ref


def event_engine(inputs: NetInputs, slots: SlotArrays, now: float) -> float:
    """Apply the staged rows of ``inputs``, flush its listed (dirty) slots
    in place and return ``min(eta)`` on the host: the plain version for CPU
    slot tensors (reading the packed buffer), the CUDA kernel for CUDA ones
    (it raises rather than fall back)."""
    if slots.device.type != "cpu":
        return event_engine_kernel(inputs, slots, now)
    idx, bw, act, staged = inputs.tensors()
    return event_engine_ref(idx, slots.path, slots.rem, slots.rate,
                            slots.eta, slots.due, bw, act, now, staged,
                            active=slots.active).item()
