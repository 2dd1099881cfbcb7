"""Launch of the CUDA event-engine flush (``csrc/event_engine.cu``)."""

from __future__ import annotations

from ..net_call import NetInputs, SlotArrays, launch


def event_engine_kernel(inputs: NetInputs, slots: SlotArrays,
                        now: float) -> float:
    """Same contract as :func:`.ref.event_engine_ref` on the packed inputs:
    applies the staged rows, flushes the listed slots of ``slots`` (CUDA
    tensors) in place and returns ``min(eta)``. One copy up, one launch of
    one cluster, one stream sync."""
    return launch("event_engine", inputs, slots, now)
