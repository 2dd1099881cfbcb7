"""Launch of the CUDA incremental re-rate (``csrc/net_rerate.cu``)."""

from __future__ import annotations

from ..net_call import NetInputs, SlotArrays, launch


def net_rerate_kernel(inputs: NetInputs, slots: SlotArrays,
                      now: float) -> float:
    """Same contract as :func:`.ref.net_rerate_ref` on the packed inputs:
    applies the staged rows, re-rates the listed slots of ``slots`` (CUDA
    tensors) in place and returns the next completion time. One copy up,
    one launch of one cluster, one stream sync."""
    return launch("net_rerate", inputs, slots, now)
