"""Launch of the CUDA event-engine flush (``csrc/event_engine.cu``)."""

from __future__ import annotations

import torch

from .. import _cuda


def event_engine_kernel(idx: torch.Tensor, path: torch.Tensor,
                        rem: torch.Tensor, rate: torch.Tensor,
                        eta: torch.Tensor, due: torch.Tensor,
                        link_bw: torch.Tensor, link_act: torch.Tensor,
                        now: float) -> torch.Tensor:
    """Same contract as :func:`.ref.event_engine_ref`, on CUDA tensors:
    flushes the slots ``idx`` in place on the current stream and returns
    ``min(eta)`` as a 0-d device tensor (no synchronisation)."""
    _cuda.check_inputs("event_engine", idx, path, (rem, rate, eta, due),
                       (link_bw, link_act))
    dev = rem.device
    out = torch.empty((), dtype=torch.float64, device=dev)
    err = _cuda.entry_point("event_engine")(
        idx.data_ptr(), idx.numel(), path.data_ptr(), path.shape[1],
        rem.data_ptr(), rate.data_ptr(), eta.data_ptr(), due.data_ptr(),
        rem.numel(), link_bw.data_ptr(), link_act.data_ptr(), float(now),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        dev.index)
    _cuda.check("event_engine", err)
    return out
