"""Launch of the CUDA incremental re-rate (``csrc/net_rerate.cu``)."""

from __future__ import annotations

import torch

from .. import _cuda


def net_rerate_kernel(idx: torch.Tensor, path: torch.Tensor,
                      rem: torch.Tensor, rate: torch.Tensor,
                      link_bw: torch.Tensor, link_act: torch.Tensor,
                      now: float) -> torch.Tensor:
    """Same contract as :func:`.ref.net_rerate_ref`, on CUDA tensors:
    re-rates the slots ``idx`` in place on the current stream and returns
    the next completion time as a 0-d device tensor (no
    synchronisation)."""
    _cuda.check_inputs("net_rerate", idx, path, (rem, rate),
                       (link_bw, link_act))
    dev = rem.device
    out = torch.empty((), dtype=torch.float64, device=dev)
    err = _cuda.entry_point("net_rerate")(
        idx.data_ptr(), idx.numel(), path.data_ptr(), path.shape[1],
        rem.data_ptr(), rate.data_ptr(), rem.numel(), link_bw.data_ptr(),
        link_act.data_ptr(), float(now), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _cuda.check("net_rerate", err)
    return out
