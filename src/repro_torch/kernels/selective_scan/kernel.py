"""Launch of the CUDA selective scan (``csrc/selective_scan.cu``)."""

from __future__ import annotations

import torch

from .. import _cuda, shapeonly
from .work import scan_work

#: the widest state the kernel keeps in registers
MAX_STATE = 16
#: time steps a round: the training forward saves h at the end of each
ROUND = 16


def round_states(x: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``(Bz, ceil(S / ROUND), Di, N)`` tensor for the
    states a training forward saves (float32; float64 for float64 ``x``,
    which only the plain version takes)."""
    Bz, S, Di = x.shape
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.empty((Bz, -(-S // ROUND), Di, h0.shape[-1]), dtype=dtype,
                       device=x.device)


def selective_scan_kernel(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                          C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                          h0: torch.Tensor, states: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`.ref.selective_scan_ref`, on contiguous CUDA
    tensors (x, dt, B, C of one dtype, bf16 or float32; A, D, h0 and
    ``states`` float32), launched on the current stream (no
    synchronisation). With ``states`` (:func:`round_states`) the launch
    also writes h at the end of every round into it."""
    Bz, S, Di = x.shape
    N = B.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"selective_scan: dtype {x.dtype} (want bfloat16 or "
                         "float32)")
    if N > MAX_STATE:
        raise ValueError(f"selective_scan: state width {N} > {MAX_STATE}")
    f32 = torch.float32
    args = [("x", x, x.dtype, (Bz, S, Di)), ("dt", dt, x.dtype, (Bz, S, Di)),
            ("B", B, x.dtype, (Bz, S, N)), ("C", C, x.dtype, (Bz, S, N)),
            ("A", A, f32, (Di, N)), ("D", D, f32, (Di,)),
            ("h0", h0, f32, (Bz, Di, N))]
    if states is not None:
        args.append(("states", states, f32, (Bz, -(-S // ROUND), Di, N)))
    dev = _cuda.check_args("selective_scan", args,
                           cuda=not shapeonly.is_fake(x))
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    if S == 0 or Bz * Di == 0:
        return y, h_last.copy_(h0)
    if shapeonly.is_fake(x):
        bytes_, flops, _ = scan_work(Bz, S, Di, N)
        shapeonly.report("selective_scan", flops, bytes_)
        return y, h_last
    err = _cuda.entry_point("selective_scan")(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
        D.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        None if states is None else states.data_ptr(), Bz, S, Di, N,
        int(x.dtype == torch.bfloat16), _cuda.stream(dev), dev.index)
    _cuda.check("selective_scan", err)
    return y, h_last
