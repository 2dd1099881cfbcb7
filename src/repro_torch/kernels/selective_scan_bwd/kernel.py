"""Launch of the CUDA selective scan backward
(``csrc/selective_scan_bwd.cu``): two kernels on the current stream, the
reverse walk writing dx, ddt, dh0 and per-block partials of dB, dC, dA and
dD, then their sums in a fixed order."""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda, shapeonly
from ..selective_scan.kernel import MAX_STATE, ROUND
from .work import scan_bwd_work

#: channels a block of the reverse walk serves
CHANNELS = 64
#: threads a block of the reverse walk
THREADS = 256
#: blocks of the reverse walk an SM is built to hold (``kBlocksPerSm``)
BLOCKS_PER_SM = 2


def resident_blocks(dtype: torch.dtype, full: bool,
                    dev: torch.device) -> int:
    """Reverse-walk blocks an SM of CUDA device ``dev`` holds at once, by
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` with the kernel's
    registers and dynamic shared memory: bf16 or float32 streams, the
    N = 16 vector build (``full``) or the masked one."""
    if dev.type != "cuda":
        raise ValueError(f"resident_blocks: needs a CUDA device, got {dev}")
    fn = _cuda.symbol("selective_scan_bwd", "selective_scan_bwd_occupancy",
                      [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    err = fn(int(dtype == torch.bfloat16), int(full), dev.index or 0,
             ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"selective_scan_bwd_occupancy: CUDA error {err}")
    return blocks.value


def selective_scan_bwd_kernel(x: torch.Tensor, dt: torch.Tensor,
                              B: torch.Tensor, C: torch.Tensor,
                              A: torch.Tensor, D: torch.Tensor,
                              h0: torch.Tensor, states: torch.Tensor,
                              dy: torch.Tensor,
                              dh_last: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, ...]:
    """Same contract as :func:`.ref.selective_scan_bwd_ref`, on contiguous
    CUDA tensors: x, dt, B, C and dy of one dtype, bf16 or float32; A, D,
    h0, ``states`` (from :func:`~..selective_scan.selective_scan_kernel`)
    and ``dh_last`` float32. Launched on the current stream (no
    synchronisation)."""
    Bz, S, Di = x.shape
    N = B.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"selective_scan_bwd: dtype {x.dtype} (want "
                         "bfloat16 or float32)")
    if N > MAX_STATE:
        raise ValueError(f"selective_scan_bwd: state width {N} > "
                         f"{MAX_STATE}")
    f32 = torch.float32
    args = [("x", x, x.dtype, (Bz, S, Di)), ("dt", dt, x.dtype, (Bz, S, Di)),
            ("B", B, x.dtype, (Bz, S, N)), ("C", C, x.dtype, (Bz, S, N)),
            ("A", A, f32, (Di, N)), ("D", D, f32, (Di,)),
            ("h0", h0, f32, (Bz, Di, N)),
            ("states", states, f32, (Bz, -(-S // ROUND), Di, N)),
            ("dy", dy, x.dtype, (Bz, S, Di))]
    if dh_last is not None:
        args.append(("dh_last", dh_last, f32, (Bz, Di, N)))
    dev = _cuda.check_args("selective_scan_bwd", args,
                           cuda=not shapeonly.is_fake(x))
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    dh0 = torch.empty_like(h0)
    if S == 0 or Bz * Di == 0:
        return (dx, ddt, dB.zero_(), dC.zero_(), dA.zero_(), dD.zero_(),
                dh0.zero_() if dh_last is None else dh0.copy_(dh_last))
    nblk = -(-Di // CHANNELS)
    part_db = torch.empty((Bz, S, nblk, N), dtype=f32, device=dev)
    part_dc = torch.empty_like(part_db)
    part_da = torch.empty((Bz, Di, N), dtype=f32, device=dev)
    part_dd = torch.empty((Bz, Di), dtype=f32, device=dev)
    if shapeonly.is_fake(x):
        bytes_, flops, _ = scan_bwd_work(Bz, S, Di, N, x.element_size())
        shapeonly.report("selective_scan_bwd", flops, bytes_)
        return dx, ddt, dB, dC, dA, dD, dh0
    err = _cuda.entry_point("selective_scan_bwd")(
        *(t.data_ptr() for t in (x, dt, B, C, A, D, h0, states, dy)),
        None if dh_last is None else dh_last.data_ptr(),
        *(t.data_ptr() for t in (dx, ddt, dB, dC, dA, dD, dh0, part_db,
                                 part_dc, part_da, part_dd)),
        Bz, S, Di, N, int(x.dtype == torch.bfloat16), _cuda.stream(dev),
        dev.index)
    _cuda.check("selective_scan_bwd", err)
    return dx, ddt, dB, dC, dA, dD, dh0
