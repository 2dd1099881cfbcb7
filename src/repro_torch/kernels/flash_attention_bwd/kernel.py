"""Launch of the CUDA flash attention backward
(``csrc/flash_attention_bwd.cu``): three kernels on the current stream,
``Delta = rowsum(dO * O)``, then dK/dV per (batch, query head, key tile)
in thread-block clusters and dQ per row tile, on the tensor cores for bf16
inputs; for float32 inputs the same three steps on the CUDA cores
(``flash_attention_bwd_f32``: dK/dV per (batch, KV head, 32-key tile), its
G heads summed in a loop, dQ per (batch, head, 32-query tile)), with no
plan and no tile table. A head dim above 64 that is not a multiple of 64
(112) runs the next multiple's shape in shared memory (the source's
``Cfg::kPD``): two consumer warpgroups at 112 as at 128.

:func:`plan_bwd` settles every launch from the shapes alone, the tile walk
included: for each launch position, the key tile of a dK/dV block with the
query tiles it walks, and the row tile of a dQ block with the key tiles it
walks, longest first. The kernels read that table and derive no bounds of
their own, so the CPU tests hold the walk the card makes.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .. import _cuda, shapeonly
from ..flash_attention.kernel import HEAD_DIMS
from ..flash_attention.work import attention_bwd_work

#: keys per dK/dV and dQ key tile, (head, query) rows per row tile: the
#: 64-row M of one wgmma
KEY_TILE = 64
ROW_TILE = 64
#: thread-block cluster size limit (the portable one)
MAX_CLUSTER = 8
#: int64 entries of the plan the C entry point takes
PLAN_FIELDS = ("cluster", "kv_heads_per_tile", "kv_block_q",
               "q_heads_per_tile", "q_block_q")


def _largest_divisor(n: int, cap: int) -> int:
    d = max(1, min(n, cap))
    while n % d:
        d -= 1
    return d


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class BwdPlan:
    """One backward call's launches.

    dK/dV: one block per (batch, KV head, cluster rank, launch position);
    the ``cluster`` blocks of a KV head are one thread-block cluster, rank
    r owning query heads ``kvh * G + r * heads_per_block`` onward, so the
    G heads' partial dK and dV meet in distributed shared memory.
    ``kv_tiles[pos]`` is ``(key tile, first query tile, query tiles)``: the
    block walks those query tiles (of ``kv_block_q`` queries) for each pack
    of ``kv_heads_per_tile`` of its heads.

    dQ: one block per (batch, group of ``q_heads_per_tile`` heads, launch
    position); ``q_tiles[pos]`` is ``(first query, first key tile, end key
    tile)`` of its ``q_block_q`` queries.

    Both tables run longest first (among equals, the first key tile and
    the last query tile), so the last wave is short.
    """

    B: int
    H: int
    KV: int
    Sq: int
    Skv: int
    kend: int
    hd: int
    causal: bool
    window: int | None
    q_offset: int
    consumers: int            # consumer warpgroups a block (2 at hd > 64)
    cluster: int
    heads_per_block: int
    kv_heads_per_tile: int
    kv_block_q: int
    q_heads_per_tile: int
    q_block_q: int
    kv_tiles: tuple[tuple[int, int, int], ...]
    q_tiles: tuple[tuple[int, int, int], ...]

    @property
    def group(self) -> int:
        return self.H // self.KV

    @property
    def dkdv_blocks(self) -> int:
        return self.B * self.KV * self.cluster * len(self.kv_tiles)

    @property
    def dq_blocks(self) -> int:
        return self.B * (self.H // self.q_heads_per_tile) * len(self.q_tiles)

    def table(self) -> list[int]:
        """The int32 tile table the kernels read: ``kv_tiles`` then
        ``q_tiles``, flat."""
        return [x for entry in self.kv_tiles + self.q_tiles for x in entry]

    @property
    def scratch_bytes(self) -> int:
        """Device memory beside the gradients: the float32 Delta of each
        call and the int32 tile table (made once a shape)."""
        return 4 * self.B * self.H * self.Sq + 4 * len(self.table())

    def as_c_array(self):
        return (ctypes.c_int64 * len(PLAN_FIELDS))(
            *(getattr(self, f) for f in PLAN_FIELDS))


def _query_span(kt: int, kend: int, Sq: int, causal: bool,
                window: int | None, q_offset: int) -> tuple[int, int]:
    """Queries ``[lo, hi)`` that can see some key of key tile ``kt``."""
    k0 = kt * KEY_TILE
    k1 = min(k0 + KEY_TILE, kend)
    if k1 <= k0:
        return 0, 0
    lo = max(0, k0 - q_offset) if causal else 0
    hi = Sq if window is None else min(Sq, k1 - 1 + window - q_offset)
    return lo, max(lo, hi)


def _key_span(q0: int, last_q: int, kend: int, causal: bool,
              window: int | None, q_offset: int) -> tuple[int, int]:
    """Keys ``[lo, hi)`` that some query of ``[q0, last_q]`` can see."""
    lo = 0 if window is None else max(0, q_offset + q0 - window + 1)
    hi = min(kend, q_offset + last_q + 1) if causal else kend
    return lo, max(lo, hi)


@functools.lru_cache(maxsize=256)
def plan_bwd(B: int, H: int, KV: int, Sq: int, Skv: int, kend: int, hd: int,
             *, causal: bool, window: int | None, q_offset: int) -> BwdPlan:
    """The launch plan of one backward call (see :class:`BwdPlan`).

    The cluster is the largest divisor of G up to 8, so G heads never need
    atomics and a cluster stays schedulable; a block packs several of its
    heads into one row tile only when a head has fewer than 64 queries. dQ
    packs the forward's way: the largest divisor of G up to 64 heads, then
    as many queries per head as fit 64 rows."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    G = H // KV
    cluster = _largest_divisor(G, MAX_CLUSTER)
    per_block = G // cluster
    kv_hpt = _largest_divisor(per_block, max(1, ROW_TILE // Sq))
    kv_bq = min(Sq, ROW_TILE // kv_hpt)
    q_hpt = _largest_divisor(G, ROW_TILE)
    q_bq = min(Sq, ROW_TILE // q_hpt)

    kv_tiles = []
    for kt in range(_cdiv(Skv, KEY_TILE)):
        lo, hi = _query_span(kt, kend, Sq, causal, window, q_offset)
        first = lo // kv_bq
        kv_tiles.append((kt, first, _cdiv(hi, kv_bq) - first if hi > lo
                         else 0))
    q_tiles = []
    for qt in range(_cdiv(Sq, q_bq)):
        q0 = qt * q_bq
        lo, hi = _key_span(q0, min(q0 + q_bq, Sq) - 1, kend, causal, window,
                           q_offset)
        q_tiles.append((q0, lo // KEY_TILE, _cdiv(hi, KEY_TILE)) if hi > lo
                       else (q0, 0, 0))
    # longest first; among equals the first key tile, the last query tile
    kv_tiles.sort(key=lambda e: (-e[2], e[0]))
    q_tiles.sort(key=lambda e: (e[1] - e[2], -e[0]))
    return BwdPlan(B=B, H=H, KV=KV, Sq=Sq, Skv=Skv, kend=kend, hd=hd,
                   causal=causal, window=window, q_offset=q_offset,
                   consumers=2 if hd > 64 else 1, cluster=cluster,
                   heads_per_block=per_block, kv_heads_per_tile=kv_hpt,
                   kv_block_q=kv_bq, q_heads_per_tile=q_hpt, q_block_q=q_bq,
                   kv_tiles=tuple(kv_tiles), q_tiles=tuple(q_tiles))


@functools.lru_cache(maxsize=64)
def _table_on(plan: BwdPlan, device: torch.device) -> torch.Tensor:
    """``plan``'s tile table on ``device``, copied once a shape (the first
    call waits for the copy; later calls launch without a host copy)."""
    return torch.tensor(plan.table(), dtype=torch.int32).to(device)


#: the dtypes the kernel takes: bf16 (tensor cores), float32 (CUDA cores)
DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=1)
def _f32_entry():
    """The float32 route's C function, beside the library's entry point."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    return _cuda.symbol("flash_attention_bwd", "flash_attention_bwd_f32",
                        [vp] * 11 + [i64] * 7 + [ctypes.c_int, i64,
                                                 ctypes.c_float, i64,
                                                 ctypes.c_float, vp,
                                                 ctypes.c_int])


def _check(q, k, v, o, lse, do) -> None:
    if q.dtype not in DTYPES:
        raise ValueError(
            f"flash_attention_bwd: dtype {q.dtype}; the backward kernel "
            "takes bf16 or float32")
    if q.device.type != "cuda" and not shapeonly.is_fake(q):
        raise ValueError(f"flash_attention_bwd: the CUDA kernel takes CUDA "
                         f"tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_bwd: want q (B, H, Sq, hd) and k, "
                         f"v (B, KV, Skv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"flash_attention_bwd: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: o and do must be shaped as q")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"float32 (B, H, Sq) tensor on {q.device}")
    for label, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        # o is the forward's float32 output before its rounding
        want = torch.float32 if label == "o" else q.dtype
        if t.device != q.device or t.dtype != want:
            raise ValueError(f"flash_attention_bwd: {label} must be "
                             f"{want} on {q.device}")
        # bf16 rows are copied by TMA: 16-byte aligned base and strides
        aligned = shapeonly.is_fake(t) or t.data_ptr() % 16 == 0
        if t.stride(3) != 1 or not aligned or any(
                s % (16 // t.element_size()) for s in t.stride()[:3]):
            raise ValueError(f"flash_attention_bwd: {label} needs a unit "
                             "stride along hd and 16-byte aligned rows, got "
                             f"strides {t.stride()}")


def flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, o: torch.Tensor,
                               lse: torch.Tensor, do: torch.Tensor, *,
                               causal: bool = True, window: int | None = None,
                               softcap: float | None = None, q_offset: int = 0,
                               kv_len: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Same contract as :func:`.ref.flash_attention_bwd_ref`, on CUDA bf16
    or float32 tensors, launched on the current stream. The inputs may be
    strided views of ``(B, S, heads, hd)`` storage; dq, dk and dv come back as
    ``(B, heads, S, hd)`` views of such storage, so the model's gradients
    need no transpose. The float32 ``Delta`` scratch is allocated here, and
    the plan's tile table on a shape's first call, which waits for its copy
    to the card (no later call synchronises); the kernels allocate nothing.
    Deterministic: the same inputs give bit-equal gradients. Float32 takes
    the CUDA-core route, which needs no plan. ``o`` is float32 whatever the
    inputs' dtype: the forward's output before its rounding (the third
    value of ``flash_attention_kernel(..., with_lse=True)``), from which
    ``Delta = rowsum(dO * O)`` is exact, where a bf16 O rounds away ``dP -
    Delta`` of rows whose values nearly agree."""
    _check(q, k, v, o, lse, do)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention_bwd: softcap {softcap} <= 0")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    dev = q.device
    new = lambda s, n: torch.empty((B, s, n, hd), dtype=q.dtype,  # noqa: E731
                                   device=dev).transpose(1, 2)
    dq, dk, dv = new(Sq, H), new(Skv, KV), new(Skv, KV)
    kend = Skv if kv_len is None else max(0, min(Skv, kv_len))
    if Sq == 0 or Skv == 0 or B == 0 or kend == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    if shapeonly.is_fake(q):
        bytes_, flops = attention_bwd_work(
            B, H, KV, hd, Sq, Skv, size=q.element_size(),
            o_size=o.element_size(), causal=causal, window=window,
            q_offset=q_offset, kv_len=kv_len)
        shapeonly.report("flash_attention_bwd", flops, bytes_)
        return dq, dk, dv
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()[:3]))
    if q.dtype == torch.float32:
        err = _f32_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, B, H, KV, Sq, Skv, kend,
            hd, int(causal), 0 if window is None else window,
            0.0 if softcap is None else softcap, q_offset, hd ** -0.5,
            _cuda.stream(dev), dev.index)
        _cuda.check("flash_attention_bwd", err)
        return dq, dk, dv
    plan = plan_bwd(B, H, KV, Sq, Skv, kend, hd, causal=causal,
                    window=window, q_offset=q_offset)
    table = _table_on(plan, dev)
    err = _cuda.entry_point("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), strides, B, H, KV, Sq, Skv, kend, hd, int(causal),
        0 if window is None else window, 0.0 if softcap is None else softcap,
        q_offset, hd ** -0.5, plan.as_c_array(), table.data_ptr(),
        _cuda.stream(dev), dev.index)
    _cuda.check("flash_attention_bwd", err)
    return dq, dk, dv
