"""Mamba-1 (falcon-mamba) and Mamba-2 (zamba2) blocks and their
single-token decode steps.

Mamba-1:

The recurrence runs through the selective-scan op: on CUDA tensors the
hand-written kernel (``csrc/selective_scan.cu``), on CPU tensors its plain
sequential version. In training (``train=True``) it runs through
:class:`~repro_torch.kernels.selective_scan.SelectiveScanFn` on every
device: the forward saves the state at the end of every 16-step round and
the backward is the hand-written ``csrc/selective_scan_bwd.cu`` on CUDA
tensors, its plain reverse loop on CPU tensors. The conv, projections,
softplus and gating stay plain PyTorch under autograd. The skip term
``D * x`` is folded into the op, as the TPU kernel folds it.

Mamba-2 (:func:`mamba2_forward`) is the SSD chunked form of
``repro.models.mamba.mamba2_forward``, in plain PyTorch under autograd on
every device: the reference computes it in jnp outside any Pallas kernel
(its products go to XLA), so its products here are ``torch.matmul`` /
``einsum``. One difference in form: the intra-chunk decay masks the
exponent, ``exp(where(causal, cum_i - cum_j, -inf))`` (the segment sum of
the published SSD code), where the reference masks its result,
``where(causal, exp(cum_i - cum_j), 0)``. Above the diagonal the exponent
is positive and, at a chunk of 128 or more, passes float32's range: the
reference's forward still gets 0 there, but exp's gradient forms
``0 * inf = NaN``. ``exp(-inf)`` is exactly 0, so the forward is the
same, and the gradients stay finite at any chunk. The chunk work runs in
an ``ssd`` profiler range. On DTensor inputs (a sharded step) the chunk
loop runs on each rank's shards (:mod:`repro_torch.kernels.sharded`): the
batch over the data axes and the heads over ``model`` when they divide it
(DTensor cannot place the chunk's batched products itself).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import sharded
from ..kernels.selective_scan import selective_scan, selective_scan_train
from .common import normal_init, rms_norm, silu


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C), weight: (C, K), bias: (C,).

    With ``state`` (B, K-1, C) (decode) it is prepended and the new state
    returned; else zero left-padding (prefill). The float32 weights promote
    the output to float32, as in the reference; the state keeps x's dtype.
    """
    K = weight.shape[1]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(K):                      # K is 4: unrolled shifts
        out = out + xp[:, i:i + S, :] * weight[:, i]
    out = out + bias
    new_state = xp[:, xp.shape[1] - (K - 1):, :]
    return out, new_state


def init_mamba1(gen: torch.Generator, d_model: int, ssm,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    di = ssm.d_inner(d_model)
    dtr = ssm.resolved_dt_rank(d_model)
    N = ssm.state_dim
    K = ssm.conv_kernel
    f32 = torch.float32
    dev = gen.device
    return {
        "in_proj": normal_init(gen, (d_model, 2 * di), dtype=dtype),
        "conv_w": normal_init(gen, (di, K), scale=0.1, dtype=f32),
        "conv_b": torch.zeros((di,), dtype=f32, device=dev),
        "x_proj": normal_init(gen, (di, dtr + 2 * N), dtype=dtype),
        "dt_proj": normal_init(gen, (dtr, di), scale=dtr ** -0.5, dtype=f32),
        "dt_bias": torch.full((di,), -4.6, dtype=f32, device=dev),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=f32, device=dev)
                           ).repeat(di, 1),
        "D_skip": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": normal_init(gen, (di, d_model), dtype=dtype),
    }


def mamba1_forward(params: dict, x: torch.Tensor, ssm, *, state=None,
                   backend: str = "auto", train: bool = False):
    """x: (B, S, D). ``state``: optional (conv_state (B, K-1, Di),
    ssm_state (B, Di, N) float32) to continue from. ``train``: the scan
    under autograd (:func:`selective_scan_train`). Returns
    (y, (new_conv_state, h_last))."""
    B, S, D = x.shape
    N = ssm.state_dim
    dtr = ssm.resolved_dt_rank(D)
    xz = x @ params["in_proj"]
    xin, z = xz.chunk(2, dim=-1)                                 # (B, S, Di)
    xc, new_conv = causal_conv1d(xin, params["conv_w"], params["conv_b"],
                                 state=None if state is None else state[0])
    xc = silu(xc)                                                # float32
    proj = xc @ params["x_proj"].float()
    dt = F.softplus(proj[..., :dtr] @ params["dt_proj"] + params["dt_bias"])
    B_ssm = proj[..., dtr:dtr + N].contiguous()
    C_ssm = proj[..., dtr + N:].contiguous()
    A = -torch.exp(params["A_log"])
    h0 = (torch.zeros((B, xc.shape[-1], N), dtype=torch.float32,
                      device=x.device) if state is None else state[1])
    scan = selective_scan_train if train else selective_scan
    y, h_last = scan(xc, dt, B_ssm, C_ssm, A, params["D_skip"], h0,
                     backend=backend)
    y = (y.to(x.dtype) * silu(z)) @ params["out_proj"]
    return y, (new_conv, h_last)


def mamba1_decode(params: dict, x: torch.Tensor, state, ssm, *,
                  backend: str = "auto"):
    """One token: x (B, 1, D); ``state`` = (conv_state, h). The scan runs
    at S = 1 from the cached state."""
    return mamba1_forward(params, x, ssm, state=state, backend=backend)


# --------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# --------------------------------------------------------------------------

#: the ``record_function`` range of the SSD chunk work
SSD_SCOPE = "ssd"


def init_mamba2(gen: torch.Generator, d_model: int, ssm,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The reference's leaves: separate z, x, B, C and dt projections,
    depthwise convs over x, B and C, float32 SSM parameters."""
    di = ssm.d_inner(d_model)
    N = ssm.state_dim
    nh = di // ssm.head_dim
    K = ssm.conv_kernel
    f32 = torch.float32
    dev = gen.device
    zeros = lambda n: torch.zeros((n,), dtype=f32, device=dev)  # noqa: E731
    return {
        "in_z": normal_init(gen, (d_model, di), dtype=dtype),
        "in_x": normal_init(gen, (d_model, di), dtype=dtype),
        "in_B": normal_init(gen, (d_model, N), dtype=dtype),
        "in_C": normal_init(gen, (d_model, N), dtype=dtype),
        "in_dt": normal_init(gen, (d_model, nh), dtype=dtype),
        "conv_x_w": normal_init(gen, (di, K), scale=0.1, dtype=f32),
        "conv_x_b": zeros(di),
        "conv_B_w": normal_init(gen, (N, K), scale=0.1, dtype=f32),
        "conv_B_b": zeros(N),
        "conv_C_w": normal_init(gen, (N, K), scale=0.1, dtype=f32),
        "conv_C_b": zeros(N),
        "dt_bias": zeros(nh),
        "A_log": zeros(nh),
        "D_skip": torch.ones((nh,), dtype=f32, device=dev),
        "norm_w": zeros(di),
        "out_proj": normal_init(gen, (di, d_model), dtype=dtype),
    }


def _ssd_chunk(S_state, xk, bk, ck, dtk, A):
    """One chunk of L steps. S_state (B, nh, P, N); xk (B, L, nh, P); bk,
    ck (B, L, N); dtk (B, L, nh); A (nh,). Returns (S_new, y (B, L, nh,
    P)), all float32."""
    L = xk.shape[1]
    dA = (dtk * A).transpose(1, 2)                       # (B, nh, L)
    cum = torch.cumsum(dA, dim=-1)
    # intra-chunk: w[b,h,i,j] = exp(cum_i - cum_j) (C_i . B_j), masked in
    # the exponent (j > i gives exp(-inf) = 0 and a zero gradient)
    causal = torch.ones((L, L), dtype=torch.bool, device=xk.device).tril()
    seg = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                                float("-inf")))          # (B, nh, L, L)
    cb = ck @ bk.transpose(1, 2)                         # (B, L, L)
    w = seg * cb[:, None]
    xdt = (xk * dtk[..., None]).transpose(1, 2)          # (B, nh, L, P)
    y_intra = w @ xdt                                    # (B, nh, L, P)
    # inter-chunk: the carried state seen through C_i, decayed to step i
    y_inter = torch.einsum("bin,bhpn->bhip", ck, S_state) * cum.exp()[..., None]
    y = (y_intra + y_inter).transpose(1, 2)              # (B, L, nh, P)
    # the new chunk state
    decay_to_end = torch.exp(cum[..., -1:] - cum)        # (B, nh, L)
    contrib = torch.einsum("bhjp,bjn->bhpn", xdt * decay_to_end[..., None],
                           bk)
    S_new = S_state * torch.exp(cum[..., -1])[..., None, None] + contrib
    return S_new, y


def _ssd_scan(S_state, xp, bp, cp, dtp, A, chunk: int):
    """Every chunk of the padded sequence in turn, from S_state. Returns
    (the final state, y (B, S_padded, nh, P))."""
    ys = []
    for c0 in range(0, xp.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        S_state, yk = _ssd_chunk(S_state, xp[:, sl], bp[:, sl], cp[:, sl],
                                 dtp[:, sl], A)
        ys.append(yk)
    return S_state, torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]


def mamba2_forward(params: dict, x: torch.Tensor, ssm, *, chunk: int = 256,
                   state=None):
    """SSD chunked forward. x: (B, S, D) -> (y, (conv_states, ssm_state)).

    ``state``: optional (conv_states, ssm_state) to continue from, as
    returned: conv_states a dict ``{x, B, C}`` of (B, K-1, dim) in x's
    dtype (bf16 as cached), ssm_state (B, nh, P, N) float32. One group:
    B and C are shared across heads. S is padded up to a multiple of the
    chunk (padded steps have dt = 0: they neither decay nor feed the
    state)."""
    Bsz, S, D = x.shape
    di = ssm.d_inner(D)
    N = ssm.state_dim
    P = ssm.head_dim
    nh = di // P
    chunk = min(chunk, S)

    z = x @ params["in_z"]
    xr = x @ params["in_x"]
    br = x @ params["in_B"]
    cr = x @ params["in_C"]
    dt_raw = x @ params["in_dt"]
    cs = state[0] if state is not None else {"x": None, "B": None, "C": None}
    xc, ncx = causal_conv1d(xr, params["conv_x_w"], params["conv_x_b"],
                            state=cs["x"])
    bc, ncb = causal_conv1d(br, params["conv_B_w"], params["conv_B_b"],
                            state=cs["B"])
    cc, ncc = causal_conv1d(cr, params["conv_C_w"], params["conv_C_b"],
                            state=cs["C"])
    new_conv = {"x": ncx, "B": ncb, "C": ncc}
    xs = silu(xc).reshape(Bsz, S, nh, P).float()
    B_ssm = silu(bc).float()                                  # (B, S, N)
    C_ssm = silu(cc).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])       # (B, S, nh)
    A = -torch.exp(params["A_log"])

    pad = (-S) % chunk
    xp, bp, cp, dtp = xs, B_ssm, C_ssm, dt
    if pad:
        xp = F.pad(xs, (0, 0, 0, 0, 0, pad))
        bp = F.pad(B_ssm, (0, 0, 0, pad))
        cp = F.pad(C_ssm, (0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
    S_state = (torch.zeros((Bsz, nh, P, N), dtype=torch.float32,
                           device=x.device) if state is None else state[1])
    with torch.profiler.record_function(SSD_SCOPE):
        args = (S_state, xp, bp, cp, dtp, A)
        if sharded.is_sharded(xp):
            m = sharded.model_ranks(xp)
            S_state, y = sharded.call_local(
                lambda *a: _ssd_scan(*a, chunk), args,
                ((0, 1), (0, 2), (0, None), (0, None), (0, 2), (None, 0)),
                ((0, 1), (0, 2)), batch=Bsz, split_model=nh % m == 0)
        else:
            S_state, y = _ssd_scan(*args, chunk)
    y = y[:, :S]
    y = y + params["D_skip"][:, None] * xs
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = rms_norm(y * silu(z), params["norm_w"])
    return y @ params["out_proj"], (new_conv, S_state)


def mamba2_decode(params: dict, x: torch.Tensor, state, ssm):
    """One token: x (B, 1, D); ``state`` = (conv_states, ssm_state); the
    forward at ``chunk=1`` from the cached state."""
    return mamba2_forward(params, x, ssm, chunk=1, state=state)
