"""The model paths' CUDA kernels against their plain versions.

No JAX here, so the file runs on the card's machine:
``pytest -m gpu tests/test_torch_model_kernels.py``. On the CPU it holds the
ops' routes and the wrappers' input checks (a CUDA tensor launches the
kernel or raises; nothing falls back). On the card (``-m gpu``) each kernel
is held against its plain version — the grid of ``tests/test_kernels.py``,
the serving path's shapes, the model's strided layouts, the edges of each
``flash_attention`` route (ragged tiles, empty and ragged decode splits,
every head dim, a call replayed from a CUDA graph; the non-causal mask
of the encoder-decoder: Sq = Skv, Sq != Skv, S not a multiple of 64, its
decode over 17 self and 1,500 cross keys), the scan's edges
(every state width, ragged rounds and channel tiles, rows off a 16-byte
boundary, a call replayed from a CUDA graph) — at that file's
tolerances: ``TOL`` for attention, ten times ``TOL`` for the scan (1,024
steps of a recurrence in another rounding order). The training path's
backwards likewise: ``flash_attention_bwd`` at ``TOL`` (the bf16
route, and the float32 route on the CUDA cores), and the scan's
forward with round states (y and h_last bit-equal to the serving
forward's) and ``selective_scan_bwd`` (``SCAN_BWD``: the training shape,
ragged rounds, channel blocks and state widths, with and without
dh_last) at ten times float32's ``TOL``, bf16's ``TOL`` in bf16, each
relative to the output's largest entry, bit-equal over two calls. The
plain versions are held against the reference's by
``test_torch_attention.py``, ``test_torch_ssm.py`` and
``test_torch_scan_bwd.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import (attention_mask,
                                                 flash_attention,
                                                 flash_attention_kernel,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref,
                                                 flash_attention_split_ref,
                                                 flash_attention_train,
                                                 plan_launch)
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd_kernel, flash_attention_bwd_ref)
from repro_torch.kernels.selective_scan import (round_states,
                                                selective_scan,
                                                selective_scan_kernel,
                                                selective_scan_ref,
                                                selective_scan_train)
from repro_torch.kernels.selective_scan.kernel import MAX_STATE, ROUND
from repro_torch.kernels.selective_scan_bwd import (selective_scan_bwd_kernel,
                                                    selective_scan_bwd_ref)
from repro_torch.kernels.selective_scan_bwd.kernel import (BLOCKS_PER_SM,
                                                           CHANNELS, THREADS,
                                                           resident_blocks)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRID_IDS = "B,H,KV,Sq,Skv,hd,causal,window,softcap"
ATTN = [
    (2, 4, 2, 128, 128, 64, True, None, None),
    (1, 4, 4, 256, 256, 32, True, None, 50.0),
    (2, 2, 1, 96, 192, 16, False, None, None),
    (1, 8, 4, 256, 256, 64, True, 64, None),
    (1, 2, 2, 64, 64, 128, True, None, None),
    (2, 6, 3, 80, 144, 32, True, None, None),
    (4, 4, 1, 1024, 1024, 256, True, None, None),   # gemma3-1b global
    (4, 4, 1, 1024, 1024, 256, True, 512, None),    # gemma3-1b local
    (1, 16, 2, 40, 40, 128, True, None, 30.0),      # G 8, softcap
    (1, 64, 1, 3, 3, 16, True, None, None),         # G 64 > rows per block
    (4, 32, 32, 1024, 1024, 112, True, None, None),  # zamba2-7b shared block
    (2, 4, 4, 96, 96, 112, True, 32, 20.0),         # hd 112, window, softcap
    (4, 8, 2, 256, 256, 80, True, None, None),      # the ~100M trainer, hd 80
    (4, 8, 2, 256, 256, 80, True, 256, None),       # and its local layers
]
#: prefill edges: Sq not a multiple of the 64-row tile, every head dim,
#: q_offset > 0 with Sq > 1 (a chunk against a longer cache), softcap with
#: a window
PREFILL_IDS = "B,H,KV,Sq,Skv,hd,window,softcap,q_offset,kv_len"
PREFILL = [
    (2, 4, 1, 70, 70, 16, None, None, 0, None),
    (1, 8, 2, 45, 45, 32, None, None, 0, None),
    (2, 2, 2, 130, 130, 64, None, None, 0, None),
    (1, 4, 1, 100, 100, 128, None, None, 0, None),
    (2, 4, 1, 77, 77, 256, None, None, 0, None),
    (1, 4, 1, 48, 300, 256, None, None, 200, 248),
    (1, 4, 2, 33, 200, 64, 16, None, 100, 133),
    (2, 4, 1, 200, 200, 128, 64, 30.0, 0, None),
    (1, 8, 1, 96, 96, 256, 40, 50.0, 0, None),
    (1, 2, 1, 1024, 1024, 256, 512, 50.0, 0, None),
    (1, 4, 1, 70, 200, 112, None, None, 100, 170),
    (2, 4, 2, 130, 130, 112, 48, 30.0, 0, None),
    (1, 4, 1, 48, 300, 80, None, None, 200, 248),
    (2, 8, 2, 70, 70, 80, 32, 30.0, 0, None),
]
#: decode beyond the serving shape: G * Sq <= 16 rows, every head dim
DECODE_IDS = "G,Sq,hd,causal,window,pos"
DECODE = [
    (4, 4, 256, True, None, 100),
    (1, 16, 128, True, 8, 300),
    (1, 16, 128, True, 20, 300),    # two splits; rows 0-12 see none of the 2nd
    (2, 3, 64, False, None, 90),
    (16, 1, 32, True, 20, 40),
    (8, 2, 16, True, None, 1500),
    (1, 1, 112, True, None, 1039),    # zamba2-7b decode
    (4, 2, 112, True, 40, 300),
    (4, 1, 80, True, None, 256),      # the ~100M trainer: 257 keys
    (4, 2, 80, True, 40, 300),
]
#: the backward (bf16): the training path's shapes (gemma3-1b's global and
#: local layers, gemma2-27b's heads with a softcap), every head dim, ragged
#: row and key tiles, G 1 to 64, and a chunk of queries against a longer
#: key range (q_offset > 0, kv_len < Skv: keys past kv_len get no gradient)
BWD_IDS = "B,H,KV,Sq,Skv,hd,window,softcap,q_offset,kv_len"
BWD = [
    (2, 4, 2, 128, 128, 64, None, None, 0, None),
    (1, 4, 1, 77, 77, 256, None, None, 0, None),
    (2, 4, 1, 70, 70, 16, None, None, 0, None),
    (1, 8, 4, 96, 96, 32, None, None, 0, None),
    (2, 4, 1, 200, 200, 128, 64, 30.0, 0, None),
    (1, 16, 2, 40, 40, 128, None, 30.0, 0, None),
    (1, 64, 1, 3, 3, 16, None, None, 0, None),
    (1, 4, 1, 48, 300, 256, None, None, 200, 248),
    (1, 4, 2, 33, 200, 64, 16, None, 100, 133),
    (4, 4, 1, 1024, 1024, 256, None, None, 0, None),
    (4, 4, 1, 1024, 1024, 256, 512, None, 0, None),
    (2, 32, 16, 512, 512, 128, None, 50.0, 0, None),
    (4, 32, 32, 1024, 1024, 112, None, None, 0, None),   # zamba2-7b
    (2, 4, 2, 70, 70, 112, 32, 30.0, 0, None),
    (1, 4, 1, 48, 300, 112, None, None, 200, 248),
    (4, 8, 2, 256, 256, 80, None, None, 0, None),   # the ~100M trainer
    (4, 8, 2, 256, 256, 80, 256, None, 0, None),
    (2, 4, 1, 70, 70, 80, 32, 30.0, 0, None),
]
SCAN = [(2, 64, 32, 8), (1, 128, 64, 16), (2, 96, 48, 4), (1, 256, 128, 16),
        (4, 1024, 8192, 16),                         # falcon-mamba-7b prefill
        (4, 1, 8192, 16),                            # and decode
        (3, 70, 200, 8),                             # ragged channel blocks
        # rounds of 16 steps: S not a multiple of the round; S = 1 from the
        # nonzero h0 every case has
        (2, 17, 64, 16), (1, 33, 128, 5), (2, 1, 100, 16), (1, 1, 64, 3),
        # channel tiles of 64: Di not a multiple of the tile; odd Di and
        # odd S * N, whose bf16 rows are copied element by element
        (2, 40, 100, 16), (1, 19, 37, 7), (2, 5, 130, 11),
        # every N the four lanes of four states a channel can hold, the
        # surplus masked off (N = 16: the vector path)
        *[(2, 40, 96, n) for n in range(1, 17)]]

#: the scan backward: falcon-mamba-7b's training shape, one round, S not a
#: multiple of the 16-step round, S = 1, Di not a multiple of the
#: 64-channel block, N below 16 (the masked states); then the edges of the
#: walk's two 8-step halves of a round: S a multiple of 8 but not of 16,
#: S of one half, just past one half, shorter than one half, with N 16, 5
#: and 1 and ragged channel blocks
SCAN_BWD = [(4, 1024, 8192, 16), (1, 16, 64, 16), (2, 17, 64, 16),
            (1, 33, 128, 5), (2, 1, 100, 16), (3, 70, 200, 8),
            (1, 19, 37, 7), (2, 40, 96, 1), (2, 100, 130, 16),
            (2, 24, 100, 16), (1, 8, 64, 5), (2, 9, 130, 1),
            (3, 5, 37, 16), (1, 56, 72, 5)]
#: the scan backward's tolerance, relative to each output's largest entry
BWD_TOL = {"float32": 10 * TOL["float32"], "bfloat16": TOL["bfloat16"]}


def _qkv(seed, B, H, KV, Sq, Skv, hd, dtype="float32", device="cpu"):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(s, np.float32),
                              device=device).to(getattr(torch, dtype))
                 for s in ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd)))


def _scan_inputs(seed, Bz, S, Di, N, dtype="float32", device="cpu"):
    """x, dt, B, C in ``dtype``; A, D, h0 float32."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    dt = (np.log1p(np.exp(n(Bz, S, Di))) * 0.1).astype(np.float32)
    streams = (n(Bz, S, Di), dt, n(Bz, S, N), n(Bz, S, N))
    rest = (-np.exp(n(Di, N) * 0.3), n(Di), n(Bz, Di, N))
    t = lambda a, d: torch.tensor(a, device=device).to(d)  # noqa: E731
    return ([t(a, getattr(torch, dtype)) for a in streams]
            + [t(a, torch.float32) for a in rest])


def _f32(t):
    return t.float().cpu().numpy()


def test_attention_routes_and_checks():
    """backend='plain' is the CPU route; the kernel takes only what it was
    built for and never falls back; no CPU call launches it."""
    q, k, v = _qkv(3, 1, 2, 1, 8, 8, 16)
    before = dict(_cuda.LAUNCHES)
    assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    assert torch.equal(flash_attention(q, k, v, backend="plain"),
                       flash_attention_ref(q, k, v))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        flash_attention(q, k, v, backend="pallas")
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention_kernel(*_qkv(0, 1, 2, 1, 4, 4, 48))
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_kernel(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention_kernel(q, k[..., :8], v[..., :8])
    assert _cuda.LAUNCHES == before


def test_scan_routes_and_checks():
    args = _scan_inputs(4, 1, 8, 16, 4)
    before = dict(_cuda.LAUNCHES)
    for backend in ("auto", "plain"):
        y, h = selective_scan(*args, backend=backend)
        ry, rh = selective_scan_ref(*args)
        assert torch.equal(y, ry) and torch.equal(h, rh)
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan(*args, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        selective_scan(*args, backend="interpret")
    with pytest.raises(ValueError, match="state width 32"):
        selective_scan_kernel(*_scan_inputs(4, 1, 8, 16, 32))
    assert _cuda.LAUNCHES == before


def test_sources_and_flags():
    """Both sources exist; the model kernels build without -fmad=false,
    the bit-exact simulation kernels with it."""
    for name in _cuda.MODEL_KERNELS:
        assert (_cuda.CSRC / f"{name}.cu").exists()
        assert "-fmad=false" not in _cuda.nvcc_flags(name)
    for name in _cuda.EXACT_KERNELS:
        assert "-fmad=false" in _cuda.nvcc_flags(name)
    assert set(_cuda.KERNELS) == set(_cuda.LAUNCHES)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(GRID_IDS, ATTN)
def test_cuda_attention_matches_plain(B, H, KV, Sq, Skv, hd, causal, window,
                                      softcap, dtype):
    """Contiguous tensors and the model's (B, S, H, hd) storage seen as
    (B, H, S, hd)."""
    dev = _card()
    q, k, v = _qkv(B * Sq + hd, B, H, KV, Sq, Skv, hd, dtype, dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _f32(flash_attention_ref(q, k, v, **kw))
    before = _cuda.LAUNCHES["flash_attention"]
    got = flash_attention_kernel(q, k, v, **kw)
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    np.testing.assert_allclose(_f32(got), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    np.testing.assert_allclose(_f32(flash_attention_kernel(*views, **kw)),
                               want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 512])
@pytest.mark.parametrize("pos", [0, 511, 1039])
def test_cuda_attention_decode_matches_plain(window, pos):
    """gemma3-1b decode: one query per head against a (B, 1040, KV, hd)
    cache seen as (B, KV, 1040, hd), q_offset = pos, kv_len = pos + 1."""
    dev = _card()
    rng = np.random.default_rng(pos)
    bf = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s, np.float32), device=dev).bfloat16()
    q = bf(4, 1, 4, 256).transpose(1, 2)
    kc, vc = bf(4, 1040, 1, 256).transpose(1, 2), bf(4, 1040, 1, 256
                                                      ).transpose(1, 2)
    kw = dict(causal=True, window=window, q_offset=pos, kv_len=pos + 1)
    np.testing.assert_allclose(_f32(flash_attention_kernel(q, kc, vc, **kw)),
                               _f32(flash_attention_ref(q, kc, vc, **kw)),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(PREFILL_IDS, PREFILL)
def test_cuda_attention_prefill_edges(B, H, KV, Sq, Skv, hd, window, softcap,
                                      q_offset, kv_len, dtype):
    """bf16 through the tensor-core kernel, float32 through the SIMT one,
    on the model's strided views; one launch a call."""
    dev = _card()
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
               _qkv(Sq * hd + Skv, B, H, KV, Sq, Skv, hd, dtype, dev))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              kv_len=kv_len)
    plan = plan_launch(B, H, KV, Sq, Skv if kv_len is None else kv_len,
                       causal=True, window=window, q_offset=q_offset,
                       dtype=q.dtype)
    assert plan.route == ("mma" if dtype == "bfloat16" else "simt")
    before = _cuda.LAUNCHES["flash_attention"]
    got = flash_attention_kernel(q, k, v, **kw)
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    np.testing.assert_allclose(_f32(got), _f32(flash_attention_ref(q, k, v,
                                                                   **kw)),
                               atol=TOL[dtype], rtol=TOL[dtype])


#: non-causal calls (the encoder-decoder): Sq = Skv on whole 64-key tiles,
#: S not a multiple of 64 (whisper-large-v3's 1,500 frames), Sq != Skv
#: (cross-attention over the encoder's output), G > 1
NONCAUSAL_IDS = "B,H,KV,Sq,Skv,hd"
NONCAUSAL = [
    (2, 4, 4, 128, 128, 64),
    (2, 4, 4, 100, 100, 64),
    (1, 20, 20, 1500, 1500, 64),    # whisper-large-v3's encoder layer
    (2, 4, 4, 19, 200, 64),
    (2, 20, 20, 187, 1500, 64),     # its cross-attention, teacher-forced
    (2, 8, 4, 70, 130, 128),
    (1, 4, 2, 33, 65, 16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(NONCAUSAL_IDS, NONCAUSAL)
def test_cuda_attention_noncausal(B, H, KV, Sq, Skv, hd, dtype):
    """``causal=False`` on the prefill routes, on the model's strided
    views: every query sees every key, the last key tile ragged where Skv
    is not a multiple of 64."""
    dev = _card()
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
               _qkv(Sq + Skv + hd, B, H, KV, Sq, Skv, hd, dtype, dev))
    plan = plan_launch(B, H, KV, Sq, Skv, causal=False, window=None,
                       q_offset=0, dtype=q.dtype)
    assert plan.route == ("mma" if dtype == "bfloat16" else "simt")
    assert (plan.key_lo, plan.key_hi) == (0, Skv)
    before = _cuda.LAUNCHES["flash_attention"]
    got = flash_attention_kernel(q, k, v, causal=False)
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    np.testing.assert_allclose(_f32(got), _f32(flash_attention_ref(
        q, k, v, causal=False)), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,slots", [(17, 187), (1500, 1500)])
def test_cuda_attention_encdec_decode(n, slots, causal, dtype):
    """whisper-large-v3's decode: one query a head (H 20 on KV 20, hd 64)
    against ``n`` keys of a ``slots``-slot cache, the self cache at 17
    keys of 187 and the cross cache at all 1,500 (24 splits of 64, the
    last 28 keys long), causal with ``q_offset = n - 1`` as the model
    calls it and non-causal."""
    dev = _card()
    q, k, v = _decode_inputs(n + slots, 4, 1, 20, 1, 64, dtype, dev,
                             cache=slots)
    kw = dict(causal=causal, q_offset=n - 1 if causal else 0, kv_len=n)
    plan = plan_launch(4, 20, 20, 1, n, causal=causal, window=None,
                       q_offset=kw["q_offset"], dtype=q.dtype)
    assert plan.route == "decode" and (plan.key_lo, plan.key_hi) == (0, n)
    got = flash_attention_kernel(q, k, v, **kw)
    np.testing.assert_allclose(_f32(got),
                               _f32(flash_attention_ref(q, k, v, **kw)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(
        _f32(got), _f32(flash_attention_split_ref(
            q, k, v, split_len=plan.split_len, **kw)),
        atol=TOL[dtype], rtol=TOL[dtype])


def _decode_inputs(seed, B, G, KV, Sq, hd, dtype, dev, cache=1040):
    """q (B, Sq, H, hd) and a (B, cache, KV, hd) cache, seen as (B, heads,
    S, hd) as the model passes them."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s, np.float32), device=dev).to(
            getattr(torch, dtype)).transpose(1, 2)
    return t(B, Sq, G * KV, hd), t(B, cache, KV, hd), t(B, cache, KV, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("window,softcap", [(None, None), (512, None),
                                            (None, 50.0), (512, 50.0)])
@pytest.mark.parametrize("pos", [0, 31, 32, 511, 1039])
def test_cuda_attention_split_decode(pos, window, softcap, G, dtype):
    """The split-KV decode route at the serving head dim: one split of one
    key (pos 0), one full split (31), a full split beside a one-key split
    (32), full splits only (511; 1039 under the window) and a ragged last
    split (1039); held to the plain version and to the plain
    split-and-merge. With one query the planned range is exactly the
    row's visible keys, so no split is empty here: ``DECODE`` holds that
    case."""
    dev = _card()
    q, kc, vc = _decode_inputs(pos * 8 + G, 2, G, 2, 1, 256, dtype, dev)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=pos,
              kv_len=pos + 1)
    plan = plan_launch(2, 2 * G, 2, 1, pos + 1, causal=True, window=window,
                       q_offset=pos, dtype=q.dtype)
    assert plan.route == "decode"
    before = _cuda.LAUNCHES["flash_attention"]
    got = _f32(flash_attention_kernel(q, kc, vc, **kw))
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(got, _f32(flash_attention_ref(q, kc, vc, **kw)),
                               **tol)
    np.testing.assert_allclose(got, _f32(flash_attention_split_ref(
        q, kc, vc, split_len=plan.split_len, **kw)), **tol)


def test_decode_cases_hold_empty_and_ragged_splits():
    """``DECODE`` (run on the card below) plans some row a split with no
    visible key beside splits with some, and some split ragged, so the
    merge's zero weight for an empty split and the partial last split are
    both exercised on the card."""
    empty = ragged = False
    for G, Sq, hd, causal, window, pos in DECODE:
        plan = plan_launch(2, G, 1, Sq, pos + Sq, causal=causal,
                           window=window, q_offset=pos, dtype=torch.float32)
        assert plan.route == "decode"
        mask = attention_mask(Sq, pos + Sq, causal=causal, window=window,
                              q_offset=pos, kv_len=pos + Sq,
                              device=torch.device("cpu"))
        starts = range(plan.key_lo, plan.key_hi, plan.split_len)
        seen = torch.stack([mask[:, a:a + plan.split_len].any(1)
                            for a in starts], 1)          # (row, split)
        empty |= bool((seen.any(1) & ~seen.all(1)).any())
        ragged |= (plan.key_hi - plan.key_lo) % plan.split_len != 0
    assert empty and ragged


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(DECODE_IDS, DECODE)
def test_cuda_attention_split_decode_rows(G, Sq, hd, causal, window, pos,
                                          dtype):
    """Several queries per head (speculative-decode shapes), non-causal
    calls and every head dim of the decode kernel."""
    dev = _card()
    q, kc, vc = _decode_inputs(G * Sq + hd, 2, G, 1, Sq, hd, dtype, dev,
                               cache=pos + Sq + 5)
    kw = dict(causal=causal, window=window, q_offset=pos, kv_len=pos + Sq)
    assert plan_launch(2, G, 1, Sq, pos + Sq, causal=causal, window=window,
                       q_offset=pos, dtype=q.dtype).route == "decode"
    before = _cuda.LAUNCHES["flash_attention"]
    got = flash_attention_kernel(q, kc, vc, **kw)
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    np.testing.assert_allclose(_f32(got),
                               _f32(flash_attention_ref(q, kc, vc, **kw)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [1, 1024])
def test_cuda_attention_graph_replay(Sq):
    """A call captured in a CUDA graph (as the timing and a graph-captured
    decode step take it) and replayed on new inputs written in place: the
    decode route's split scratch, allocated by the wrapper during capture,
    stays valid."""
    dev = _card()
    pos = 1039 if Sq == 1 else 0
    q, kc, vc = _decode_inputs(Sq, 4, 4, 1, Sq, 256, "bfloat16", dev,
                               cache=1040 if Sq == 1 else Sq)
    kw = dict(causal=True, q_offset=pos, kv_len=pos + Sq)
    flash_attention_kernel(q, kc, vc, **kw)          # build, load, configure
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention_kernel(q, kc, vc, **kw)
    for seed in (1, 2):
        new = _decode_inputs(seed, 4, 4, 1, Sq, 256, "bfloat16", dev,
                             cache=kc.shape[2])
        for dst, src in zip((q, kc, vc), new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(out),
                                   _f32(flash_attention_ref(q, kc, vc, **kw)),
                                   atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def _check_scan(args, dtype):
    """One kernel launch against the plain version on ``args``."""
    before = _cuda.LAUNCHES["selective_scan"]
    y, h = selective_scan_kernel(*args)
    assert _cuda.LAUNCHES["selective_scan"] == before + 1
    ry, rh = selective_scan_ref(*args)
    tol = dict(atol=TOL[dtype] * 10, rtol=TOL[dtype] * 10)
    np.testing.assert_allclose(_f32(y), _f32(ry), **tol)
    np.testing.assert_allclose(_f32(h), _f32(rh), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bz,S,Di,N", SCAN)
def test_cuda_scan_matches_plain(Bz, S, Di, N, dtype):
    dev = _card()
    _check_scan(_scan_inputs(S + Di, Bz, S, Di, N, dtype, dev), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [16, 6])
def test_cuda_scan_unaligned_rows(N):
    """Streams and state rows that start 4 bytes past a 16-byte boundary
    (views into a larger buffer): 4-byte copy granules, and at N = 16 the
    scalar state path instead of the vector one."""
    dev = _card()
    args = _scan_inputs(N + 1, 2, 21, 72, N, device=dev)
    shifted = []
    for t in args:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == 4
        shifted.append(view)
    _check_scan(shifted, "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("Bz,S,Di", [(4, 1, 8192), (2, 100, 256)])
def test_cuda_scan_graph_replay(Bz, S, Di):
    """A call captured in a CUDA graph (as the timing and a graph-captured
    decode step take it) and replayed on new inputs written in place."""
    dev = _card()
    args = _scan_inputs(S, Bz, S, Di, 16, device=dev)
    selective_scan_kernel(*args)                     # build, load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, h = selective_scan_kernel(*args)
    for seed in (1, 2):
        for dst, src in zip(args, _scan_inputs(seed, Bz, S, Di, 16,
                                               device=dev)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        ry, rh = selective_scan_ref(*args)
        tol = dict(atol=TOL["float32"] * 10, rtol=TOL["float32"] * 10)
        np.testing.assert_allclose(_f32(y), _f32(ry), **tol)
        np.testing.assert_allclose(_f32(h), _f32(rh), **tol)


@pytest.mark.gpu
def test_cuda_scan_streams_like_one_call():
    """Two kernel calls carrying h equal one call (the decode contract)."""
    dev = _card()
    x, dt, B, C, A, D, _ = _scan_inputs(2, 1, 64, 16, 4, device=dev)
    h0 = torch.zeros(1, 16, 4, device=dev)
    y_full, h_full = selective_scan_kernel(x, dt, B, C, A, D, h0)
    y1, h_mid = selective_scan_kernel(x[:, :32].contiguous(),
                                      dt[:, :32].contiguous(),
                                      B[:, :32].contiguous(),
                                      C[:, :32].contiguous(), A, D, h0)
    y2, h_end = selective_scan_kernel(x[:, 32:].contiguous(),
                                      dt[:, 32:].contiguous(),
                                      B[:, 32:].contiguous(),
                                      C[:, 32:].contiguous(), A, D, h_mid)
    np.testing.assert_allclose(_f32(torch.cat([y1, y2], 1)), _f32(y_full),
                               atol=1e-5)
    np.testing.assert_allclose(_f32(h_end), _f32(h_full), atol=1e-5)


# -- the backward -------------------------------------------------------------

def _bwd_inputs(seed, B, H, KV, Sq, Skv, hd, kw, device="cpu",
                dtype="bfloat16"):
    """q, k, v (contiguous) and dO (the model's (B, Sq, H, hd) storage
    seen as (B, H, Sq, hd)) in ``dtype``; o (float32, before its rounding:
    what the backward reads) and lse from the plain forward."""
    q, k, v = _qkv(seed, B, H, KV, Sq, Skv, hd, dtype, device)
    rng = np.random.default_rng(seed + 1)
    do = torch.tensor(rng.standard_normal((B, Sq, H, hd), np.float32),
                      device=device).to(getattr(torch, dtype)).transpose(1, 2)
    _, lse, o = flash_attention_lse_ref(q, k, v, **kw)
    return q, k, v, o, lse, do


def test_bwd_kernel_checks():
    """The backward kernel takes bf16 or float32 (float16 raises) CUDA
    tensors; nothing on the CPU launches it."""
    kw = dict(causal=True)
    args = _bwd_inputs(0, 1, 2, 1, 8, 8, 16, kw)
    before = dict(_cuda.LAUNCHES)
    f16 = [t if t is args[4] else t.half() for t in args]
    with pytest.raises(ValueError, match="bf16 or float32"):
        flash_attention_bwd_kernel(*f16, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_kernel(*args, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_kernel(*(t.float() for t in args), **kw)
    assert _cuda.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize(BWD_IDS, BWD)
def test_cuda_attention_bwd_matches_plain(B, H, KV, Sq, Skv, hd, window,
                                          softcap, q_offset, kv_len):
    """dq, dk, dv against the plain backward on the same inputs (which
    rounds P and dS to bf16 where the kernel does), contiguous and in the
    model's strided layout, at the bf16 tolerance."""
    dev = _card()
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              kv_len=kv_len)
    args = _bwd_inputs(B * Sq + hd, B, H, KV, Sq, Skv, hd, kw, dev)
    want = flash_attention_bwd_ref(*args, **kw)
    before = _cuda.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_kernel(*args, **kw)
    assert _cuda.LAUNCHES["flash_attention_bwd"] == before + 1
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in args[:4]] + [args[4], args[5].contiguous()]
    got_views = flash_attention_bwd_kernel(*views, **kw)
    tol = TOL["bfloat16"]
    for g, gv, w in zip(got, got_views, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=tol)
        np.testing.assert_array_equal(_f32(gv), _f32(g))
    if kv_len is not None:
        assert not bool(got[1][:, :, kv_len:].any())
        assert not bool(got[2][:, :, kv_len:].any())


@pytest.mark.gpu
@pytest.mark.parametrize(BWD_IDS, [BWD[9], BWD[10], BWD[11], BWD[6],
                                   BWD[8], BWD[12], BWD[14], BWD[15],
                                   BWD[16], BWD[17]])
def test_cuda_attention_bwd_is_deterministic(B, H, KV, Sq, Skv, hd, window,
                                             softcap, q_offset, kv_len):
    """Two calls on the same inputs give bit-equal dq, dk and dv: no float
    atomics; a cluster sums its heads' dK and dV in ascending order (the
    training shapes, hd 80 and 112 among them, G 64 in 8-block clusters, a
    chunk with kv_len)."""
    dev = _card()
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              kv_len=kv_len)
    args = _bwd_inputs(B * Sq + hd + 1, B, H, KV, Sq, Skv, hd, kw, dev)
    first = [t.clone() for t in flash_attention_bwd_kernel(*args, **kw)]
    second = flash_attention_bwd_kernel(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


LSE_CASES = PREFILL + [(1, 4, 1, 2, 2, 64, None, None, 0, None),
                       (2, 4, 1, 1024, 1024, 256, 512, None, 0, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(PREFILL_IDS, LSE_CASES)
def test_cuda_attention_lse_matches_plain(B, H, KV, Sq, Skv, hd, window,
                                          softcap, q_offset, kv_len, dtype):
    """The forward's log-sum-exp and its output before the rounding (both
    prefill routes; a call of decode size takes a prefill route when it
    asks for lse)."""
    dev = _card()
    q, k, v = _qkv(B * Sq + hd, B, H, KV, Sq, Skv, hd, dtype, dev)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              kv_len=kv_len)
    o, lse, o32 = flash_attention_kernel(q, k, v, with_lse=True, **kw)
    ro, rlse, ro32 = flash_attention_lse_ref(q, k, v, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert o32.dtype == torch.float32 and o32.stride() == o.stride()
    for got, want in ((o, ro), (lse, rlse), (o32, ro32)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("window,softcap", [(None, None), (64, None),
                                            (None, 30.0)])
def test_cuda_flash_autograd_matches_plain(window, softcap):
    """FlashAttentionFn on the kernels against backend="plain" on the card:
    the model's (B, S, heads, hd) leaves, gradients through the views; bf16
    at its tolerance, float32 (the CUDA-core route) at 2e-5."""
    dev = _card()
    rng = np.random.default_rng(7)
    B, S, H, KV, hd = 2, 160, 4, 1, 128
    leaves = [torch.tensor(rng.standard_normal((B, S, n, hd), np.float32),
                           device=dev) for n in (H, KV, KV)]
    w = torch.tensor(rng.standard_normal((B, S, H, hd), np.float32),
                     device=dev)
    kw = dict(causal=True, window=window, softcap=softcap)

    def grads(backend, dtype):
        xs = [t.to(dtype).requires_grad_() for t in leaves]
        o = flash_attention_train(*(x.transpose(1, 2) for x in xs),
                                  backend=backend, **kw)
        (o.transpose(1, 2).float() * w).sum().backward()
        return [x.grad for x in xs]

    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        before = _cuda.LAUNCHES["flash_attention_bwd"]
        got = grads("auto", dtype)
        assert _cuda.LAUNCHES["flash_attention_bwd"] == before + 1
        for g, want in zip(got, grads("plain", dtype)):
            assert g.dtype == dtype
            np.testing.assert_allclose(_f32(g), _f32(want), atol=TOL[name],
                                       rtol=TOL[name])


#: the backward at the training calls of the encoder-decoder and the VLM
#: (``chip_smoke.py`` phase 17 (a)): whisper-large-v3's encoder layer
#: (1,500 frames, not a multiple of 64, non-causal), its cross-attention
#: (187 decoder positions on 1,500 keys, non-causal) and its decoder's
#: self-attention (187, causal); internvl2-2b's layer (H 16 on KV 8)
ENCDEC_BWD_IDS = "B,H,KV,Sq,Skv,hd,causal"
ENCDEC_BWD = [
    (4, 20, 20, 1500, 1500, 64, False),
    (4, 20, 20, 187, 1500, 64, False),
    (4, 20, 20, 187, 187, 64, True),
    (4, 16, 8, 1024, 1024, 128, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize(ENCDEC_BWD_IDS, ENCDEC_BWD)
def test_cuda_attention_encdec_bwd(B, H, KV, Sq, Skv, hd, causal, dtype):
    """The training path's calls in the model's strided layout: the
    forward with lse and its float32 output against the plain forward,
    then the backward reading that float32 output against the plain
    backward on the same inputs at ``TOL``; two calls bit-equal."""
    dev = _card()
    kw = dict(causal=causal)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
               _qkv(Sq + Skv + hd + 3, B, H, KV, Sq, Skv, hd, dtype, dev))
    rng = np.random.default_rng(Sq + hd)
    do = torch.tensor(rng.standard_normal((B, Sq, H, hd), np.float32),
                      device=dev).to(q.dtype).transpose(1, 2)
    o, lse, o32 = flash_attention_kernel(q, k, v, with_lse=True, **kw)
    assert o32.dtype == torch.float32 and o32.stride() == o.stride()
    want_o, want_lse, want_o32 = flash_attention_lse_ref(q, k, v, **kw)
    tol = TOL[dtype]
    for got, want in ((o, want_o), (o32, want_o32), (lse, want_lse)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    want = flash_attention_bwd_ref(q, k, v, o32, lse, do, **kw)
    got = [t.clone() for t in
           flash_attention_bwd_kernel(q, k, v, o32, lse, do, **kw)]
    again = flash_attention_bwd_kernel(q, k, v, o32, lse, do, **kw)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == q.dtype
        np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=tol)
        assert torch.equal(g, a)


#: the float32 backward: every head dim, causal and not, window, softcap,
#: a chunk against a longer key range (q_offset, kv_len), G 1 to 16,
#: ragged 32-key and 32-query tiles, and the training shapes (gemma3-1b's
#: global layer, granite-moe-1b-a400m's layer)
BWD_F32 = [
    (2, 4, 2, 70, 70, 16, None, None, 0, None),
    (1, 8, 2, 45, 45, 32, 16, None, 0, None),
    (2, 16, 8, 130, 130, 64, None, None, 0, None),
    (1, 4, 1, 100, 100, 128, 64, 30.0, 0, None),
    (2, 4, 1, 77, 77, 256, None, 50.0, 0, None),
    (1, 4, 1, 48, 300, 256, None, None, 200, 248),
    (1, 4, 2, 33, 200, 64, 16, None, 100, 133),
    (1, 16, 1, 3, 3, 16, None, None, 0, None),
    (4, 4, 1, 1024, 1024, 256, None, None, 0, None),
    (4, 16, 8, 1024, 1024, 64, None, None, 0, None),
    (4, 32, 32, 1024, 1024, 112, None, None, 0, None),   # zamba2-7b
    (1, 8, 2, 45, 100, 112, 16, 30.0, 40, 85),
    (4, 8, 2, 256, 256, 80, None, None, 0, None),   # the ~100M trainer
    (4, 8, 2, 256, 256, 80, 256, None, 0, None),
    (1, 8, 2, 45, 100, 80, 16, 30.0, 40, 85),
]


@pytest.mark.gpu
@pytest.mark.parametrize(BWD_IDS, BWD_F32)
def test_cuda_attention_bwd_f32_matches_plain(B, H, KV, Sq, Skv, hd, window,
                                              softcap, q_offset, kv_len):
    """The float32 route (CUDA cores) against the plain backward, which is
    the exact float32 gradient, at float32's tolerance; the model's strided
    layout gives the same bits; two calls are bit-equal; keys past kv_len
    get no gradient."""
    dev = _card()
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              kv_len=kv_len)
    args = _bwd_inputs(B * Sq + hd + 2, B, H, KV, Sq, Skv, hd, kw, dev,
                       "float32")
    want = flash_attention_bwd_ref(*args, **kw)
    before = _cuda.LAUNCHES["flash_attention_bwd"]
    got = [t.clone() for t in flash_attention_bwd_kernel(*args, **kw)]
    assert _cuda.LAUNCHES["flash_attention_bwd"] == before + 1
    again = flash_attention_bwd_kernel(*args, **kw)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in args[:4]] + [args[4], args[5].contiguous()]
    got_views = flash_attention_bwd_kernel(*views, **kw)
    tol = TOL["float32"]
    for g, a, gv, w in zip(got, again, got_views, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=tol)
        assert torch.equal(g, a)
        assert torch.equal(gv, g)
    if kv_len is not None:
        assert not bool(got[1][:, :, kv_len:].any())
        assert not bool(got[2][:, :, kv_len:].any())


# -- the scan backward ----------------------------------------------------------

def _scan_bwd_inputs(seed, Bz, S, Di, N, dtype="float32", device="cpu"):
    """The scan's inputs (nonzero h0), dy in ``dtype`` and a float32
    dh_last."""
    args = _scan_inputs(seed, Bz, S, Di, N, dtype, device)
    rng = np.random.default_rng(seed + 1)
    dy = torch.tensor(rng.standard_normal((Bz, S, Di), np.float32),
                      device=device).to(getattr(torch, dtype))
    dh_last = torch.tensor(rng.standard_normal((Bz, Di, N), np.float32),
                           device=device)
    return args, dy, dh_last


def _close_to_largest(got, want, tol):
    """Within ``tol`` of ``want``, relative to its largest entry."""
    assert got.shape == want.shape and got.dtype == want.dtype
    want = _f32(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol * scale)


def test_scan_bwd_kernel_checks():
    """The backward kernel takes CUDA tensors of the forward's dtypes and
    widths; nothing on the CPU launches it."""
    args, dy, dh_last = _scan_bwd_inputs(5, 1, 20, 8, 4)
    states = round_states(args[0], args[6])
    selective_scan_ref(*args, states)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_bwd_kernel(*args, states, dy, dh_last)
    with pytest.raises(ValueError, match="dtype"):
        selective_scan_bwd_kernel(*(t.double() for t in args),
                                  states.double(), dy.double())
    wide, wdy, _ = _scan_bwd_inputs(5, 1, 4, 8, 32)
    with pytest.raises(ValueError, match="state width 32"):
        selective_scan_bwd_kernel(*wide, round_states(wide[0], wide[6]), wdy)
    assert round_states(args[0], args[6]).shape == (1, 2, 8, 4)
    assert _cuda.LAUNCHES == before


def _constants(path):
    """``constexpr int name = value;`` of a C source, as a dict."""
    import re
    text = (_cuda.CSRC / path).read_text()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (k\w+) = ([^;]+);", text)}


def test_scan_bwd_constants_match_source():
    """The wrapper's constants are the C source's: the 16-step round the
    forward saves states at, the 64-channel block of 256 threads, the
    widest state, two resident blocks an SM; and two blocks' dynamic
    shared memory (two stages of a round's rows, the round's a(t) as a
    float4 a thread a step, the warps' dB | dC sums) fit an SM's 228 KB
    beside 1 KB each the runtime keeps."""
    head = _constants("selective_scan.cuh")
    bwd = _constants("selective_scan_bwd.cu")
    assert int(head["kSteps"]) == ROUND
    assert int(head["kCh"]) == CHANNELS
    assert head["kThreads"] == "kCh * kLanes"
    assert CHANNELS * int(head["kLanes"]) == THREADS
    assert int(head["kLanes"]) * int(head["kPer"]) == MAX_STATE
    assert bwd["kHalf"] == "kSteps / 2"
    assert int(bwd["kBlocksPerSm"]) == BLOCKS_PER_SM
    text = (_cuda.CSRC / "selective_scan_bwd.cu").read_text()
    assert "__launch_bounds__(kThreads, kBlocksPerSm)" in text
    assert text.count("ex2_ftz(") == 2        # the definition and one call
    assert "exp2f(" not in text and "__expf(" not in text
    for size in (4, 2):                       # float32, bf16 streams
        stage = size * (3 * ROUND * CHANNELS + 2 * ROUND * MAX_STATE)
        smem = (2 * stage + 16 * ROUND * THREADS
                + 4 * ROUND * (THREADS // 32) * 2 * MAX_STATE)
        assert smem <= 232_448                # a block's most
        assert BLOCKS_PER_SM * (smem + 1024) <= 233_472


def test_scan_train_routes():
    """SelectiveScanFn on CPU tensors: the plain forward and backward
    (its gradients are the plain backward's on the saved states);
    backend="cuda" raises rather than fall back."""
    args, dy, _ = _scan_bwd_inputs(6, 2, 21, 12, 4)
    leaves = [t.clone().requires_grad_() for t in args]
    before = dict(_cuda.LAUNCHES)
    y, h = selective_scan_train(*leaves)
    ry, rh = selective_scan_ref(*args)
    assert torch.equal(y.detach(), ry) and torch.equal(h.detach(), rh)
    y.backward(dy)
    states = round_states(args[0], args[6])
    selective_scan_ref(*args, states)
    want = selective_scan_bwd_ref(*args, states, dy)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_train(*leaves, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        selective_scan_train(*leaves, backend="interpret")
    assert _cuda.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bz,S,Di,N", SCAN_BWD)
def test_cuda_scan_states_match_plain(Bz, S, Di, N, dtype):
    """The forward with round states: y and h_last bit-equal to the
    forward without, the states within tolerance of the plain loop's, the
    last one h_last itself."""
    dev = _card()
    args = _scan_inputs(S * N + Di, Bz, S, Di, N, dtype, dev)
    y0, h0 = selective_scan_kernel(*args)
    states = round_states(args[0], args[6])
    y, h = selective_scan_kernel(*args, states)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert torch.equal(states[:, -1], h)
    want = round_states(args[0], args[6])
    selective_scan_ref(*args, want)
    _close_to_largest(states, want, BWD_TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("with_dh_last", [True, False], ids=["dh", "nodh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bz,S,Di,N", SCAN_BWD)
def test_cuda_scan_bwd_matches_plain(Bz, S, Di, N, dtype, with_dh_last):
    """Every gradient against the plain backward on the same inputs and
    the kernel forward's states."""
    dev = _card()
    args, dy, dh_last = _scan_bwd_inputs(S + Di + N, Bz, S, Di, N, dtype,
                                         dev)
    dh_last = dh_last if with_dh_last else None
    states = round_states(args[0], args[6])
    selective_scan_kernel(*args, states)
    before = _cuda.LAUNCHES["selective_scan_bwd"]
    got = selective_scan_bwd_kernel(*args, states, dy, dh_last)
    assert _cuda.LAUNCHES["selective_scan_bwd"] == before + 1
    want = selective_scan_bwd_ref(*args, states, dy, dh_last)
    for g, w in zip(got, want):
        _close_to_largest(g, w, BWD_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("full", [True, False], ids=["n16", "masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scan_bwd_occupancy(dtype, full):
    """The reverse walk holds its design's blocks an SM (16 warps) with
    its registers and dynamic shared memory."""
    dev = _card()
    assert resident_blocks(getattr(torch, dtype), full, dev) >= BLOCKS_PER_SM


@pytest.mark.gpu
@pytest.mark.parametrize("Bz,S,Di,N", [SCAN_BWD[0], SCAN_BWD[5],
                                       SCAN_BWD[8]])
def test_cuda_scan_bwd_is_deterministic(Bz, S, Di, N):
    """Two calls on the same inputs are bit-equal: the sums over lanes,
    channels, blocks, batch and time run in a fixed order, no float
    atomics."""
    dev = _card()
    args, dy, dh_last = _scan_bwd_inputs(Bz + S, Bz, S, Di, N,
                                         device=dev)
    states = round_states(args[0], args[6])
    selective_scan_kernel(*args, states)
    first = [t.clone() for t in selective_scan_bwd_kernel(
        *args, states, dy, dh_last)]
    second = selective_scan_bwd_kernel(*args, states, dy, dh_last)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_scan_autograd_matches_plain(dtype):
    """SelectiveScanFn on the kernels against backend="plain" on the
    card, both outputs used, h0 a leaf: one forward with states and one
    backward launched."""
    dev = _card()
    args, dy, dh_last = _scan_bwd_inputs(9, 2, 50, 160, 16, dtype, dev)

    def grads(backend):
        leaves = [t.clone().requires_grad_() for t in args]
        y, h = selective_scan_train(*leaves, backend=backend)
        torch.autograd.backward((y, h), (dy, dh_last))
        return [t.grad for t in leaves]

    before = dict(_cuda.LAUNCHES)
    got = grads("auto")
    assert _cuda.LAUNCHES["selective_scan"] == before["selective_scan"] + 1
    assert (_cuda.LAUNCHES["selective_scan_bwd"]
            == before["selective_scan_bwd"] + 1)
    for g, w in zip(got, grads("plain")):
        _close_to_largest(g, w, BWD_TOL[dtype])
