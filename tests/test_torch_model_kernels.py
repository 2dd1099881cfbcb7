"""The serving path's two CUDA kernels against their plain versions.

No JAX here, so the file runs on the card's machine:
``pytest -m gpu tests/test_torch_model_kernels.py``. On the CPU it holds the
ops' routes and the wrappers' input checks (a CUDA tensor launches the
kernel or raises; nothing falls back). On the card (``-m gpu``) each kernel
is held against its plain version — the grid of ``tests/test_kernels.py``,
the serving path's shapes, the model's strided layouts — at that file's
tolerances: ``TOL`` for attention, ten times ``TOL`` for the scan (1,024
steps of a recurrence in another rounding order). The plain versions are
held against the reference's by ``test_torch_attention.py`` and
``test_torch_ssm.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_kernel,
                                                 flash_attention_ref)
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_kernel,
                                                selective_scan_ref)

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
]
SCAN = [(2, 64, 32, 8), (1, 128, 64, 16), (2, 96, 48, 4), (1, 256, 128, 16),
        (4, 1024, 8192, 16),                         # falcon-mamba-7b prefill
        (4, 1, 8192, 16),                            # and decode
        (3, 70, 200, 8)]                             # ragged channel blocks


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
@pytest.mark.parametrize("Bz,S,Di,N", SCAN)
def test_cuda_scan_matches_plain(Bz, S, Di, N, dtype):
    dev = _card()
    args = _scan_inputs(S + Di, Bz, S, Di, N, dtype, dev)
    before = _cuda.LAUNCHES["selective_scan"]
    y, h = selective_scan_kernel(*args)
    assert _cuda.LAUNCHES["selective_scan"] == before + 1
    ry, rh = selective_scan_ref(*args)
    tol = dict(atol=TOL[dtype] * 10, rtol=TOL[dtype] * 10)
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
