"""The host side of the flash attention kernels, on the CPU.

``plan_launch`` picks the route of every call (split-KV decode, bf16
tensor-core prefill, float32 SIMT prefill) and the decode splits; its
rule and its constants are held here against the serving shapes and the
C source. ``flash_attention_split_ref`` — the plain version of the decode
kernel: partial ``(m, l, acc)`` per split, merged by log-sum-exp — is held
against ``flash_attention_ref`` in float32 within 1e-6 (the two differ only
by float32 rounding of ``exp(a) * exp(b)`` against ``exp(a + b)``), splits
with no valid key included, and against the reference's oracle at
``tests/test_kernels.py``'s float32 tolerance. The CPU route of the op
still runs ``flash_attention_ref``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import (attention_mask,
                                                 flash_attention,
                                                 flash_attention_ref,
                                                 flash_attention_split_ref,
                                                 plan_launch)
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import key_range

#: gemma3-1b: B 4, H 4, KV 1, a 1,040-slot cache, a 512-token window
GEMMA = dict(B=4, H=4, KV=1)
CACHE = 1040


def _qkv(seed, B, H, KV, Sq, Skv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, np.float32)
                 for s in ((B, H, Sq, hd), (B, KV, Skv, hd),
                           (B, KV, Skv, hd)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [None, 512])
@pytest.mark.parametrize("pos", [0, 31, 32, 511, 1039])
def test_serving_decode_takes_the_split_route(dtype, window, pos):
    """One query per head against the cache (G * Sq = 4): decode, in both
    dtypes, at every position of the serving run."""
    plan = plan_launch(**GEMMA, Sq=1, kend=pos + 1, causal=True,
                       window=window, q_offset=pos, dtype=dtype)
    assert plan.route == "decode"
    assert plan.split_len in K.SPLIT_KEYS and plan.n_split >= 1


def test_global_decode_covers_the_card_once():
    """1,040 keys in 33 splits of 32: 4 x 33 = 132 blocks, one per SM; the
    local layer's 512 keys in 16."""
    plan = plan_launch(**GEMMA, Sq=1, kend=CACHE, causal=True, window=None,
                       q_offset=CACHE - 1, dtype=torch.bfloat16)
    assert (plan.key_lo, plan.key_hi, plan.split_len, plan.n_split) == (
        0, CACHE, 32, 33)
    assert GEMMA["B"] * GEMMA["KV"] * plan.n_split == K.SMS
    local = plan_launch(**GEMMA, Sq=1, kend=CACHE, causal=True, window=512,
                        q_offset=CACHE - 1, dtype=torch.bfloat16)
    assert (local.key_lo, local.key_hi, local.n_split) == (528, CACHE, 16)
    # enough (batch, KV head) pairs: longer splits
    wide = plan_launch(B=64, H=4, KV=1, Sq=1, kend=CACHE, causal=True,
                       window=None, q_offset=CACHE - 1, dtype=torch.float32)
    assert (wide.split_len, wide.n_split) == (64, 17)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt")])
@pytest.mark.parametrize("B,H,KV,Sq", [(4, 4, 1, 1024), (1, 64, 1, 3),
                                       (2, 4, 4, 17), (1, 2, 1, 9),
                                       (1, 32, 1, 1)])
def test_prefill_routes(B, H, KV, Sq, dtype, route):
    """More (head, query) rows than one decode tile: the tensor-core
    kernel for bf16, the SIMT kernel for float32."""
    assert (H // KV) * Sq > K.DECODE_ROWS
    plan = plan_launch(B, H, KV, Sq, Sq, causal=True, window=None,
                       q_offset=0, dtype=dtype)
    assert plan.route == route and plan.n_split == 0


@pytest.mark.parametrize("H,KV,Sq", [(16, 1, 1), (4, 1, 4), (1, 1, 16),
                                     (8, 4, 8)])
def test_decode_tile_edge(H, KV, Sq):
    assert (H // KV) * Sq <= K.DECODE_ROWS
    for dtype in (torch.bfloat16, torch.float32):
        plan = plan_launch(1, H, KV, Sq, 64, causal=True, window=None,
                           q_offset=40, dtype=dtype)
        assert plan.route == "decode"


SPLIT_CASES = [
    # Sq, kend, causal, window, q_offset, B, KV
    (1, 1040, True, None, 1039, 4, 1),
    (1, 1040, True, 512, 1039, 4, 1),
    (1, 1, True, None, 0, 4, 1),
    (1, 32, True, None, 31, 4, 1),
    (1, 33, True, None, 32, 4, 1),
    (1, 512, True, 512, 511, 4, 1),
    (1, 1040, True, 512, 600, 2, 2),
    (4, 200, True, None, 100, 1, 2),      # q_offset > 0, Sq > 1
    (16, 300, True, 8, 50, 1, 1),         # window narrower than Sq
    (2, 90, False, None, 0, 3, 1),        # non-causal: every key < kend
    (3, 90, False, 20, 60, 1, 1),
    (1, 10, True, 4, 30, 1, 1),           # the window lies past kend
    (1, 5000, True, None, 4999, 1, 1),
]


@pytest.mark.parametrize("Sq,kend,causal,window,q_offset,B,KV", SPLIT_CASES)
def test_splits_cover_exactly_the_visible_keys(Sq, kend, causal, window,
                                               q_offset, B, KV):
    """[key_lo, key_hi) is the hull of the keys some query sees under the
    masks (an empty range when none does); the splits cover it, and no
    split lies wholly outside it."""
    plan = plan_launch(B, KV, KV, Sq, kend, causal=causal,
                       window=window, q_offset=q_offset,
                       dtype=torch.bfloat16)
    skv = kend + 8                  # keys past kend exist but are masked
    mask = attention_mask(Sq, skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kend,
                          device=torch.device("cpu"))
    seen = torch.nonzero(mask.any(0)).flatten()
    if seen.numel():
        assert (plan.key_lo, plan.key_hi) == (int(seen[0]), int(seen[-1]) + 1)
        # the hull has no holes: every key in it is seen by some query
        assert seen.numel() == plan.key_hi - plan.key_lo
    else:
        assert plan.key_lo == plan.key_hi
    n = plan.key_hi - plan.key_lo
    assert plan.route == "decode" and plan.split_len in K.SPLIT_KEYS
    assert plan.n_split * plan.split_len >= n
    assert plan.n_split == 1 or (plan.n_split - 1) * plan.split_len < n
    starts = [plan.key_lo + s * plan.split_len for s in range(plan.n_split)]
    assert all(a < plan.key_hi for a in starts) or n == 0


def test_plan_constants_match_the_kernel_source():
    """The decode tile, the split lengths and the route ids of the host
    are those the C entry point checks."""
    src = (_cuda.CSRC / "flash_attention.cu").read_text()
    const = lambda name: int(re.search(  # noqa: E731
        rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kDecodeRows") == K.DECODE_ROWS
    assert const("kSplitKeys") == max(K.SPLIT_KEYS)
    assert f"split_len != {min(K.SPLIT_KEYS)}" in src
    for i, route in enumerate(K.ROUTES):
        assert re.search(rf"case {i}:", src), route


@pytest.mark.parametrize("window", [None, 256])
def test_trainer_hd80_routes(window):
    """The ~100M gemma3-family trainer's head dim 80 takes every route: its
    training calls (B 4, H 8 on KV 2, S 256) the tensor-core prefill in
    bf16 and the SIMT prefill in float32, one query against 257 slots (G 4
    x Sq 1 rows) the split decode; the wrapper's check passes 80 (a CPU
    tensor then raises for want of a card) and still rejects 48."""
    assert 80 in K.HEAD_DIMS
    for dtype, route in ((torch.bfloat16, "mma"), (torch.float32, "simt")):
        plan = plan_launch(4, 8, 2, 256, 256, causal=True, window=window,
                           q_offset=0, dtype=dtype)
        assert plan.route == route
        dec = plan_launch(4, 8, 2, 1, 257, causal=True, window=window,
                          q_offset=256, dtype=dtype)
        assert dec.route == "decode"
        assert (dec.key_lo, dec.key_hi) == ((0 if window is None else 1),
                                            257)
    q, k, v = (torch.tensor(a) for a in _qkv(8, 1, 8, 2, 4, 4, 80))
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.flash_attention_kernel(q, k, v)
    q, k, v = (torch.tensor(a) for a in _qkv(8, 1, 8, 2, 4, 4, 48))
    with pytest.raises(ValueError, match="head dim 48"):
        K.flash_attention_kernel(q, k, v)


@pytest.mark.parametrize("name,switches", [("flash_attention", 3),
                                           ("flash_attention_bwd", 2)])
def test_every_route_is_built_at_every_head_dim(name, switches):
    """Each dispatch of the C source (the forward's decode, tensor-core
    and SIMT routes; the backward's bf16 and float32 routes) has a case
    for each of ``HEAD_DIMS`` and no other, so a head dim the wrapper
    passes is instantiated on every route."""
    src = (_cuda.CSRC / f"{name}.cu").read_text()
    cases = re.findall(r"case (\d+): return launch_\w+<(?:T, )?(\d+)>", src)
    assert all(a == b for a, b in cases)
    dims = [int(a) for a, _ in cases]
    assert sorted(dims) == sorted(K.HEAD_DIMS * switches)


SPLIT_REF_CASES = [
    # B, H, KV, Sq, Skv, hd, causal, window, softcap, q_offset, kv_len
    (4, 4, 1, 1, 1040, 64, True, None, None, 1039, 1040),
    (4, 4, 1, 1, 1040, 64, True, 512, None, 1039, 1040),
    (2, 8, 1, 1, 1040, 32, True, None, 50.0, 31, 32),
    (2, 8, 1, 1, 1040, 32, True, 512, 50.0, 32, 33),
    (1, 4, 1, 1, 100, 16, True, None, None, 0, 1),
    (1, 4, 2, 4, 200, 32, True, None, None, 100, 104),
    (1, 2, 1, 16, 200, 16, True, 8, None, 50, 66),   # splits empty for rows
    (1, 2, 1, 16, 200, 16, True, 8, 5.0, 50, 66),
    (2, 2, 1, 8, 60, 16, False, None, None, 0, 40),
    (1, 1, 1, 3, 90, 16, False, 20, None, 60, None),
]


@pytest.mark.parametrize("split_len", [4, 32, 64])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Skv,hd,causal,window,softcap,q_offset,kv_len", SPLIT_REF_CASES)
def test_split_ref_matches_ref(B, H, KV, Sq, Skv, hd, causal, window,
                               softcap, q_offset, kv_len, split_len):
    q, k, v = (torch.tensor(a) for a in _qkv(Sq + Skv + hd, B, H, KV, Sq,
                                            Skv, hd))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_len=kv_len)
    want = flash_attention_ref(q, k, v, **kw)
    got = flash_attention_split_ref(q, k, v, split_len=split_len, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_split_ref_cases_have_empty_splits():
    """The windowed cases above give some rows splits with no valid key
    (a window of 8 over 16 queries, splits of 4), so the merge's zero
    weight for them is exercised."""
    lo, hi = key_range(16, 66, causal=True, window=8, q_offset=50)
    mask = attention_mask(16, 200, causal=True, window=8, q_offset=50,
                          kv_len=66, device=torch.device("cpu"))[:, lo:hi]
    empty = [not bool(mask[r, a:a + 4].any())
             for r in range(16) for a in range(0, hi - lo, 4)]
    assert any(empty) and not all(empty)


@pytest.mark.parametrize(
    "B,H,KV,Sq,Skv,hd,causal,window,softcap,q_offset,kv_len",
    SPLIT_REF_CASES[:6])
def test_split_ref_matches_jax_oracle(B, H, KV, Sq, Skv, hd, causal, window,
                                      softcap, q_offset, kv_len):
    """Against the reference's pure-jnp oracle, float32, at
    ``tests/test_kernels.py``'s tolerance."""
    arrays = _qkv(Sq + Skv + hd, B, H, KV, Sq, Skv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, kv_len=kv_len)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in arrays), **kw))
    got = flash_attention_split_ref(*(torch.tensor(a) for a in arrays), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_cpu_route_is_still_the_plain_version():
    q, k, v = (torch.tensor(a) for a in _qkv(5, 1, 4, 1, 1, 64, 16))
    kw = dict(q_offset=40, kv_len=41)
    before = dict(_cuda.LAUNCHES)
    assert torch.equal(flash_attention(q, k, v, **kw),
                       flash_attention_ref(q, k, v, **kw))
    assert _cuda.LAUNCHES == before
