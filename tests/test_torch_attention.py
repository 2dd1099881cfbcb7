"""The port's flash attention against the reference's.

On the CPU the op runs its plain PyTorch version; it is held against
``flash_attention_ref`` and against the Pallas kernel in interpret mode on
the grid of ``tests/test_kernels.py`` (both dtypes), plus its decode case,
at that file's tolerances (``TOL``: 2e-5 for float32, 2e-2 for bf16). The
model's attention functions are held against ``repro.models.attention``.
Inputs are made with numpy from a seed and handed to both. Rows with no
valid key are not on the serving path and no case here has one. The CUDA
kernel is held against the plain version on the card by
``tests/test_torch_model_kernels.py`` (``-m gpu``; no JAX there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention_kernel as jax_flash_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models import attention as jax_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the grid of ``tests/test_kernels.py``
GRID = [
    (2, 4, 2, 128, 128, 64, True, None, None),
    (1, 4, 4, 256, 256, 32, True, None, 50.0),
    (2, 2, 1, 96, 192, 16, False, None, None),     # cross, GQA 2:1
    (1, 8, 4, 256, 256, 64, True, 64, None),       # sliding window
    (1, 2, 2, 64, 64, 128, True, None, None),
    (2, 6, 3, 80, 144, 32, True, None, None),      # ragged sizes
]
GRID_IDS = "B,H,KV,Sq,Skv,hd,causal,window,softcap"


def _qkv(seed, B, H, KV, Sq, Skv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd), np.float32),
            rng.standard_normal((B, KV, Skv, hd), np.float32),
            rng.standard_normal((B, KV, Skv, hd), np.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(GRID_IDS, GRID)
def test_plain_matches_reference_and_interpret_kernel(B, H, KV, Sq, Skv, hd,
                                                      causal, window,
                                                      softcap, dtype):
    q, k, v = _qkv(B * Sq + hd, B, H, KV, Sq, Skv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _f32(flash_attention(*(_torch(a, dtype) for a in (q, k, v)), **kw))
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    want = _f32(jax_ref(jq, jk, jv, **kw))
    interp = _f32(jax_flash_kernel(jq, jk, jv, block_q=64, block_k=64,
                                   interpret=True, **kw))
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(got, interp, atol=TOL[dtype], rtol=TOL[dtype])


def test_decode_mode_matches_reference_and_interpret_kernel():
    """q_offset + kv_len: one-token decode against a padded cache."""
    q, k, v = _qkv(1, 1, 4, 2, 1, 128, 32)
    kw = dict(causal=True, q_offset=99, kv_len=100)
    got = _f32(flash_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), **kw))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, _f32(jax_ref(jq, jk, jv, **kw)),
                               atol=2e-5)
    np.testing.assert_allclose(
        got, _f32(jax_flash_kernel(jq, jk, jv, block_q=8, block_k=64,
                                   interpret=True, **kw)), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (32, None),
                                            (None, 50.0)])
def test_model_attention_matches_reference(window, softcap, dtype):
    """Prefill (the reference's blockwise online softmax) and decode
    against a cache longer than the valid prefix, in the model's
    (B, S, H, hd) layout."""
    rng = np.random.default_rng(7)
    B, S, H, KV, hd, max_len = 2, 40, 4, 2, 16, 48
    q = rng.standard_normal((B, S, H, hd), np.float32)
    k = rng.standard_normal((B, S, KV, hd), np.float32)
    v = rng.standard_normal((B, S, KV, hd), np.float32)
    kw = dict(window=window, softcap=softcap)
    got = attention.attention_blockwise(*(_torch(a, dtype) for a in (q, k, v)),
                                        **kw)
    want = jax_attention.attention_blockwise(
        *(_jax(a, dtype) for a in (q, k, v)), q_chunk=16, kv_chunk=16, **kw)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    kc = rng.standard_normal((B, max_len, KV, hd), np.float32)
    vc = rng.standard_normal((B, max_len, KV, hd), np.float32)
    for pos in (0, 31, 39):
        got = attention.attention_decode(
            _torch(q[:, :1], dtype), _torch(kc, dtype), _torch(vc, dtype),
            cache_len=pos, **kw)
        want = jax_attention.attention_decode(
            _jax(q[:, :1], dtype), _jax(kc, dtype), _jax(vc, dtype),
            cache_len=pos, **kw)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])
