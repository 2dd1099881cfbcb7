"""The port's selective scan and Mamba-1 block against the reference's.

On the CPU the scan op runs its plain sequential version; it is held
against ``selective_scan_ref`` and the Pallas kernel in interpret mode on
the grid of ``tests/test_kernels.py`` at ten times that file's ``TOL``
(the sum over the state and the recurrence round in another order), and
to the two-call streaming equivalence. ``causal_conv1d`` and the Mamba-1
block (prefill, then decode from its state) are held against
``repro.models.mamba``. Inputs are made with numpy from a seed and handed
to both. The CUDA kernel is held against the plain version on the card
by ``tests/test_torch_model_kernels.py`` (``-m gpu``; no JAX there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels.selective_scan.kernel import \
    selective_scan_kernel as jax_scan_kernel
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref
from repro.models import mamba as jax_mamba
from repro.models.common import KeyGen
from repro_torch.configs import get_config
from repro_torch.kernels.selective_scan import (selective_scan,
                                                selective_scan_ref)
from repro_torch.models import mamba

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the grid of ``tests/test_kernels.py`` (Bz, S, Di, N, chunk, block_d)
GRID = [(2, 64, 32, 8, 16, 16), (1, 128, 64, 16, 32, 32),
        (2, 96, 48, 4, 32, 16), (1, 256, 128, 16, 64, 128)]


def _inputs(seed, Bz, S, Di, N):
    """x, dt, B, C (the streams), A, D, h0 as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    dt = (np.log1p(np.exp(n(Bz, S, Di))) * 0.1).astype(np.float32)
    return (n(Bz, S, Di), dt, n(Bz, S, N), n(Bz, S, N),
            -np.exp(n(Di, N) * 0.3), n(Di), n(Bz, Di, N))


def _split(arrays, dtype, to):
    """Streams in ``dtype``; A, D, h0 float32."""
    return ([to(a, dtype) for a in arrays[:4]]
            + [to(a, "float32") for a in arrays[4:]])


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bz,S,Di,N,chunk,bd", GRID)
def test_plain_matches_reference_and_interpret_kernel(Bz, S, Di, N, chunk, bd,
                                                      dtype):
    arrays = _inputs(S + Di, Bz, S, Di, N)
    y, h = selective_scan(*_split(arrays, dtype, _torch))
    ja = _split(arrays, dtype, _jax)
    tol = dict(atol=TOL[dtype] * 10, rtol=TOL[dtype] * 10)
    for jy, jh in (jax_ref(*ja),
                   jax_scan_kernel(*ja, chunk=chunk, block_d=bd,
                                   interpret=True)):
        np.testing.assert_allclose(_f32(y), _f32(jy), **tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **tol)
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32


def test_streaming_equivalence():
    """Scanning a sequence in two calls (carrying h) equals one call."""
    x, dt, B, C, A, D, _ = (torch.tensor(a)
                            for a in _inputs(2, 1, 64, 16, 4))
    h0 = torch.zeros(1, 16, 4)
    y_full, h_full = selective_scan_ref(x, dt, B, C, A, D, h0)
    half = 32
    y1, h_mid = selective_scan_ref(x[:, :half], dt[:, :half], B[:, :half],
                                   C[:, :half], A, D, h0)
    y2, h_end = selective_scan_ref(x[:, half:], dt[:, half:], B[:, half:],
                                   C[:, half:], A, D, h_mid)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(h_end.numpy(), h_full.numpy(), atol=1e-5)


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12), np.float32)
    w = rng.standard_normal((12, 4), np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12), np.float32)
    for state in (None, st):
        got, new = mamba.causal_conv1d(
            torch.tensor(x).bfloat16(), torch.tensor(w), torch.tensor(b),
            None if state is None else torch.tensor(state).bfloat16())
        want, jnew = jax_mamba.causal_conv1d(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
            None if state is None else jnp.asarray(state, jnp.bfloat16))
        assert got.dtype == torch.float32 and new.dtype == torch.bfloat16
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_array_equal(_f32(new), _f32(jnew))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_block_matches_reference(dtype):
    """Prefill over 24 tokens, then three decode steps from its state, on
    the reduced falcon-mamba block; the weights are the reference's."""
    cfg = get_config("falcon-mamba-7b").reduced()
    jcfg = jax_config("falcon-mamba-7b").reduced()
    jp = jax_mamba.init_mamba1(KeyGen(jax.random.PRNGKey(3)), jcfg.d_model,
                               jcfg.ssm)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    p = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 27, cfg.d_model), np.float32)
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    y, (conv, h) = mamba.mamba1_forward(p, _torch(x[:, :24], dtype), cfg.ssm)
    jy, (jconv, jh) = jax_mamba.mamba1_forward(jp, _jax(x[:, :24], dtype),
                                               jcfg.ssm, chunk=8)
    np.testing.assert_allclose(_f32(y), _f32(jy), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **tol)
    # the cache keeps the conv state in bf16, as the reference's does
    state = (conv.bfloat16(), h)
    jstate = (jconv.astype(jnp.bfloat16), jh)
    for t in range(24, 27):
        y, state = mamba.mamba1_decode(p, _torch(x[:, t:t + 1], dtype), state,
                                       cfg.ssm)
        jy, jstate = jax_mamba.mamba1_decode(jp, _jax(x[:, t:t + 1], dtype),
                                             jstate, jcfg.ssm)
        state = (state[0].bfloat16(), state[1])
        jstate = (jstate[0].astype(jnp.bfloat16), jstate[1])
        np.testing.assert_allclose(_f32(y), _f32(jy), **tol)
        np.testing.assert_allclose(state[1].numpy(), np.asarray(jstate[1]),
                                   **tol)
