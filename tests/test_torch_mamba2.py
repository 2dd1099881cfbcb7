"""The port's Mamba-2 mixer (``repro_torch.models.mamba.mamba2_forward``,
the SSD chunked form) against the reference's
(``repro.models.mamba.mamba2_forward``) on the CPU, at the reduced
zamba2-7b's SSM (d_model 64, N 8, P 16, 8 heads), inputs from numpy seeds.

* y, the three conv states and the SSM state: float32 at 2e-5 (atol and
  rtol; observed ~3e-7), bf16 at 2e-2 (one bf16 ulp is 7.8e-3), at S a
  multiple of the chunk and S not one (the padded tail), and at
  ``chunk=1`` continuing from a carried state;
* a prefill of S tokens then n decode steps against the forward of
  S + n;
* gradients of a weighted sum of y in every parameter and in x, as
  relative L2 distances: against ``jax.grad`` at 1e-5 where both run
  chunks of 16 or 32 (observed up to 4.1e-6 and 5.5e-6, in the conv bias
  of B, whose gradient is a sum that cancels); the port's chunk-64 and
  chunk-256 gradients against the reference's chunk-64 ones at 5e-5
  (``CHUNK_TOL``). The chunk only reassociates float32 sums, and longer
  chunks sum more terms at once: the reference's own gradients move by up
  to 4.5e-6 between chunk 32 and 64, and the port lies 1.05e-5 (chunk 64)
  and 1.43e-5 (chunk 256, A_log) from the reference's chunk-64 ones;
* on inputs where the reference's chunk-256 gradients are not finite
  (its ``where(causal, exp(cum_i - cum_j), 0)`` forms exp of positive
  exponents past float32's range above the diagonal), the port's, which
  masks the exponent instead, are finite and equal its chunk-64 ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import mamba as JMb
from repro.models.common import KeyGen
from repro_torch.configs import get_config
from repro_torch.models import mamba as PM

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-5
#: the port at chunk 64 or 256 against the reference at 64: 3.5 x the
#: largest distance observed (1.43e-5)
CHUNK_TOL = 5e-5
CFG = get_config("zamba2-7b").reduced()
SSM = CFG.ssm


def _params(dtype: str, seed: int = 0, perturb: bool = True) -> dict:
    """The reference's init (bf16 projections, float32 SSM leaves), with
    dt_bias, A_log, the norm and the conv biases moved off their constant
    init so that a dropped term shows; numpy leaves."""
    jp = JMb.init_mamba2(KeyGen(jax.random.PRNGKey(seed)), CFG.d_model, SSM)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jp.items():
        a = np.asarray(v)
        if perturb and k in ("dt_bias", "A_log", "norm_w", "conv_x_b",
                             "conv_B_b", "conv_C_b"):
            a = (a.astype(np.float32)
                 + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                 ).astype(a.dtype)
        out[k] = a.astype(np.float32) if dtype == "float32" else a
    return out


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.tensor(a)


def _x(dtype: str, S: int, seed: int = 1, batch: int = 2):
    x = np.random.default_rng(seed).standard_normal(
        (batch, S, CFG.d_model)).astype(np.float32)
    return x if dtype == "float32" else np.asarray(jnp.asarray(x, jnp.bfloat16))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _state_close(got, want, tol):
    (gc, gs), (wc, ws) = got, want
    assert set(gc) == set(wc) == {"x", "B", "C"}
    for k in "xBC":
        assert gc[k].shape == tuple(wc[k].shape)
        _close(gc[k], wc[k], tol)
    assert gs.dtype == torch.float32 and gs.shape == tuple(ws.shape)
    _close(gs, ws, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (40, 256)])
def test_forward_matches_reference(dtype, S, chunk):
    """S = 64 fills four chunks; S = 50 pads the last one; S = 40 with
    the default chunk runs one chunk of S."""
    p, x = _params(dtype), _x(dtype, S)
    want_y, want_state = JMb.mamba2_forward(_jax(p), jnp.asarray(x), SSM,
                                            chunk=chunk)
    got_y, got_state = PM.mamba2_forward(
        {k: _torch(v) for k, v in p.items()}, _torch(x), SSM, chunk=chunk)
    assert got_y.dtype == _torch(x).dtype and got_y.shape == want_y.shape
    _close(got_y, want_y, TOL[dtype])
    _state_close(got_state, want_state, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk1_with_carried_state_matches_reference(dtype):
    """``chunk=1`` from the state a 24-token prefill left (conv states in
    bf16, as cached), over 5 tokens."""
    p = _params(dtype)
    x0, x1 = _x(dtype, 24, seed=2), _x(dtype, 5, seed=3)
    _, (jconv, jssm) = JMb.mamba2_forward(_jax(p), jnp.asarray(x0), SSM,
                                          chunk=8)
    jconv = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jconv)
    want_y, want_state = JMb.mamba2_forward(_jax(p), jnp.asarray(x1), SSM,
                                            chunk=1, state=(jconv, jssm))
    state = ({k: _torch(v) for k, v in jconv.items()}, _torch(jssm))
    got_y, got_state = PM.mamba2_forward({k: _torch(v) for k, v in p.items()},
                                         _torch(x1), SSM, chunk=1,
                                         state=state)
    _close(got_y, want_y, TOL[dtype])
    _state_close(got_state, want_state, TOL[dtype])


def test_prefill_then_decode_matches_forward():
    """Float32 through: a prefill of 20 tokens, then 6 decode steps, each
    step's y and the final state against the forward of all 26 (port and
    reference)."""
    p, x = _params("float32"), _x("float32", 26, seed=4)
    tp = {k: _torch(v) for k, v in p.items()}
    want_y, want_state = JMb.mamba2_forward(_jax(p), jnp.asarray(x), SSM,
                                            chunk=8)
    full_y, full_state = PM.mamba2_forward(tp, _torch(x), SSM, chunk=8)
    _close(full_y, want_y, TOL["float32"])
    y0, state = PM.mamba2_forward(tp, _torch(x[:, :20]), SSM, chunk=8)
    ys = [y0]
    for t in range(20, 26):
        y, state = PM.mamba2_decode(tp, _torch(x[:, t:t + 1]), state, SSM)
        ys.append(y)
    _close(torch.cat(ys, dim=1), want_y, TOL["float32"])
    _state_close(state, want_state, TOL["float32"])
    _state_close(state, full_state, TOL["float32"])


def _jax_grads(p, x, g, chunk):
    def f(params, xx):
        y, _ = JMb.mamba2_forward(params, xx, SSM, chunk=chunk)
        return jnp.sum(y * g)

    gp, gx = jax.grad(f, argnums=(0, 1))(_jax(p), jnp.asarray(x))
    return {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}


def _port_grads(p, x, g, chunk):
    tp = {k: _torch(v).requires_grad_() for k, v in p.items()}
    tx = _torch(x).requires_grad_()
    y, _ = PM.mamba2_forward(tp, tx, SSM, chunk=chunk)
    (y * torch.tensor(g)).sum().backward()
    return {**{k: t.grad.numpy() for k, t in tp.items()}, "x": tx.grad.numpy()}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cotangent(S: int, seed: int = 5):
    return np.random.default_rng(seed).standard_normal(
        (2, S, CFG.d_model)).astype(np.float32)


@pytest.mark.parametrize("chunk", [16, 32])
def test_gradients_match_jax_grad(chunk):
    """Every parameter and x, 128 tokens, both sides at the same chunk."""
    p, x, g = _params("float32"), _x("float32", 128), _cotangent(128)
    want = _jax_grads(p, x, g, chunk)
    got = _port_grads(p, x, g, chunk)
    assert set(got) == set(want) and len(got) == 17
    for k in want:
        assert np.isfinite(want[k]).all() and np.isfinite(got[k]).all(), k
        assert _rel_l2(got[k], want[k]) <= GRAD_TOL, (k, _rel_l2(got[k],
                                                                 want[k]))


def _overflow_inputs():
    """The reference's own init (A = -1, dt_bias 0, so dt ~ softplus of a
    small projection) over 2 x 256 tokens: a 256-step chunk's cumulative
    decay passes 88, so exp of its negation above the diagonal overflows."""
    return (_params("float32", perturb=False), _x("float32", 256, seed=6),
            _cotangent(256, seed=7))


@pytest.mark.parametrize("chunk", [64, 256])
def test_long_chunk_gradients_match_reference_at_chunk64(chunk):
    """zamba2 trains at ``scan_chunk`` 256: the port there (and at 64)
    against the reference at 64, where the reference's gradients are
    finite."""
    p, x, g = _overflow_inputs()
    want = _jax_grads(p, x, g, 64)
    got = _port_grads(p, x, g, chunk)
    for k in want:
        assert np.isfinite(want[k]).all()
        assert _rel_l2(got[k], want[k]) <= CHUNK_TOL, (k, _rel_l2(got[k],
                                                                  want[k]))


def test_chunk256_gradients_finite_where_reference_is_not():
    """The reference's chunk-256 gradients are NaN in A_log, dt_bias and
    in_dt (the decay's leaves) on these inputs; the port's are finite,
    with the same forward as the reference's."""
    p, x, g = _overflow_inputs()
    ref = _jax_grads(p, x, g, 256)
    bad = sorted(k for k, v in ref.items() if not np.isfinite(v).all())
    assert {"A_log", "dt_bias", "in_dt"} <= set(bad)
    got = _port_grads(p, x, g, 256)
    assert all(np.isfinite(v).all() for v in got.values())
    want_y, _ = JMb.mamba2_forward(_jax(p), jnp.asarray(x), SSM, chunk=256)
    got_y, _ = PM.mamba2_forward({k: _torch(v) for k, v in p.items()},
                                 _torch(x), SSM, chunk=256)
    _close(got_y, want_y, TOL["float32"])


def test_init_mamba2_matches_reference_leaves():
    """The port's own init: the reference's leaf names, shapes and
    dtypes."""
    want = JMb.init_mamba2(KeyGen(jax.random.PRNGKey(0)), CFG.d_model, SSM)
    got = PM.init_mamba2(torch.Generator().manual_seed(0), CFG.d_model, SSM)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == getattr(torch, np.asarray(v).dtype.name), k
    assert dataclasses.asdict(jax_config("zamba2-7b").reduced().ssm) == \
        dataclasses.asdict(SSM)
