"""The selective scan's backward on the CPU (``repro_torch.kernels.
selective_scan_bwd``, ``SelectiveScanFn``) against autograd and the
reference.

* ``selective_scan_bwd_ref`` in float64 is the exact gradient of the plain
  forward: equal to ``torch.autograd.grad`` through ``selective_scan_ref``
  within 1e-10 of each output's largest entry;
* ``SelectiveScanFn`` passes ``torch.autograd.gradcheck`` in float64,
  both outputs used, h0 a leaf;
* in float32 its gradients match ``jax.grad`` of the reference's oracle
  ``repro.kernels.selective_scan.ref.selective_scan_ref`` (its interpret
  route raises on jax 0.9.0) within ten times ``tests/test_kernels.py``'s
  float32 tolerance, relative to each output's largest entry (the
  recurrence's sums round in another order);
* the forward's round states are the plain loop's h at each round end.

Shapes: S not a multiple of the 16-step round, N 8 and 16, Di not a
multiple of the kernel's 64-channel block, nonzero h0, with and without
dh_last. Inputs are made with numpy from a seed and handed to both. The
CUDA kernels are held against these plain versions on the card by
``tests/test_torch_model_kernels.py`` (``-m gpu``; no JAX there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref
from repro_torch.kernels.selective_scan import (ROUND, SelectiveScanFn,
                                                round_states,
                                                selective_scan_ref,
                                                selective_scan_train)
from repro_torch.kernels.selective_scan_bwd import selective_scan_bwd_ref

#: (Bz, S, Di, N)
SHAPES = [(2, 37, 70, 8), (1, 50, 130, 16), (2, 16, 64, 16), (1, 1, 5, 8),
          (3, 33, 9, 16)]
F32_TOL = 10 * 2e-5          # tests/test_kernels.py's float32 TOL, x 10
F64_TOL = 1e-10


def _inputs(seed, Bz, S, Di, N):
    """x, dt, B, C, A, D, h0 (nonzero), dy, dh_last as numpy float64."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)  # noqa: E731
    dt = np.log1p(np.exp(n(Bz, S, Di))) * 0.1
    return (n(Bz, S, Di), dt, n(Bz, S, N), n(Bz, S, N),
            -np.exp(n(Di, N) * 0.3), n(Di), n(Bz, Di, N), n(Bz, S, Di),
            n(Bz, Di, N))


def _torch(arrays, dtype):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def _close(got, want, tol):
    """Within ``tol`` of ``want``, relative to its largest entry."""
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("with_dh_last", [True, False], ids=["dh", "nodh"])
@pytest.mark.parametrize("Bz,S,Di,N", SHAPES)
def test_plain_bwd_is_the_float64_gradient(Bz, S, Di, N, with_dh_last):
    *args, dy, dh_last = _torch(_inputs(S + Di, Bz, S, Di, N), torch.float64)
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = selective_scan_ref(*leaves)
    loss = (y * dy).sum() + ((h * dh_last).sum() if with_dh_last else 0)
    want = torch.autograd.grad(loss, leaves)
    states = round_states(args[0], args[6])
    assert states.dtype == torch.float64
    selective_scan_ref(*args, states)
    got = selective_scan_bwd_ref(*args, states, dy,
                                 dh_last if with_dh_last else None)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _close(g, w.numpy(), F64_TOL)


@pytest.mark.parametrize("Bz,S,Di,N", [(2, 19, 6, 4), (1, 33, 3, 2)])
def test_scan_fn_gradcheck(Bz, S, Di, N):
    args = _torch(_inputs(7 + S, Bz, S, Di, N)[:7], torch.float64)
    leaves = [t.requires_grad_() for t in args]
    assert torch.autograd.gradcheck(lambda *a: selective_scan_train(*a),
                                    leaves)


@pytest.mark.parametrize("with_dh_last", [True, False], ids=["dh", "nodh"])
@pytest.mark.parametrize("Bz,S,Di,N", SHAPES)
def test_gradients_match_jax(Bz, S, Di, N, with_dh_last):
    arrays = [a.astype(np.float32) for a in _inputs(S * N, Bz, S, Di, N)]
    *_, dy, dh_last = arrays

    def jax_loss(*a):
        y, h = jax_ref(*a)
        out = jnp.sum(y * dy)
        return out + jnp.sum(h * dh_last) if with_dh_last else out

    want = jax.grad(jax_loss, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in arrays[:7]))
    leaves = [t.requires_grad_() for t in _torch(arrays[:7], torch.float32)]
    y, h = SelectiveScanFn.apply(*leaves, "auto")
    if with_dh_last:
        torch.autograd.backward((y, h), (torch.tensor(dy),
                                         torch.tensor(dh_last)))
    else:
        y.backward(torch.tensor(dy))
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.float32
        _close(leaf.grad, np.asarray(w), F32_TOL)


@pytest.mark.parametrize("Bz,S,Di,N", SHAPES)
def test_round_states_are_the_loop_h(Bz, S, Di, N):
    """State r is h after step min(S, 16 (r + 1)) - 1: bit-equal to the
    plain forward's h_last on that prefix, and to the reference oracle's
    within float32 rounding."""
    args = _torch(_inputs(S, Bz, S, Di, N)[:7], torch.float32)
    states = round_states(args[0], args[6])
    assert states.shape == (Bz, -(-S // ROUND), Di, N)
    y, h = selective_scan_ref(*args, states)
    assert torch.equal(y, selective_scan_ref(*args)[0])
    assert torch.equal(states[:, -1], h)
    for r in range(states.shape[1]):
        end = min(S, ROUND * (r + 1))
        prefix = [t[:, :end] for t in args[:4]] + args[4:]
        assert torch.equal(states[:, r], selective_scan_ref(*prefix)[1])
        _, jh = jax_ref(*(jnp.asarray(t.numpy()) for t in prefix))
        np.testing.assert_allclose(states[:, r].numpy(), np.asarray(jh),
                                   rtol=1e-5, atol=1e-5)
