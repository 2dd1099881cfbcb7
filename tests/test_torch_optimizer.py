"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's (``repro.train.optimizer``) on the same float32 arrays.

Every function is written op for op as the reference's, so the results
agree to float32 rounding: at most 1e-6 relative (atol 1e-6 times the
leaf's largest magnitude, for entries that cancel to near zero), and the
int8 payload of ``quantize_int8`` bit for bit (both round half to even).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as J
from repro_torch.train import optimizer as P

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _tree(seed, shapes=((7, 5), (3,), (2, 4, 3)), scale=1.0):
    """A nested dict/list tree of float32 draws (numpy)."""
    rng = np.random.default_rng(seed)
    a, b, c = (scale * rng.standard_normal(s).astype(np.float32)
               for s in shapes)
    return {"w": a, "blocks": [{"b": b}, {"b": c}]}


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax(v) for v in tree]
    return jnp.asarray(tree)


def _torch(tree):
    return P.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _leaves(tree):
    return P.tree_leaves(tree)


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 2500, 9999, 10000,
                                  12000])
def test_cosine_lr(step):
    cfg = P.OptimizerConfig()
    got = P.cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))
    want = J.cosine_lr(J.OptimizerConfig(), jnp.int32(step))
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm(dtype):
    """Leaves of either dtype are summed in float32 (dict keys sorted, as
    ``jax.tree.leaves`` orders them)."""
    tree = _tree(0)
    tt = P.tree_map(lambda t: t.to(getattr(torch, dtype)), _torch(tree))
    jt = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), _jax(tree))
    got = P.global_norm(tt)
    assert got.dtype == torch.float32
    _close(got, J.global_norm(jt))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((33, 17)).astype(np.float32)
    err = 0.01 * rng.standard_normal((33, 17)).astype(np.float32)
    # halves land exactly on a rounding tie: both round to even
    g[0, :4] = np.array([0.5, 1.5, -2.5, 3.5], np.float32) * (
        np.abs(g + err).max() / 127.0) - err[0, :4]
    deq, new_err = P.quantize_int8(torch.tensor(g), torch.tensor(err))
    jdeq, jerr = J.quantize_int8(jnp.asarray(g), jnp.asarray(err))
    scale = float(np.abs(g + err).max()) / 127.0
    np.testing.assert_array_equal(np.round(deq.numpy() / scale),
                                  np.round(np.asarray(jdeq) / scale))
    _close(deq, jdeq)
    _close(new_err, jerr)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update(compress, steps):
    """A few updates from the same params and grads; bf16 params keep
    their dtype, the float32 master and moments hold the update."""
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
               compress_grads=compress)
    pc, jc = P.OptimizerConfig(**cfg), J.OptimizerConfig(**cfg)
    params = _tree(1)
    tp, jp = _torch(params), _jax(params)
    tp["w"], jp["w"] = tp["w"].bfloat16(), jp["w"].astype(jnp.bfloat16)
    ts, js = P.init_opt_state(tp), J.init_opt_state(jp)
    tcs, jcs = P.init_compress_state(tp), J.init_compress_state(jp)
    for i in range(steps):
        grads = _tree(10 + i, scale=0.3)
        tg, jg = _torch(grads), _jax(grads)
        before = [t.clone() for t in _leaves(tp)]
        tp2, ts, tcs2, tstats = P.adamw_update(
            pc, tg, tp, ts, tcs if compress else None)
        jp, js, jcs2, jstats = J.adamw_update(
            jc, jg, jp, js, jcs if compress else None)
        # functional: the inputs are untouched
        assert all(torch.equal(a, b) for a, b in zip(before, _leaves(tp)))
        tp = tp2
        if compress:
            tcs, jcs = tcs2, jcs2
            for a, b in zip(_leaves(tcs), jax.tree.leaves(jcs)):
                _close(a, b)
        for key in ("grad_norm", "lr"):
            _close(tstats[key], jstats[key])
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for part in ("master", "m", "v"):
            for a, b in zip(_leaves(ts[part]), jax.tree.leaves(js[part])):
                _close(a, b)
        assert tp["w"].dtype == torch.bfloat16
        for a, b in zip(_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-2, atol=1e-6)
