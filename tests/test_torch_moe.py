"""The port's mixture-of-experts feed-forward (``repro_torch.models.moe``)
and the MoE configs' serving path against the reference's, on the CPU.

* ``moe_ffn`` against ``repro.models.moe.moe_ffn`` on the same numpy
  weights: float32 at 2e-5 (atol and rtol; observed ~3e-7) and bf16 at
  2e-2 (one bf16 ulp where the grouped products accumulate in another
  order), with and without the dense residual, at decode (S = 1, so
  C = 1 and nothing drops), at the default capacity and at a capacity
  factor low enough that tokens drop. The chosen experts and the keep mask
  are held *equal* to the reference's (its ``top_k``, stable ``argsort``
  and capacity lines on the same float32 logits), not only the outputs;
* ties: equal logits choose the lower expert index, as ``jax.lax.top_k``;
* ``moe_aux_loss`` at 1e-6 and the float32 gradients of ``moe_ffn``
  (input, router and experts) against ``jax.grad`` at 1e-5;
* two calls are bit-equal, forward and backward;
* the reduced granite-moe-1b-a400m and arctic-480b (dense residual) on
  the reference's weights (``params_from_jax``): prefill and decode
  logits along the reference's greedy tokens, float32 at 2e-5 and bf16 at
  2e-2 (``tests/test_torch_serve.py``'s tolerances);
* the analytic parameter counts of both configs, whole and active.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import mlp as jax_mlp
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import moe as TMoE
from repro_torch.models.mlp import gated_mlp
from repro_torch.models.transformer import check_config
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import check_trainable

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MOE_ARCHS = ("granite-moe-1b-a400m", "arctic-480b")
#: (batch, sequence, capacity factor): the default, decode, tokens dropped
SHAPES = [(2, 40, 1.25), (3, 1, 1.25), (2, 40, 0.5)]


def _weights(seed, D, F, E, dense_residual):
    rng = np.random.default_rng(seed)
    w = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.3,
         "wg": rng.standard_normal((E, D, F)).astype(np.float32) * 0.1,
         "wu": rng.standard_normal((E, D, F)).astype(np.float32) * 0.1,
         "wd": rng.standard_normal((E, F, D)).astype(np.float32) * 0.1}
    if dense_residual:
        w["res"] = {k: rng.standard_normal(s).astype(np.float32) * 0.1
                    for k, s in (("wg", (D, F)), ("wu", (D, F)),
                                 ("wd", (F, D)))}
    return w


def _cast(tree, dtype, lib):
    """The router stays float32; every other leaf in ``dtype``."""
    def go(t, name):
        if isinstance(t, dict):
            return {k: go(v, k) for k, v in t.items()}
        if lib == "jax":
            a = jnp.asarray(t)
            return a if name == "router" else a.astype(dtype)
        a = torch.tensor(t)
        return a if name == "router" else a.to(dtype)
    return go(tree, "")


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _reference_routing(x, router, top_k, C):
    """The reference's routing lines (``_dispatch_one_row``) per row, on
    its float32 logits: chosen experts and the keep mask in sorted order,
    and the stable sort order."""
    logits = jnp.asarray(x).astype(jnp.float32) @ jnp.asarray(router)
    _, idx = jax.lax.top_k(logits, top_k)
    E = router.shape[-1]
    S = x.shape[1]

    def one(row_idx):
        flat_e = row_idx.reshape(-1)
        order = jnp.argsort(flat_e)
        sorted_e = flat_e[order]
        counts = jnp.bincount(sorted_e, length=E)
        starts = jnp.cumsum(counts) - counts
        pos = jnp.arange(S * top_k) - starts[sorted_e]
        return order, pos < C

    order, keep = jax.vmap(one)(idx)
    return np.asarray(idx), np.asarray(order), np.asarray(keep)


def _inputs(seed, B, S, D, dtype):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(dtype)
    return xj, torch.tensor(_f32(xj)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dense_residual", [False, True],
                         ids=["moe", "moe+res"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,cf", SHAPES)
def test_moe_ffn_matches_reference(B, S, cf, dtype, dense_residual):
    D, F, E, k = 64, 32, 4, 2
    w = _weights(3, D, F, E, dense_residual)
    jw = _cast(w, getattr(jnp, dtype), "jax")
    tw = _cast(w, getattr(torch, dtype), "torch")
    xj, xt = _inputs(S + B, B, S, D, dtype)
    want = JMoE.moe_ffn(jw, xj, top_k=k, capacity_factor=cf)
    got = TMoE.moe_ffn(tw, xt, top_k=k, capacity_factor=cf)
    if dense_residual:
        want = want + jax_mlp.gated_mlp(jw["res"], xj, "swiglu")
        got = got + gated_mlp(tw["res"], xt, "swiglu")
    assert got.dtype == xt.dtype and got.shape == (B, S, D)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])

    # the routing itself, equal to the reference's
    C = TMoE.capacity(S, k, E, cf)
    assert C == int(max(1, int(S * k / E * cf)))
    r = TMoE.route(xt, tw["router"], top_k=k, C=C)
    idx, order, keep = _reference_routing(xj, w["router"], k, C)
    np.testing.assert_array_equal(r["idx"].numpy(), idx)
    np.testing.assert_array_equal(r["order"].numpy(), order)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    if S == 1:
        assert C == 1 and keep.all()
    if cf < 1:
        assert not keep.all()      # the case drops tokens


def test_top_k_breaks_ties_toward_the_lower_index():
    logits = torch.tensor([[0.5, 2.0, 2.0, 0.5, 2.0],
                           [1.0, 1.0, 1.0, 1.0, 1.0]])
    vals, idx = TMoE.topk_stable(logits, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("S", [1, 40])
def test_moe_aux_loss_matches_reference(S):
    D, E, k = 64, 4, 2
    w = _weights(5, D, 32, E, False)
    xj, xt = _inputs(11, 2, S, D, "float32")
    want = JMoE.moe_aux_loss(_cast(w, jnp.float32, "jax"), xj, top_k=k)
    got = TMoE.moe_aux_loss(_cast(w, torch.float32, "torch"), xt, top_k=k)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_gradients_match_reference(cf):
    """d(sum(moe_ffn(x) * w)) / d(x, router, wg, wu, wd) in float32; the
    router's through the softmax gates."""
    D, F, E, k, B, S = 64, 32, 4, 2, 2, 40
    w = _weights(7, D, F, E, False)
    xj, xt = _inputs(13, B, S, D, "float32")
    probe = np.random.default_rng(1).standard_normal((B, S, D)).astype(
        np.float32)

    def jloss(params, x):
        y = JMoE.moe_ffn(params, x, top_k=k, capacity_factor=cf)
        return jnp.sum(y * probe)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(_cast(w, jnp.float32, "jax"),
                                                 xj)
    tw = {n: t.requires_grad_() for n, t in
          _cast(w, torch.float32, "torch").items()}
    xt.requires_grad_()
    (TMoE.moe_ffn(tw, xt, top_k=k, capacity_factor=cf)
     * torch.tensor(probe)).sum().backward()
    for name in tw:
        np.testing.assert_allclose(_f32(tw[name].grad), _f32(jg_p[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(_f32(xt.grad), _f32(jg_x), atol=1e-5,
                               rtol=1e-5)
    assert float(tw["router"].grad.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_is_deterministic(dtype):
    """Two calls give bit-equal outputs and gradients."""
    w = _weights(9, 64, 32, 4, False)
    xj, xt = _inputs(17, 2, 40, 64, dtype)
    runs = []
    for _ in range(2):
        tw = {n: t.requires_grad_() for n, t in
              _cast(w, getattr(torch, dtype), "torch").items()}
        x = xt.clone().requires_grad_()
        y = TMoE.moe_ffn(tw, x, top_k=2, capacity_factor=0.5)
        y.float().square().sum().backward()
        runs.append([y.detach(), x.grad] + [tw[n].grad for n in sorted(tw)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _reference_params(arch, dtype):
    jcfg = jax_config(arch).reduced()
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "ln" in name or "norm" in name:
            noise = rng.standard_normal(a.shape).astype(np.float32)
            return (a.astype(jnp.float32) + 0.1 * noise).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return jcfg, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_config_logits_match_reference(arch, dtype):
    """Prefill, then decode steps (S = 1 a step, C = 1) along the
    reference's greedy tokens."""
    B, S, NEW = 2, 40, 4
    cfg = get_config(arch).reduced()
    jcfg, jp = _reference_params(arch, dtype)
    p = M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    moe = p["groups"][0]["b0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].shape == (cfg.moe.num_experts, cfg.d_model, cfg.d_ff)
    assert ("res" in moe) == cfg.moe.dense_residual
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    engine = JaxEngine(jcfg, jp, max_len=S + NEW)
    jl, jc = engine._prefill(jp, {"tokens": jnp.asarray(tokens)})
    jc = jax.tree.map(engine._pad_cache_leaf, jc)
    caches = M.init_caches(cfg, B, S + NEW, device="cpu",
                           dtype=p["embed"].dtype)
    logits, caches = M.prefill(cfg, p, torch.tensor(tokens), caches=caches)
    for i in range(NEW):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol,
                                   err_msg=f"step {i}")
        tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        jl, jc = engine._decode(jp, jc, tok, jnp.int32(S + i))
        logits, caches = M.decode_step(cfg, p, caches,
                                       torch.tensor(np.asarray(tok)), S + i)


@pytest.mark.parametrize("arch,total,active", [
    ("granite-moe-1b-a400m", 1_334_628_352, 428_658_688),
    ("arctic-480b", 476_850_275_328, 15_584_314_368)])
def test_moe_param_counts(arch, total, active):
    cfg = get_config(arch)
    assert cfg.param_count() == total == jax_config(arch).param_count()
    assert cfg.active_param_count() == active == \
        jax_config(arch).active_param_count()
    assert M.count_params_analytic(cfg, active_only=True) == active
    small = cfg.reduced()
    assert small.param_count() == jax_config(arch).reduced().param_count()
    assert small.active_param_count() == \
        jax_config(arch).reduced().active_param_count()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_pass_check_config(arch):
    """The MoE configs are served and trained; the training step accepts
    the encoder-decoder flag too
    (``test_torch_serve.py::test_unported_paths_raise``)."""
    cfg = get_config(arch)
    check_config(cfg)
    check_trainable(cfg)
    check_trainable(dataclasses.replace(cfg, enc_dec=True))
    p = M.init_params(cfg.reduced(), seed=0, device="cpu")
    block = p["groups"][0]["b0"]
    assert "mlp" not in block and set(block["moe"]) == (
        {"router", "wg", "wu", "wd"} | ({"res"} if cfg.moe.dense_residual
                                        else set()))
    assert sum(t.numel() for t in tree_leaves(p)) == \
        cfg.reduced().param_count()
