"""zamba2-7b (Mamba-2 blocks and one shared attention block) in the port
against the reference on the CPU, at the reduced config (d_model 64, 4
heads on 2 KV heads, head dim 16, SSM N 8, P 16) at depth 14 (2 groups of
six mamba2 blocks and the shared block) and at depth 18 (2 groups and 4
remainder mamba2 blocks), the reference's weights carried by
``params_from_jax``.

* prefill and decode logits, teacher-forced along the reference's greedy
  tokens: float32 at 2e-5, bf16 at 2e-2 (``test_torch_serve.py``'s
  tolerances, with its ``_follow_conv_caches`` in float32). Each group's
  application of the shared block keeps its own KV cache: a wrong cache
  index still gives finite logits, and only this comparison, at two or
  more groups, sees it;
* the loss and every gradient leaf, ``shared_attn`` included (the sum of
  its gradients over the groups' applications, under remat one
  checkpointed segment a group), against ``jax.value_and_grad``: float32
  at 1e-5, bf16 at 2e-2, relative to each leaf's largest entry
  (``test_torch_train.py``'s rule), or twice the reference's own noise
  on that kind of leaf where that is larger (``_leaf_tolerances``). At
  this width the gradients of Mamba-2's conv biases and weights of B and
  C, dt_bias, A_log and in_B / in_C are sums that cancel to ~1e-5 of
  their terms: re-chunking the reference's scan (8 or 16 for 40) moves
  its own float32 leaves by up to 1.45e-5, and its bf16 run lies up to
  0.28 from its float32 run (the port: 1.9e-5 and 0.20); remat against
  none;
* one ``make_train_step`` step against the reference's;
* ``count_params_analytic`` at full depth, depth 18, depth 14 and the
  reduced config;
* a checkpoint round trip of a training state that holds ``shared_attn``;
* the serving and training launchers at the reduced config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import model as JM
from repro.train.optimizer import OptimizerConfig as JOpt
from repro.train.optimizer import init_opt_state as jax_opt_state
from repro.train.train_step import TrainConfig as JTrain
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.models.transformer import check_config
from repro_torch.train.optimizer import (OptimizerConfig, init_opt_state,
                                         tree_leaves, tree_map)
from repro_torch.train.train_step import (TrainConfig, check_trainable,
                                          grad_fn, init_train_state,
                                          make_train_step)
from test_torch_serve import _follow_conv_caches, _JaxEngine
from test_torch_train import _as_torch, _batch, _close, _pairs

ARCH = "zamba2-7b"
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # logits
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # loss, leaves
B, S, NEW = 2, 40, 6
DEPTHS = (14, 18)


def _configs(depth: int):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=depth)
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), n_layers=depth)
    return cfg, jcfg


def _reference(dtype: str, depth: int):
    """The reference's reduced parameters at ``depth``, norms, conv
    biases and the SSM's dt_bias / A_log moved off their constant init so
    that a dropped term shows; in float32 or as initialised (bf16
    matrices)."""
    cfg, jcfg = _configs(depth)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("ln", "norm", "conv_x_b", "conv_B_b",
                                   "conv_C_b", "dt_bias", "A_log")):
            noise = rng.standard_normal(a.shape).astype(np.float32)
            return (a.astype(jnp.float32) + 0.1 * noise).astype(a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    p = M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    return cfg, jcfg, jp, p


def test_layout_and_check_config():
    """The shared block lives once, at ``params["shared_attn"]``; the
    groups hold the six mamba2 blocks; the caches hold a KV slot for each
    application; the config builds with a GELU MLP, and the training
    step accepts the encoder-decoder and VLM flags."""
    for depth in DEPTHS:
        cfg, jcfg, jp, p = _reference("float32", depth)
        assert set(p) == set(jp) == {"embed", "groups", "rest", "final_norm",
                                     "shared_attn"}
        assert len(p["groups"]) == 2 and all(
            set(g) == {f"b{i}" for i in range(6)} for g in p["groups"])
        assert len(p["rest"]) == depth - 14
        own = M.init_params(cfg, seed=0, device="cpu")
        assert [t.shape for t in tree_leaves(own)] == [
            t.shape for t in tree_leaves(p)]
        assert sum(t.numel() for t in tree_leaves(own)) == cfg.param_count()
        caches = M.init_caches(cfg, B, S, device="cpu")
        assert all(set(g) == {f"b{i}" for i in range(7)}
                   for g in caches["groups"])
        kv = [g["b6"]["k"] for g in caches["groups"]]
        assert kv[0].data_ptr() != kv[1].data_ptr()
        assert set(caches["groups"][0]["b0"]["conv"]) == {"x", "B", "C"}
    full = get_config(ARCH)
    check_config(full)
    check_config(dataclasses.replace(full, act="gelu"))
    for replace in (dict(enc_dec=True), dict(vision_tokens=8)):
        check_trainable(dataclasses.replace(full, **replace))


def test_param_counts_match_reference():
    full = get_config(ARCH)
    want = {81: 5_778_684_128, 18: 1_567_868_672, 14: 1_255_956_416}
    for depth, n in want.items():
        cfg = dataclasses.replace(full, n_layers=depth)
        assert M.count_params_analytic(cfg) == n
        assert JM.count_params_analytic(
            dataclasses.replace(jax_config(ARCH), n_layers=depth)) == n
    assert full.reduced().param_count() == 378_016 == \
        jax_config(ARCH).reduced().param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_prefill_and_decode_logits_match_reference(depth, dtype):
    cfg, jcfg, jp, p = _reference(dtype, depth)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
    engine = _JaxEngine(jcfg, jp, max_len=S + NEW)
    engine.prompt_len = S
    jl, jc = engine._prefill(jp, {"tokens": jnp.asarray(tokens)})
    jc = jax.tree.map(engine._pad_cache_leaf, jc)
    caches = M.init_caches(cfg, B, S + NEW, device="cpu",
                           dtype=p["embed"].dtype)
    logits, caches = M.prefill(cfg, p, torch.tensor(tokens), caches=caches)
    for i in range(NEW):
        np.testing.assert_allclose(logits.float().numpy(), np.asarray(jl),
                                   **tol, err_msg=f"step {i}")
        tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        jl, jc = engine._decode(jp, jc, tok, jnp.int32(S + i))
        logits, caches = M.decode_step(cfg, p, caches,
                                       torch.tensor(np.asarray(tok)), S + i)
        if dtype == "float32":
            _follow_conv_caches(caches, jc, f"step {i}")
    # each application's KV cache holds its own keys
    k0, k1 = (caches["groups"][g]["b6"]["k"] for g in range(2))
    assert not torch.equal(k0[:, :S + NEW], k1[:, :S + NEW])


def _jax_value_and_grad(jcfg, jp, batch):
    return jax.value_and_grad(
        lambda q: JM.loss_fn(jcfg, q, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)


def _kind(name: str) -> str:
    """A leaf's name without its group or remainder position:
    ``groups/1/b2/mixer/conv_C_b`` -> ``b2/mixer/conv_C_b`` ->
    ``mixer/conv_C_b``."""
    parts = name.split("/")
    if parts[0] == "groups":
        parts = parts[3:]
    elif parts[0] == "rest":
        parts = parts[2:]
    return "/".join(parts)


def _rel(a, b) -> float:
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - b).max()
                 / max(float(np.abs(b).max()), 1e-30))


def _noise(cfg, grads, pairs, others) -> dict:
    """The largest distance (``_rel``) of any leaf of each kind
    (``_kind``) between the reference's gradients ``pairs`` and each tree
    of ``others``."""
    noise: dict = {}
    for other in others:
        for (name, _, want), (_, _, alt) in zip(pairs,
                                                _pairs(cfg, grads, other)):
            noise[_kind(name)] = max(noise.get(_kind(name), 0.0),
                                     _rel(alt, want))
    return noise


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_loss_and_gradients_match_reference(depth, dtype):
    """Every leaf, the shared block's included; under the default remat
    each group is one checkpointed segment.

    Float32: each leaf within GRAD_TOL of the reference's, or within
    twice the reference's own reassociation noise on that kind of leaf
    where larger (its leaves move that far when its 40-step scan runs as
    chunks of 8 or 16); only Mamba-2 mixer leaves take the larger one.
    bf16: each leaf within GRAD_TOL of the reference's bf16 leaf, or (as
    ``test_torch_moe_train.py`` holds a leaf that bf16 moves in the
    reference's own run) within twice the reference's own bf16 distance
    from float32 on that kind of leaf, or GRAD_TOL where larger, of the
    reference's float32 leaf: the port's bf16 gradient no farther from
    the exact one than twice the reference's."""
    cfg, jcfg, jp, p = _reference(dtype, depth)
    batch = _batch(cfg)
    (jl, _), jg = _jax_value_and_grad(jcfg, jp, batch)
    loss, metrics, grads = grad_fn(cfg, TrainConfig(), p, _as_torch(batch))
    _close(loss, np.float32(jl), GRAD_TOL[dtype])
    pairs = _pairs(cfg, grads, jg)
    assert len(pairs) == len(tree_leaves(p))
    assert sum(name.startswith("shared_attn/") for name, _, _ in pairs) == \
        len(tree_leaves(p["shared_attn"])) > 0
    tol = GRAD_TOL[dtype]
    if dtype == "float32":
        others = [_jax_value_and_grad(dataclasses.replace(jcfg, scan_chunk=c),
                                      jp, batch)[1] for c in (8, 16)]
        noise = _noise(cfg, grads, pairs, others)
        for name, got, want in pairs:
            assert np.isfinite(want).all(), name
            leaf_tol = max(tol, 2 * noise[_kind(name)])
            assert _rel(got.numpy(), want) <= leaf_tol, (name, leaf_tol)
        assert all(k.startswith("mixer/") for k, n in noise.items()
                   if 2 * n > tol)
        return
    _, _, jp32, _ = _reference("float32", depth)
    ref32 = _pairs(cfg, grads, _jax_value_and_grad(jcfg, jp32, batch)[1])
    noise = _noise(cfg, grads, ref32, [jg])
    for (name, got, want), (_, _, want32) in zip(pairs, ref32):
        got = got.float().numpy()
        if _rel(got, want) > tol:
            leaf_tol = max(tol, 2 * noise[_kind(name)])
            assert _rel(got, want32) <= leaf_tol, (name, _rel(got, want32),
                                                   leaf_tol)


def test_remat_and_shared_gradient_sum():
    """Remat recomputes the same forward (bit-equal gradients); the shared
    block's gradient is the sum over its applications: the gradient with
    the two groups given separate copies of it sums to the shared one."""
    cfg, _, _, p = _reference("float32", 18)
    batch = _as_torch(_batch(cfg))
    _, _, g_remat = grad_fn(cfg, TrainConfig(), p, batch)
    _, _, g_plain = grad_fn(cfg, TrainConfig(remat=False), p, batch)
    for a, b in zip(tree_leaves(g_remat), tree_leaves(g_plain)):
        assert torch.equal(a, b)
    # the same network with the shared block copied into each group's b6
    split_cfg = dataclasses.replace(
        cfg, layer_pattern=("mamba2",) * 6 + ("attn",))
    split = {**{k: v for k, v in p.items() if k != "shared_attn"},
             "groups": [{**g, "b6": tree_map(torch.clone,
                                             p["shared_attn"])}
                        for g in p["groups"]]}
    _, _, g_split = grad_fn(split_cfg, TrainConfig(), split, batch)
    copies = [tree_leaves(g["b6"]) for g in g_split["groups"]]
    for want, *got in zip(tree_leaves(g_remat["shared_attn"]), *copies):
        _close(sum(got), want.numpy(), 1e-5)


def test_train_step_matches_reference():
    """One step from the same float32 parameters at depth 18 (``eps`` as
    in ``test_torch_train.py``)."""
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
    cfg, jcfg, jp, p = _reference("float32", 18)
    batch = _batch(cfg)
    jstep = jax.jit(jax_train_step(jcfg, JTrain(opt=JOpt(**opt))))
    jnew, jstate, jm = jstep(jp, jax_opt_state(jp),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(**opt)))
    new, new_state, m = step(p, init_opt_state(p), _as_torch(batch))
    for key in ("loss", "grad_norm", "lr"):
        _close(m[key], np.float32(jm[key]), GRAD_TOL["float32"])
    for _, got, want in _pairs(cfg, new, jnew):
        _close(got, want, GRAD_TOL["float32"])
    for _, got, want in _pairs(cfg, new_state["m"], jstate["m"]):
        _close(got, want, GRAD_TOL["float32"])


def test_checkpoint_round_trip_holds_shared_attn(tmp_path):
    cfg, _ = _configs(18)
    params, state = init_train_state(cfg, seed=3, device="cpu")
    assert "shared_attn" in params
    save_checkpoint((params, state), str(tmp_path), 5)
    like = init_train_state(cfg, seed=4, device="cpu")
    (got_p, got_s), _ = restore_checkpoint(str(tmp_path), 5, like=like,
                                           device="cpu")
    for a, b in zip(tree_leaves((params, state)), tree_leaves((got_p,
                                                               got_s))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert set(got_p["shared_attn"]) == set(params["shared_attn"])


def test_launchers_run_zamba2_reduced(capsys, tmp_path):
    launch_serve.main(["--arch", ARCH, "--reduced", "--prompt-len", "20",
                       "--new-tokens", "3", "--device", "cpu"])
    assert ARCH in capsys.readouterr().out
    launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "4", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "4"])
    out = capsys.readouterr().out
    assert np.isfinite(float(out.split("final loss ")[1].split(";")[0]))
    assert sorted(q.name for q in tmp_path.iterdir()) == ["step_00000004"]
