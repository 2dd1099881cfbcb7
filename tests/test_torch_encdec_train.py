"""Training the encoder-decoder (whisper-large-v3) and the VLM front end
(internvl2-2b) in the port, against the reference, on the CPU.

* ``FlashAttentionFn``'s plain route on the non-causal mask, Sq != Skv and
  ragged (23 x 100, 37 x 37, GQA), in the model's (B, S, heads, hd)
  layout, against ``jax.grad`` of the reference's ``attention_blockwise(
  causal=False)`` with small chunks: float32 at 2e-5, bf16 at 2e-2
  (relative to each gradient's largest entry);
* ``plan_bwd`` at whisper-large-v3's three training shapes (the encoder
  layer, 1,500 x 1,500 non-causal; the cross-attention, 187 x 1,500
  non-causal; the decoder's self-attention, 187 causal): every visible
  (query, key) pair covered once, the ragged last row and key tiles in
  the table once, the order of ties fixed;
* the reduced whisper-large-v3's and internvl2-2b's (with its patch
  embeddings) loss and every gradient leaf against ``jax.value_and_grad``
  of ``repro.models.model.loss_fn`` (float32 at 2e-5, bf16 at 2e-2, each
  relative to the leaf's largest entry), the reference's weights carried
  by ``params_from_jax`` with every norm and bias moved off its init;
* one ``make_train_step`` step against the reference's: the new params
  and the AdamW state (``tests/test_models_smoke.py``'s step, held);
* whisper: two microbatches against one, remat against none, and every
  attention call through ``FlashAttentionFn`` with its mask and shapes,
  the same in remat's recompute;
* the launcher on the CPU: the loss falls for both archs, and a ``seq``
  shorter than ``vision_tokens`` raises.

The CUDA kernels at whisper's and internvl2-2b's full training shapes
are held on the card by ``tests/test_torch_model_kernels.py`` (``-m gpu
-k encdec_bwd``) and ``chip_smoke.py`` phase 17.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.attention import attention_blockwise as jax_blockwise
from repro.train.optimizer import OptimizerConfig as JOpt
from repro.train.optimizer import init_opt_state as jax_opt_state
from repro.train.train_step import TrainConfig as JTrain
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_train)
from repro_torch.kernels.flash_attention_bwd.kernel import (KEY_TILE,
                                                            plan_bwd)
from repro_torch.launch import train as launch_train
from repro_torch.train.optimizer import (OptimizerConfig, init_opt_state,
                                         tree_leaves)
from repro_torch.train.train_step import (TrainConfig, grad_fn,
                                          make_train_step)
from test_torch_encdec import _reference as _whisper_reference
from test_torch_flash_bwd_plan import check_plan
from test_torch_train import _close, _pairs
from test_torch_vlm import _reference as _vlm_reference

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
WHISPER, VLM = "whisper-large-v3", "internvl2-2b"
B, S_ENC, S_VLM = 2, 60, 20             # 60 frames: 7 decoder positions


def _batch(cfg, seed=0, b=B):
    """A seeded numpy batch of the family's shapes: whisper's ``S_ENC``
    frames and ``S_ENC // 8`` decoder tokens; internvl2-2b's ``S_VLM``
    tokens with ``vision_tokens`` patch embeddings."""
    rng = np.random.default_rng(seed)
    s = S_ENC // 8 if cfg.enc_dec else S_VLM
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal((b, S_ENC, cfg.d_model)).astype(
            np.float32)
    else:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def _embeds_key(cfg):
    return "frames" if cfg.enc_dec else "vision_embeds"


def _as_jax(cfg, batch, dtype):
    key = _embeds_key(cfg)
    return {k: jnp.asarray(v).astype(getattr(jnp, dtype)) if k == key
            else jnp.asarray(v) for k, v in batch.items()}


def _as_torch(cfg, batch, dtype):
    key = _embeds_key(cfg)
    return {k: torch.tensor(v).to(getattr(torch, dtype)) if k == key
            else torch.tensor(v) for k, v in batch.items()}


def _reference(arch, dtype):
    return (_whisper_reference if arch == WHISPER else _vlm_reference)(dtype)


# -- the differentiable op on the non-causal mask -----------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Bz,H,KV,Sq,Skv,hd", [(2, 4, 4, 23, 100, 16),
                                               (1, 4, 2, 37, 37, 32)])
def test_noncausal_gradients_match_jax_grad(Bz, H, KV, Sq, Skv, hd, dtype):
    """The plain route's dq, dk, dv at ``causal=False``, ragged Sq != Skv,
    against ``jax.grad`` of the reference's blockwise attention with 8-row
    chunks (its scan crosses several key blocks and pads the last)."""
    rng = np.random.default_rng(Sq * Skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bz, Sq, H, hd), (Bz, Skv, KV, hd),
                         (Bz, Skv, KV, hd)))
    w = rng.standard_normal((Bz, Sq, H, hd)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def jloss(q, k, v):
        o = jax_blockwise(q, k, v, causal=False, q_chunk=8, kv_chunk=8)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    leaves = [torch.tensor(a).to(getattr(torch, dtype)).requires_grad_()
              for a in (q, k, v)]
    o = flash_attention_train(*(t.transpose(1, 2) for t in leaves),
                              causal=False)
    assert o.shape == (Bz, H, Sq, hd)
    (o.transpose(1, 2).float() * torch.tensor(w)).sum().backward()
    for leaf, g in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, np.asarray(g.astype(jnp.float32)), TOL[dtype])


# -- the backward's launch plan at whisper's shapes ---------------------------

#: (Sq, Skv, causal) of whisper-large-v3's three training calls (B 4, H 20
#: on KV 20, hd 64)
WHISPER_BWD = {"encoder": (1500, 1500, False), "cross": (187, 1500, False),
               "decoder self": (187, 187, True)}


@pytest.mark.parametrize("name", list(WHISPER_BWD))
def test_plan_bwd_at_whisper_shapes(name):
    """Every visible pair once in each kernel's walk (at B 1, H 20: the
    table does not depend on B); the table at B 4 is the same; the ragged
    last row tile (28 of 1,500 queries, 59 of 187) and key tile are in it
    once; under the non-causal mask every key tile walks every query
    tile, and the ties keep the key tiles in ascending order."""
    Sq, Skv, causal = WHISPER_BWD[name]
    plan = plan_bwd.__wrapped__(1, 20, 20, Sq, Skv, Skv, 64, causal=causal,
                                window=None, q_offset=0)
    check_plan(plan)
    full = plan_bwd(4, 20, 20, Sq, Skv, Skv, 64, causal=causal, window=None,
                    q_offset=0)
    assert full.table() == plan.table()
    assert plan_bwd.__wrapped__(4, 20, 20, Sq, Skv, Skv, 64, causal=causal,
                                window=None, q_offset=0) == full
    n_q = -(-Sq // plan.q_block_q)
    n_k = -(-Skv // KEY_TILE)
    assert plan.q_block_q == plan.kv_block_q == 64 and plan.cluster == 1
    last_q = (n_q - 1) * plan.q_block_q
    assert Sq - last_q == {1500: 28, 187: 59}[Sq]
    assert [q0 for q0, _, _ in plan.q_tiles].count(last_q) == 1
    assert [kt for kt, _, _ in plan.kv_tiles].count(n_k - 1) == 1
    if not causal:
        assert plan.kv_tiles == tuple((kt, 0, n_q) for kt in range(n_k))
        assert all(lo == 0 and hi == n_k for _, lo, hi in plan.q_tiles)
        assert [q0 for q0, _, _ in plan.q_tiles] == [
            t * plan.q_block_q for t in reversed(range(n_q))]


# -- the reduced models against the reference ---------------------------------

def _jax_value_and_grad(jcfg, jp, batch):
    return jax.jit(jax.value_and_grad(
        lambda q, b: JM.loss_fn(jcfg, q, b), has_aux=True))(jp, batch)


def _rel_max(got, want) -> float:
    """max |got - want| / max |want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_loss_and_gradients_match_reference(arch, dtype):
    """The loss, the perplexity and every gradient leaf (the encoder's
    through the cross-attention's K and V; the patch embeddings' positions
    through attention) against ``jax.value_and_grad``.

    In bf16 a leaf whose gradient is small next to the terms that make it
    (the reduced whisper's decoder self-attention: 8 positions, scores
    near zero) is as far from its float32 value in the reference's own bf16
    run as bf16 allows or more (up to 5e-2): such a leaf is held within
    ``TOL`` of the reference's bf16 gradient or, failing that, within
    twice the reference's own bf16 distance from its float32 gradient (at
    least ``TOL``) of that float32 gradient, on the same bf16 weights and
    inputs (``chip_smoke.py``'s rule for bf16 against float32)."""
    cfg, jcfg, jp, p = _reference(arch, dtype)
    batch = _batch(cfg, seed=1)
    jb = _as_jax(cfg, batch, dtype)
    (jl, jm), jg = _jax_value_and_grad(jcfg, jp, jb)
    loss, metrics, grads = grad_fn(cfg, TrainConfig(), p,
                                   _as_torch(cfg, batch, dtype))
    _close(loss, np.float32(jl), TOL[dtype])
    _close(metrics["perplexity"], np.float32(jm["perplexity"]), TOL[dtype])
    pairs = _pairs(cfg, grads, jg)
    assert len(pairs) == len(tree_leaves(p))
    assert [g.dtype for g in tree_leaves(grads)] == [
        t.dtype for t in tree_leaves(p)]
    exact = {}
    if dtype == "bfloat16":
        up = lambda t: jax.tree.map(  # noqa: E731
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        _, jg32 = _jax_value_and_grad(jcfg, up(jp), up(jb))
        exact = {name: want for name, _, want in _pairs(cfg, grads, jg32)}
    for name, got, want in pairs:
        assert float(np.abs(want).max()) > 0, name
        if name in exact and _rel_max(got, want) > TOL[dtype]:
            noise = _rel_max(want, exact[name])
            err = _rel_max(got, exact[name])
            assert err <= max(TOL[dtype], 2 * noise), (name, err, noise)
        else:
            _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_train_step_matches_reference(arch):
    """One step from the same float32 parameters: the loss, the gradient
    norm, the new params and the AdamW moments (``eps`` large for the
    reason ``tests/test_torch_train.py`` gives)."""
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
    cfg, jcfg, jp, p = _reference(arch, "float32")
    batch = _batch(cfg, seed=2)
    jstep = jax.jit(jax_train_step(jcfg, JTrain(opt=JOpt(**opt))))
    jnew, jstate, jm = jstep(jp, jax_opt_state(jp),
                             _as_jax(cfg, batch, "float32"))
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(**opt)))
    new, state, m = step(p, init_opt_state(p),
                         _as_torch(cfg, batch, "float32"))
    for key in ("loss", "grad_norm", "lr"):
        _close(m[key], np.float32(jm[key]), TOL["float32"])
    for tree, jtree in ((new, jnew), (state["m"], jstate["m"]),
                        (state["v"], jstate["v"])):
        for name, got, want in _pairs(cfg, tree, jtree):
            _close(got, want, TOL["float32"])


def test_whisper_microbatches_and_remat_agree():
    """Two microbatches split ``frames`` by rows with the tokens and give
    the mean of their halves' gradients in float32; remat recomputes the
    same forward, so its gradients are bit-equal."""
    cfg, _, _, p = _reference(WHISPER, "float32")
    batch = _as_torch(cfg, _batch(cfg, seed=3, b=4), "float32")
    l1, _, g1 = grad_fn(cfg, TrainConfig(), p, batch)
    l2, m2, g2 = grad_fn(cfg, TrainConfig(n_microbatches=2), p, batch)
    l3, _, g3 = grad_fn(cfg, TrainConfig(remat=False), p, batch)
    halves = [grad_fn(cfg, TrainConfig(), p,
                      {k: v[i:i + 2] for k, v in batch.items()})
              for i in (0, 2)]
    _close(l2, l1.numpy(), 1e-6)
    _close(l2, ((halves[0][0] + halves[1][0]) / 2).numpy(), 1e-6)
    assert set(m2) == {"loss"}
    for a, b, c, h0, h1 in zip(tree_leaves(g1), tree_leaves(g2),
                               tree_leaves(g3), tree_leaves(halves[0][2]),
                               tree_leaves(halves[1][2])):
        assert b.dtype == torch.float32
        _close(b, a.numpy(), TOL["float32"])
        _close(b, ((h0 + h1) / 2).numpy(), 1e-6)
        assert torch.equal(a, c)


def test_whisper_attention_goes_through_flash_attention_fn(monkeypatch):
    """Every attention call of a training step is ``FlashAttentionFn``:
    per layer the encoder's (non-causal, Sq = Skv = frames), then the
    decoder's self-attention (causal) and cross-attention (non-causal,
    decoder positions on frames), with the backend given; under remat
    each block's recompute repeats its calls with the same mask and
    shapes."""
    cfg, _, _, p = _reference(WHISPER, "float32")
    batch = _as_torch(cfg, _batch(cfg, seed=4), "float32")
    seen = []
    apply = FlashAttentionFn.apply

    def spy(q, k, v, causal, *rest):
        seen.append((causal, q.shape[2], k.shape[2], rest[-1]))
        return apply(q, k, v, causal, *rest)

    monkeypatch.setattr(FlashAttentionFn, "apply", spy)
    S_dec = S_ENC // 8
    enc = [(False, S_ENC, S_ENC, "plain")] * cfg.n_encoder_layers
    dec = [(True, S_dec, S_dec, "plain"),
           (False, S_dec, S_ENC, "plain")] * cfg.n_layers
    grad_fn(cfg, TrainConfig(remat=False), p, batch, backend="plain")
    assert seen == enc + dec
    seen.clear()
    grad_fn(cfg, TrainConfig(remat=True), p, batch, backend="plain")
    assert len(seen) == 2 * len(enc + dec)
    assert sorted(seen) == sorted(2 * (enc + dec))
    assert seen[:len(enc + dec)] == enc + dec     # the forward, in order


# -- the launcher -------------------------------------------------------------

@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_launcher_loss_falls_on_the_cpu(arch, capsys, tmp_path):
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "20", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "20"])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    final = float(out.split("final loss ")[1].split(";")[0])
    assert len(losses) == 10 and final < losses[0]
    assert all(np.isfinite(losses)) and "device=cpu" in out


def test_family_batch_and_short_seq():
    """The launcher's batch is the reference's: whisper's tokens and
    labels cut to seq // 8 beside (B, seq, D) bf16 ones, internvl2-2b's
    (B, vision_tokens, D) bf16 ones; given embeddings are taken as they
    are; a seq shorter than vision_tokens raises, naming both."""
    rng = np.random.default_rng(5)
    loader = {k: rng.integers(0, 256, (2, 40)).astype(np.int32)
              for k in ("tokens", "labels")}
    w = get_config(WHISPER).reduced()
    b = launch_train.family_batch(w, loader, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (2, 5)
    assert torch.equal(b["tokens"], torch.tensor(loader["tokens"][:, :5]))
    assert b["frames"].shape == (2, 40, w.d_model)
    assert b["frames"].dtype == torch.bfloat16 and bool(
        (b["frames"] == 1).all())
    v = get_config(VLM).reduced()
    emb = torch.randn(2, v.vision_tokens, v.d_model)
    b = launch_train.family_batch(v, loader, device="cpu", embeds=emb)
    assert b["tokens"].shape == (2, 40)
    assert torch.equal(b["vision_embeds"], emb)
    with pytest.raises(ValueError, match="vision_embeds"):
        launch_train.family_batch(v, loader, device="cpu", embeds=emb[:, :3])
    short = {k: a[:, :5] for k, a in loader.items()}
    for fn in (lambda: launch_train.family_batch(v, short, device="cpu"),
               lambda: launch_train.build(v, batch=2, seq=5, steps=1,
                                          device="cpu")):
        with pytest.raises(ValueError, match="seq 5 .*vision_tokens 8"):
            fn()
    g = get_config("gemma3-1b").reduced()
    assert set(launch_train.family_batch(g, loader, device="cpu")) == {
        "tokens", "labels"}
