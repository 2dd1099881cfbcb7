"""The port's training path (``repro_torch.models.model.loss_fn``,
``repro_torch.train.train_step``, ``repro_torch.launch.train``) against the
reference's at the reduced gemma3-1b and the reduced falcon-mamba-7b, on
the CPU (the plain versions of the kernels).

* the loss and every gradient leaf against ``jax.value_and_grad`` of
  ``repro.models.model.loss_fn``, the reference's parameters carried by
  ``params_from_jax``: float32 copies at 1e-5 (observed ~8e-7) and the bf16
  layout at 2e-2 (``tests/test_kernels.py``'s bf16 tolerance; observed up
  to 1.8e-2), each relative to the leaf's largest entry;
* the training logits and the chunked cross-entropy with several chunks
  against the reference's;
* two microbatches against one, ``remat`` against none;
* one whole train step's new parameters against the reference's
  ``make_train_step``;
* ``compress_grads``: the step carries the int8 error feedback in the
  optimizer state, step for step equal to ``adamw_update`` given that
  state by hand, and the launcher's ``--compress-grads`` checkpoints it;
* falcon-mamba-7b's Mamba-1 blocks: the loss and every gradient leaf
  against ``jax.value_and_grad`` (float32 at 1e-5, observed ~1.2e-6; bf16
  at 2e-2, observed ~7e-3: the reference's associative scan needs no more
  than gemma3-1b's tolerances), one whole train step against
  ``make_train_step``, remat against none; train mode reaches
  ``SelectiveScanFn`` (the scan's forward and backward in one
  ``autograd.Function``, no graph over time), and ``backend="cuda"`` on
  CPU tensors raises rather than fall back;
* one step with finite loss and gradients for every registered config;
* the launcher's loss falls over 20 steps on the CPU, and without
  ``--device cpu`` it asks for the card.
"""


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
from repro_torch.configs import arch_ids, get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.kernels.selective_scan import SelectiveScanFn
from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_compress_state, init_opt_state,
                                         tree_leaves)
from repro_torch.train.train_step import (TrainConfig, grad_fn,
                                          init_train_state, make_train_step)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 40                   # longer than the reduced 32-key window
MAMBA = "falcon-mamba-7b"


def _reference(dtype, arch="gemma3-1b"):
    jcfg = jax_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    cfg = get_config(arch).reduced()
    return cfg, jcfg, jp, M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))


def _batch(cfg, seed=0, b=B, s=S):
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _as_torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _pairs(cfg, port, ref):
    """(name, port leaf, reference leaf as numpy) for every leaf; the
    reference's stacked group leaves are split per group, and the
    encoder-decoder's stacked ``enc_blocks`` and ``dec_blocks`` per
    layer."""
    ref = jax.tree.map(np.asarray, ref)
    out = []

    def walk(p, r, name):
        if isinstance(r, dict):
            for k in r:
                walk(p[k], r[k], f"{name}/{k}")
        elif isinstance(r, (list, tuple)):
            for i, x in enumerate(r):
                walk(p[i], x, f"{name}/{i}")
        else:
            out.append((name, p, np.asarray(r, np.float32)))

    stacked = {"groups": cfg.n_groups, "enc_blocks": cfg.n_encoder_layers,
               "dec_blocks": cfg.n_layers}
    for key in ref:
        if key in stacked:
            for g in range(stacked[key]):
                walk(port[key][g],
                     jax.tree.map(lambda a, g=g: a[g], ref[key]),
                     f"{key}/{g}")
        else:
            walk(port[key], ref[key], key)
    return out


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _check_loss_and_gradients(dtype, arch):
    cfg, jcfg, jp, p = _reference(dtype, arch)
    batch = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda q: JM.loss_fn(jcfg, q, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)
    loss, metrics, grads = grad_fn(cfg, TrainConfig(), p, _as_torch(batch))
    _close(loss, np.float32(jl), TOL[dtype])
    _close(metrics["perplexity"], np.float32(jm["perplexity"]), TOL[dtype])
    pairs = _pairs(cfg, grads, jg)
    assert len(pairs) == len(tree_leaves(p))
    # one microbatch: each gradient in its parameter's dtype
    assert [g.dtype for g in tree_leaves(grads)] == [
        t.dtype for t in tree_leaves(p)]
    for name, got, want in pairs:
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype):
    _check_loss_and_gradients(dtype, "gemma3-1b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_loss_and_gradients_match_reference(dtype):
    """Every Mamba-1 leaf (A_log and D_skip through the scan's backward,
    the conv, projections and dt through what it hands back)."""
    _check_loss_and_gradients(dtype, MAMBA)


def test_train_logits_match_reference():
    """The training forward's float32 logits, remat on and off."""
    cfg, jcfg, jp, p = _reference("float32")
    batch = _batch(cfg)
    want = np.asarray(JM.train_logits(
        jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    for remat in (False, True):
        got = M.train_logits(cfg, p, _as_torch(batch), remat=remat)
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got.detach(), want, TOL["float32"])


def test_chunked_cross_entropy_matches_reference():
    """Five chunks of 8 positions, each recomputed in the backward."""
    cfg, jcfg, jp, p = _reference("float32")
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    want = JM.chunked_cross_entropy(jcfg, jp, jnp.asarray(hidden),
                                    jnp.asarray(labels), chunk=8)
    h = torch.tensor(hidden, requires_grad=True)
    got = M.chunked_cross_entropy(cfg, p, h, torch.tensor(labels).long(),
                                  chunk=8)
    _close(got.detach(), np.float32(want), TOL["float32"])
    got.backward()
    jh = jax.grad(lambda x: JM.chunked_cross_entropy(
        jcfg, jp, x, jnp.asarray(labels), chunk=8))(jnp.asarray(hidden))
    _close(h.grad, np.asarray(jh), TOL["float32"])


def test_microbatches_and_remat_agree():
    """Two microbatches give the mean of their halves' gradients in
    float32; remat recomputes the same forward."""
    _check_microbatches_and_remat("gemma3-1b")


def test_mamba_microbatches_and_remat_agree():
    """The same through Mamba-1 blocks: remat runs the scan's forward
    twice, and the backward reads the recomputed round states."""
    _check_microbatches_and_remat(MAMBA)


def _check_microbatches_and_remat(arch):
    cfg, _, _, p = _reference("float32", arch)
    batch = _as_torch(_batch(cfg, b=4))
    l1, _, g1 = grad_fn(cfg, TrainConfig(), p, batch)
    l2, m2, g2 = grad_fn(cfg, TrainConfig(n_microbatches=2), p, batch)
    l3, _, g3 = grad_fn(cfg, TrainConfig(remat=False), p, batch)
    _close(l2, l1.numpy(), 1e-6)
    assert set(m2) == {"loss"}
    for a, b, c in zip(tree_leaves(g1), tree_leaves(g2), tree_leaves(g3)):
        assert b.dtype == torch.float32
        _close(b, a.numpy(), TOL["float32"])
        assert torch.equal(a, c)
    with pytest.raises(ValueError, match="not divisible"):
        grad_fn(cfg, TrainConfig(n_microbatches=3), p, batch)


def test_train_step_matches_reference():
    """One step from the same float32 parameters. A large ``eps`` keeps
    the update a smooth function of the gradient (at the default 1e-8,
    ``m / sqrt(v)`` is the sign of a first-step gradient, which float32
    noise flips where the gradient is near zero)."""
    _check_train_step("gemma3-1b")


def test_mamba_train_step_matches_reference():
    _check_train_step(MAMBA)


def _check_train_step(arch):
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
    cfg, jcfg, jp, p = _reference("float32", arch)
    batch = _batch(cfg)
    jstep = jax.jit(jax_train_step(jcfg, JTrain(opt=JOpt(**opt))))
    jnew, jstate, jm = jstep(jp, jax_opt_state(jp),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(**opt)))
    before = [t.clone() for t in tree_leaves(p)]
    state = init_opt_state(p)
    new, new_state, m = step(p, state, _as_torch(batch))
    # functional: the inputs are untouched
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(p)))
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    for key in ("loss", "grad_norm", "lr"):
        _close(m[key], np.float32(jm[key]), TOL["float32"])
    for name, got, want in _pairs(cfg, new, jnew):
        _close(got, want, TOL["float32"])
    for name, got, want in _pairs(cfg, new_state["m"], jstate["m"]):
        _close(got, want, TOL["float32"])


def test_train_step_compress_grads_carries_error_feedback():
    """Two steps with ``compress_grads``: the error feedback rides in the
    optimizer state under ``"ef"``, and each step equals ``grad_fn`` plus
    ``adamw_update`` given that state by hand (exactly: the same
    operations); the compressed update differs from the plain one. A
    state without ``"ef"`` raises rather than train uncompressed."""
    cfg = get_config("gemma3-1b").reduced()
    tcfg = TrainConfig(opt=OptimizerConfig(warmup_steps=1,
                                           compress_grads=True))
    p, state = init_train_state(cfg, seed=0, device="cpu",
                                compress_grads=True)
    step = make_train_step(cfg, tcfg)
    hand_p, hand_s, hand_ef = p, init_opt_state(p), init_compress_state(p)
    for seed in (0, 1):
        batch = _as_torch(_batch(cfg, seed=seed, s=24))
        p, state, _ = step(p, state, batch)
        _, _, grads = grad_fn(cfg, tcfg, hand_p, batch)
        hand_p, hand_s, hand_ef, _ = adamw_update(tcfg.opt, grads, hand_p,
                                                  hand_s, hand_ef)
        for got, want in zip(tree_leaves((p, state)),
                             tree_leaves((hand_p, {**hand_s, "ef": hand_ef}))):
            assert torch.equal(got, want)
    assert any(bool(t.abs().max() > 0) for t in tree_leaves(state["ef"]))
    plain_p, _, _ = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(
        warmup_steps=1)))(*init_train_state(cfg, seed=0, device="cpu"),
                          _as_torch(_batch(cfg, seed=0, s=24)))
    first_p, _, _ = step(*init_train_state(cfg, seed=0, device="cpu",
                                           compress_grads=True),
                         _as_torch(_batch(cfg, seed=0, s=24)))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(first_p),
                                                      tree_leaves(plain_p)))
    with pytest.raises(ValueError, match="compress_grads"):
        step(*init_train_state(cfg, seed=0, device="cpu"),
             _as_torch(_batch(cfg, s=24)))


def test_launcher_compress_grads_checkpoints_the_error_feedback(capsys,
                                                                 tmp_path):
    launch_train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                       "--steps", "2", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "2", "--compress-grads"])
    assert np.isfinite(float(capsys.readouterr().out.split(
        "final loss ")[1].split(";")[0]))
    like = init_train_state(get_config("gemma3-1b").reduced(), seed=0,
                            device="cpu", compress_grads=True)
    (params, state), _ = restore_checkpoint(str(tmp_path), 2, like=like,
                                            device="cpu")
    assert int(state["step"]) == 2
    assert len(tree_leaves(state["ef"])) == len(tree_leaves(params))
    assert any(bool(t.abs().max() > 0) for t in tree_leaves(state["ef"]))


@pytest.mark.parametrize("arch", sorted(arch_ids()))
def test_one_step_is_finite_for_every_config(arch):
    """Every config takes one finite step, the encoder-decoder (24
    frames, 3 decoder tokens) and the VLM front end (8 patch embeddings)
    on the launcher's family batch among them."""
    cfg = get_config(arch).reduced()
    p = M.init_params(cfg, seed=0, device="cpu")
    tcfg = TrainConfig(opt=OptimizerConfig(warmup_steps=1))
    step = make_train_step(cfg, tcfg)
    batch = launch_train.family_batch(cfg, _batch(cfg, s=24), device="cpu")
    new, state, m = step(p, init_opt_state(p), batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for t in tree_leaves(new) + tree_leaves(state["m"]):
        assert bool(torch.isfinite(t.float()).all())
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                      tree_leaves(p)))


def test_mamba_train_mode_reaches_selective_scan_fn(monkeypatch):
    """A train-mode Mamba-1 block runs its scan through SelectiveScanFn,
    once a layer (no remat) with the backend it was given; prefill does
    not."""
    cfg, _, _, p = _reference("float32", MAMBA)
    seen = []
    apply = SelectiveScanFn.apply

    def spy(*args):
        seen.append(args[-1])
        return apply(*args)

    monkeypatch.setattr(SelectiveScanFn, "apply", spy)
    batch = _as_torch(_batch(cfg))
    grad_fn(cfg, TrainConfig(remat=False), p, batch, backend="plain")
    assert seen == ["plain"] * cfg.n_layers
    M.prefill(cfg, p, batch["tokens"],
              caches=M.init_caches(cfg, B, S, device="cpu"))
    assert len(seen) == cfg.n_layers


def test_mamba_train_on_cpu_tensors_with_cuda_backend_raises():
    """backend="cuda" on CPU tensors raises in the scan's forward rather
    than fall back to the plain version."""
    cfg, _, _, p = _reference("float32", MAMBA)
    with pytest.raises(ValueError, match="CUDA tensors"):
        grad_fn(cfg, TrainConfig(), p, _as_torch(_batch(cfg)),
                backend="cuda")


def test_launcher_loss_falls_on_the_cpu(capsys, tmp_path):
    launch_train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                       "--steps", "20", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "10"])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    final = float(out.split("final loss ")[1].split(";")[0])
    assert len(losses) == 10 and final < losses[0]
    assert "device=cpu" in out and "inter-pod=" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000010", "step_00000020"]


def test_launcher_runs_on_the_card_by_default(tmp_path):
    """Without ``--device cpu`` the launcher asks for the card and, with
    none, raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would train on it")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        launch_train.main(["--arch", "gemma3-1b", "--reduced", "--steps",
                           "1", "--ckpt-dir", str(tmp_path)])
