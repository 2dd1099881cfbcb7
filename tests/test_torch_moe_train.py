"""Training the MoE configs in the port against the reference, on the CPU
(the plain versions of the kernels), at the reduced granite-moe-1b-a400m
(4 experts, top 2) and arctic-480b (dense residual):

* the microbatch loss with the auxiliary load-balancing probe
  (``micro_loss``: the NLL plus ``moe_aux_weight`` times group 0's ``b0``
  router loss on the embedded batch), ``moe_aux`` itself, and every
  gradient leaf, the routers included, against ``jax.value_and_grad`` of
  the reference's ``micro_loss`` on ``params_from_jax`` weights: float32 at
  1e-5 and bf16 at 2e-2, each relative to the leaf's largest entry
  (``tests/test_torch_train.py``'s tolerances); a bf16 leaf that a
  routing flip moves in the reference's own bf16 run is held to the
  reference's float32 leaf instead (see the test);
* one whole ``make_train_step`` step against the reference's;
* the gradients are bit-equal over two calls (no atomics meet two nonzero
  values in the dispatch's backward);
* a MoE training state round-trips through a checkpoint bit for bit;
* the launchers take ``--arch granite-moe-1b-a400m`` unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.optimizer import OptimizerConfig as JOpt
from repro.train.optimizer import init_opt_state as jax_opt_state
from repro.train.train_step import TrainConfig as JTrain
from repro.train.train_step import make_train_step as jax_train_step
from repro.train.train_step import micro_loss as jax_micro_loss
from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.train.optimizer import (OptimizerConfig, init_opt_state,
                                         tree_leaves)
from repro_torch.train.train_step import (TrainConfig, grad_fn,
                                          init_train_state, make_train_step)
from test_torch_train import TOL, _as_torch, _batch, _close, _pairs, _reference

GRANITE, ARCTIC = "granite-moe-1b-a400m", "arctic-480b"


def _micro_value_and_grad(jcfg, jp, batch):
    return jax.value_and_grad(
        lambda q: jax_micro_loss(jcfg, JTrain(), q,
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()}), has_aux=True)(jp)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float32) - b).max()
                 / max(float(np.abs(b).max()), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_moe_loss_and_gradients_match_reference(arch, dtype):
    """In bf16 a token near a routing tie may take another expert in the
    reference's run than in its own float32 run (at the reduced granite
    config, one token of layer 0 moves that layer's expert leaves by ~20%
    of their largest entry). A port bf16 leaf off the reference's bf16
    leaf passes only where that leaf lies more than the tolerance from the
    reference's float32 leaf, and then the port's must lie within the
    tolerance of the float32 one."""
    cfg, jcfg, jp, p = _reference(dtype, arch)
    batch = _batch(cfg)
    (jl, jm), jg = _micro_value_and_grad(jcfg, jp, batch)
    loss, metrics, grads = grad_fn(cfg, TrainConfig(), p, _as_torch(batch))
    assert set(metrics) == {"loss", "perplexity", "moe_aux"}
    _close(loss, np.float32(jl), TOL[dtype])
    _close(metrics["loss"], np.float32(jm["loss"]), TOL[dtype])
    _close(metrics["moe_aux"], np.float32(jm["moe_aux"]), TOL[dtype])
    assert float(metrics["moe_aux"]) > 0
    pairs = _pairs(cfg, grads, jg)
    assert len(pairs) == len(tree_leaves(p))
    routers = [name for name, _, _ in pairs if name.endswith("/router")]
    assert len(routers) == cfg.n_layers
    if dtype == "float32":
        for name, got, want in pairs:
            _close(got, want, TOL[dtype])
        return
    _, _, jp32, _ = _reference("float32", arch)
    _, jg32 = _micro_value_and_grad(jcfg, jp32, batch)
    for (name, got, want), (_, _, want32) in zip(pairs,
                                                 _pairs(cfg, grads, jg32)):
        try:
            _close(got, want, TOL[dtype])
        except AssertionError:
            assert _rel(want, want32) > TOL[dtype], name
            _close(got, want32, TOL[dtype])


def test_moe_aux_weight_scales_the_probe():
    """The loss is the NLL plus ``moe_aux_weight`` times ``moe_aux``."""
    cfg, _, _, p = _reference("float32", GRANITE)
    batch = _as_torch(_batch(cfg))
    loss, m, _ = grad_fn(cfg, TrainConfig(moe_aux_weight=0.5), p, batch)
    _close(loss, np.float32(m["loss"] + 0.5 * m["moe_aux"]), 1e-6)
    loss0, m0, _ = grad_fn(cfg, TrainConfig(moe_aux_weight=0.0), p, batch)
    _close(loss0, m0["loss"].numpy(), 1e-7)


def test_moe_train_step_matches_reference():
    """One step from the same float32 parameters (eps as in
    ``test_torch_train.py``: the update a smooth function of the
    gradient)."""
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
    cfg, jcfg, jp, p = _reference("float32", GRANITE)
    batch = _batch(cfg)
    jstep = jax.jit(jax_train_step(jcfg, JTrain(opt=JOpt(**opt))))
    jnew, jstate, jm = jstep(jp, jax_opt_state(jp),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(**opt)))
    new, new_state, m = step(p, init_opt_state(p), _as_torch(batch))
    for key in ("loss", "grad_norm", "lr", "moe_aux"):
        _close(m[key], np.float32(jm[key]), TOL["float32"])
    for _, got, want in _pairs(cfg, new, jnew):
        _close(got, want, TOL["float32"])
    for _, got, want in _pairs(cfg, new_state["m"], jstate["m"]):
        _close(got, want, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gradients_are_deterministic(dtype):
    cfg, _, _, p = _reference(dtype, GRANITE)
    batch = _as_torch(_batch(cfg))
    first = grad_fn(cfg, TrainConfig(), p, batch)
    second = grad_fn(cfg, TrainConfig(), p, batch)
    assert torch.equal(first[0], second[0])
    for a, b in zip(tree_leaves(first[2]), tree_leaves(second[2])):
        assert torch.equal(a, b)


def test_moe_checkpoint_round_trip(tmp_path):
    """Parameters (float32 routers, bf16 experts) and the optimizer state
    of a MoE config after one step, saved and restored bit for bit."""
    cfg = get_config(GRANITE).reduced()
    params, state = init_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(
        warmup_steps=1)))
    params, state, _ = step(params, state, _as_torch(_batch(cfg, s=24)))
    tree = (params, state)
    save_checkpoint(tree, str(tmp_path), 1, n_shards=3)
    out, _ = restore_checkpoint(str(tmp_path), 1, like=tree, device="cpu")
    got, want = tree_leaves(out), tree_leaves(tree)
    assert len(got) == len(want)
    assert params["groups"][0]["b0"]["moe"]["router"].dtype == torch.float32
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)


def test_moe_launchers_take_the_arch(capsys, tmp_path):
    launch_train.main(["--arch", GRANITE, "--reduced", "--device", "cpu",
                       "--steps", "3", "--ckpt-every", "10",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert np.isfinite(float(out.split("final loss ")[1].split(";")[0]))
    launch_serve.main(["--arch", GRANITE, "--reduced", "--device", "cpu",
                       "--prompt-len", "24", "--new-tokens", "3",
                       "--requests", "2"])
    out = capsys.readouterr().out
    assert out.count("completion") == 2 and '"arch": "granite' in out
