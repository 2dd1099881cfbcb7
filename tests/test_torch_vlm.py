"""The port's VLM front end (internvl2-2b) against the reference's.

The front end is a stub in both packages: patch embeddings (B, n, D),
cast to the activation dtype, overwrite the first n token embeddings; the
rest is the decoder-only LM. At internvl2-2b's ``reduced()`` config (2
layers, d 64, 4 heads on 2, 8 vision positions), the reference's weights
carried by ``params_from_jax`` with the norms moved off zero, inputs from
a numpy seed: ``prefill`` with and without ``vision_embeds`` and the
decode steps after it, ``train_logits`` and ``loss_fn`` with them, in
float32 at 2e-5 and bf16 at 2e-2 (atol and rtol). The engine serves the
config text-only, as the reference's (``tests/test_torch_serve.py``
holds it with the other configs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import model as M
from test_torch_encdec import _jax, _np, _perturbed, _tol, _torch

ARCH = "internvl2-2b"
B, S, NEW = 2, 20, 3
DTYPES = ["float32", "bfloat16"]


def _reference(dtype):
    cfg, jcfg = get_config(ARCH).reduced(), jax_config(ARCH).reduced()
    jp = _perturbed(jcfg, JM.init_params(jcfg, jax.random.PRNGKey(3)))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return cfg, jcfg, jp, M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))


def _inputs(cfg, seed=11):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    vision = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)).astype(
        np.float32)
    return tokens, vision


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_vision", [True, False])
def test_prefill_and_decode_match_reference(with_vision, dtype):
    """Prefill (with the patch embeddings, or text only) and ``NEW``
    decode steps after it, teacher-forced along the reference's greedy
    tokens."""
    cfg, jcfg, jp, p = _reference(dtype)
    assert cfg.vision_tokens == 8
    tokens, vision = _inputs(cfg)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32)}
    kw = {}
    if with_vision:
        jb["vision_embeds"] = jnp.asarray(vision)
        kw["vision_embeds"] = torch.tensor(vision)
    jl, jc = JM.prefill(jcfg, jp, jb)
    caches = M.init_caches(cfg, B, S + NEW, device="cpu",
                           dtype=p["embed"].dtype)
    logits, caches = M.prefill(cfg, p, torch.tensor(tokens), caches=caches,
                               **kw)
    jc = jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0), (0, NEW)] + [(0, 0)] * (a.ndim - 2)), jc)
    for i in range(NEW + 1):
        np.testing.assert_allclose(_np(logits), _np(jl), **_tol(dtype),
                                   err_msg=f"step {i}")
        if i == NEW:
            break
        tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, tok, jnp.int32(S + i))
        logits, caches = M.decode_step(cfg, p, caches,
                                       torch.tensor(np.asarray(tok)), S + i)


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_logits_and_loss_match_reference(dtype):
    cfg, jcfg, jp, p = _reference(dtype)
    tokens, vision = _inputs(cfg, seed=12)
    labels = np.random.default_rng(13).integers(0, cfg.vocab, (B, S))
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32),
          "vision_embeds": _jax(vision, dtype)}
    tb = {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels),
          "vision_embeds": _torch(vision, dtype)}
    np.testing.assert_allclose(_np(M.train_logits(cfg, p, tb)),
                               _np(JM.train_logits(jcfg, jp, jb)),
                               **_tol(dtype))
    loss, _ = M.loss_fn(cfg, p, tb)
    np.testing.assert_allclose(float(loss), float(JM.loss_fn(jcfg, jp, jb)[0]),
                               **_tol(dtype))


def test_vision_embeds_change_the_logits():
    """The patch embeddings reach the logits at the last position (through
    attention), and only positions [0, n) of the embeddings change."""
    cfg, _, _, p = _reference("float32")
    tokens, vision = _inputs(cfg)
    x = M._embed_tokens(cfg, p, torch.tensor(tokens), torch.tensor(vision))
    plain = M._embed_tokens(cfg, p, torch.tensor(tokens))
    n = cfg.vision_tokens
    assert torch.equal(x[:, :n], torch.tensor(vision))
    assert torch.equal(x[:, n:], plain[:, n:])
    runs = []
    for kw in ({}, {"vision_embeds": torch.tensor(vision)}):
        caches = M.init_caches(cfg, B, S, device="cpu", dtype=torch.float32)
        runs.append(M.prefill(cfg, p, torch.tensor(tokens), caches=caches,
                              **kw)[0])
    assert float((runs[0] - runs[1]).abs().max()) > 1e-3


def test_vision_embeds_are_checked():
    cfg, _, _, p = _reference("float32")
    tokens, vision = _inputs(cfg)
    caches = M.init_caches(cfg, B, S, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="do not fit"):
        M.prefill(cfg, p, torch.tensor(tokens), caches=caches,
                  vision_embeds=torch.tensor(vision[:, :, :8]))
    lm = get_config("granite-3-8b").reduced()
    with pytest.raises(ValueError, match="no vision front end"):
        M.prefill(lm, M.init_params(lm, device="cpu"), torch.tensor(tokens),
                  caches=M.init_caches(lm, B, S, device="cpu"),
                  vision_embeds=torch.tensor(vision))
