"""The port's encoder-decoder (whisper) against the reference's.

At whisper-large-v3's ``reduced()`` config (2 + 2 layers, d 64, 4 heads of
16, frames 64, so 8 decoder positions), the reference's weights carried by
``params_from_jax`` with every LayerNorm and bias moved off its init value
(so a dropped or misplaced term shows; ``wk`` has no bias in either
package), inputs from a numpy seed: ``layer_norm``, ``gelu_mlp``,
non-causal attention at Sq = Skv and Sq != Skv, ``encode``,
``decode_train``, ``precompute_cross_caches``, ``decode_step``,
``train_logits``, ``loss_fn``, and ``prefill`` with the greedy decode
after it, in float32 at 2e-5 and in bf16 at 2e-2 (atol and rtol, as
``tests/test_torch_serve.py``). Both packages keep the decoder caches in
bf16 in a float32 run. An LM block with ``act="gelu"`` is held the same
way, and ``count_params_analytic`` equals the reference's for both new
configs. The CUDA kernel on the non-causal mask is held against its plain
version on the card by ``tests/test_torch_model_kernels.py`` (``-m gpu``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import encdec as JE
from repro.models import mlp as jax_mlp
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import attention, encdec
from repro_torch.models import model as M
from repro_torch.models.common import layer_norm
from repro_torch.models.mlp import gelu_mlp
from repro_torch.serve.engine import (ServeEngine, generate_encdec,
                                      greedy_agreement)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCH = "whisper-large-v3"
B, S_ENC = 2, 64
S_DEC = S_ENC // JE.DEC_RATIO          # 8 decoder positions
MAX_ENC, MAX_DEC = 128, 32
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(atol=TOL[dtype], rtol=TOL[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _bf16(a) -> torch.Tensor:
    """A reference bf16 array as a torch tensor, bit for bit."""
    a = np.array(a, order="C")
    return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)


def _perturbed(jcfg, params, seed=0):
    """Every LayerNorm weight and bias and every bias leaf moved off its
    init value by N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        keys = [getattr(k, "key", None) for k in path]
        if (any(str(k).startswith("ln") or "norm" in str(k) for k in keys)
                or keys[-1] in ("bq", "bv", "bo", "b1", "b2")):
            noise = rng.standard_normal(a.shape).astype(np.float32)
            return (a.astype(jnp.float32) + 0.1 * noise).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _reference(dtype, arch=ARCH):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    kw = dict(max_enc=MAX_ENC, max_dec=MAX_DEC) if jcfg.enc_dec else {}
    jp = _perturbed(jcfg, JM.init_params(jcfg, jax.random.PRNGKey(1), **kw))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return cfg, jcfg, jp, M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))


def _frames(seed=3, S=S_ENC, D=64):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_reference(dtype):
    """Float32 arithmetic, eps 1e-5, the population variance (what
    ``torch.var``'s default, n - 1, would get wrong by ~1/D)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    w, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(
        64).astype(np.float32)
    got = layer_norm(_torch(x, dtype), torch.tensor(w), torch.tensor(b))
    want = jax_common.layer_norm(_jax(x, dtype), jnp.asarray(w),
                                 jnp.asarray(b))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    if dtype == "float32":
        xt, wt, bt = torch.tensor(x), torch.tensor(w), torch.tensor(b)
        sample = (xt - xt.mean(-1, keepdim=True)) * torch.rsqrt(
            xt.var(-1, keepdim=True) + 1e-5) * wt + bt
        assert not np.allclose(sample.numpy(), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_reference(dtype):
    """``gelu(x @ w1 + b1) @ w2 + b2`` with bf16-stored biases, the tanh
    GELU."""
    rng = np.random.default_rng(9)
    shapes = {"w1": (16, 32), "b1": (32,), "w2": (32, 16), "b2": (16,)}
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.3
         for k, s in shapes.items()}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    got = gelu_mlp({k: _torch(v, dtype) for k, v in w.items()},
                   _torch(x, dtype))
    want = jax_mlp.gelu_mlp({k: _jax(v, dtype) for k, v in w.items()},
                            _jax(x, dtype))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Skv", [(64, 64), (8, 64), (70, 100)])
def test_noncausal_attention_matches_reference(Sq, Skv, dtype):
    """``attention_blockwise(causal=False)``: the encoder's Sq = Skv, the
    cross-attention's Sq != Skv, and lengths past a 64-key tile."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((B, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, 4, 16)).astype(np.float32)
            for _ in range(2))
    got = attention.attention_blockwise(
        *(_torch(a, dtype) for a in (q, k, v)), causal=False)
    want = jax_attention.attention_blockwise(
        *(_jax(a, dtype) for a in (q, k, v)), causal=False)
    assert got.shape == (B, Sq, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    causal = attention.attention_blockwise(
        *(_torch(a, dtype) for a in (q, k, v)))
    assert not np.allclose(_np(causal), _np(want), **_tol(dtype))


def test_params_from_jax_is_bit_exact():
    """Layer i of a stacked ``enc_blocks`` / ``dec_blocks`` leaf is row i;
    bf16 leaves through their bits."""
    cfg, _, jp, p = _reference("bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    assert set(p) == set(M.ENCDEC_KEYS)
    assert len(p["enc_blocks"]) == cfg.n_encoder_layers
    assert len(p["dec_blocks"]) == cfg.n_layers

    def same(t, a):
        if a.dtype.name == "bfloat16":
            assert torch.equal(t.view(torch.int16), _bf16(a).view(torch.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)

    for key in ("enc_pos", "embed", "dec_pos"):
        same(p[key], tree[key])
    for stack in ("enc_blocks", "dec_blocks"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree[stack]):
            for i in range(leaf.shape[0]):
                t = p[stack][i]
                for key in path:
                    t = t[key.key]
                same(t, leaf[i])
    assert "bk" not in p["dec_blocks"][0]["cross_attn"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_decode_train_match_reference(dtype):
    cfg, jcfg, jp, p = _reference(dtype)
    frames = _frames()
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (B, S_DEC))
    enc_j = JE.encode(jcfg, jp, _jax(frames, dtype))
    enc_t = encdec.encode(cfg, p, _torch(frames, dtype))
    assert enc_t.shape == (B, S_ENC, cfg.d_model)
    np.testing.assert_allclose(_np(enc_t), _np(enc_j), **_tol(dtype))
    # the decoder on the same encoder output (the reference's)
    enc = _torch(_np(enc_j), dtype)
    got = encdec.decode_train(cfg, p, enc, torch.tensor(tokens))
    want = JE.decode_train(jcfg, jp, enc_j, jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_caches_and_decode_step_match_reference(dtype):
    """``precompute_cross_caches`` (K without a bias, V with one, bf16),
    then ``decode_step`` at every decoder position from the same caches:
    the self K/V written at ``pos`` (bf16) and the logits."""
    cfg, jcfg, jp, p = _reference(dtype)
    enc_j = JE.encode(jcfg, jp, _jax(_frames(), dtype))
    ck_j, cv_j = JE.precompute_cross_caches(jcfg, jp, enc_j)
    ks, vs = encdec.precompute_cross_caches(cfg, p, _torch(_np(enc_j), dtype))
    for got, want in ((ks, ck_j), (vs, cv_j)):
        assert len(got) == cfg.n_layers
        for i, t in enumerate(got):
            assert t.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(t), _np(want[i]),
                                       **_tol("bfloat16"))
    jc = JE.init_decoder_caches(jcfg, B, S_DEC, S_ENC)
    jc = dict(jc, cross_k=ck_j, cross_v=cv_j)
    caches = encdec.init_decoder_caches(cfg, B, S_DEC, S_ENC, device="cpu")
    caches["cross_k"] = [_bf16(a) for a in np.asarray(ck_j)]
    caches["cross_v"] = [_bf16(a) for a in np.asarray(cv_j)]
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (B, S_DEC))
    for pos in range(S_DEC):
        tok = tokens[:, pos:pos + 1]
        jl, jc = JE.decode_step(jcfg, jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(pos))
        logits, caches = encdec.decode_step(cfg, p, caches, torch.tensor(tok),
                                            pos)
        assert logits.dtype == torch.float32 and logits.shape == (
            B, 1, cfg.vocab)
        np.testing.assert_allclose(_np(logits), _np(jl), **_tol(dtype),
                                   err_msg=f"pos {pos}")
        for name in ("self_k", "self_v"):
            assert caches[name][0].dtype == torch.bfloat16
            for i in range(cfg.n_layers):
                np.testing.assert_allclose(
                    _np(caches[name][i][:, :pos + 1]),
                    _np(jc[name][i][:, :pos + 1]), **_tol("bfloat16"),
                    err_msg=f"{name} layer {i} pos {pos}")
        # follow the reference's bf16 rounding of the new K/V
        for name in ("self_k", "self_v"):
            caches[name] = [_bf16(a) for a in np.asarray(jc[name])]


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_logits_and_loss_match_reference(dtype):
    cfg, jcfg, jp, p = _reference(dtype)
    rng = np.random.default_rng(7)
    frames = _frames()
    tokens = rng.integers(0, cfg.vocab, (B, S_DEC))
    labels = rng.integers(0, cfg.vocab, (B, S_DEC))
    jb = {"frames": _jax(frames, dtype),
          "tokens": jnp.asarray(tokens, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"frames": _torch(frames, dtype), "tokens": torch.tensor(tokens),
          "labels": torch.tensor(labels)}
    got = M.train_logits(cfg, p, tb)
    assert got.dtype == torch.float32 and got.shape == (B, S_DEC, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(JM.train_logits(jcfg, jp, jb)),
                               **_tol(dtype))
    loss, metrics = M.loss_fn(cfg, p, tb)
    jloss, _ = JM.loss_fn(jcfg, jp, jb)
    np.testing.assert_allclose(float(loss), float(jloss), **_tol(dtype))
    assert float(metrics["perplexity"]) == pytest.approx(
        float(np.exp(float(loss))), rel=1e-6)
    if dtype == "float32":
        # remat recomputes the same blocks; the plain route is differentiable
        leaves = M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))
        for block in leaves["dec_blocks"]:
            block["cross_attn"]["wq"].requires_grad_()
        rl, _ = M.loss_fn(cfg, leaves, tb, remat=True)
        assert float(rl.detach()) == pytest.approx(float(loss), rel=1e-6)
        rl.backward()
        g = leaves["dec_blocks"][0]["cross_attn"]["wq"].grad
        assert g is not None and bool(torch.isfinite(g).all()) and float(
            g.abs().max()) > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_greedy_decode_match_reference(dtype):
    """``M.prefill(frames=)`` (encoder, cross caches, the BOS step) and a
    decode step at each of the 7 later decoder positions, teacher-forced
    along the reference's greedy tokens: the logits of all 8 steps; then
    ``generate_encdec``'s 7 greedy tokens against the reference's by
    ``greedy_agreement``, its logits up to a row's first differing
    token."""
    cfg, jcfg, jp, p = _reference(dtype)
    frames = _frames()
    new = S_DEC - 1
    jl, jc = JM.prefill(jcfg, jp, {"frames": _jax(frames, dtype)})
    caches = M.init_caches(cfg, B, S_ENC, device="cpu")
    logits, caches = M.prefill(cfg, p, caches=caches,
                               frames=_torch(frames, dtype))
    want_tokens, ref_logits = [], []
    for pos in range(1, S_DEC + 1):
        np.testing.assert_allclose(_np(logits), _np(jl), **_tol(dtype),
                                   err_msg=f"step {pos - 1}")
        tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        want_tokens.append(np.asarray(tok)[:, 0])
        ref_logits.append(_np(jl)[:, -1])
        if pos == S_DEC:
            break
        jl, jc = JM.decode_step(jcfg, jp, jc, tok, jnp.int32(pos))
        logits, caches = M.decode_step(cfg, p, caches,
                                       torch.tensor(np.asarray(tok)), pos)
    want_tokens = np.stack(want_tokens[:new], 1)
    ref_logits = torch.tensor(np.stack(ref_logits[:new], 1))
    r = generate_encdec(cfg, p, _torch(frames, dtype), new)
    assert r["tokens"].shape == (B, new) and r["logits"].shape == (
        B, new, cfg.vocab)
    for row in range(B):
        differ = np.flatnonzero(r["tokens"][row] != want_tokens[row])
        upto = differ[0] + 1 if differ.size else new
        np.testing.assert_allclose(_np(r["logits"][row, :upto]),
                                   ref_logits[row, :upto].numpy(),
                                   **_tol(dtype), err_msg=f"row {row}")
    assert greedy_agreement(r["tokens"], want_tokens, ref_logits,
                            **_tol(dtype)) > 0


def test_serving_entry_points_check_their_inputs():
    """The engine serves token prompts and refuses the encoder-decoder;
    the encoder-decoder's prefill takes frames, not tokens, into cross
    caches of exactly S_enc slots, all bf16."""
    cfg, _, _, p = _reference("float32")
    frames = _torch(_frames(), "float32")
    with pytest.raises(ValueError, match="generate_encdec"):
        ServeEngine(cfg, p, max_len=S_ENC)
    lm = get_config("gemma3-1b").reduced()
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        generate_encdec(lm, M.init_params(lm, device="cpu"), frames, 2)
    with pytest.raises(ValueError, match="decoder positions"):
        generate_encdec(cfg, p, frames, S_DEC)
    with pytest.raises(ValueError, match="bf16"):
        M.init_caches(cfg, B, S_ENC, device="cpu", dtype=torch.float32)
    caches = M.init_caches(cfg, B, S_ENC, device="cpu")
    assert [len(caches[k]) for k in encdec.CACHE_KEYS] == [cfg.n_layers] * 4
    assert caches["self_k"][0].shape == (B, S_DEC, cfg.n_heads, 16)
    assert caches["cross_k"][0].shape == (B, S_ENC, cfg.n_heads, 16)
    with pytest.raises(ValueError, match="no tokens"):
        M.prefill(cfg, p, torch.zeros((B, 4), dtype=torch.int64),
                  caches=caches, frames=frames)
    with pytest.raises(ValueError, match="S_enc"):
        M.prefill(cfg, p, caches=M.init_caches(cfg, B, 2 * S_ENC,
                                               device="cpu"), frames=frames)
    with pytest.raises(ValueError, match="not frames"):
        M.prefill(lm, M.init_params(lm, device="cpu"), caches=caches,
                  frames=frames)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_lm_block_matches_reference(dtype):
    """A decoder-only LM whose blocks take the plain GELU MLP
    (``act="gelu"``, biases moved off zero): prefill and two decode
    steps."""
    base = dataclasses.replace(get_config("granite-3-8b").reduced(),
                               act="gelu")
    jcfg = dataclasses.replace(jax_config("granite-3-8b").reduced(),
                               act="gelu")
    jp = _perturbed(jcfg, JM.init_params(jcfg, jax.random.PRNGKey(2)))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    p = M.params_from_jax(base, jax.tree.map(np.asarray, jp))
    assert set(p["groups"][0]["b0"]["mlp"]) == {"w1", "b1", "w2", "b2"}
    S = 12
    tokens = np.random.default_rng(8).integers(0, base.vocab, (B, S))
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    caches = M.init_caches(base, B, S + 2, device="cpu",
                           dtype=p["embed"].dtype)
    logits, caches = M.prefill(base, p, torch.tensor(tokens), caches=caches)
    np.testing.assert_allclose(_np(logits), _np(jl), **_tol(dtype))
    jc = jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0), (0, 2)] + [(0, 0)] * (a.ndim - 2)), jc)
    for i in range(2):
        tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        jl, jc = JM.decode_step(jcfg, jp, jc, tok, jnp.int32(S + i))
        logits, caches = M.decode_step(base, p, caches,
                                       torch.tensor(np.asarray(tok)), S + i)
        np.testing.assert_allclose(_np(logits), _np(jl), **_tol(dtype),
                                   err_msg=f"decode {i}")


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-2b"])
def test_param_counts_match_reference(arch):
    """Full and reduced, ``active_only`` both ways; the reference's counts
    (the encoder-decoder's are its approximate analytic terms)."""
    for reduce in (False, True):
        cfg, jcfg = get_config(arch), jax_config(arch)
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for active in (False, True):
            assert M.count_params_analytic(cfg, active) == \
                JM.count_params_analytic(jcfg, active)
    assert get_config(arch).param_count() == {
        "whisper-large-v3": 1_535_215_360,
        "internvl2-2b": 1_699_598_336}[arch]
