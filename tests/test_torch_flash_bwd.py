"""The flash attention backward's plain version and the differentiable op
(``repro_torch.kernels.flash_attention_bwd``,
``repro_torch.kernels.flash_attention.FlashAttentionFn``) on the CPU.

* ``flash_attention_bwd_ref`` is the exact gradient of
  ``flash_attention_ref``: against ``torch.autograd`` of it in float64 at
  1e-10 (atol and rtol);
* against ``jax.grad`` of the reference's ``attention_blockwise`` (the jnp
  stand-in the reference trains through) in float32 at 2e-5, causal,
  windowed, soft-capped and GQA, through ``FlashAttentionFn`` in the
  model's (B, S, heads, hd) layout;
* ``torch.autograd.gradcheck`` of ``FlashAttentionFn`` in float64;
* in bf16 the plain backward rounds P and dS where the CUDA kernel does
  (its tensor-core operands): held here to the float32 gradient at the
  bf16 tolerance 2e-2 (relative to each gradient's largest entry).

The CUDA kernel itself is held to this plain version on the card by
``tests/test_torch_model_kernels.py`` (``-m gpu``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_blockwise as jax_blockwise
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref,
                                                 flash_attention_train)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_ref

IDS = "B,H,KV,S,hd,window,softcap"
CASES = [
    (2, 4, 2, 24, 16, None, None),      # causal, GQA G 2
    (1, 4, 1, 40, 16, 8, None),         # windowed, G 4
    (2, 2, 2, 17, 32, None, 2.0),       # soft-capped
    (1, 8, 1, 33, 16, 12, 3.0),         # all three, G 8
]


def _draw(seed, B, H, KV, S, hd, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


@pytest.mark.parametrize(IDS, CASES)
def test_bwd_ref_is_the_exact_gradient_float64(B, H, KV, S, hd, window,
                                               softcap):
    q, k, v, do = (torch.tensor(a).transpose(1, 2)
                   for a in _draw(0, B, H, KV, S, hd))
    kw = dict(causal=True, window=window, softcap=softcap)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_ref(*leaves, **kw).backward(do)
    o, lse, wide = flash_attention_lse_ref(q, k, v, **kw)
    assert wide is o
    assert lse.dtype == torch.float64
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float64 and g.shape == leaf.shape
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-10,
                                   rtol=1e-10)


@pytest.mark.parametrize(IDS, CASES)
def test_gradients_match_jax_grad_of_the_reference(B, H, KV, S, hd, window,
                                                   softcap):
    """float32, the model's layout: the port's op against jax.grad of the
    reference's attention_blockwise, small chunks so its scan crosses
    several key blocks."""
    q, k, v, w = _draw(1, B, H, KV, S, hd, np.float32)

    def jloss(q, k, v):
        o = jax_blockwise(q, k, v, causal=True, window=window,
                          softcap=softcap, q_chunk=8, kv_chunk=8)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention_train(*(t.transpose(1, 2) for t in leaves),
                              causal=True, window=window, softcap=softcap)
    (o.transpose(1, 2) * torch.tensor(w)).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window,softcap", [(None, None), (3, None),
                                            (None, 1.5)])
def test_flash_attention_fn_gradcheck(window, softcap):
    rng = np.random.default_rng(2)
    B, H, KV, S, hd = 1, 4, 2, 7, 8
    args = [torch.tensor(rng.standard_normal(s)).requires_grad_()
            for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]
    fn = lambda q, k, v: FlashAttentionFn.apply(  # noqa: E731
        q, k, v, True, window, softcap, 0, None, "auto")
    assert torch.autograd.gradcheck(fn, args)


def test_non_tensor_arguments_get_no_gradient():
    q, k, v, do = (torch.tensor(a).transpose(1, 2)
                   for a in _draw(3, 1, 2, 1, 6, 8))
    o, lse, _ = flash_attention_lse_ref(q, k, v)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, o, lse),
                                kw={"causal": True}, plain=True)
    grads = FlashAttentionFn.backward(ctx, do)
    assert len(grads) == 9 and all(g is None for g in grads[3:])
    with pytest.raises(ValueError, match="unknown backend"):
        flash_attention_train(q, k, v, backend="pallas")


@pytest.mark.parametrize(IDS, CASES[:2])
def test_bf16_rounding_convention(B, H, KV, S, hd, window, softcap):
    """bf16 inputs: P and dS are rounded to bf16 before their products;
    the gradients (Delta from the forward's float32 output, as the training
    path keeps it) stay within the bf16 tolerance of the float32 ones."""
    arrays = _draw(4, B, H, KV, S, hd, np.float32)
    kw = dict(causal=True, window=window, softcap=softcap)
    bf = [torch.tensor(a).bfloat16().transpose(1, 2) for a in arrays]
    f32 = [t.float() for t in bf]
    _, lse, o = flash_attention_lse_ref(*bf[:3], **kw)
    assert o.dtype == torch.float32
    got = flash_attention_bwd_ref(*bf[:3], o, lse, bf[3], **kw)
    o32, lse32, _ = flash_attention_lse_ref(*f32[:3], **kw)
    want = flash_attention_bwd_ref(*f32[:3], o32, lse32, f32[3], **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                   atol=2e-2 * scale, rtol=2e-2)
