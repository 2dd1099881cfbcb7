"""Mixture-of-experts feed-forward with capacity-bucketed, sort-based
dispatch (the counterpart of ``repro.models.moe``).

Per batch row, as the reference's ``_dispatch_one_row`` (batched over B
here, where the reference maps it with ``vmap``):

  1. top-k routing over E experts in float32, the k selected logits
     renormalised by a softmax;
  2. the S * k (token, choice) slots sorted by expert id (stable), each
     slot's position within its expert counted from the expert's start,
     slots at or past the capacity C dropped;
  3. an (E, C, D) buffer per row, one grouped product per FFN matrix,
     each token's k gated outputs added back in ascending expert order.

Ties and order are the reference's on every device: ``topk_stable`` keeps
the lower expert index among equal logits (a stable descending sort, as
``jax.lax.top_k``), and the slot sort is stable (``jnp.argsort``). Nothing
is scattered: x is expanded to the (S, k) slots and permuted, the buffer
is a gather of the sorted slots, and the combine permutes the S * k gated
outputs back to (S, k) and adds over k one choice at a time, in the
working dtype and ascending expert order, as the reference's
``.at[token_of].add`` does. Every gather's indices are a permutation, or
repeat only where the gathered rows are masked to zero, so the atomic adds
of their backwards never meet two nonzero values in one place: forward and
backward are bit-equal over calls.

On DTensor inputs (a sharded step) the block runs on each rank's shards,
as DTensor has no sharding rule for ``searchsorted`` and the stable
sorts: the rows of x stay sharded over the data axes (the dispatch is
local to a row), and when the experts divide the ``model`` axis each
rank keeps its E / model experts (expert parallelism: the router and x
are whole on every model rank, the rank's output is its experts' part of
the sum, reduced over ``model`` by the next operator); otherwise every
rank holds every expert. The input and output are anchored to the batch
sharding (``shardctx.anchor_batch``), as in the reference.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Partial

from ..kernels import sharded
from . import shardctx
from .common import normal_init, silu


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int,
             dense_residual: bool, dtype: torch.dtype = torch.bfloat16
             ) -> dict:
    """The router (D, E) in float32, the experts' ``wg``, ``wu`` (E, D, F)
    and ``wd`` (E, F, D) in ``dtype``, and a dense gated MLP ``res`` when
    ``dense_residual``; drawn from ``gen`` in the reference's order."""
    p = {
        "router": normal_init(gen, (d_model, num_experts),
                              dtype=torch.float32),
        "wg": normal_init(gen, (num_experts, d_model, d_ff), dtype=dtype),
        "wu": normal_init(gen, (num_experts, d_model, d_ff), dtype=dtype),
        "wd": normal_init(gen, (num_experts, d_ff, d_model), dtype=dtype),
    }
    if dense_residual:
        p["res"] = {
            "wg": normal_init(gen, (d_model, d_ff), dtype=dtype),
            "wu": normal_init(gen, (d_model, d_ff), dtype=dtype),
            "wd": normal_init(gen, (d_ff, d_model), dtype=dtype),
        }
    return p


def capacity(S: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert keeps per batch row: ``max(1, int(S k / E f))``."""
    return max(1, int(S * top_k / num_experts * capacity_factor))


def topk_stable(logits: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, largest
    first, the lower index first among equals (``jax.lax.top_k``)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router: torch.Tensor, *, top_k: int, C: int
          ) -> dict:
    """The routing of x (B, S, D): ``logits`` (B, S, E) float32, the
    chosen experts ``idx`` and their renormalised ``gates`` (B, S, k), the
    stable slot ``order`` (B, S k) with each sorted slot's expert
    ``sorted_e``, its position ``pos`` within that expert and ``keep``
    (pos < C), and each expert's first sorted slot ``starts`` and slot
    count ``counts`` (B, E)."""
    B, S, _ = x.shape
    E = router.shape[-1]
    logits = x.float() @ router
    vals, idx = topk_stable(logits, top_k)
    gates = torch.softmax(vals, dim=-1)
    flat_e = idx.reshape(B, S * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    ranks = torch.arange(S * top_k, device=x.device)
    pos = ranks - starts.gather(1, sorted_e)
    return {"logits": logits, "idx": idx, "gates": gates, "order": order,
            "sorted_e": sorted_e, "pos": pos, "keep": pos < C,
            "starts": starts, "counts": counts}


def _rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``index`` (B, n) of t (B, m, D) -> (B, n, D)."""
    return t.gather(1, index[..., None].expand(-1, -1, t.shape[-1]))


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, act=silu) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), the reference's ``moe_ffn``: dispatch
    local to each batch row, capacity per row. Tokens an expert drops get
    nothing from it; the caller's residual carries them. Runs inside a
    ``moe_ffn`` profiler range, so that a trace can attribute its device
    time (and its backward's, through the autograd nodes' sequence
    numbers)."""
    with torch.profiler.record_function("moe_ffn"):
        if sharded.is_sharded(x):
            return _moe_on_shards(params, x, top_k=top_k,
                                  capacity_factor=capacity_factor, act=act)
        return _moe_ffn(params, x, top_k=top_k,
                        capacity_factor=capacity_factor, act=act)


_EXPERT_KEYS = ("router", "wg", "wu", "wd")


def _moe_on_shards(params: dict, x, *, top_k: int, capacity_factor: float,
                   act):
    """:func:`moe_ffn` of a DTensor x on each rank's shards (the module
    docstring); a dense residual MLP stays with the caller."""
    x = shardctx.anchor_batch(x)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    m = sharded.model_ranks(x)
    E = params["router"].shape[-1]
    ep = m > 1 and E % m == 0
    n = E // m if ep else E
    e0 = mesh.get_local_rank("model") * n if ep else 0
    expert = (None, 0 if ep else None)

    def local(x_, router, wg, wu, wd):
        p = {"router": router, "wg": wg, "wu": wu, "wd": wd}
        return _moe_ffn(p, x_, top_k=top_k, capacity_factor=capacity_factor,
                        act=act, experts=(e0, n) if ep else None)

    args = (x,) + tuple(params[k] for k in _EXPERT_KEYS)
    roles = ((0, None), (None, None), expert, expert, expert)
    out = None
    if ep:
        out = [tuple(Partial() if name == "model" else p for name, p in
                     zip(names, sharded.role_placements(
                         mesh, x.shape[0], False, 0, None)))]
    y = sharded.call_local(local, args, roles, ((0, None),),
                           batch=x.shape[0], split_model=ep,
                           out_placements=out)
    return shardctx.anchor_batch(y)


def _moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
             capacity_factor: float, act,
             experts: tuple[int, int] | None = None) -> torch.Tensor:
    """``experts`` (e0, n): only the rank's experts e0 .. e0 + n - 1 of
    the router's E (their ``wg``, ``wu``, ``wd``), whose part of each
    token's sum is the output; all E without it."""
    B, S, D = x.shape
    E = params["router"].shape[-1]
    e0, n = experts or (0, E)
    C = capacity(S, top_k, E, capacity_factor)
    r = route(x, params["router"], top_k=top_k, C=C)
    order, keep = r["order"], r["keep"]

    # dispatch: the (S, k) slots in sorted order; buffer slot (e, c) holds
    # sorted slot starts[e] + c when c < counts[e], else zeros
    xs = _rows(x[:, :, None].expand(B, S, top_k, D).reshape(B, -1, D), order)
    c = torch.arange(C, device=x.device)
    src = r["starts"][:, e0:e0 + n, None] + c                  # (B, n, C)
    filled = (c < r["counts"][:, e0:e0 + n, None]).reshape(B, n * C, 1)
    src = src.clamp(max=S * top_k - 1).reshape(B, n * C)
    buf = torch.where(filled, _rows(xs, src), 0.0)
    buf = buf.view(B, n, C, D).transpose(0, 1).reshape(n, B * C, D)

    g = act(torch.bmm(buf, params["wg"]))
    u = torch.bmm(buf, params["wu"])
    y = torch.bmm(g * u, params["wd"])                         # (n, B C, D)
    yf = y.view(n, B, C, D).transpose(0, 1).reshape(B, n * C, D)

    # combine: each sorted slot's gated output (zero where dropped), back
    # to (S, k) in ascending expert order, added one choice at a time
    slot = ((r["sorted_e"] - e0) * C + r["pos"]).clamp(max=n * C - 1)
    if experts is not None:             # another rank's experts add nothing
        keep = keep & (r["sorted_e"] >= e0) & (r["sorted_e"] < e0 + n)
        slot = slot.clamp(min=0)
    flat_gate = r["gates"].reshape(B, S * top_k).gather(1, order)
    contrib = torch.where(keep[..., None], _rows(yf, slot), 0.0) * \
        flat_gate[..., None].to(x.dtype)
    inv = torch.argsort(order, dim=-1)         # slot s k + j -> sorted slot
    by_expert, _ = torch.sort(inv.view(B, S, top_k), dim=-1)
    parts = _rows(contrib, by_expert.view(B, S * top_k)).view(B, S, top_k, D)
    out = parts[:, :, 0]
    for j in range(1, top_k):
        out = out + parts[:, :, j]
    return out


def moe_aux_loss(params: dict, x: torch.Tensor, *,
                 top_k: int) -> torch.Tensor:
    """Switch-style load-balancing loss E * sum_e f_e p_e: f_e the share
    of the top-k choices that went to expert e, p_e its mean router
    probability (only p carries a gradient). A DTensor x is gathered
    whole on every rank (f and p are means over every token)."""
    if sharded.is_sharded(x):
        return sharded.call_local(
            lambda x_, r_: moe_aux_loss({"router": r_}, x_, top_k=top_k),
            (x, params["router"]), ((None, None), (None, None)),
            ((None, None),), batch=x.shape[0], split_model=False)
    D = x.shape[-1]
    E = params["router"].shape[-1]
    logits = x.reshape(-1, D).float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    _, idx = topk_stable(logits, top_k)
    hard = torch.zeros_like(logits).scatter_(1, idx, 1.0)
    f = hard.mean(0)
    p = probs.mean(0)
    return E * (f * p).sum()
