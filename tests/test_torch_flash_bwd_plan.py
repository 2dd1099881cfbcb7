"""The host side of the flash attention backward, on the CPU.

``plan_bwd`` (``repro_torch.kernels.flash_attention_bwd.kernel``) fixes
every launch of ``csrc/flash_attention_bwd.cu``: the clusters of the
dK/dV kernel, the tile shapes, and the tile table the kernels read (each
launch position's key tile with the query tiles it walks, each dQ
position's row tile with its key tiles). :func:`dkdv_walk` and
:func:`dq_walk` read a block's work as the kernels do: the block index
decoded, then the table. Over the backward's GPU cases
(``tests/test_torch_model_kernels.py``'s ``BWD``) and hypothesis-drawn
shapes (G up to 64, ``q_offset``, ``kv_len``, windows) it is held to:

* each visible (query, key) pair lies in exactly one (block, row tile) of
  the dK/dV kernel and one (block, key tile) of the dQ kernel, and each
  gradient row is written by exactly one block;
* the cluster divides G and is at most 8; blocks map one to one onto
  (batch, KV head, rank, key tile);
* the table has as many entries as the kernels' grids have positions,
  and both orders are longest first: row tiles (dK/dV) and key tiles
  (dQ) never grow along the launch order.

A plain tile walk that sums in the kernels' grouping (each block's row
tiles in its order, the cluster's heads in ascending rank, dQ's key tiles
in ascending order) equals ``flash_attention_bwd_ref`` in float64 within
1e-10.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.flash_attention import (attention_mask,
                                                 flash_attention_lse_ref)
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_ref
from repro_torch.kernels.flash_attention_bwd.kernel import (KEY_TILE,
                                                            MAX_CLUSTER,
                                                            ROW_TILE,
                                                            _table_on,
                                                            plan_bwd)
from repro_torch.kernels.spec import FLASH_ATTENTION_BWD_SPEC
from test_torch_model_kernels import BWD, BWD_IDS


def _plan(B, H, KV, Sq, Skv, hd, window, q_offset, kv_len, causal=True):
    kend = Skv if kv_len is None else max(0, min(Skv, kv_len))
    return plan_bwd(B, H, KV, Sq, Skv, kend, hd, causal=causal,
                    window=window, q_offset=q_offset)


def dkdv_walk(plan):
    """``(b, kvh, rank, kt, [(h0, q0), ...])`` of each dK/dV block in
    block order, as ``dkdv_kernel`` reads it: its index decoded, its key
    tile and query tiles from the table, row tile t of head pack ``t //
    nq`` and query tile ``qt_lo + t % nq``."""
    table = plan.table()
    packs = plan.heads_per_block // plan.kv_heads_per_tile
    for bid in range(plan.dkdv_blocks):
        rank, rest = bid % plan.cluster, bid // plan.cluster
        kvh, rest = rest % plan.KV, rest // plan.KV
        b, pos = rest % plan.B, rest // plan.B
        kt, qt_lo, nq = table[3 * pos:3 * pos + 3]
        h_first = kvh * plan.group + rank * plan.heads_per_block
        tiles = [(h_first + (t // nq) * plan.kv_heads_per_tile,
                  (qt_lo + t % nq) * plan.kv_block_q)
                 for t in range(nq * packs)]
        yield b, kvh, rank, kt, tiles


def dq_walk(plan):
    """``(b, h0, q0, key tiles)`` of each dQ block in block order, as
    ``dq_kernel`` reads it."""
    table = plan.table()
    n_groups = plan.H // plan.q_heads_per_tile
    for bid in range(plan.dq_blocks):
        b, rest = bid % plan.B, bid // plan.B
        h0 = (rest % n_groups) * plan.q_heads_per_tile
        at = 3 * (len(plan.kv_tiles) + rest // n_groups)
        q0, t_lo, t_hi = table[at:at + 3]
        yield b, h0, q0, range(t_lo, t_hi)


def _tile_rows(plan, h0, q0, heads_per_tile, block_q):
    """(head, query) of the valid rows of a row tile."""
    return [(h0 + r // block_q, q0 + r % block_q)
            for r in range(heads_per_tile * block_q)
            if q0 + r % block_q < plan.Sq]


def check_plan(plan):
    """Every invariant of the module docstring but the emulation."""
    B, H, KV, Sq, Skv, G = plan.B, plan.H, plan.KV, plan.Sq, plan.Skv, \
        plan.group
    assert 1 <= plan.cluster <= MAX_CLUSTER and G % plan.cluster == 0
    assert plan.heads_per_block * plan.cluster == G
    assert plan.heads_per_block % plan.kv_heads_per_tile == 0
    assert G % plan.q_heads_per_tile == 0
    for hpt, bq in ((plan.kv_heads_per_tile, plan.kv_block_q),
                    (plan.q_heads_per_tile, plan.q_block_q)):
        assert 1 <= hpt * bq <= ROW_TILE
    # dK/dV packs heads only when each has fewer queries than a tile
    assert plan.kv_heads_per_tile == 1 or plan.kv_block_q == Sq
    # the grids' positions, as the C entry point derives them
    n_ktiles = -(-Skv // KEY_TILE)
    assert len(plan.kv_tiles) == n_ktiles
    assert len(plan.q_tiles) == -(-Sq // plan.q_block_q)
    assert len(plan.table()) == 3 * (len(plan.kv_tiles) + len(plan.q_tiles))
    mask = attention_mask(Sq, Skv, causal=plan.causal, window=plan.window,
                          q_offset=plan.q_offset, kv_len=plan.kend,
                          device="cpu").numpy()
    visible = np.broadcast_to(mask, (B, H, Sq, Skv))

    # dK/dV: each visible pair once; each (b, kvh, key) written once
    seen = np.zeros((B, H, Sq, Skv), np.int16)
    written = np.zeros((B, KV, n_ktiles), np.int16)
    blocks = set()
    for b, kvh, rank, kt, tiles in dkdv_walk(plan):
        blocks.add((b, kvh, rank, kt))
        if rank == 0:
            written[b, kvh, kt] += 1
        k0, k1 = kt * KEY_TILE, min(kt * KEY_TILE + KEY_TILE, Skv)
        for h0, q0 in tiles:
            for h, qi in _tile_rows(plan, h0, q0, plan.kv_heads_per_tile,
                                    plan.kv_block_q):
                assert h // G == kvh
                seen[b, h, qi, k0:k1] += mask[qi, k0:k1]
    assert len(blocks) == plan.dkdv_blocks
    assert (written == 1).all()
    assert (seen == visible).all()

    # launch order: every key tile once, longest first
    assert sorted(kt for kt, _, _ in plan.kv_tiles) == list(range(n_ktiles))
    rows_at = [nq for _, _, nq in plan.kv_tiles]
    assert all(a >= b for a, b in zip(rows_at, rows_at[1:])), rows_at

    # dQ: each visible pair once; each (b, h, query) row written once
    seen[:] = 0
    rows_written = np.zeros((B, H, Sq), np.int16)
    for b, h0, q0, tiles in dq_walk(plan):
        for h, qi in _tile_rows(plan, h0, q0, plan.q_heads_per_tile,
                                plan.q_block_q):
            assert h // G == h0 // G
            rows_written[b, h, qi] += 1
            for kt in tiles:
                k0, k1 = kt * KEY_TILE, min(kt * KEY_TILE + KEY_TILE, Skv)
                seen[b, h, qi, k0:k1] += mask[qi, k0:k1]
    assert (rows_written == 1).all()
    assert (seen == visible).all()
    assert sorted(q0 for q0, _, _ in plan.q_tiles) == \
        list(range(0, Sq, plan.q_block_q))
    keys_at = [hi - lo for _, lo, hi in plan.q_tiles]
    assert all(a >= b for a, b in zip(keys_at, keys_at[1:])), keys_at


def emulate_bwd(q, k, v, o, lse, do, plan, *, softcap=None):
    """The kernels' tile walk in plain PyTorch (float64): dK/dV per block
    over its row tiles in order, the cluster's blocks summed in ascending
    rank; dQ per block over its key tiles in ascending order; Delta per
    row. Masks as the kernels apply them (keys past kend, causal, window)."""
    B, H, Sq, hd = q.shape
    Skv, G = k.shape[2], plan.group
    scale = hd ** -0.5
    mask = attention_mask(Sq, Skv, causal=plan.causal, window=plan.window,
                          q_offset=plan.q_offset, kv_len=plan.kend,
                          device="cpu")
    delta = (do * o).sum(-1)

    def grads(b, heads, queries, k0, k1):
        """P and dS of rows (heads, queries) against keys [k0, k1)."""
        kvh = heads[0] // G
        qr, dor = q[b, heads, queries], do[b, heads, queries]
        s = qr @ k[b, kvh, k0:k1].T * scale
        grad = scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s, grad = softcap * t, (1 - t * t) * scale
        m = mask[queries][:, k0:k1]
        p = torch.where(m, torch.exp(s - lse[b, heads, queries, None]), 0.0)
        dp = dor @ v[b, kvh, k0:k1].T
        ds = p * (dp - delta[b, heads, queries, None]) * grad
        return qr, dor, p, ds

    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    blocks = list(dkdv_walk(plan))
    for cid in range(plan.dkdv_blocks // plan.cluster):
        parts = []
        for b, kvh, rank, kt, tiles in blocks[cid * plan.cluster:
                                              (cid + 1) * plan.cluster]:
            k0, k1 = kt * KEY_TILE, min(kt * KEY_TILE + KEY_TILE, Skv)
            pk = torch.zeros((k1 - k0, hd), dtype=q.dtype)
            pv = torch.zeros_like(pk)
            for h0, q0 in tiles:
                rows = _tile_rows(plan, h0, q0, plan.kv_heads_per_tile,
                                  plan.kv_block_q)
                heads, queries = (list(x) for x in zip(*rows))
                qr, dor, p, ds = grads(b, heads, queries, k0, k1)
                pv = pv + p.T @ dor
                pk = pk + ds.T @ qr
            parts.append((pk, pv))
        total_k, total_v = parts[0]
        for pk, pv in parts[1:]:
            total_k, total_v = total_k + pk, total_v + pv
        dk[b, kvh, k0:k1], dv[b, kvh, k0:k1] = total_k, total_v
    for b, h0, q0, tiles in dq_walk(plan):
        rows = _tile_rows(plan, h0, q0, plan.q_heads_per_tile, plan.q_block_q)
        heads, queries = (list(x) for x in zip(*rows))
        acc = torch.zeros((len(rows), hd), dtype=q.dtype)
        for kt in tiles:
            k0, k1 = kt * KEY_TILE, min(kt * KEY_TILE + KEY_TILE, Skv)
            _, _, _, ds = grads(b, heads, queries, k0, k1)
            acc = acc + ds @ k[b, heads[0] // G, k0:k1]
        dq[b, heads, queries] = acc
    return dq, dk, dv


def _inputs(seed, B, H, KV, Sq, Skv, hd, kw):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.standard_normal(s))  # noqa: E731
    q, k, v, do = t(B, H, Sq, hd), t(B, KV, Skv, hd), t(B, KV, Skv, hd), \
        t(B, H, Sq, hd)
    o, lse, _ = flash_attention_lse_ref(q, k, v, **kw)
    return q, k, v, o, lse, do


def check_emulation(seed, B, H, KV, Sq, Skv, hd, window, softcap, q_offset,
                    kv_len):
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              kv_len=kv_len)
    args = _inputs(seed, B, H, KV, Sq, Skv, hd, kw)
    plan = _plan(B, H, KV, Sq, Skv, hd, window, q_offset, kv_len)
    got = emulate_bwd(*args, plan, softcap=softcap)
    want = flash_attention_bwd_ref(*args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-10,
                                   rtol=1e-10)


@pytest.mark.parametrize(BWD_IDS, BWD)
def test_plan_covers_the_gpu_cases(B, H, KV, Sq, Skv, hd, window, softcap,
                                   q_offset, kv_len):
    check_plan(_plan(B, H, KV, Sq, Skv, hd, window, q_offset, kv_len))


@pytest.mark.parametrize(BWD_IDS, [c for c in BWD
                                   if c[3] <= 300 and c[0] * c[1] * c[3]
                                   <= 2048])
def test_tile_walk_is_the_gradient(B, H, KV, Sq, Skv, hd, window, softcap,
                                   q_offset, kv_len):
    check_emulation(Sq + H, B, H, KV, Sq, Skv, min(hd, 32), window, softcap,
                    q_offset, kv_len)


def test_training_plans():
    """gemma3-1b's global and local layers: one 4-block cluster per KV
    head, 64-query row tiles of one head, 4 x 4 x 16 = 256 dK/dV blocks
    from key tile 0; dQ packs the 4 heads x 16 queries (256 blocks, the
    last query tile first). gemma2-27b's heads (G 2): 2-block clusters, 2 x 16 x 2 x 8 blocks."""
    for window in (None, 512):
        plan = _plan(4, 4, 1, 1024, 1024, 256, window, 0, None)
        assert (plan.cluster, plan.heads_per_block) == (4, 1)
        assert (plan.kv_heads_per_tile, plan.kv_block_q) == (1, 64)
        assert (plan.q_heads_per_tile, plan.q_block_q) == (4, 16)
        assert plan.dkdv_blocks == 256 and plan.dq_blocks == 256
        assert [kt for kt, _, _ in plan.kv_tiles] == list(range(16))
        assert plan.consumers == 2
        assert next(dq_walk(plan))[:3] == (0, 0, 1008)
        # Delta, and 16 + 64 table entries of three int32
        assert plan.scratch_bytes == 4 * 4 * 4 * 1024 + 4 * 3 * (16 + 64)
    plan = _plan(2, 32, 16, 512, 512, 128, None, 0, None)
    assert (plan.cluster, plan.heads_per_block, plan.dkdv_blocks) == (2, 1,
                                                                      512)
    kts = [blk[3] for blk in dkdv_walk(plan)]
    assert [kts[i] for i in (0, 63, 64)] == [0, 0, 1]


def test_zamba2_shared_layer_plan():
    """zamba2-7b's shared attention block (B 4, H 32 on KV 32, S 1,024,
    hd 112): G 1, so one-block clusters, 64-query row tiles of one head,
    4 x 32 x 16 = 2,048 dK/dV and dQ blocks; hd 112 runs the hd-128 shape
    (two consumer warpgroups)."""
    plan = _plan(4, 32, 32, 1024, 1024, 112, None, 0, None)
    assert (plan.cluster, plan.heads_per_block, plan.consumers) == (1, 1, 2)
    assert (plan.kv_heads_per_tile, plan.kv_block_q) == (1, 64)
    assert (plan.q_heads_per_tile, plan.q_block_q) == (1, 64)
    assert plan.dkdv_blocks == 2048 and plan.dq_blocks == 2048
    assert [kt for kt, _, _ in plan.kv_tiles] == list(range(16))
    assert _plan(4, 32, 32, 1024, 1024, 64, None, 0, None).consumers == 1


@pytest.mark.parametrize("window", [None, 256])
def test_trainer_hd80_plan(window):
    """The ~100M gemma3-family trainer's layer (B 4 a microbatch, H 8 on
    KV 2, S 256, hd 80; its local layers' window 256 spans the whole
    sequence): 4-block clusters, 64-query row tiles of one head, 4 x 8 x 4
    = 128 dK/dV blocks from key tile 0; dQ packs the 4 heads x 16 queries
    (128 blocks). hd 80 is above 64 and not a multiple of it, so the source
    lays it out as ``Cfg::kPD`` = 128 columns (TMA zero-fills 80..127) and
    runs the hd-128 shape: two consumer warpgroups."""
    assert 80 in HEAD_DIMS
    plan = _plan(4, 8, 2, 256, 256, 80, window, 0, None)
    assert (plan.cluster, plan.heads_per_block, plan.consumers) == (4, 1, 2)
    assert (plan.kv_heads_per_tile, plan.kv_block_q) == (1, 64)
    assert (plan.q_heads_per_tile, plan.q_block_q) == (4, 16)
    assert plan.dkdv_blocks == 128 and plan.dq_blocks == 128
    assert [kt for kt, _, _ in plan.kv_tiles] == list(range(4))
    assert next(dq_walk(plan))[:3] == (0, 0, 240)
    check_plan(plan)


def test_wide_groups_pack_heads_into_blocks():
    """G 64 (3 queries): 8-block clusters of 8 heads each, packed into one
    24-row tile; G 12: 6-block clusters of 2 heads; G 7: 7-block clusters."""
    plan = _plan(1, 64, 1, 3, 3, 16, None, 0, None)
    assert (plan.cluster, plan.heads_per_block) == (8, 8)
    assert (plan.kv_heads_per_tile, plan.kv_block_q) == (8, 3)
    rank1 = [blk for blk in dkdv_walk(plan) if blk[2] == 1]
    assert [len(blk[4]) for blk in rank1] == [1]
    assert _plan(1, 12, 1, 100, 100, 64, None, 0, None).cluster == 6
    assert _plan(1, 7, 1, 100, 100, 64, None, 0, None).cluster == 7
    assert _plan(1, 12, 1, 100, 100, 64, None, 0, None).consumers == 1


def test_unbalanced_chunk_starts_at_the_heaviest_key_tile():
    """A chunk of queries against a longer cache with a window: key tile 0
    is seen by no query (the window) nor key tile 3 (past kv_len), so the
    order starts at key tile 1 and takes those two last, with no row
    tile."""
    plan = _plan(1, 4, 2, 33, 200, 64, 16, 100, 133)
    assert plan.kv_tiles[0][0] == 1
    assert [kt for kt, _, _ in plan.kv_tiles[2:]] == [0, 3]
    assert [nq for _, _, nq in plan.kv_tiles] == [1, 1, 0, 0]
    check_plan(plan)


def test_plan_rejects_unknown_head_dims():
    with pytest.raises(ValueError, match="head dim"):
        plan_bwd(1, 2, 1, 8, 8, 8, 48, causal=True, window=None, q_offset=0)


@st.composite
def shapes(draw):
    G = draw(st.sampled_from([1, 2, 3, 4, 5, 6, 8, 12, 16, 64]))
    KV = draw(st.integers(1, 2 if G >= 16 else 3))
    Sq = draw(st.integers(1, 130 if G < 16 else 20))
    q_offset = draw(st.sampled_from([0, 0, draw(st.integers(0, 90))]))
    Skv = Sq + q_offset + draw(st.integers(0, 40))
    kv_len = draw(st.sampled_from(
        [None, draw(st.integers(1, Skv)), Sq + q_offset]))
    window = draw(st.sampled_from([None, draw(st.integers(1, 100))]))
    return dict(B=draw(st.integers(1, 2)), H=G * KV, KV=KV, Sq=Sq, Skv=Skv,
                hd=draw(st.sampled_from(HEAD_DIMS)), window=window,
                q_offset=q_offset, kv_len=kv_len)


@settings(max_examples=60, deadline=None)
@given(shapes())
def test_plan_covers_drawn_shapes(s):
    check_plan(_plan(**s))


@settings(max_examples=25, deadline=None)
@given(shapes(), st.sampled_from([None, 5.0]))
def test_tile_walk_is_the_gradient_on_drawn_shapes(s, softcap):
    s = dict(s, hd=16)
    check_emulation(s["Sq"], softcap=softcap, **s)


def test_table_is_copied_once_a_shape():
    """The wrapper's table is the plan's, int32, made once a (plan,
    device) and reused."""
    plan = _plan(1, 4, 2, 100, 100, 64, 32, 0, None)
    dev = torch.device("cpu")
    table = _table_on(plan, dev)
    assert table.dtype == torch.int32
    assert table.tolist() == plan.table()
    assert _table_on(plan, dev) is table


def test_audit_budget_counts_the_scratch():
    """``FLASH_ATTENTION_BWD_SPEC.budget_bytes`` at its audit shape (B 1,
    H 4, KV 2, S 256, hd 64): the 800,000 B of the design without a tile
    table and with a bf16 o, plus the other half of o's bytes (the backward
    reads the forward's float32 output), plus the table's bytes and nothing
    else."""
    plan = _plan(1, 4, 2, 256, 256, 64, None, 0, None)
    delta = 4 * 1 * 4 * 256
    assert plan.scratch_bytes - delta == 4 * 3 * (4 + 8) == 144
    o_widened = (4 - 2) * 1 * 4 * 256 * 64
    assert FLASH_ATTENTION_BWD_SPEC.budget_bytes == 800_000 + o_widened + 144
