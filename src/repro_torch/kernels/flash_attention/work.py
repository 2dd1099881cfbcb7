"""The work of one flash attention call, forward and backward: the bytes
each input and output moves once and the operations the visible (query,
key) pairs take. ``chip_smoke.py`` bounds the kernels' times by them and
the dry run (:mod:`repro_torch.kernels.shapeonly`) counts a traced step's
calls with them. The visible pairs are counted row by row from the mask's
bounds, so a 32k-token causal mask costs no (Sq, Skv) tensor."""

from __future__ import annotations

import numpy as np


def _bounds(sq: int, skv: int, *, causal: bool, window: int | None,
            q_offset: int, kv_len: int | None):
    """Each query's visible keys ``[lo, hi)`` under
    :func:`.ref.attention_mask`'s rules (query i at position q_offset + i)."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    end = skv if kv_len is None else max(0, min(skv, kv_len))
    lo = np.zeros(sq, np.int64) if window is None else np.maximum(
        0, pos - window + 1)
    hi = np.minimum(end, pos + 1) if causal else np.full(sq, end, np.int64)
    return lo, np.maximum(lo, hi)


def visible_pairs(sq: int, skv: int, *, causal: bool = True,
                  window: int | None = None, q_offset: int = 0,
                  kv_len: int | None = None) -> int:
    """The (query, key) pairs the mask lets through: ``mask.sum()``."""
    lo, hi = _bounds(sq, skv, causal=causal, window=window,
                     q_offset=q_offset, kv_len=kv_len)
    return int((hi - lo).sum())


def needed_keys(sq: int, skv: int, *, causal: bool = True,
                window: int | None = None, q_offset: int = 0,
                kv_len: int | None = None) -> int:
    """The keys some query reads: ``mask.any(0).sum()``. Both bounds rise
    with the query, so each row adds what lies past the rows before it."""
    lo, hi = _bounds(sq, skv, causal=causal, window=window,
                     q_offset=q_offset, kv_len=kv_len)
    if not sq:
        return 0
    before = np.maximum.accumulate(np.concatenate(([0], hi[:-1])))
    return int(np.maximum(0, hi - np.maximum(lo, before)).sum())


def attention_work(B: int, H: int, KV: int, hd: int, sq: int, skv: int, *,
                   size: int, causal: bool = True, window: int | None = None,
                   q_offset: int = 0, kv_len: int | None = None
                   ) -> tuple[int, int]:
    """Bytes and operations of one forward: q read and o written (``size``
    bytes an element), the needed keys' k and v read once; 4 x hd
    operations a visible pair and head (the two products)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    bytes_ = size * (2 * B * H * sq * hd
                     + 2 * B * KV * needed_keys(sq, skv, **kw) * hd)
    return bytes_, 4 * B * H * hd * visible_pairs(sq, skv, **kw)


def attention_bwd_work(B: int, H: int, KV: int, hd: int, sq: int, skv: int,
                       *, size: int, o_size: int, causal: bool = True,
                       window: int | None = None, q_offset: int = 0,
                       kv_len: int | None = None) -> tuple[int, float]:
    """Bytes and operations of one backward: q, do, dq and k, v, dk, dv
    once each (``size`` bytes an element), o (``o_size``) and lse
    (float32); 2.5 x the forward's operations (the recomputed scores and
    the four gradient products)."""
    pairs = visible_pairs(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, kv_len=kv_len)
    bytes_ = (size * (3 * B * H * sq * hd + 4 * B * KV * skv * hd)
              + o_size * B * H * sq * hd + 4 * B * H * sq)
    return bytes_, 2.5 * 4 * B * H * pairs * hd
