"""Plain PyTorch version of the replica value-scoring pass
(``csrc/value_score.cu``).

Mirrors the float64 oracle ``value_score_ref``
(``src/repro/kernels/value_score/ref.py:33``):

1. ``best[s, f]`` — max of ``bw[h, s]`` over the holders ``h != s`` of
   file ``f`` (self-supply excluded; 0 when no other holder exists);
2. ``mode="cost"``: ``demand * (size / best)``, in that order;
   ``mode="plain"``: ``demand``; both 0 where ``best`` is 0.

The holder max runs one holder row at a time over a ``(sites, files)``
buffer, as the oracle does; max and divide are exact, and the masked
entries never read a quotient (no ``0 * inf``), so the result is
bit-identical to the oracle and to the CUDA kernel. No step depends on
the data's values for its shape, so a call can be captured in a CUDA
graph.
"""

from __future__ import annotations

import torch

MODES = ("cost", "plain")


def value_score_ref(demand: torch.Tensor, sizes: torch.Tensor,
                    presence: torch.Tensor, bw: torch.Tensor, *,
                    mode: str = "cost") -> torch.Tensor:
    """``(sites, files)`` float64 values.

    Args: ``demand`` ``(sites, files)`` float64 predicted accesses;
    ``sizes`` ``(files,)`` float64; ``presence`` ``(sites, files)`` bool
    fetchable holders; ``bw`` ``(sites, sites)`` float64, ``bw[h, s]``
    from holder ``h`` to site ``s``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown value_score mode {mode!r} "
                         f"(want one of {MODES})")
    n_sites = demand.shape[0]
    best = torch.zeros_like(demand)
    for h in range(n_sites):
        contrib = torch.where(presence[h][None, :], bw[h][:, None], 0.0)
        contrib[h].zero_()                       # self-supply excluded
        torch.maximum(best, contrib, out=best)
    good = best > 0.0
    if mode == "plain":
        return torch.where(good, demand, 0.0)
    cost = sizes[None, :] / torch.where(good, best, 1.0)
    return torch.where(good, demand * cost, 0.0)
