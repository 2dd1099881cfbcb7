"""Plain PyTorch version of the shortest-transfer cost pass
(``csrc/st_cost.cu``).

Mirrors the float64 oracle ``st_cost_ref``
(``src/repro/kernels/st_cost/ref.py:565``), costing every (job, site) pair
of one dispatch batch:

1. ``best[f, s]`` — max of ``bw[h, s]`` over the fetchable holders ``h``
   of file ``f`` (0 when there is none);
2. ``t[j, s]`` — over the files job ``j`` requires that are missing at
   ``s``, in ascending file order, the sum of ``size / best`` (``inf``
   where ``best`` is 0);
3. ``cost = max(t, rel)``, ``inf`` at offline sites.

The holder max runs one holder row at a time and the file sum one
``(jobs, sites)`` slice at a time, in ascending file order, as the oracle
sums; a term of a file that is not missing is an exact ``+0.0``. Max,
divide and the sequential sum are exact against the oracle, so the result
is bit-identical to it and to the CUDA kernel. No step depends on the
data's values for its shape, so a call can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import torch


def st_cost_ref(bw: torch.Tensor, fetch_mask: torch.Tensor,
                presence: torch.Tensor, sizes: torch.Tensor,
                required: torch.Tensor, rel: torch.Tensor,
                online: torch.Tensor) -> torch.Tensor:
    """``(jobs, sites)`` float64 costs of one batch.

    Args: ``bw`` ``(sites, sites)`` float64, ``bw[h, s]`` from holder
    ``h`` to site ``s``; ``fetch_mask`` / ``presence`` ``(sites, files)``
    bool fetchable holders / all holders; ``sizes`` ``(files,)`` float64;
    ``required`` ``(jobs, files)`` bool; ``rel`` ``(sites,)`` float64
    relative load; ``online`` ``(sites,)`` bool.
    """
    n_sites, n_files = presence.shape
    n_jobs = required.shape[0]
    best = torch.zeros((n_files, n_sites), dtype=bw.dtype, device=bw.device)
    for h in range(n_sites):
        torch.maximum(best, torch.where(fetch_mask[h][:, None], bw[h][None, :],
                                        0.0), out=best)
    good = best > 0.0
    t_fs = torch.where(good, sizes[:, None] / torch.where(good, best, 1.0),
                       math.inf)
    t = torch.zeros((n_jobs, n_sites), dtype=bw.dtype, device=bw.device)
    for f in range(n_files):
        miss = required[:, f][:, None] & ~presence[:, f][None, :]
        t = t + torch.where(miss, t_fs[f][None, :], 0.0)
    cost = torch.maximum(t, rel[None, :])
    return torch.where(online[None, :], cost, math.inf)
