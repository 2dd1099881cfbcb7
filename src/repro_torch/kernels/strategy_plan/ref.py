"""Plain PyTorch version of the batched replica-strategy plan pass
(``csrc/strategy_plan.cu``).

Mirrors the float64 oracle ``strategy_plan_ref``
(``src/repro/kernels/strategy_plan/ref.py:259``): for every (job,
missing-file) pair column ``p`` of one arrival burst,

* ``src_g[p]`` — argmax over sites of ``bw[s, p] / (1.0 + serve[s])``
  among the fetchable holders, masked keys ``-1``; ``torch.argmax``
  returns the first maximum, so ties keep the lowest site id and an
  all-masked column gives site 0, as ``np.argmax`` does;
* ``src_l[p]`` / ``has_l[p]`` — the same argmax over the fetchable holders
  in the destination's region, and whether one exists;
* ``inter_g[p]`` — the global pick lies outside the destination's region;
* ``store_ok[p]`` — ``free >= size``.

Divide, compare and where are exact IEEE ops on float64 tensors, so the
result is bit-identical to the oracle and to the CUDA kernel.
"""

from __future__ import annotations

import torch


def strategy_plan_ref(bw: torch.Tensor, fetch: torch.Tensor,
                      local: torch.Tensor, serve: torch.Tensor,
                      free: torch.Tensor, size: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plan one burst.

    Args: ``bw`` ``(sites, pairs)`` float64 point bandwidth to each pair's
    destination; ``fetch`` / ``local`` ``(sites, pairs)`` bool fetchable
    holders / same-region sites; ``serve`` ``(sites,)`` float64 decayed
    serving load (zeros for the history-blind strategies); ``free`` /
    ``size`` ``(pairs,)`` float64.

    Returns ``(sources, flags)``: ``sources`` ``(2, pairs)`` int32 rows
    ``src_g``, ``src_l``; ``flags`` ``(3, pairs)`` bool rows ``has_l``,
    ``inter_g``, ``store_ok``. With no site or no pair every entry is 0.
    """
    n_sites, n_pairs = bw.shape
    dev = bw.device
    sources = torch.zeros((2, n_pairs), dtype=torch.int32, device=dev)
    flags = torch.zeros((3, n_pairs), dtype=torch.bool, device=dev)
    if n_sites == 0 or n_pairs == 0:
        return sources, flags
    eff = bw / (1.0 + serve)[:, None]
    fl = fetch & local
    src_g = torch.argmax(torch.where(fetch, eff, -1.0), dim=0)
    sources[0] = src_g
    sources[1] = torch.argmax(torch.where(fl, eff, -1.0), dim=0)
    flags[0] = fl.any(dim=0)
    flags[1] = ~local.gather(0, src_g[None, :])[0]
    flags[2] = free >= size
    return sources, flags
