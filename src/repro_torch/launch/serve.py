"""Serve a model through ``GridRouter`` and ``ServeEngine``: the port's
counterpart of ``examples/serve_grid.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --requests 4 --prompt-len 1024 --new-tokens 16

A two-pod pool of eight engine sites (LAN 50 GB/s, WAN 3.125 GB/s) holds
three shared system prompts as 2 GB prefix-KV artifacts on sites 0, 3 and
6. Each request names one of them; the router places it with the paper's
data-aware scheduler and HRS, and the engine serves all requests as one
batch: one prefill, then greedy decode. Weights are random, from
``--seed``, at the config's full width (``--reduced`` for the small
variant). The device defaults to the CUDA card and raises without one;
``--device cpu`` runs the plain PyTorch versions of the kernels. Before the
timed run one tiny request warms the path up (allocator, cuBLAS, kernel
libraries), so the printed times exclude one-time set-up.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs.base import ArchConfig, arch_ids, get_config
from ..core.topology import GridTopology
from ..device import resolve_device
from ..grid.datagrid import DataGridService
from ..models import model as M
from ..serve.engine import GridRouter, Request, ServeEngine

#: (prefix id, master site) of the pool's shared system prompts
PREFIXES = (("prefix0", 0), ("prefix1", 3), ("prefix2", 6))
PREFIX_BYTES = 2e9


def make_router() -> tuple[GridTopology, DataGridService, GridRouter]:
    """The example's serving pool: 2 pods of 4 sites and three prefix-KV
    artifacts."""
    topo = GridTopology(2, 4, lan_bandwidth=50e9, wan_bandwidth=3.125e9,
                        storage_capacity=64e9)
    grid = DataGridService(topo)
    router = GridRouter(grid, n_engines=topo.n_sites)
    for lfn, site in PREFIXES:
        router.register_prefix(lfn, kv_bytes=PREFIX_BYTES, master_site=site)
    return topo, grid, router


def serve(cfg: ArchConfig, params: dict, *, n_requests: int, prompt_len: int,
          new_tokens: int, seed: int = 0, backend: str = "auto") -> dict:
    """Route ``n_requests`` random prompts (from ``seed``) through a fresh
    pool and serve them as one batch on ``params``' device. Returns the
    tokens (numpy), the logits of every emitted token (on the device), the
    sites, the grid's transfer totals and the timings."""
    dev = params["embed"].device
    topo, grid, router = make_router()
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab, prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens,
                    prefix_id=PREFIXES[i % len(PREFIXES)][0])
            for i in range(n_requests)]
    sites = [router.route(r) for r in reqs]
    engine = ServeEngine(cfg, params, max_len=prompt_len + new_tokens,
                         backend=backend)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tokens, logits = engine.generate(np.stack([r.tokens for r in reqs]),
                                     new_tokens, return_logits=True)
    for site, r in zip(sites, reqs):
        router.complete(site, r)
    t = engine.last_timing
    return {
        "tokens": tokens, "logits": logits, "sites": sites,
        "pods": [topo.region_of(s) for s in sites],
        "inter_comms": grid.inter_comm_count(), "wan_bytes": grid.wan_bytes(),
        "lan_bytes": grid.lan_bytes(),
        "prefill_ms": 1e3 * t["prefill_s"],
        "decode_ms_per_token": 1e3 * t["decode_s"] / max(new_tokens, 1),
        "tokens_per_s": n_requests * new_tokens / (t["prefill_s"]
                                                   + t["decode_s"]),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=arch_ids(), default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's small variant instead of full width")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = M.init_params(cfg, seed=args.seed, device=dev)
    serve(cfg, params, n_requests=1, prompt_len=8, new_tokens=1,
          seed=args.seed)                                      # warm-up
    r = serve(cfg, params, n_requests=args.requests,
              prompt_len=args.prompt_len, new_tokens=args.new_tokens,
              seed=args.seed)
    for i, (site, pod) in enumerate(zip(r["sites"], r["pods"])):
        print(f"req {i} prefix{i % len(PREFIXES)} site {site} pod {pod} "
              f"completion {r['tokens'][i].tolist()}")
    summary = {k: r[k] for k in ("inter_comms", "wan_bytes", "lan_bytes",
                                 "prefill_ms", "decode_ms_per_token",
                                 "tokens_per_s", "peak_bytes")}
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(json.dumps({"arch": cfg.name, "reduced": args.reduced,
                      "device": name,
                      "params": cfg.param_count(), **summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
