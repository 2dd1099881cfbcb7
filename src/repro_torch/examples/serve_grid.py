"""Serving example: greedy decoding with grid-routed request placement
(prefix-KV locality via the paper's scheduler + HRS; the port's copy of
``examples/serve_grid.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_grid \\
        [--reduced] [--device cpu]

On the card the model is granite-3-8b at full width and depth (40 layers,
bf16 weights from seed 0, ~16.3 GB); ``--reduced`` gives the reference
example's small config. The pool is ``launch.serve.make_router``'s: two
pods of four engine sites, three 2 GB prefix-KV artifacts at sites 0, 3
and 6.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..launch.serve import make_router
from ..models import model as M
from ..serve.engine import Request, ServeEngine

ARCH = "granite-3-8b"
#: requests, prompt tokens and new tokens of each, the engine's cache
N_REQUESTS, PROMPT, NEW_TOKENS, MAX_LEN = 12, 8, 8, 64


def serve_requests(cfg, params: dict, *, backend: str = "auto") -> dict:
    """Route ``N_REQUESTS`` random prompts (``np.random.default_rng(0)``,
    the reference's draws) through a fresh pool, one at a time, each
    served by ``ServeEngine(max_len=MAX_LEN).generate`` on ``params``'
    device and then completed. Returns each request's prefix, site, pod
    and tokens, the logits each token was the argmax of (N_REQUESTS,
    NEW_TOKENS, V) on the device, the grid's transfer totals and the
    engine's seconds."""
    topo, grid, router = make_router()
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, backend=backend)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=(PROMPT,))
                    .astype(np.int32), max_new_tokens=NEW_TOKENS,
                    prefix_id=f"prefix{i % 3}")
            for i in range(N_REQUESTS)]
    rows, logits, prefill_s, decode_s = [], [], 0.0, 0.0
    for r in reqs:
        site = router.route(r)
        out, seen = engine.generate(r.tokens[None, :], n_new=r.max_new_tokens,
                                    return_logits=True)
        router.complete(site, r)
        rows.append({"request": r.request_id, "prefix": r.prefix_id,
                     "site": site, "pod": topo.region_of(site),
                     "tokens": out[0].tolist()})
        logits.append(seen[0])
        prefill_s += engine.last_timing["prefill_s"]
        decode_s += engine.last_timing["decode_s"]
    return {"requests": rows, "logits": torch.stack(logits),
            "inter_comms": grid.inter_comm_count(),
            "wan_bytes": grid.wan_bytes(), "lan_bytes": grid.lan_bytes(),
            "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the reference example's small granite-3-8b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(ARCH)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, seed=0, device=dev)
    out = serve_requests(cfg, params)

    print(f"{'req':>4} {'prefix':>8} {'site':>5} {'pod':>4}  completion")
    for row in out["requests"]:
        print(f"{row['request']:>4} {row['prefix']:>8} {row['site']:>5} "
              f"{row['pod']:>4}  {row['tokens']}")
    print(f"\ninter-pod transfers: {out['inter_comms']} "
          f"(WAN {out['wan_bytes']/1e9:.1f} GB) — prefix locality keeps "
          f"requests in the pod that owns their KV block")
    return out


if __name__ == "__main__":
    main()
