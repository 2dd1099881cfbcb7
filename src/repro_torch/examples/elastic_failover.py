"""Fault-tolerance walkthrough: checkpoint -> node failure -> HRS-selected
restore source -> elastic re-shard to a smaller host set (the port's copy
of ``examples/elastic_failover.py``).

    PYTHONPATH=src python -m repro_torch.examples.elastic_failover \\
        [--reduced] [--device cpu]

On the card the model is gemma3-1b at full width and depth; ``--reduced``
gives the reference example's small config.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from ..checkpoint.ckpt import (choose_restore_sources, restore_checkpoint,
                               save_checkpoint)
from ..configs import get_config
from ..core import GridConfig, GridTopology, run_experiment
from ..device import resolve_device
from ..models import model as M
from ..train.optimizer import tree_leaves

N_JOBS = 150
#: (site, at, duration) outages of the failed run
FAILURES = ((3, 2000.0, 5000.0), (17, 8000.0, 4000.0))
#: the checkpoint: its step, shards and the sites holding its replicas
#: (one a pod), and the restarting host
STEP, N_SHARDS, REPLICAS, DST_SITE = 100, 8, (1, 5), 6
#: the result fields returned for each simulated run
METRICS = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "makespan",
           "completed_jobs", "n_jobs")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the reference example's small gemma3-1b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1) DES view: inject site failures into the grid simulation; jobs are
    #    resubmitted through the broker, replicas re-fetched from masters.
    base = run_experiment(GridConfig(), strategy="hrs", n_jobs=N_JOBS,
                          device=dev)
    failed = run_experiment(GridConfig(), strategy="hrs", n_jobs=N_JOBS,
                            failures=list(FAILURES), device=dev)
    print("[DES] avg job time:"
          f" healthy={base.avg_job_time:.0f}s"
          f" with-2-failures={failed.avg_job_time:.0f}s"
          f" (all {failed.n_jobs} jobs completed)")

    # 2) Runtime view: checkpoint a model, fail a host, restore choosing
    #    sources by HRS, re-shard onto a smaller host set.
    cfg = get_config("gemma3-1b")
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, seed=0, device=dev)
    topo = GridTopology(2, 4, lan_bandwidth=50e9, wan_bandwidth=3.125e9,
                        storage_capacity=256e9)
    with tempfile.TemporaryDirectory() as d:
        man = save_checkpoint(params, d, step=STEP, n_shards=N_SHARDS,
                              replicate_to=list(REPLICAS))  # one copy per pod
        print(f"[ckpt] saved step {STEP}: {len(man.replicas)} chunks, "
              f"replicas at sites 1 (pod 0) and 5 (pod 1)")

        # host 6 (pod 1) restarts: HRS picks the intra-pod replica at 5
        srcs = choose_restore_sources(man, topo, dst_site=DST_SITE)
        if set(srcs.values()) != {5}:
            raise AssertionError(f"restore sources {set(srcs.values())}, "
                                 "want the intra-pod replica at site 5")
        print("[restore] host 6 (pod 1) pulls every chunk from site 5 "
              "(intra-pod) — zero cross-pod restore traffic")

        # elastic re-shard: the 8-shard checkpoint restores fine regardless
        # of the target topology
        restored, _ = restore_checkpoint(d, STEP, like=params, device=dev)
        pairs = list(zip(tree_leaves(params), tree_leaves(restored)))
        same = all(a.dtype == b.dtype and a.device == b.device
                   and torch.equal(a, b) for a, b in pairs)
        print(f"[elastic] bit-exact restore onto a different host count: "
              f"{same}")
    return {"des": {"healthy": {m: getattr(base, m) for m in METRICS},
                    "with_failures": {m: getattr(failed, m)
                                      for m in METRICS}},
            "arch": cfg.name, "layers": cfg.n_layers,
            "chunks": len(man.replicas),
            "restore_sources": sorted(set(srcs.values())),
            "bit_exact": same, "leaves": len(pairs)}


if __name__ == "__main__":
    main()
