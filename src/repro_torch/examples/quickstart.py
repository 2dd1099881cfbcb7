"""Quickstart: reproduce the paper's headline result in one command.

Runs the Table-1 grid (4 regions x 13 sites, 10 GB SEs, 1000/10 Mbps) with
the paper's data-aware scheduler under the three replication strategies
and no replication, and prints the Fig. 4-6 metrics (the port's copy of
``examples/quickstart.py``, at the reference's defaults: 500 jobs,
``net="numpy"``, ``broker="event"``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

from ..core import GridConfig, run_experiment
from ..core.quantities import GB, MB, MBPS_TO_BYTES_PER_S
from ..device import resolve_device

STRATEGIES = ("hrs", "bhr", "lru", "noreplication")
#: the result fields returned for each strategy
METRICS = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "makespan",
           "completed_jobs")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = GridConfig()
    print(f"grid: {cfg.n_regions} regions x {cfg.sites_per_region} sites, "
          f"SE={cfg.storage_capacity / GB:.0f} GB, "
          f"LAN={cfg.lan_bandwidth / MBPS_TO_BYTES_PER_S:.0f} Mbps, "
          f"WAN={cfg.wan_bandwidth / MBPS_TO_BYTES_PER_S:.0f} Mbps, "
          f"{cfg.n_jobs} jobs x {cfg.files_per_job} x "
          f"{cfg.file_size / MB:.0f} MB files")
    print(f"{'strategy':>14} {'avg job time':>14} {'inter-comms/job':>16} "
          f"{'WAN GB':>8}")
    results = {}
    for strat in STRATEGIES:
        r = run_experiment(cfg, strategy=strat, device=dev)
        results[strat] = {m: getattr(r, m) for m in METRICS}
        print(f"{strat:>14} {r.avg_job_time:>13.0f}s "
              f"{r.avg_inter_comms:>16.2f} {r.total_wan_gb:>8.1f}")
    gain = 100 * (results["bhr"]["avg_job_time"]
                  - results["hrs"]["avg_job_time"]) \
        / results["bhr"]["avg_job_time"]
    print(f"\nHRS over BHR: {gain:.1f}% faster total job execution "
          f"(paper reports ~12%)")
    return {"n_jobs": cfg.n_jobs, "results": results, "hrs_over_bhr_pct": gain}


if __name__ == "__main__":
    main()
