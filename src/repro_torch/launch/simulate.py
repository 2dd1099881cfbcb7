"""Simulation CLI: run a registered scenario, or an ad-hoc grid, across
replication strategies, on the CUDA card (``--device cpu`` for the
kernels' plain PyTorch versions).

  PYTHONPATH=src python -m repro_torch.launch.simulate --strategy hrs bhr lru \\
      --jobs 500 --wan-mbps 10
  PYTHONPATH=src python -m repro_torch.launch.simulate --scenario cache_starved
  PYTHONPATH=src python -m repro_torch.launch.simulate \\
      --scenario grid_500_saturated --jobs 2000 --strategy hrs --obs report
  PYTHONPATH=src python -m repro_torch.launch.simulate --failures 2 \\
      --regions 2 --sites 4 --device cpu

Both forms build a ``ScenarioSpec`` and run it through
``repro_torch.launch.experiments.run_spec`` — the same config-driven path
the scenario runner uses. The counterpart of ``repro.launch.simulate``;
each run's line adds its wall time (ended by a device synchronise) and is
followed by its metrics unrounded; under an ``--obs`` mode the measured
phase breakdown and each span's self time follow. For machine-readable
multi-scenario output use ``python -m repro_torch.launch.experiments``
instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.core import (ChurnSpec, ECON_BACKENDS, OBS_MODES, SCENARIOS,
                              STRATEGIES, STRATEGY_MODES, SCHEDULERS,
                              ScenarioSpec, get_scenario)
from repro_torch.core.simulator import NETS
from repro_torch.device import resolve_device
from repro_torch.launch.experiments import device_name, run_spec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS),
                    help="run a registered scenario instead of the ad-hoc "
                         "grid flags below")
    ap.add_argument("--strategy", nargs="+", default=["hrs", "bhr", "lru"],
                    choices=list(STRATEGIES))
    ap.add_argument("--scheduler", default="dataaware",
                    choices=list(SCHEDULERS))
    ap.add_argument("--jobs", type=int, default=None,
                    help="job count (default: 500, or the scenario's)")
    ap.add_argument("--wan-mbps", type=float, default=10.0)
    ap.add_argument("--lan-mbps", type=float, default=1000.0)
    ap.add_argument("--regions", type=int, default=4)
    ap.add_argument("--sites", type=int, default=13)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--net", default=None, choices=list(NETS),
                    help="network-engine backend (default: the scenario's, "
                         "or 'numpy'; 'topmost' = legacy single-uplink model)")
    ap.add_argument("--econ", default=None, choices=list(ECON_BACKENDS),
                    help="replication-economy value-scoring backend "
                         "(default: the scenario's, or 'numpy')")
    ap.add_argument("--strategy-mode", default=None, choices=list(STRATEGY_MODES),
                    help="strategy planning engine (default: the scenario's, "
                         "or 'sequential'; 'batch' plans each arrival burst "
                         "in one strategy_plan kernel pass)")
    ap.add_argument("--econ-interval", type=float, default=None,
                    help="seconds between proactive-replication rounds "
                         "(default: auto — armed only for the economic/"
                         "predictive strategies; 0 disables)")
    ap.add_argument("--obs", default=None, choices=list(OBS_MODES),
                    help="telemetry mode (default: the scenario's, or off; "
                         "report/series/trace print the measured phase "
                         "breakdown and span self times per run)")
    ap.add_argument("--obs-interval", type=float, default=None,
                    help="sim-seconds between telemetry ring-buffer samples "
                         "(series/trace modes; default 300)")
    ap.add_argument("--failures", type=int, default=0,
                    help="number of random site failures to inject")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.scenario is not None:
        spec = get_scenario(args.scenario)
        if args.failures:
            spec = dataclasses.replace(spec, churn=ChurnSpec(
                n_failures=args.failures,
                window=(2000.0, 2000.0 * (args.failures + 1)),
                mean_downtime_s=4000.0))
    else:
        churn = ChurnSpec(n_failures=args.failures,
                          window=(2000.0, 2000.0 * (args.failures + 1)),
                          mean_downtime_s=4000.0) if args.failures else ChurnSpec()
        spec = ScenarioSpec(
            name="cli", description="ad-hoc CLI grid",
            tier_fanouts=(args.regions, args.sites),
            lan_mbps=args.lan_mbps, uplink_mbps=(args.wan_mbps,),
            scheduler=args.scheduler, churn=churn, seeds=(args.seed,))
    if args.net is not None:
        spec = dataclasses.replace(spec, net=args.net)
    if args.econ is not None:
        spec = dataclasses.replace(spec, econ=args.econ)
    if args.strategy_mode is not None:
        spec = dataclasses.replace(spec, strategy_mode=args.strategy_mode)
    if args.econ_interval is not None:
        spec = dataclasses.replace(spec, econ_interval_s=args.econ_interval)
    if args.obs is not None:
        spec = dataclasses.replace(spec, obs=args.obs)
    if args.obs_interval is not None:
        spec = dataclasses.replace(spec, obs_interval_s=args.obs_interval)
    print(f"device: {device_name(dev)}")
    print(f"{'strategy':>14} {'avg_job_time':>13} {'inter/job':>10} "
          f"{'WAN GB':>8} {'makespan':>10} {'wall':>10}")
    for strat in args.strategy:
        t0 = time.perf_counter()
        r = run_spec(dataclasses.replace(spec, strategy=strat),
                     seed=args.seed, n_jobs=args.jobs, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        print(f"{strat:>14} {r.avg_job_time:>12.0f}s {r.avg_inter_comms:>10.2f} "
              f"{r.total_wan_gb:>8.1f} {r.makespan:>9.0f}s {wall:>9.3f}s")
        print(f"{'':>14} exact: avg_job_time={r.avg_job_time!r} "
              f"makespan={r.makespan!r} inter/job={r.avg_inter_comms!r} "
              f"completed={r.completed_jobs}/{r.n_jobs}")
        if r.telemetry is not None:
            tel = r.telemetry
            ph = tel.phase_breakdown()
            print(f"{'':>14} phases[s]: "
                  f"dispatch={ph['dispatch_s']!r} "
                  f"strategy_plan={ph['strategy_plan_s']!r} "
                  f"flush={ph['flush_s']!r} other={ph['other_s']!r} "
                  f"(wall={tel.wall_s!r}, "
                  f"samples={tel.n_samples})")
            for name, self_s in sorted(tel.phase_self_s.items(),
                                       key=lambda kv: -kv[1]):
                calls = tel.phase_calls[name]
                print(f"{'':>14} span {name:<20} self_s={self_s!r} "
                      f"calls={calls} "
                      f"us_per_call={1e6 * self_s / calls:.1f}")


if __name__ == "__main__":
    main()
