"""Config-driven experiment runner: named scenarios through the port.

The counterpart of ``repro.launch.experiments``. Every experiment is one
:class:`repro_torch.core.ScenarioSpec` lowered to a ``run_experiment`` call
(:func:`run_spec`); the CLI runs named scenarios or sweeps from the
registry on the CUDA card (``--device cpu`` for the plain PyTorch
versions):

    PYTHONPATH=src python -m repro_torch.launch.experiments --list
    PYTHONPATH=src python -m repro_torch.launch.experiments \\
        --scenario grid_500_saturated --jobs 2000

It prints one line per run and, with ``--out PATH``, writes the rows as
JSON in the reference's ``BENCH_scenarios.json`` layout (the port never
writes the reference's ``results/``). Each row names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Iterable, Sequence

import torch

from repro_torch.core import (ExperimentResult, SCENARIOS, SWEEPS,
                              ScenarioSpec, SweepSpec, arrival_schedule,
                              get_scenario, get_sweep, injections,
                              run_experiment, to_grid_config)
from repro_torch.device import resolve_device


def run_spec(spec: ScenarioSpec, *, seed: int | None = None,
             n_jobs: int | None = None,
             device: str | torch.device = "cuda") -> ExperimentResult:
    """Lower one spec (at one seed) to ``run_experiment`` and run it."""
    seed = spec.seeds[0] if seed is None else seed
    n = spec.n_jobs if n_jobs is None else n_jobs
    cfg = to_grid_config(spec, seed)
    failures, slowdowns = injections(spec, seed=seed)
    return run_experiment(
        cfg, scheduler=spec.scheduler, strategy=spec.strategy, n_jobs=n,
        failures=failures or None, slowdowns=slowdowns or None,
        broker=spec.broker, batch_window=spec.batch_window_s,
        strategy_mode=spec.strategy_mode,
        arrival_burst=spec.arrival_burst,
        arrival_times=arrival_schedule(spec, n, seed=seed),
        net=spec.net, econ=spec.econ, econ_interval=spec.econ_interval_s,
        # "off" lowers to None so the REPRO_OBS environment value applies
        obs=None if spec.obs == "off" else spec.obs,
        obs_interval=spec.obs_interval_s, device=device,
    )


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run_scenario(spec: ScenarioSpec, *, n_jobs: int | None = None,
                 seeds: Sequence[int] | None = None,
                 device: str | torch.device = "cuda") -> list[dict]:
    """Run a spec once per seed; one machine-readable row per run."""
    dev = resolve_device(device)
    rows = []
    for seed in (spec.seeds if seeds is None else seeds):
        t0 = time.perf_counter()
        r = run_spec(spec, seed=seed, n_jobs=n_jobs, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rows.append({
            "scenario": spec.name, "seed": seed, "n_jobs": r.n_jobs,
            "device": device_name(dev),
            "wall_s": time.perf_counter() - t0,
            "avg_job_time_s": r.avg_job_time,
            "avg_inter_comms": r.avg_inter_comms,
            "completed_jobs": r.completed_jobs,
            "makespan_s": r.makespan,
            "total_wan_gb": r.total_wan_gb,
            "net_stats": r.net_stats,
        })
    return rows


def run_sweep_spec(sweep: SweepSpec, *, n_jobs: int | None = None,
                   device: str | torch.device = "cuda") -> dict:
    """Run a named sweep: every (axis value, seed) cell of the grid."""
    rows = []
    for value, cell in sweep.expand():
        for row in run_scenario(cell, n_jobs=n_jobs, device=device):
            rows.append({sweep.axis: value, **row})
    return {"sweep": sweep.to_dict(),
            "base_spec": get_scenario(sweep.base).to_dict(), "rows": rows}


def run_scenarios(names: Iterable[str], *, n_jobs: int | None = None,
                  out_path: str | None = None,
                  device: str | torch.device = "cuda") -> dict:
    """Run each named scenario *or sweep*, print one line per scenario,
    and write the payload to ``out_path`` when given."""
    payload: dict = {"n_jobs_override": n_jobs, "scenarios": {}, "sweeps": {}}
    for name in names:
        if name in SWEEPS:
            entry = run_sweep_spec(get_sweep(name), n_jobs=n_jobs,
                                   device=device)
            payload["sweeps"][name] = entry
            sw = entry["sweep"]
            print(f"{name:>16} sweep {sw['base']} x {sw['axis']}="
                  f"{sw['values']} rows={len(entry['rows'])}")
            continue
        spec = get_scenario(name)
        rows = run_scenario(spec, n_jobs=n_jobs, device=device)
        payload["scenarios"][name] = {"spec": spec.to_dict(), "rows": rows}
        r = rows[0]
        print(f"{name:>16} device={r['device']} seeds={len(rows)} "
              f"wall={r['wall_s']:.3f}s "
              f"avg_job_time={r['avg_job_time_s']!r}s "
              f"inter/job={r['avg_inter_comms']!r} "
              f"completed={r['completed_jobs']}/{r['n_jobs']} "
              f"makespan={r['makespan_s']!r}s")
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {out_path}")
    return payload


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Run named scenarios from the repro_torch.core.scenarios "
                    "registry on the CUDA card (or the CPU)")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--scenario", nargs="+", metavar="NAME",
                   help="scenario or sweep names to run (see --list)")
    g.add_argument("--list", action="store_true",
                   help="list registered scenarios + sweeps and exit")
    ap.add_argument("--jobs", type=int, default=None,
                    help="override every scenario's job count")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the rows as JSON to this path")
    args = ap.parse_args(argv)

    if args.list:
        for name, spec in sorted(SCENARIOS.items()):
            fan = "x".join(str(f) for f in spec.tier_fanouts)
            print(f"{name:>16}  [{fan} sites={spec.n_sites} "
                  f"arrival={spec.arrival} strategy={spec.strategy} "
                  f"broker={spec.broker} net={spec.net}]  "
                  f"{spec.description}")
        for name, sw in sorted(SWEEPS.items()):
            print(f"{name:>16}  [sweep {sw.base} x {sw.axis}="
                  f"{list(sw.values)}]  {sw.description}")
        return
    for name in args.scenario:
        if name not in SWEEPS:
            get_scenario(name)  # fail fast on typos before running anything
    run_scenarios(args.scenario, n_jobs=args.jobs, out_path=args.out,
                  device=args.device)


if __name__ == "__main__":
    main()
