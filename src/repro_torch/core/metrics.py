"""Aggregate metrics + the paper's experiment runner.

The counterpart of ``repro.core.metrics``: ``run_experiment`` keeps the
reference's signature and flag values and adds ``device`` (``"cuda"`` by
default; ``"cpu"`` runs the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .quantities import GB
from .simulator import GridSimulator
from .workload import GridConfig, build_catalog, build_topology, generate_jobs


@dataclasses.dataclass
class ExperimentResult:
    scheduler: str
    strategy: str
    n_jobs: int                  # submitted count (resubmissions not included)
    avg_job_time: float
    avg_inter_comms: float
    total_wan_gb: float
    total_lan_gb: float
    makespan: float
    completed_jobs: int = 0      # jobs that actually produced a record
    # NetworkEngine work counters and the speculative-prefetch ledger
    net_stats: dict = dataclasses.field(default_factory=dict)
    prefetches: int = 0
    prefetch_gb: float = 0.0


def run_experiment(
    cfg: GridConfig,
    *,
    scheduler: str = "dataaware",
    strategy: str = "hrs",
    strategy_mode: str = "sequential",
    n_jobs: int | None = None,
    failures: list[tuple[int, float, float]] | None = None,
    slowdowns: list[tuple[int, float, float, float]] | None = None,
    speculative_backups: bool = False,
    broker: str = "event",
    batch_window: float = 0.0,
    arrival_burst: int = 1,
    arrival_times: Sequence[float] | None = None,
    net: str = "numpy",
    econ: str = "numpy",
    econ_interval: float | None = None,
    obs: str | None = None,
    obs_interval: float | None = None,
    device: str | torch.device = "cuda",
) -> ExperimentResult:
    """One full simulation run (the unit behind every paper figure).

    Builds the grid described by ``cfg``, bootstraps master replicas,
    submits the generated workload, and runs the discrete-event engine to
    completion. ``scheduler``/``strategy`` name entries in the
    ``SCHEDULERS`` / ``STRATEGIES`` registries.

    Arrivals: by default job ``j`` is submitted at ``j * cfg.interarrival``;
    ``arrival_burst`` > 1 submits jobs in bursts of that size (same mean
    rate), which ``broker="jax"`` dispatches as one batched decision;
    ``arrival_times`` (one per job) overrides both. ``failures`` is a list
    of ``(site, at, duration)`` outages and ``slowdowns`` a list of
    ``(site, at, duration, factor)`` stragglers.

    ``net`` picks the network-engine backend (:data:`.simulator.NETS`):
    ``"numpy"``/``"pallas"`` incremental re-rating through the
    ``net_rerate`` kernel, ``"device"`` the batched flush through the
    ``event_engine`` kernel, ``"topmost"`` the legacy single-uplink
    accounting. ``device`` places the engine's state and the dispatch
    tensors: ``"cuda"`` (the default) runs the kernels on the card and
    raises without one; ``"cpu"`` runs their plain PyTorch versions.

    ``strategy_mode`` picks the planning engine: ``"sequential"`` (one
    ``plan_fetch`` per missing file) or ``"batch"`` (whole arrival bursts
    planned in one ``strategy_plan`` pass on ``device``). ``econ`` keeps
    the reference's values (``"pallas-interpret"`` raises once the economy
    is armed) and ``econ_interval`` is the economy's period: ``None`` arms
    it for the access-aware strategies (``economic``, ``predictive``), a
    value > 0 forces it on, 0 turns it off; its value matrix is scored by
    the ``value_score`` kernel on ``device``.

    Kept for the reference's signature and still raising when it would
    take effect: ``obs`` other than off.
    """
    topology = build_topology(
        cfg, path_model="topmost" if net == "topmost" else "full")
    catalog = build_catalog(cfg, topology)
    sim = GridSimulator(topology, catalog, scheduler=scheduler, strategy=strategy,
                        strategy_mode=strategy_mode,
                        seed=cfg.seed, speculative_backups=speculative_backups,
                        broker=broker, batch_window=batch_window, net=net,
                        econ=econ, econ_interval=econ_interval,
                        obs=obs, obs_interval=obs_interval, device=device)
    for info in catalog.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    jobs = generate_jobs(cfg, n_jobs)
    if arrival_times is not None and len(arrival_times) < len(jobs):
        raise ValueError(f"arrival_times has {len(arrival_times)} entries "
                         f"for {len(jobs)} jobs")
    for j, job in enumerate(jobs):
        if arrival_times is not None:
            at = float(arrival_times[j])
        else:
            at = (j // arrival_burst) * cfg.interarrival * arrival_burst
        sim.submit_job(job, at=at)
    for site, at, dur in failures or []:
        sim.inject_failure(site, at, dur)
    for site, at, dur, factor in slowdowns or []:
        sim.inject_slowdown(site, at, dur, factor)
    res = sim.run()
    return ExperimentResult(
        scheduler=scheduler, strategy=strategy, n_jobs=len(jobs),
        avg_job_time=res.avg_job_time, avg_inter_comms=res.avg_inter_comms,
        total_wan_gb=res.total_wan_bytes / GB, total_lan_gb=res.total_lan_bytes / GB,
        makespan=res.makespan,
        completed_jobs=len(res.records),
        net_stats=res.net_stats,
        prefetches=res.prefetches,
        prefetch_gb=res.prefetch_bytes / GB,
    )
