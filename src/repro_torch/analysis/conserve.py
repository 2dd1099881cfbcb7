"""Runtime conservation auditor: ledger-closure invariants, replayed.

The counterpart of ``repro.analysis.conserve``, run on the port's
simulator: the engine's double-entry accounting must close over a real
run. Every byte the network engine bills must show up in exactly one
access-history ledger, every reserved byte of storage must be backed by a
catalogued replica, and every speculative prefetch the economy started
must have been debited once — on the ``numpy`` route (``net_rerate``) and
on the batched ``device`` route (``event_engine``), on the CUDA card by
default (``device="cpu"`` runs the kernels' plain versions).

The simulator is built by hand from a named
:class:`~repro_torch.core.scenarios.ScenarioSpec` so the post-run engine
objects stay inspectable (the public
:func:`~repro_torch.core.metrics.run_experiment` only returns the
aggregated :class:`ExperimentResult`). Arrival handling matches
``run_experiment`` exactly — bursts and spec-driven arrival processes
included — so the audited runs are the shipped runs.

Invariants (failure-free runs; ``I2``/``I7`` are skipped when the
scenario injects churn because aborted transfers are billed at start):

* **I1 byte ledger** — ``total_wan_bytes + total_lan_bytes`` (billed at
  transfer start by the engine) equals ``wan_bytes + lan_bytes +
  prefetch_bytes`` in the access history (debited by the same call).
* **I2 inter-comms** — ``total_inter_comms`` equals the access ledger's
  ``remote_fetches``: every inter-region job fetch is counted once on
  each side.
* **I3 site occupancy** — per site: ``used_storage`` equals the summed
  catalog sizes of ``storage.site_contents(site)``, never exceeds
  ``storage_capacity``, and the contents set equals the catalog's
  holder view of that site (replica-table coherence).
* **I4 aggregate replicas** — total ``used_storage`` over sites equals
  ``sum(size(lfn) * n_holders(lfn))`` over the catalog.
* **I5 drained** — no in-flight transfers survive ``run()``.
* **I6 prefetch ledger** — the access history's ``prefetches`` equals
  the result's counter, equals the obs probe's ``econ.prefetch_started``
  count, and never exceeds the optimizer's ``proposed`` total.
* **I7 completion** — every submitted job produced a record.

Float note: file sizes are exact float64 values (multiples of
``500 * MB``) and the summed totals stay far below 2**53, so the
equalities hold *exactly* on a sound engine; the comparisons still use
a relative tolerance so the auditor reports a broken invariant rather
than FP noise if a future scenario uses non-representable sizes.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..core.scenarios import arrival_schedule, get_scenario, to_grid_config
from ..core.simulator import GridSimulator
from ..core.workload import build_catalog, build_topology, generate_jobs
from ..fault.failures import churn_schedule

#: Relative tolerance for byte-total comparisons (see float note above).
REL_TOL = 1e-9


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=REL_TOL, abs_tol=1e-6)


def _check(checks: dict[str, Any], name: str, ok: bool, lhs, rhs,
           detail: str) -> None:
    checks[name] = {"ok": bool(ok), "lhs": lhs, "rhs": rhs, "what": detail}


def conservation_audit(scenario: str = "paper_baseline", *,
                       n_jobs: int | None = None,
                       net: str | None = None,
                       seed: int | None = None,
                       obs: str = "report",
                       device: str | torch.device = "cuda"
                       ) -> dict[str, Any]:
    """Run a scenario to completion on ``device`` and audit the ledgers.

    ``n_jobs`` / ``net`` / ``seed`` override the spec (the CI smoke
    trims job counts); ``obs="report"`` keeps the probe counters the I6
    prefetch check reads. Returns a JSON-ready report with per-invariant
    ``{ok, lhs, rhs, what}`` entries and an overall ``ok``.
    """
    spec = get_scenario(scenario)
    cfg = to_grid_config(spec, seed)
    if n_jobs is not None:
        cfg.n_jobs = n_jobs
    net = spec.net if net is None else net
    topology = build_topology(
        cfg, path_model="topmost" if net == "topmost" else "full")
    catalog = build_catalog(cfg, topology)
    sim = GridSimulator(
        topology, catalog, scheduler=spec.scheduler, strategy=spec.strategy,
        strategy_mode=spec.strategy_mode, seed=cfg.seed, broker=spec.broker,
        batch_window=spec.batch_window_s, net=net, econ=spec.econ,
        econ_interval=spec.econ_interval_s, obs=obs, device=device)
    for info in catalog.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    jobs = generate_jobs(cfg)
    times = arrival_schedule(spec, len(jobs), seed=cfg.seed)
    for j, job in enumerate(jobs):
        at = (times[j] if times is not None
              else (j // spec.arrival_burst) * cfg.interarrival
              * spec.arrival_burst)
        sim.submit_job(job, at=at)
    failures = churn_schedule(spec.churn, topology.n_sites, seed=cfg.seed)
    for site, at, dur in failures:
        sim.inject_failure(site, at, dur)
    for site, at, dur, factor in spec.slowdowns:
        sim.inject_slowdown(site, at, dur, factor)
    res = sim.run()
    failure_free = not failures and not spec.slowdowns

    checks: dict[str, Any] = {}
    acc = sim.access

    billed = res.total_wan_bytes + res.total_lan_bytes
    debited = acc.wan_bytes + acc.lan_bytes + acc.prefetch_bytes
    _check(checks, "I1_byte_ledger", _close(billed, debited), billed, debited,
           "engine WAN+LAN bytes == access-history fetch+prefetch bytes")

    if failure_free:
        _check(checks, "I2_inter_comms",
               res.total_inter_comms == acc.remote_fetches,
               res.total_inter_comms, acc.remote_fetches,
               "inter-region comms counter == remote fetches debited")

    occupancy_ok = True
    coherent_ok = True
    capacity_ok = True
    bad_site = None
    for site in topology.sites:
        contents = sim.storage.site_contents(site.site_id)
        held = sum(catalog.size(lfn) for lfn in contents)
        cat_view = {lfn for lfn, info in catalog.files.items()
                    if site.site_id in catalog.holders(lfn)}
        if not _close(site.used_storage, held):
            occupancy_ok = False
        if set(contents) != cat_view:
            coherent_ok = False
        if site.used_storage > site.storage_capacity * (1 + REL_TOL):
            capacity_ok = False
        if not (occupancy_ok and coherent_ok and capacity_ok) \
                and bad_site is None:
            bad_site = site.site_id
    _check(checks, "I3_site_occupancy",
           occupancy_ok and coherent_ok and capacity_ok,
           bad_site, None,
           "per-site used_storage == sum(contents sizes) <= capacity, "
           "contents set == catalog holders")

    total_used = sum(s.used_storage for s in topology.sites)
    replica_bytes = sum(info.size * len(catalog.holders(lfn))
                        for lfn, info in catalog.files.items())
    _check(checks, "I4_aggregate_replicas", _close(total_used, replica_bytes),
           total_used, replica_bytes,
           "total used storage == sum(size * n_holders) over the catalog")

    _check(checks, "I5_drained", not sim._transfers, len(sim._transfers), 0,
           "no in-flight transfers survive run()")

    counters = getattr(sim._obs, "counters", {}) or {}
    started = counters.get("econ.prefetch_started", 0)
    proposed = sim._econ.proposed if sim._econ is not None else 0
    _check(checks, "I6_prefetch_ledger",
           (acc.prefetches == res.prefetches == started
            and started <= proposed),
           (acc.prefetches, res.prefetches, started), proposed,
           "prefetch debits == result counter == obs events <= proposals")

    if failure_free:
        _check(checks, "I7_completion", len(res.records) == len(jobs),
               len(res.records), len(jobs),
               "every submitted job produced a record")

    return {
        "scenario": scenario,
        "n_jobs": len(jobs),
        "net": net,
        "seed": cfg.seed,
        "failure_free": failure_free,
        "makespan": res.makespan,
        "checks": checks,
        "ok": all(c["ok"] for c in checks.values()),
    }


def run_conservation_smoke(*, n_jobs: int = 60,
                           device: str | torch.device = "cuda"
                           ) -> list[dict[str, Any]]:
    """The conservation gate: paper baseline + the economy regime
    (prefetch ledger live), numpy engine, trimmed workload."""
    return [
        conservation_audit("paper_baseline", n_jobs=n_jobs, net="numpy",
                           device=device),
        conservation_audit("economy_starved", n_jobs=n_jobs, net="numpy",
                           device=device),
    ]
