"""Tie-race helpers: the port's ``repro.analysis.tierace``.

* :func:`static_tie_key_findings` — simlint rule SL010 alone: every
  ``heapq.heappush`` pushes a literal ``(time, seq, ...)`` tuple, so
  same-timestamp pops are ordered by the monotonic submission counter
  instead of whatever the heap sift happens to do. By default it runs over
  the port's ``core/``.
* :func:`canonical_records` — the order-free projection of a
  :class:`~repro_torch.core.simulator.SimResult` used by the determinism
  tests: per-job records sorted by job id plus the scalar totals. Two
  runs that differ only in same-timestamp *insertion order* must agree on
  this projection exactly.
* :func:`sanitize_smoke` — runs a small paper-grid scenario with the
  engine's ``sanitize=True`` twin-replay mode and returns the tie report
  (how many tie instants were replayed, which raced), on the CUDA card by
  default.

A note on what "race" means here: the engine is deterministic by
construction — (time, seq) keys pin one canonical order. The sanitizer
asks the stronger question *"would a different causally-valid order at
this instant change observable state?"*. Sequential policies whose
decisions read mutable load state (or consume a shared PRNG stream) are
*expected* to race under reordering; the deterministic seq key is
exactly what makes that acceptable.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..core.simulator import GridSimulator
from ..core.workload import (GridConfig, build_catalog, build_topology,
                             generate_jobs)
from .findings import Finding
from .simlint import lint_source

#: the event-loop package SL010 guards
CORE_DIR = Path(__file__).resolve().parents[1] / "core"


def static_tie_key_findings(paths: list[Path] | None = None
                            ) -> list[Finding]:
    """Run only the SL010 heappush-tie-key rule over ``paths`` (default:
    every module of the port's ``core/``)."""
    if paths is None:
        paths = sorted(CORE_DIR.glob("*.py"))
    out: list[Finding] = []
    for path in paths:
        source = path.read_text()
        rel = path.as_posix()
        out.extend(f for f in lint_source(source, rel) if f.rule == "SL010")
    return out


def canonical_records(result) -> dict:
    """Order-free projection of a SimResult / run_experiment records list:
    identical across any causally-equivalent event reordering."""
    return {
        "records": sorted(
            (r.job_id, r.job_type, r.site, r.submit_time,
             r.data_ready_time, r.start_time, r.finish_time,
             r.inter_comms, r.wan_bytes, r.resubmits)
            for r in result.records),
        "total_inter_comms": result.total_inter_comms,
        "total_wan_bytes": result.total_wan_bytes,
        "total_lan_bytes": result.total_lan_bytes,
        "makespan": result.makespan,
    }


def sanitize_smoke(*, n_jobs: int = 40, seed: int = 0,
                   scheduler: str = "dataaware", strategy: str = "hrs",
                   device: str | torch.device = "cuda") -> dict:
    """Run a small paper grid with ``sanitize=True`` and burst arrivals
    (shared arrival timestamps force tie groups) on ``device``, returning
    the tie report."""
    cfg = GridConfig(seed=seed)
    topology = build_topology(cfg)
    catalog = build_catalog(cfg, topology)
    sim = GridSimulator(topology, catalog, scheduler=scheduler,
                        strategy=strategy, seed=cfg.seed, sanitize=True,
                        device=device)
    for info in catalog.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    burst = 8
    for j, job in enumerate(generate_jobs(cfg, n_jobs)):
        sim.submit_job(job, at=(j // burst) * cfg.interarrival * burst)
    sim.run()
    return {
        "ties_seen": sim.ties_seen,
        "tie_races": [
            {"time": r.time, "kinds": list(r.kinds), "detail": r.detail}
            for r in sim.tie_races],
    }
