"""Site churn and the simulation CLI in the port, against the reference.

``repro_torch.fault.failures.churn_schedule`` gives
``repro.fault.failures.churn_schedule``'s lists for every spec and seed
tried; the registered ``site_churn`` scenario (six outages over the paper
grid) matches the reference record for record on the CPU; and
``python -m repro_torch.launch.simulate`` prints the reference CLI's
numbers.
"""

import dataclasses

import pytest

import repro.core as ref
import repro.core.metrics as ref_metrics
from repro.fault.failures import churn_schedule as ref_churn_schedule
from repro.launch.experiments import run_spec as ref_run_spec
import repro_torch.core as port
from repro_torch.core import SCENARIOS, ChurnSpec, injections
from repro_torch.fault import churn_schedule
from repro_torch.launch import simulate

SPECS = [
    ChurnSpec(),
    ChurnSpec(n_failures=1, window=(0.0, 0.0)),
    ChurnSpec(n_failures=6, window=(1000.0, 30000.0),
              mean_downtime_s=4000.0),
    ChurnSpec(n_failures=20, window=(2000.0, 42000.0),
              mean_downtime_s=1.0),
    ChurnSpec(n_failures=60, window=(500.0, 500.5),
              mean_downtime_s=9000.0),
]


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"n{s.n_failures}")
@pytest.mark.parametrize("n_sites", [8, 52, 500])
def test_churn_schedule_matches_reference(spec, seed, n_sites):
    ref_spec = ref.ChurnSpec(**dataclasses.asdict(spec))
    assert churn_schedule(spec, n_sites, seed=seed) == \
        ref_churn_schedule(ref_spec, n_sites, seed=seed)


def test_injections_match_reference():
    for name in ("site_churn", "paper_baseline"):
        for seed in (0, 3):
            assert injections(SCENARIOS[name], seed=seed) == \
                ref.injections(ref.SCENARIOS[name], seed=seed)


def _records(spec, n_jobs, core, **kw):
    """Job records of ``spec`` run through ``core``'s simulator the way
    ``run_experiment`` runs it (uniform arrivals, churn injected)."""
    cfg = core.to_grid_config(spec)
    topo = core.build_topology(cfg)
    cat = core.build_catalog(cfg, topo)
    sim = core.GridSimulator(topo, cat, scheduler=spec.scheduler,
                             strategy=spec.strategy, seed=cfg.seed,
                             net=spec.net, **kw)
    for info in cat.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    assert core.arrival_schedule(spec, n_jobs) is None
    for j, job in enumerate(core.generate_jobs(cfg, n_jobs)):
        sim.submit_job(job, at=j * cfg.interarrival)
    failures, _ = core.injections(spec, seed=cfg.seed)
    for site, at, dur in failures:
        sim.inject_failure(site, at, dur)
    res = sim.run()
    return [dataclasses.astuple(r) for r in res.records], res


@pytest.mark.parametrize("net", ["numpy", "device"])
def test_site_churn_matches_reference_record_for_record(net):
    spec = dataclasses.replace(SCENARIOS["site_churn"], net=net)
    ref_spec = dataclasses.replace(ref.SCENARIOS["site_churn"], net=net)
    n = spec.n_jobs if net == "numpy" else 200
    got, gres = _records(spec, n, port, device="cpu")
    want, wres = _records(ref_spec, n, ref)
    assert len(got) == n
    assert any(r[-1] > 0 for r in got)          # jobs were resubmitted
    assert got == want
    assert gres.makespan == wres.makespan
    assert gres.net_stats == wres.net_stats


def test_site_churn_run_spec_metrics_match_reference():
    """Through the entry point: the four pinned metrics (avg_job_time as
    the left-to-right mean of the reference's records)."""
    from repro_torch.launch.experiments import run_spec

    got = run_spec(SCENARIOS["site_churn"], n_jobs=120, device="cpu")
    base = ref_metrics.GridSimulator
    sims = []

    class Recording(base):
        def run(self, *a, **kw):
            sims.append(super().run(*a, **kw))
            return sims[-1]

    ref_metrics.GridSimulator = Recording
    try:
        want = ref_run_spec(ref.SCENARIOS["site_churn"], n_jobs=120)
    finally:
        ref_metrics.GridSimulator = base
    total = 0.0
    for rec in sims[0].records:
        total += rec.job_time
    assert got.avg_job_time == total / len(sims[0].records)
    assert (got.makespan, got.avg_inter_comms, got.completed_jobs) == \
        (want.makespan, want.avg_inter_comms, want.completed_jobs)


def _table(text: str) -> list[list[str]]:
    """The strategy rows of a simulate table: name, avg_job_time,
    inter/job, WAN GB, makespan."""
    rows = []
    for line in text.splitlines():
        parts = line.split()
        if parts and parts[0] in ("hrs", "bhr", "lru"):
            rows.append(parts[:5])
    return rows


@pytest.mark.parametrize("argv", [
    ["--failures", "2", "--regions", "2", "--sites", "4", "--jobs", "60"],
    ["--scenario", "site_churn", "--jobs", "60", "--strategy", "hrs"],
    ["--scenario", "paper_baseline", "--jobs", "40", "--failures", "1",
     "--strategy", "lru", "--obs", "report"],
], ids=["adhoc-failures", "site_churn", "scenario-failures-obs"])
def test_simulate_cli_matches_reference(argv, capsys):
    from repro.launch import simulate as ref_simulate
    import sys

    simulate.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    saved = sys.argv
    sys.argv = ["simulate"] + argv
    try:
        ref_simulate.main()
    finally:
        sys.argv = saved
    want = capsys.readouterr().out
    assert got.splitlines()[0] == "device: cpu"
    assert _table(got) and _table(got) == _table(want)
    assert got.count("exact: avg_job_time=") == len(_table(got))
    if "--obs" in argv:
        assert "phases[s]" in got and "span net.rerate" in got


def test_simulate_needs_a_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        simulate.main(["--jobs", "2"])
