"""What the port carries over from the reference beside the engine:
configuration and scenario state, the entry points, and the features that
ride on them (telemetry through ``obs=`` and ``REPRO_OBS``, the tie-race
sanitizer, churn injection)."""

import dataclasses
import json

import pytest

import repro.core as ref
from repro_torch.core import (SCENARIOS, STRATEGIES, SWEEPS, GridConfig,
                              GridSimulator, build_catalog, build_topology,
                              generate_jobs, make_strategy, run_experiment)
from repro_torch.core.replica import StorageState
from repro_torch.launch import experiments


@pytest.mark.parametrize("cfg", [
    ref.GridConfig(),
    ref.to_grid_config(ref.SCENARIOS["grid_500_saturated"]),
    ref.to_grid_config(ref.SCENARIOS["deep_contended"]),
    ref.to_grid_config(ref.SCENARIOS["fat_region"]),
], ids=["paper", "grid_500_saturated", "deep_contended", "fat_region"])
def test_grid_config_from_reference_dict(cfg):
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))   # lists, not tuples
    port = GridConfig.from_dict(d)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.n_sites == cfg.n_sites and port.n_files == cfg.n_files
    topo, rtopo = build_topology(port), ref.build_topology(cfg)
    assert [l.bandwidth for l in topo.wan_links] == \
        [l.bandwidth for l in rtopo.wan_links]


def test_scenario_registry_is_the_reference_registry():
    assert sorted(SCENARIOS) == sorted(ref.SCENARIOS)
    for name, spec in SCENARIOS.items():
        assert spec.to_dict() == ref.SCENARIOS[name].to_dict(), name
    assert sorted(SWEEPS) == sorted(ref.SWEEPS)
    assert sorted(STRATEGIES) == sorted(ref.STRATEGIES)


def _sim(**kw):
    cfg = GridConfig(n_regions=2, sites_per_region=4)
    topo = build_topology(cfg)
    return GridSimulator(topo, build_catalog(cfg, topo), device="cpu", **kw)


def _run(sim, n_jobs=30):
    cfg = GridConfig(n_regions=2, sites_per_region=4)
    for info in sim.catalog.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    for j, job in enumerate(generate_jobs(cfg, n_jobs)):
        sim.submit_job(job, at=(j // 5) * cfg.interarrival * 5)
    return sim.run()


@pytest.mark.parametrize("kw", [dict(obs="report"), dict(sanitize=True)],
                         ids=["obs", "sanitize"])
def test_obs_and_sanitize_run(kw):
    """Both run and leave the records of a plain run as they are."""
    got, want = _run(_sim(**kw)), _run(_sim())
    assert got.records == want.records
    assert got.makespan == want.makespan
    if "obs" in kw:
        assert got.telemetry.mode == "report"
        assert got.telemetry.counters["event.CPU_DONE"] == 30
    else:
        sim = _sim(**kw)
        _run(sim)
        assert sim.ties_seen > 0


def test_repro_obs_environment_is_not_ignored(monkeypatch):
    want = _run(_sim())
    monkeypatch.setenv("REPRO_OBS", "trace")
    got = _run(_sim())
    assert got.telemetry is not None and got.telemetry.mode == "trace"
    assert (got.avg_job_time, got.makespan, got.total_wan_bytes) == \
        (want.avg_job_time, want.makespan, want.total_wan_bytes)
    assert got.records == want.records
    monkeypatch.setenv("REPRO_OBS", "loud")
    with pytest.raises(ValueError, match="obs mode"):
        _sim()
    monkeypatch.setenv("REPRO_OBS", "off")
    assert _run(_sim()).telemetry is None


def test_churn_scenarios_run():
    r = experiments.run_spec(SCENARIOS["site_churn"], n_jobs=60,
                             device="cpu")
    want = ref.run_experiment(
        ref.to_grid_config(ref.SCENARIOS["site_churn"]), n_jobs=60,
        failures=ref.injections(ref.SCENARIOS["site_churn"])[0])
    assert r.completed_jobs == want.completed_jobs == 60
    assert (r.makespan, r.avg_inter_comms, r.total_wan_gb) == \
        (want.makespan, want.avg_inter_comms, want.total_wan_gb)


def test_entry_points_need_a_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        run_experiment(GridConfig(n_regions=2, sites_per_region=2),
                       n_jobs=2)


@pytest.mark.parametrize("strategy", ["hrs", "hrs_singlephase", "bhr",
                                      "lru", "noreplication"])
def test_sequential_strategies_match_reference(strategy):
    """Every ported strategy, 60 jobs on a small grid with stragglers and
    one outage: the reference's metrics."""
    cfg = GridConfig(n_regions=2, sites_per_region=4, storage_capacity=2e9)
    kw = dict(strategy=strategy, n_jobs=60, failures=[(3, 500.0, 2000.0)],
              slowdowns=[(1, 100.0, 3000.0, 0.2)],
              speculative_backups=True)
    got = run_experiment(cfg, device="cpu", **kw)
    want = ref.run_experiment(ref.GridConfig(
        n_regions=2, sites_per_region=4, storage_capacity=2e9), **kw)
    assert got.completed_jobs == want.completed_jobs
    assert got.makespan == want.makespan
    assert got.avg_inter_comms == want.avg_inter_comms
    assert got.total_wan_gb == want.total_wan_gb
    assert got.net_stats == want.net_stats


def test_make_strategy_names():
    cfg = GridConfig(n_regions=2, sites_per_region=2)
    topo = build_topology(cfg)
    cat = build_catalog(cfg, topo)
    st = make_strategy("hrs", cat, topo, StorageState(cat, topo))
    assert st.name == "hrs"
    with pytest.raises(ValueError, match="strategy_mode"):
        make_strategy("hrs", cat, topo, StorageState(cat, topo), mode="x")


def test_cli_list_and_cpu_run(capsys, tmp_path):
    experiments.main(["--list"])
    assert "grid_500_saturated" in capsys.readouterr().out
    out = tmp_path / "rows.json"
    experiments.main(["--scenario", "paper_baseline", "--jobs", "20",
                      "--device", "cpu", "--out", str(out)])
    rows = json.load(open(out))["scenarios"]["paper_baseline"]["rows"]
    assert rows[0]["device"] == "cpu" and rows[0]["completed_jobs"] == 20
    want = ref.run_experiment(ref.GridConfig(), n_jobs=20)
    assert rows[0]["makespan_s"] == want.makespan
