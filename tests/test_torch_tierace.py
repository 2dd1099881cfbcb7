"""The port's tie-race sanitizer (``sanitize=True``) and its runners.

The port's counterparts of the dynamic tests of ``tests/test_tierace.py``
(``device="cpu"``: the kernels' plain versions), ``sanitize_smoke`` held
to the reference's report (and to ``chip_smoke.SANITIZE_REFERENCE``), and
the engine's ``rem_now`` held to the reference's. The deep copy the twins
are made by is held in ``tests/test_torch_kernels.py`` (its ``-m gpu``
case runs on the card, where no JAX is installed).
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import repro.analysis.tierace as ref_tierace
import repro.core as ref
import repro_torch.core as port
from repro_torch.analysis.tierace import canonical_records, sanitize_smoke
from repro_torch.core.scheduler import Job
from repro_torch.core.simulator import GridSimulator
from repro_torch.core.workload import (GridConfig, build_catalog,
                                       build_topology, generate_jobs)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_sim(*, scheduler="dataaware", strategy="hrs", sanitize=False,
             broker="event", net="numpy", seed=0, device="cpu", cfg=None):
    cfg = cfg or GridConfig(seed=seed)
    topology = build_topology(cfg)
    catalog = build_catalog(cfg, topology)
    sim = GridSimulator(topology, catalog, scheduler=scheduler,
                        strategy=strategy, seed=seed, sanitize=sanitize,
                        broker=broker, net=net, device=device)
    for info in catalog.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    return cfg, sim


def pinned_jobs(n):
    """Jobs whose single required file is mastered at n distinct sites:
    dataaware placement is a unique argmax, independent of decision
    order, and the equal-length jobs finish at one shared instant."""
    return [Job(job_id=j, job_type=0, required=[f"lfn{4 * j:04d}"],
                length=60e9) for j in range(n)]


# -- dynamic: sanitize mode flags racy ties, passes commuting ones ----------

def test_sequential_scheduler_submit_ties_race():
    rep = sanitize_smoke(n_jobs=16, scheduler="leastloaded", device="cpu")
    assert rep["ties_seen"] > 0
    assert rep["tie_races"], "expected order-dependent SUBMIT burst"
    assert any("SUBMIT" in r["kinds"] for r in rep["tie_races"])


def test_disjoint_placements_commute():
    _, sim = make_sim(sanitize=True)
    for job in pinned_jobs(4):
        sim.submit_job(job, at=0.0)
    sim.run()
    assert sim.ties_seen >= 2    # the SUBMIT burst + the CPU_DONE group
    assert sim.tie_races == [], sim.tie_races[:1]


def test_batched_drain_ties_commute_on_device_engine():
    """A same-instant burst on the batched ``device`` engine resolves
    through one fused flush whose per-slot math is permutation-invariant:
    reordering finds ties but no divergence."""
    _, sim = make_sim(sanitize=True, net="device")
    for j in range(4):
        sim.submit_job(Job(job_id=j, job_type=0,
                           required=[f"lfn{4 * j:04d}", f"lfn{4 * j + 2:04d}"],
                           length=60e9), at=0.0)
    sim.run()
    assert sim.network.batched
    assert sim.network.stats["flush_passes"] > 0
    assert sim.network.stats["rerate_slots"] == 0
    assert sim.ties_seen >= 2
    assert sim.tie_races == [], sim.tie_races[:1]


@pytest.mark.parametrize("net", ["numpy", "device"])
def test_sanitize_mode_is_observation_only(net):
    """sanitize=True leaves the primary timeline as it is: the same
    records, in the same order, and the same metrics."""
    results = []
    for sanitize in (False, True):
        cfg, sim = make_sim(sanitize=sanitize, net=net)
        for j, job in enumerate(generate_jobs(cfg, 16)):
            sim.submit_job(job, at=(j // 8) * cfg.interarrival * 8)
        results.append(sim.run())
    assert canonical_records(results[0]) == canonical_records(results[1])
    assert results[0].records == results[1].records
    for m in ("avg_job_time", "avg_inter_comms", "makespan",
              "total_wan_bytes", "net_stats"):
        assert getattr(results[0], m) == getattr(results[1], m), m


def test_sanitize_requires_event_broker():
    with pytest.raises(ValueError, match="sanitize"):
        make_sim(sanitize=True, broker="jax")


def test_smoke_report_shape():
    rep = sanitize_smoke(n_jobs=8, device="cpu")
    assert set(rep) == {"ties_seen", "tie_races"}
    for race in rep["tie_races"]:
        assert set(race) == {"time", "kinds", "detail"}


def test_sanitize_smoke_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        sanitize_smoke(n_jobs=2)


# -- held against repro -----------------------------------------------------

def test_sanitize_smoke_matches_reference_and_the_pin():
    got = sanitize_smoke(device="cpu")
    assert got == ref_tierace.sanitize_smoke()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert got == smoke.SANITIZE_REFERENCE


@pytest.mark.parametrize("scheduler,net", [("leastloaded", "numpy"),
                                           ("dataaware", "device")])
def test_sanitize_reports_match_reference(scheduler, net):
    def report(core, **kw):
        cfg = core.GridConfig()
        topo = core.build_topology(cfg)
        cat = core.build_catalog(cfg, topo)
        sim = core.GridSimulator(topo, cat, scheduler=scheduler,
                                 sanitize=True, net=net, **kw)
        for info in cat.files.values():
            sim.storage.bootstrap(info.master_site, info.lfn)
        for j, job in enumerate(core.generate_jobs(cfg, 16)):
            sim.submit_job(job, at=(j // 8) * cfg.interarrival * 8)
        sim.run()
        return sim.ties_seen, [dataclasses.astuple(r) for r in sim.tie_races]

    assert report(port, device="cpu") == report(ref)


@pytest.mark.parametrize("net", ["numpy", "device"])
@pytest.mark.parametrize("until", [600.0, 2500.0, 7000.0])
def test_rem_now_matches_reference(net, until):
    """Mid-run, after the same events: the engine's remaining bytes per
    slot (the batched route rebuilds them from ``(rate, eta)``)."""
    def engine(core, **kw):
        cfg = core.GridConfig(n_regions=2, sites_per_region=4)
        topo = core.build_topology(cfg)
        cat = core.build_catalog(cfg, topo)
        sim = core.GridSimulator(topo, cat, net=net, **kw)
        for info in cat.files.values():
            sim.storage.bootstrap(info.master_site, info.lfn)
        for j, job in enumerate(core.generate_jobs(cfg, 40)):
            sim.submit_job(job, at=(j // 4) * 120.0)
        sim.run(until=until)
        return sim.network

    got, want = engine(port, device="cpu"), engine(ref)
    assert got.n_active == want.n_active > 0
    assert np.array_equal(got.rem_now(), want.rem_now())
    assert np.array_equal(got.rem_now(until + 50.0),
                          want.rem_now(until + 50.0))
    rem, rate = got.slot_state()
    assert np.array_equal(rate, want.rate)
