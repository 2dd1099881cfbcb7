"""The port's dataaware batch broker (``broker="jax"``) against the
reference's ``repro.core.jaxsched``.

``select_sites_batch`` scores in float64, where the per-site byte sums are
exact integers; the reference scores in float32, where a sum of nine or
more 500 MB files rounds in a summation-order-dependent way. So the port's
decisions equal an exact numpy oracle on every job, and the reference's on
every job whose best site holds at most eight of the required files (all
its float32 sums exact). End to end, ``grid_500_saturated`` at 500 jobs
runs the reference's trajectory.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core.jaxsched import select_sites_batch as ref_select
from repro_torch.core import (SCENARIOS, GridConfig, GridSimulator,
                              TorchScheduler, build_catalog, build_topology,
                              generate_jobs, run_experiment, select_site_vec,
                              select_sites_batch)
from repro_torch.launch.experiments import run_spec

FILE = 5e8


def _burst(seed: int, density: float):
    """A grid_500-shaped burst: 500 sites, 1000 files, 50 jobs of 12."""
    rng = np.random.default_rng(seed)
    sites, files, jobs = 500, 1000, 50
    presence = rng.random((sites, files)) < density
    masks = np.zeros((jobs, files), bool)
    for j in range(jobs):
        masks[j, rng.choice(files, 12, replace=False)] = True
    load = (rng.integers(0, 50, sites) * 6e10).astype(np.float32)
    load[rng.choice(sites, 40)] = load[0]          # relative-load ties
    cap = np.full(sites, 1e9, np.float32)
    online = rng.random(sites) < 0.95
    return presence, np.full(files, FILE), masks, load, cap, online


def _exact(presence, sizes, masks, load, cap, online) -> np.ndarray:
    s = (masks * sizes) @ presence.T.astype(np.float64)
    s = np.where(online[None, :], s, -1.0)
    tie = s >= s.max(axis=1, keepdims=True)
    return np.argmin(np.where(tie, (load / cap)[None, :], np.inf), axis=1)


@pytest.mark.parametrize("seed", range(10))
def test_select_sites_batch_matches_reference(seed):
    density = [0.02, 0.1, 0.3, 0.6, 0.9][seed % 5]
    burst = _burst(seed, density)
    presence, sizes, masks, load, cap, online = burst
    got = select_sites_batch(*(torch.tensor(a) for a in burst)).numpy()
    assert np.array_equal(got, _exact(*burst))
    want = np.asarray(ref_select(
        jnp.asarray(presence), jnp.asarray(sizes, jnp.float32),
        jnp.asarray(masks), jnp.asarray(load), jnp.asarray(cap),
        jnp.asarray(online)))
    best = ((masks[:, None, :] & presence[None, :, :]).sum(-1)
            * online[None, :]).max(axis=1)
    exact32 = best <= 8
    if density <= 0.1:
        assert exact32.all()
    assert np.array_equal(got[exact32], want[exact32])


def test_select_site_vec_matches_batch_rows():
    burst = _burst(3, 0.3)
    presence, sizes, masks, load, cap, online = (torch.tensor(a)
                                                 for a in burst)
    batch = select_sites_batch(presence, sizes, masks, load, cap, online)
    for j in range(masks.shape[0]):
        one = select_site_vec(presence, sizes, masks[j], load, cap, online)
        assert int(one) == int(batch[j])


def _world():
    cfg = GridConfig(n_regions=2, sites_per_region=4)
    topo = build_topology(cfg)
    return cfg, topo, build_catalog(cfg, topo)


def test_broker_tracks_catalog_and_offline_sites():
    cfg, topo, cat = _world()
    broker = TorchScheduler(cat, topo, device="cpu")
    jobs = generate_jobs(cfg, 8)
    lfn = jobs[0].required[0]
    before = broker.presence_np().copy()
    site = next(s for s in range(topo.n_sites) if not cat.has_replica(lfn, s))
    cat.add_replica(lfn, site)
    after = broker.presence_np()
    j = broker.lfn_index[lfn]
    assert not before[site, j] and after[site, j]
    for s in topo.sites:
        s.online = False
    with pytest.raises(ValueError, match="no online sites"):
        broker.select_batch([job.required for job in jobs])


def test_batch_broker_completes_and_is_deterministic():
    cfg = GridConfig(n_regions=2, sites_per_region=4)
    a = run_experiment(cfg, strategy="hrs", n_jobs=80, broker="jax",
                       arrival_burst=10, device="cpu")
    b = run_experiment(cfg, strategy="hrs", n_jobs=80, broker="jax",
                       arrival_burst=10, device="cpu")
    assert a.completed_jobs == a.n_jobs == 80
    assert a.avg_job_time == b.avg_job_time
    assert a.avg_inter_comms == b.avg_inter_comms


def test_batch_broker_singleton_batches_match_event_broker():
    """One job per batch falls back to the sequential dispatch path."""
    cfg = GridConfig(n_regions=2, sites_per_region=4)
    ev = run_experiment(cfg, strategy="hrs", n_jobs=40, broker="event",
                        device="cpu")
    jx = run_experiment(cfg, strategy="hrs", n_jobs=40, broker="jax",
                        device="cpu")
    assert ev.avg_job_time == jx.avg_job_time
    assert ev.avg_inter_comms == jx.avg_inter_comms
    assert jx.completed_jobs == 40


def test_batch_window_holds_then_flushes():
    cfg, topo, cat = _world()
    sim = GridSimulator(topo, cat, strategy="hrs", broker="jax",
                        batch_window=300.0, device="cpu")
    for info in cat.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    for j, job in enumerate(generate_jobs(cfg, 30)):
        sim.submit_job(job, at=j * 60.0)
    res = sim.run()
    assert len(res.records) == 30
    for r in res.records:
        assert r.finish_time >= r.submit_time
        assert r.job_time > 0


def test_unknown_broker_rejected():
    with pytest.raises(ValueError):
        run_experiment(GridConfig(n_regions=2, sites_per_region=2),
                       n_jobs=1, broker="nope", device="cpu")


def _spec_run(mod, spec, n: int, **kw):
    """``run_experiment``'s setup for a uniform-arrival spec at the
    simulator level, returning the SimResult with its per-job records."""
    cfg = mod.to_grid_config(spec)
    topo = mod.build_topology(cfg)
    cat = mod.build_catalog(cfg, topo)
    sim = mod.GridSimulator(topo, cat, scheduler=spec.scheduler,
                            strategy=spec.strategy, seed=cfg.seed,
                            broker=spec.broker, net=spec.net, **kw)
    for info in cat.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    burst = spec.arrival_burst
    for j, job in enumerate(mod.generate_jobs(cfg, n)):
        sim.submit_job(job, at=(j // burst) * cfg.interarrival * burst)
    return sim.run()


def test_grid_500_saturated_matches_reference():
    """Full-width 500-site grid, jax broker, device engine, 500 jobs: the
    reference's trajectory, record for record."""
    import repro_torch.core as port

    got = _spec_run(port, SCENARIOS["grid_500_saturated"], 500,
                    device="cpu")
    want = _spec_run(ref, ref.SCENARIOS["grid_500_saturated"], 500)
    assert len(got.records) == len(want.records) == 500
    assert [dataclasses.astuple(r) for r in got.records] == \
        [dataclasses.astuple(r) for r in want.records]
    assert got.makespan == want.makespan
    assert got.total_inter_comms == want.total_inter_comms
    assert got.total_wan_bytes == want.total_wan_bytes
    assert got.net_stats == want.net_stats
    total = 0.0
    for r in want.records:
        total += r.job_time
    assert got.avg_job_time == total / 500


def test_run_spec_grid_500_saturated_small():
    """The CLI's lowering of the scale scenario runs on the CPU."""
    r = run_spec(SCENARIOS["grid_500_saturated"], n_jobs=100, device="cpu")
    assert r.completed_jobs == 100
    assert r.net_stats["flush_passes"] > 0
    assert r.net_stats["rerate_slots"] == 0
