"""The port's batched planning path (``strategy_mode="batch"``) against the
reference's.

Every comparison is exact (tolerance 0): the ``strategy_plan`` plain
version against the float64 oracle ``strategy_plan_ref``; the port's
``StorageTensorView`` against the reference's through a run with evictions
and an outage; the port's batched plans against ``repro``'s batched plans
(and the sequential twins) on the random worlds of
``tests/test_batch_strategy.py``; and whole runs record for record. The
reference plans with its default ``backend="auto"``, which on the CPU is
the numpy oracle (its interpret route raises on this jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.core.metrics as ref_metrics
from repro.kernels.strategy_plan import strategy_plan_ref as oracle_plan
from repro.launch.experiments import run_spec as ref_run_spec
import repro_torch.core as port
import repro_torch.core.metrics as port_metrics
from repro_torch.core.replica import (BATCH_STRATEGIES, PLAN_BACKENDS,
                                      StorageTensorView)
from repro_torch.kernels import _cuda
from repro_torch.kernels.strategy_plan import (strategy_plan,
                                               strategy_plan_kernel)
from repro_torch.launch.experiments import run_spec

GB = 1e9
STRATEGIES = sorted(BATCH_STRATEGIES)


# -- helpers shared with test_torch_sched.py and test_torch_economy.py -----

def mean_left_to_right(records) -> float:
    total = 0.0
    for r in records:
        total += r.job_time
    return total / max(1, len(records))


def run_with_result(monkeypatch, metrics_mod, fn):
    """Call ``fn()`` (a ``run_experiment`` / ``run_spec`` call of the
    package whose ``core.metrics`` module is ``metrics_mod``) and return
    its ``ExperimentResult`` with the simulator's ``SimResult``, whose
    per-job records ``run_experiment`` does not keep."""
    base = metrics_mod.GridSimulator
    got = []

    class Recording(base):
        def run(self, *a, **kw):
            got.append(super().run(*a, **kw))
            return got[-1]

    monkeypatch.setattr(metrics_mod, "GridSimulator", Recording)
    try:
        out = fn()
    finally:
        monkeypatch.setattr(metrics_mod, "GridSimulator", base)
    return out, got[0]


def assert_same_run(monkeypatch, spec_name: str, n_jobs: int, **replace):
    """A registered scenario (with ``replace`` applied) through both
    packages, the port on the CPU: every job record, the totals and the
    counters equal, and ``avg_job_time`` equal to the left-to-right mean
    of the reference's records. Returns the port's SimResult."""
    want_r, want = run_with_result(monkeypatch, ref_metrics, lambda: (
        ref_run_spec(dataclasses.replace(ref.SCENARIOS[spec_name],
                                         **replace), n_jobs=n_jobs)))
    got_r, got = run_with_result(monkeypatch, port_metrics, lambda: (
        run_spec(dataclasses.replace(port.SCENARIOS[spec_name], **replace),
                 n_jobs=n_jobs, device="cpu")))
    assert [dataclasses.astuple(r) for r in got.records] == \
        [dataclasses.astuple(r) for r in want.records]
    assert got.makespan == want.makespan
    assert got.total_inter_comms == want.total_inter_comms
    assert got.total_wan_bytes == want.total_wan_bytes
    assert got.total_lan_bytes == want.total_lan_bytes
    assert got.net_stats == want.net_stats
    assert (got.prefetches, got.prefetch_bytes) == \
        (want.prefetches, want.prefetch_bytes)
    assert got.avg_job_time == mean_left_to_right(want.records)
    assert got_r.completed_jobs == want_r.completed_jobs == n_jobs
    return got


# -- strategy_plan: plain version against the oracle ------------------------

def _plan_case(seed: int, sites: int, pairs: int, served: bool):
    rng = np.random.default_rng(seed)
    # a few bandwidth levels: ties between sites are common
    bw = rng.choice([0.0, 6.25e5, 1.25e6, 2.5e6], (sites, pairs))
    fetch = rng.random((sites, pairs)) < 0.3
    if pairs:
        fetch[:, rng.integers(pairs)] = False       # an all-masked column
    local = rng.random((sites, pairs)) < 0.5
    serve = (rng.choice([0.0, 0.25, 1.0, 4.0], sites) if served
             else np.zeros(sites))
    free = rng.choice([0.0, 5e8, 2e9], pairs)
    size = rng.choice([5e8, 1e9], pairs)
    return bw, fetch, local, serve, free, size


@pytest.mark.parametrize("served", [False, True])
@pytest.mark.parametrize("sites,pairs", [(1, 1), (4, 3), (13, 17), (52, 50),
                                         (129, 50), (37, 260), (8, 0)])
def test_strategy_plan_plain_matches_oracle(sites, pairs, served):
    args = _plan_case(sites * 1000 + pairs, sites, pairs, served)
    sources, flags = strategy_plan(*(torch.tensor(a) for a in args))
    assert sources.dtype == torch.int32 and flags.dtype == torch.bool
    assert sources.shape == (2, pairs) and flags.shape == (3, pairs)
    if pairs == 0:
        return
    want = oracle_plan(*args)
    got = (sources[0], sources[1], flags[0], flags[1], flags[2])
    for name, w, g in zip(("src_g", "src_l", "has_l", "inter_g",
                           "store_ok"), want, got):
        assert np.array_equal(w, g.numpy().astype(np.float64)), name


def test_strategy_plan_ties_keep_the_lowest_site():
    """Equal effective bandwidth at sites 1, 2 and 3: the first wins, and
    a serve load can break the tie toward a later site."""
    bw = np.array([[1.0], [4.0], [4.0], [4.0]])
    fetch = np.array([[True], [True], [True], [True]])
    local = np.array([[False], [False], [True], [True]])
    free, size = np.array([0.0]), np.array([1.0])
    for serve, g, l in ((np.zeros(4), 1, 2), (np.array([0, 1.0, 0, 0]), 2, 2),
                        (np.array([0, 0, 1.0, 0]), 1, 3)):
        sources, flags = strategy_plan(*(torch.tensor(a) for a in (
            bw, fetch, local, serve, free, size)))
        assert sources[:, 0].tolist() == [g, l]
        assert flags[:, 0].tolist() == [True, g < 2, False]


def test_strategy_plan_kernel_refuses_cpu_tensors():
    args = [torch.tensor(a) for a in _plan_case(0, 4, 3, False)]
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        strategy_plan_kernel(*args)
    assert _cuda.LAUNCHES == before


def test_plan_backends():
    cfg = port.GridConfig(n_regions=2, sites_per_region=2)
    topo = port.build_topology(cfg)
    cat = port.build_catalog(cfg, topo)
    stor = port.StorageState(cat, topo)
    net = port.NetworkEngine(topo, device="cpu")
    assert PLAN_BACKENDS == ("auto", "pallas", "interpret", "numpy")
    for backend in ("auto", "pallas", "numpy"):
        port.make_strategy("hrs", cat, topo, stor, mode="batch", network=net,
                           backend=backend)
    with pytest.raises(NotImplementedError, match="interpreter"):
        port.make_strategy("hrs", cat, topo, stor, mode="batch",
                           network=net, backend="interpret")
    with pytest.raises(ValueError, match="backend"):
        port.make_strategy("hrs", cat, topo, stor, mode="batch",
                           network=net, backend="tpu")
    with pytest.raises(ValueError, match="network="):
        port.make_strategy("hrs", cat, topo, stor, mode="batch")


# -- the random worlds of tests/test_batch_strategy.py ----------------------

def _world(mod, seed: int):
    """``tests/test_batch_strategy.py::_random_world`` built with the
    classes of ``mod`` (``repro.core`` or ``repro_torch.core``): the same
    draws from the same seed give the same state in both packages."""
    rng = np.random.default_rng(seed)
    topo = mod.GridTopology(int(rng.integers(2, 4)), int(rng.integers(2, 5)),
                            lan_bandwidth=125e6, wan_bandwidth=1.25e6,
                            storage_capacity=4 * GB,
                            seed=int(rng.integers(100)))
    cat = mod.ReplicaCatalog()
    stor = mod.StorageState(cat, topo)
    n_files = int(rng.integers(4, 11))
    for i in range(n_files):
        m = int(rng.integers(topo.n_sites))
        cat.register_file(f"f{i}", float(rng.uniform(0.3, 1.2)) * GB, m)
        stor.bootstrap(m, f"f{i}")
    now = 1.0
    for _ in range(2 * topo.n_sites):
        lfn = f"f{int(rng.integers(n_files))}"
        s = int(rng.integers(topo.n_sites))
        if not stor.holds(s, lfn) and \
                topo.sites[s].free_storage >= cat.size(lfn):
            stor.add(s, lfn, now)
            now += 1.0
    for _ in range(3):
        s = int(rng.integers(topo.n_sites))
        contents = stor.site_contents(s)
        if contents:
            stor.pin(s, contents[int(rng.integers(len(contents)))])
    for s in topo.sites[1:]:
        if rng.random() < 0.15:
            s.online = False
    access = mod.AccessHistory(cat, topo)
    for _ in range(30):
        now += float(rng.uniform(0.0, 400.0))
        lfn = f"f{int(rng.integers(n_files))}"
        site = int(rng.integers(topo.n_sites))
        access.record_access(site, lfn, now)
        src = int(rng.integers(topo.n_sites))
        access.record_fetch(src, site, lfn, cat.size(lfn),
                            bool(rng.integers(2)), now)
    return topo, cat, stor, access


def _as_tuple(plan):
    return (plan.lfn, plan.src, plan.dst, plan.store, plan.evictions,
            plan.inter_region, plan.remote_access)


@pytest.mark.parametrize("seed", range(12))
def test_batched_plans_match_reference(seed):
    """On one random world, for every strategy: the port's ``plan_batch``
    equals the reference's ``plan_batch`` plan for plan, and each plan
    equals the port's sequential twin's ``plan_fetch`` and its own
    singleton replan route."""
    from test_batch_strategy import _random_world
    topo, cat, stor, access = _world(ref, seed)
    # the same world as the reference test's
    rt, rc, rs, _ = _random_world(np.random.default_rng(seed))
    assert [s.online for s in topo.sites] == [s.online for s in rt.sites]
    assert {l: sorted(cat.holders(l)) for l in cat.files} == \
        {l: sorted(rc.holders(l)) for l in rc.files}
    ptopo, pcat, pstor, paccess = _world(port, seed)
    net = ref.NetworkEngine(topo)
    pnet = port.NetworkEngine(ptopo, device="cpu")
    pairs = [(lfn, d) for lfn in sorted(cat.files)
             for d in range(topo.n_sites)
             if topo.sites[d].online and not stor.holds(d, lfn)]
    for name in STRATEGIES:
        want = ref.make_strategy(name, cat, topo, stor, access, mode="batch",
                                 network=net).plan_batch(pairs)
        bat = port.make_strategy(name, pcat, ptopo, pstor, paccess,
                                 mode="batch", network=pnet)
        seq = port.make_strategy(name, pcat, ptopo, pstor, paccess)
        got = bat.plan_batch(pairs)
        assert len(got) == len(want) == len(pairs)
        for pair, g, w in zip(pairs, got, want):
            assert _as_tuple(g) == _as_tuple(w), (name, pair)
            assert _as_tuple(seq.plan_fetch(*pair)) == _as_tuple(g)
            assert _as_tuple(bat.plan_fetch(*pair)) == _as_tuple(g)


def test_empty_burst_plans_nothing():
    topo, cat, stor, access = _world(port, 3)
    net = port.NetworkEngine(topo, device="cpu")
    for name in STRATEGIES:
        st = port.make_strategy(name, cat, topo, stor, access, mode="batch",
                                network=net)
        assert st.plan_batch([]) == []


# -- StorageTensorView ------------------------------------------------------

_VIEW_ARRAYS = ("cat_present", "region_counts", "st_present", "st_atime",
                "st_seq", "st_pins", "sizes", "masters", "region_map")


def _churn_run(mod, **kw):
    """``test_view_tracks_storage_through_churn``'s run: a batched HRS
    run with evictions and one outage."""
    cfg = mod.GridConfig(n_regions=2, sites_per_region=4,
                         storage_capacity=3e9)
    topo = mod.build_topology(cfg)
    cat = mod.build_catalog(cfg, topo)
    sim = mod.GridSimulator(topo, cat, strategy="hrs", strategy_mode="batch",
                            broker="jax", **kw)
    for info in cat.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    for j, job in enumerate(mod.generate_jobs(cfg, 60)):
        sim.submit_job(job, at=(j // 5) * 60.0)
    sim.inject_failure(3, 500.0, 2000.0)
    return sim, sim.run()


def test_view_matches_reference_view_through_churn():
    """After the same batched run with evictions and an outage, the port's
    listener-maintained view equals the reference's and a fresh rebuild,
    array for array, and the run is the reference's record for record."""
    psim, pres = _churn_run(port, device="cpu")
    rsim, rres = _churn_run(ref)
    assert [dataclasses.astuple(r) for r in pres.records] == \
        [dataclasses.astuple(r) for r in rres.records]
    pview, rview = psim.strategy.view, rsim.strategy.view
    pview.sync()
    rview.sync()
    fresh = StorageTensorView(psim.catalog, psim.topology, psim.storage)
    assert pview.lfns == rview.lfns == fresh.lfns
    for attr in _VIEW_ARRAYS:
        assert np.array_equal(getattr(pview, attr), getattr(rview, attr)), \
            attr
        assert np.array_equal(getattr(pview, attr), getattr(fresh, attr)), \
            attr


def test_view_readers_match_reference():
    """The burst readers on a random world: fetch mask, region map, LRU
    order, region duplication and refetch costs."""
    for seed in range(6):
        rt, rc, rs, _ = _world(ref, seed)
        pt, pc, ps, _ = _world(port, seed)
        rv = ref.StorageTensorView(rc, rt, rs)
        pv = StorageTensorView(pc, pt, ps)
        online = np.array([s.online for s in rt.sites])
        js = np.arange(len(rv.lfns))
        assert np.array_equal(pv.fetch_mask(js, online),
                              rv.fetch_mask(js, online))
        assert np.array_equal(pv.region_map, rv.region_map)
        bw = ref.NetworkEngine(rt).point_bandwidth_matrix()
        for d in range(rt.n_sites):
            order = rv.lru_evictable(d)
            assert np.array_equal(pv.lru_evictable(d), order)
            assert np.array_equal(pv.region_dup(d, order),
                                  rv.region_dup(d, order))
            assert np.array_equal(
                pv.refetch_costs(d, js, bw[:, d], online),
                rv.refetch_costs(d, js, bw[:, d], online))


# -- whole runs, record for record ------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_paper_baseline_batch_matches_reference(monkeypatch, strategy):
    """Batch mode on the paper grid with 10-job bursts through the
    ``dataaware`` batch broker, every strategy (the access-aware ones arm
    the economy)."""
    assert_same_run(monkeypatch, "paper_baseline", 120, strategy=strategy,
                    strategy_mode="batch", broker="jax", arrival_burst=10)


def test_grid_500_evict_batch_matches_reference(monkeypatch):
    """The planner's scale regime at full width (500 sites, 10,000 files,
    25-file jobs, 50-job bursts), 200 jobs."""
    got = assert_same_run(monkeypatch, "grid_500_evict", 200,
                          strategy_mode="batch")
    assert got.net_stats["rerate_calls"] > 0


def test_batched_run_with_outage_matches_reference(monkeypatch):
    """Failure injection invalidates the planners' online vector:
    paper grid, batched LRU, two outages."""
    cfg = dict(n_regions=2, sites_per_region=4, storage_capacity=3e9)
    kw = dict(strategy="lru", n_jobs=80, strategy_mode="batch",
              broker="jax", arrival_burst=8,
              failures=[(2, 300.0, 900.0), (5, 2000.0, 1500.0)])
    want_r, want = run_with_result(monkeypatch, ref_metrics, lambda: (
        ref.run_experiment(ref.GridConfig(**cfg), **kw)))
    got_r, got = run_with_result(monkeypatch, port_metrics, lambda: (
        port.run_experiment(port.GridConfig(**cfg), device="cpu", **kw)))
    assert [dataclasses.astuple(r) for r in got.records] == \
        [dataclasses.astuple(r) for r in want.records]
    assert got.makespan == want.makespan
    assert got.net_stats == want.net_stats


def test_sanitize_rejects_batch_mode():
    cfg = port.GridConfig(n_regions=2, sites_per_region=2)
    topo = port.build_topology(cfg)
    with pytest.raises(ValueError, match="strategy_mode='sequential'"):
        port.GridSimulator(topo, port.build_catalog(cfg, topo),
                           strategy_mode="batch", sanitize=True,
                           device="cpu")


def test_batch_mode_rejects_strategy_instance():
    cfg = port.GridConfig(n_regions=2, sites_per_region=2)
    topo = port.build_topology(cfg)
    cat = port.build_catalog(cfg, topo)
    inst = port.make_strategy("hrs", cat, topo, port.StorageState(cat, topo))
    with pytest.raises(ValueError, match="registry name"):
        port.GridSimulator(topo, cat, strategy=inst, strategy_mode="batch",
                           device="cpu")


def test_kernel_inputs_are_what_the_cuda_kernels_take(monkeypatch):
    """The CUDA wrappers refuse non-contiguous or mistyped tensors, which
    the plain versions would take; on the CPU, check that every op call of
    a run (the planner's, the shortest-transfer broker's and the
    economy's) gets row-major float64 / bool tensors."""
    import repro_torch.core.economy as economy
    import repro_torch.core.replica as replica
    import repro_torch.core.torchsched as torchsched

    calls = []

    def checked(module, name):
        real = getattr(module, name)

        def op(*args, **kw):
            for t in args:
                assert t.is_contiguous(), (name, tuple(t.stride()))
                assert t.dtype in (torch.float64, torch.bool), (name, t.dtype)
            calls.append(name)
            return real(*args, **kw)
        monkeypatch.setattr(module, name, op)

    checked(replica, "strategy_plan")
    checked(torchsched, "st_cost")
    checked(economy, "value_score")
    r = port.run_experiment(
        port.GridConfig(n_regions=2, sites_per_region=4, storage_capacity=3e9),
        strategy="economic", scheduler="shortesttransfer", broker="jax",
        arrival_burst=6, strategy_mode="batch", n_jobs=60, device="cpu")
    assert r.completed_jobs == 60
    assert set(calls) == {"strategy_plan", "st_cost", "value_score"}
