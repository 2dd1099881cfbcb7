"""The port's replication economy against the reference's
``repro.core.economy``.

Exact throughout (tolerance 0): the ``value_score`` plain version against
the float64 oracle ``value_score_ref`` in both modes, the optimizer's value
matrix and auction proposals against the reference's on the same state,
and ``economy_starved`` / ``hotset_drift`` record for record in both
strategy modes. The reference scores with ``econ="numpy"`` (its default;
``econ="pallas"`` is the same oracle on the CPU).
"""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import repro.core as ref
from repro.kernels.value_score import value_score_ref as oracle_value
import repro_torch.core as port
from repro_torch.core.economy import (ECON_BACKENDS, VALUE_MODELS,
                                      ReplicationOptimizer)
from repro_torch.kernels import _cuda
from repro_torch.kernels.value_score import value_score, value_score_kernel
from test_torch_plan import assert_same_run


def _vs_case(seed: int, sites: int, files: int):
    rng = np.random.default_rng(seed)
    demand = rng.random((sites, files)) * rng.choice([0.0, 1.0, 12.0],
                                                     (sites, files))
    sizes = rng.choice([5e8, 1e9, 2e9], files)
    presence = rng.random((sites, files)) < 0.2
    presence[:, 0] = False                       # a file nobody holds
    if sites > 1:
        presence[1, min(1, files - 1)] = True    # a single holder
    bw = rng.choice([0.0, 1.25e6, 2.5e6, 1.25e8], (sites, sites))
    return demand, sizes, presence, bw


@pytest.mark.parametrize("mode", ["cost", "plain"])
@pytest.mark.parametrize("sites,files", [(1, 3), (4, 6), (13, 40), (52, 100),
                                         (37, 260)])
def test_value_score_plain_matches_oracle(sites, files, mode):
    args = _vs_case(sites * 100 + files, sites, files)
    got = value_score(*(torch.tensor(a) for a in args), mode=mode).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got, oracle_value(*args, mode=mode))


def test_value_score_rejects_unknown_mode_and_cpu_kernel_call():
    args = [torch.tensor(a) for a in _vs_case(0, 4, 5)]
    with pytest.raises(ValueError, match="mode"):
        value_score(*args, mode="nope")
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        value_score_kernel(*args)
    assert _cuda.LAUNCHES == before


# -- the optimizer on one state ---------------------------------------------

def _world(mod, storage=None):
    """``tests/test_economy.py::_world`` plus recorded demand, busy links
    and a replica that fills site 1, built with ``mod``'s classes."""
    cfg = mod.GridConfig(n_regions=2, sites_per_region=3,
                         **({"storage_capacity": storage} if storage else {}))
    topo = mod.build_topology(cfg)
    cat = mod.ReplicaCatalog()
    for i in range(6):
        cat.register_file(f"lfn{i:04d}", 1e9, i % topo.n_sites)
    store = mod.StorageState(cat, topo)
    for info in cat.files.values():
        store.bootstrap(info.master_site, info.lfn)
    access = mod.AccessHistory(cat, topo, half_life_s=3600.0)
    net = (mod.NetworkEngine(topo) if mod is ref
           else mod.NetworkEngine(topo, device="cpu"))
    store.add(1, "lfn0002", now=0.0)
    rng = np.random.default_rng(5)
    for t in range(80):
        access.record_access(int(rng.integers(topo.n_sites)),
                             f"lfn{int(rng.integers(6)):04d}", now=30.0 * t)
    net.link_act[:] = rng.integers(0, 4, net.n_links).astype(np.float64)
    topo.sites[4].online = False
    return cat, topo, store, access, net


@pytest.mark.parametrize("storage", [None, 2e9])
@pytest.mark.parametrize("model", ["economic", "popularity"])
def test_optimizer_matches_reference(model, storage):
    """Value matrix and proposals of one round, on the same state: free
    space everywhere, and a full site 1 whose trades must evict."""
    r = _world(ref, storage)
    p = _world(port, storage)
    ropt = ref.ReplicationOptimizer(*r, model=model)
    popt = ReplicationOptimizer(*p, model=model)
    rv, rheld = ropt.value_matrix(2400.0)
    pv, pheld = popt.value_matrix(2400.0)
    assert np.array_equal(pv, rv) and np.array_equal(pheld, rheld)
    want = ropt.step(2400.0)
    got = popt.step(2400.0)
    assert want
    assert [vars(g) for g in got] == [vars(w) for w in want]
    assert [astuple(g.to_plan(p[1])) for g in got] == \
        [astuple(w.to_plan(r[1])) for w in want]
    assert (popt.rounds, popt.proposed) == (ropt.rounds, ropt.proposed)


def test_value_models_and_backends():
    assert sorted(VALUE_MODELS) == sorted(ref.VALUE_MODELS)
    for name, cls in VALUE_MODELS.items():
        rcls = ref.VALUE_MODELS[name]
        assert (cls.mode, cls.min_value) == (rcls.mode, rcls.min_value)
    assert ECON_BACKENDS == ref.ECON_BACKENDS
    world = _world(port)
    for backend in ("numpy", "pallas"):
        ReplicationOptimizer(*world, backend=backend)
    with pytest.raises(NotImplementedError, match="interpreter"):
        ReplicationOptimizer(*world, backend="pallas-interpret")
    with pytest.raises(ValueError, match="econ backend"):
        ReplicationOptimizer(*world, backend="cuda")
    with pytest.raises(ValueError, match="value model"):
        ReplicationOptimizer(*world, model="nope")


def test_interpret_econ_raises_only_when_armed():
    cfg = port.GridConfig(n_regions=2, sites_per_region=2)
    port.run_experiment(cfg, n_jobs=3, econ="pallas-interpret",
                        device="cpu")
    with pytest.raises(NotImplementedError, match="interpreter"):
        port.run_experiment(cfg, n_jobs=3, strategy="economic",
                            econ="pallas-interpret", device="cpu")


# -- whole runs, record for record ------------------------------------------

@pytest.mark.parametrize("mode", ["sequential", "batch"])
def test_economy_starved_matches_reference(monkeypatch, mode):
    """``economy_starved`` at seed 0 (the economic strategy, 2 GB SEs),
    with prefetches on the ledger."""
    got = assert_same_run(monkeypatch, "economy_starved", 150,
                          strategy_mode=mode)
    assert got.prefetches > 0


@pytest.mark.parametrize("mode", ["sequential", "batch"])
def test_hotset_drift_predictive_matches_reference(monkeypatch, mode):
    """``hotset_drift`` under the predictive strategy (the popularity
    model)."""
    got = assert_same_run(monkeypatch, "hotset_drift", 200,
                          strategy="predictive", strategy_mode=mode)
    assert got.prefetches > 0


def test_forced_economy_on_hrs_matches_reference(monkeypatch):
    """An explicit interval arms the optimizer for a reactive strategy
    too, here with the shortest-transfer batch broker in bursts."""
    assert_same_run(monkeypatch, "paper_baseline", 150, strategy="hrs",
                    econ_interval_s=600.0, scheduler="shortesttransfer",
                    broker="jax", arrival_burst=5)
