"""The port's ``leastloaded``, ``random`` and ``shortesttransfer`` batch
brokers (``broker="jax"``) against the reference's ``repro.core.jaxsched``.

Exact throughout (tolerance 0): the ``st_cost`` plain version against the
float64 oracle ``st_cost_ref`` (infs in the same places), each broker site
for site against its reference broker on the same snapshot, and whole
runs record for record. The reference's shortest-transfer broker costs
with ``backend="auto"``, which on the CPU is the numpy oracle.
"""

import random

import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core.jaxsched import (JaxLeastLoadedBroker, JaxRandomBroker,
                                 JaxShortestTransferBroker)
from repro.kernels.st_cost import st_cost_ref as oracle_st_cost
import repro_torch.core as port
from repro_torch.core.torchsched import (TorchLeastLoadedBroker,
                                         TorchRandomBroker,
                                         TorchShortestTransferBroker,
                                         leastloaded_select)
from repro_torch.kernels import _cuda
from repro_torch.kernels.st_cost import st_cost, st_cost_kernel
from test_torch_kernels import ST_CASES, st_inputs
from test_torch_plan import assert_same_run


def _st_case(seed: int, sites: int, files: int, jobs: int):
    rng = np.random.default_rng(seed)
    bw = rng.choice([0.0, 6.25e5, 1.25e6, 1.25e8], (sites, sites))
    presence = rng.random((sites, files)) < 0.15
    online = rng.random(sites) < 0.8
    fetch = presence & online[:, None]
    sizes = rng.choice([5e8, 1e9, 1.7e9], files)
    required = rng.random((jobs, files)) < 0.3
    rel = rng.integers(0, 40, sites) * 37.5
    return bw, fetch, presence, sizes, required, rel, online


def _st(args):
    return st_cost(*(torch.tensor(a) for a in args)).numpy()


#: the plain version's cases: ``mixed`` is ``_st_case``, the others the
#: card's ``ST_CASES`` (``st_inputs``' edge inputs)
ST_PLAIN_CASES = tuple(
    ((s, f, j, "mixed"), f"{s}-{f}-{j}")
    for s, f, j in ((1, 1, 1), (4, 8, 3), (13, 100, 17), (52, 100, 50),
                    (37, 260, 9), (6, 0, 4), (5, 7, 0))) + ST_CASES


@pytest.mark.parametrize("sites,files,jobs,kind",
                         [c for c, _ in ST_PLAIN_CASES],
                         ids=[i for _, i in ST_PLAIN_CASES])
def test_st_cost_plain_matches_oracle(sites, files, jobs, kind):
    seed = sites * 7 + files + jobs
    args = (_st_case(seed, sites, files, jobs) if kind == "mixed"
            else st_inputs(seed, sites, files, jobs, kind))
    got = _st(args)
    assert got.shape == (jobs, sites) and got.dtype == np.float64
    assert np.array_equal(got, oracle_st_cost(*args))


def test_st_cost_edges_match_oracle():
    """Zero bandwidth from every holder (an ``inf`` term), a file with no
    fetchable holder, an offline site, and an all-``inf`` job row."""
    bw = np.array([[1e6, 0.0, 2e6], [0.0, 0.0, 0.0], [4e6, 0.0, 1e6]])
    presence = np.array([[True, False, False],
                         [False, True, False],
                         [False, False, False]])
    fetch = presence.copy()
    sizes = np.array([1e9, 2e9, 3e9])
    required = np.array([[True, False, False],     # held at site 0
                         [False, True, False],     # holder 1 sends at 0 B/s
                         [False, False, True],     # no holder at all
                         [False, False, False]])   # nothing to stage
    rel = np.array([5.0, 0.0, 800.0])
    online = np.array([True, True, False])
    args = (bw, fetch, presence, sizes, required, rel, online)
    got, want = _st(args), oracle_st_cost(*args)
    assert np.array_equal(got, want)
    assert np.isinf(got[:, 2]).all()               # offline site
    assert np.isinf(got[1, 0]) and got[1, 1] == 0.0
    assert np.isinf(got[2, :]).all()               # all-inf row
    assert got[3, 0] == 5.0 and got[3, 1] == 0.0


def test_st_cost_kernel_refuses_cpu_tensors():
    args = [torch.tensor(a) for a in _st_case(0, 4, 6, 3)]
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        st_cost_kernel(*args)
    assert _cuda.LAUNCHES == before


# -- brokers, site for site -------------------------------------------------

def _worlds(sites_per_region: int, seed: int):
    """The same (topology, catalog) in both packages, with uneven queued
    work (load ties included), two offline sites, and extra replicas."""
    kw = dict(n_regions=4, sites_per_region=sites_per_region, seed=seed)
    out = []
    for mod in (ref, port):
        cfg = mod.GridConfig(**kw)
        topo = mod.build_topology(cfg)
        cat = mod.build_catalog(cfg, topo)
        rng = np.random.default_rng(seed)
        for s in topo.sites:
            s.queued_work = float(rng.integers(0, 4)) * 1e9
        for s in (1, topo.n_sites - 2):
            topo.sites[s].online = False
        lfns = sorted(cat.files)
        for _ in range(3 * topo.n_sites):
            cat.add_replica(lfns[int(rng.integers(len(lfns)))],
                            int(rng.integers(topo.n_sites)))
        out.append((cfg, topo, cat))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("sites_per_region", [4, 13])
def test_brokers_match_reference_site_for_site(sites_per_region, seed):
    (rcfg, rtopo, rcat), (_, ptopo, pcat) = _worlds(sites_per_region, seed)
    burst = [j.required for j in ref.generate_jobs(rcfg, 40)]
    rnet = ref.NetworkEngine(rtopo)
    pnet = port.NetworkEngine(ptopo, device="cpu")
    # some links busy: the shortest-transfer costs read the shares
    rng = np.random.default_rng(seed)
    act = rng.integers(0, 6, rnet.n_links).astype(np.float64)
    rnet.link_act[:] = act
    pnet.link_act[:] = act
    pairs = (
        (JaxLeastLoadedBroker(rcat, rtopo),
         TorchLeastLoadedBroker(pcat, ptopo, device="cpu")),
        (JaxRandomBroker(rcat, rtopo, random.Random(seed)),
         TorchRandomBroker(pcat, ptopo, random.Random(seed), device="cpu")),
        (JaxShortestTransferBroker(rcat, rtopo, rnet),
         TorchShortestTransferBroker(pcat, ptopo, pnet, device="cpu")),
    )
    for want, got in pairs:
        w = want.select_batch(burst)
        assert got.select_batch(burst) == w, type(got).__name__
        assert all(ptopo.sites[s].online for s in w)


def test_shortest_transfer_broker_follows_catalog_changes():
    """The presence bitmap and the master table track replica changes and
    late-registered files between bursts."""
    (rcfg, rtopo, rcat), (_, ptopo, pcat) = _worlds(4, 9)
    rb = JaxShortestTransferBroker(rcat, rtopo, ref.NetworkEngine(rtopo))
    pb = TorchShortestTransferBroker(
        pcat, ptopo, port.NetworkEngine(ptopo, device="cpu"), device="cpu")
    burst = [j.required for j in ref.generate_jobs(rcfg, 20)]
    assert pb.select_batch(burst) == rb.select_batch(burst)
    for cat in (rcat, pcat):
        cat.register_file("zz_late", 7e8, 5)
        for lfn in burst[0]:
            for h in sorted(cat.holders(lfn)):
                if not cat.is_master(lfn, h):
                    cat.remove_replica(lfn, h)
    burst = [b + ["zz_late"] for b in burst]
    assert pb.select_batch(burst) == rb.select_batch(burst)


def test_leastloaded_select_first_minimum_in_float32():
    load = torch.tensor([3.0, 1.0, 1.0, 0.5], dtype=torch.float32)
    cap = torch.tensor([1.0, 1.0, 1.0, 0.25], dtype=torch.float32)
    online = torch.tensor([True, True, True, True])
    assert int(leastloaded_select(load, cap, online)) == 1
    online[1] = False
    assert int(leastloaded_select(load, cap, online)) == 2


def test_brokers_raise_like_sequential_when_all_offline():
    """No online site: the deterministic brokers raise ValueError, the
    random broker IndexError without drawing from its PRNG."""
    (_, _, _), (pcfg, ptopo, pcat) = _worlds(3, 0)
    for s in ptopo.sites:
        s.online = False
    rng = random.Random(4)
    state = rng.getstate()
    net = port.NetworkEngine(ptopo, device="cpu")
    for broker in (TorchLeastLoadedBroker(pcat, ptopo, device="cpu"),
                   TorchShortestTransferBroker(pcat, ptopo, net,
                                               device="cpu")):
        with pytest.raises(ValueError, match="no online"):
            broker.select_batch([["lfn0000"]])
    with pytest.raises(IndexError):
        TorchRandomBroker(pcat, ptopo, rng, device="cpu").select_batch(
            [["lfn0000"]])
    assert rng.getstate() == state


# -- whole runs, record for record ------------------------------------------

def test_bulk_shortest_matches_reference(monkeypatch):
    """``bulk_shortest`` as registered (the paper grid, 50-job bursts
    through the shortest-transfer broker)."""
    assert_same_run(monkeypatch, "bulk_shortest", 300)


@pytest.mark.parametrize("scheduler", ["leastloaded", "random",
                                       "shortesttransfer"])
def test_batch_broker_runs_match_reference(monkeypatch, scheduler):
    """Each broker on the paper grid in 10-job bursts, with the batched
    planner."""
    assert_same_run(monkeypatch, "paper_baseline", 150, scheduler=scheduler,
                    broker="jax", arrival_burst=10, strategy_mode="batch")
