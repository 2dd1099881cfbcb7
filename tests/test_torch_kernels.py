"""The port's network kernels against the reference's float64 oracles,
and the CUDA kernels of all five against their plain versions on the card.

On the CPU the port's wrappers run the plain PyTorch versions; they must
be bit-identical (``np.array_equal``, infs in the same places) to
``event_engine_core`` / ``net_rerate_ref`` of ``repro.kernels`` applied the
way the reference engine applies them: to the dirty-slot subset, leaving
every other slot untouched. Inputs are made with numpy from a seed and
hold a mix of released, fresh and carried slots. The CUDA kernels
themselves are held against the plain versions on the card
(``-m gpu``; ``chip_smoke.py`` does the same at the main path's shapes).
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels.event_engine import event_engine_core
from repro.kernels.net_rerate import net_rerate_ref as oracle_rerate
from repro.kernels.st_cost import st_cost_ref as oracle_st_cost
from repro.kernels.strategy_plan import strategy_plan_ref as oracle_plan
from repro.kernels.value_score import value_score_ref as oracle_value
from repro_torch.kernels import _cuda
from repro_torch.kernels.event_engine import (event_engine,
                                              event_engine_kernel,
                                              event_engine_ref)
from repro_torch.kernels.net_rerate import (net_rerate, net_rerate_kernel,
                                            net_rerate_ref)
from repro_torch.kernels.st_cost import st_cost_kernel, st_cost_ref
from repro_torch.kernels.strategy_plan import (strategy_plan_kernel,
                                               strategy_plan_ref)
from repro_torch.kernels.value_score import (value_score_kernel,
                                             value_score_ref)

SIZES = (0, 1, 127, 4096, 16384)
N_LINKS = 555


def _state(seed: int, slots: int, depth: int):
    """Numpy slot state: kind 0 released (all -1 path, zero state), 1
    fresh (rem set, rate 0, eta inf), 2 carried (rate and finite eta)."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, slots)
    path = np.full((slots, depth), -1, np.int32)
    for s in np.flatnonzero(kind > 0):
        k = int(rng.integers(1, depth + 1))       # left-packed, 1..depth links
        path[s, :k] = rng.choice(N_LINKS, k, replace=False)
    now = 1234.5
    rem = np.where(kind == 1, rng.integers(1, 1000, slots) * 5e5, 0.0)
    # some carried slots are already past their eta (rem clamps to 0)
    rate = np.where(kind == 2, rng.uniform(1e3, 1e7, slots), 0.0)
    eta = np.where(kind == 2, now + rng.uniform(-5.0, 1e5, slots), np.inf)
    due = np.where(kind == 2, eta - 1.0 / np.where(rate > 0, rate, 1.0),
                   np.inf)
    bw = rng.uniform(1e5, 1.25e8, N_LINKS)
    act = rng.integers(0, 30, N_LINKS).astype(np.float64)
    return dict(path=path, rem=rem, rate=rate, eta=eta, due=due), bw, act, now


def _dirty(seed: int, slots: int, frac: float) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return rng.permutation(slots)[: int(round(frac * slots))].astype(np.int32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(a)


def _equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("slots", SIZES)
@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_event_engine_plain_matches_oracle(slots, depth, frac):
    st, bw, act, now = _state(slots + depth, slots, depth)
    idx = _dirty(slots, slots, frac)
    # the reference engine's CPU route: the oracle on the dirty subset,
    # then due = eta - 1/rate (network.py:534-545)
    want = {k: v.copy() for k, v in st.items()}
    if idx.size:
        rem_now, rate_new, eta_new, _ = event_engine_core(
            st["path"][idx], st["rem"][idx], st["rate"][idx], st["eta"][idx],
            bw, act, now)
        live = rate_new > 0.0
        want["rem"][idx] = rem_now
        want["rate"][idx] = rate_new
        want["eta"][idx] = eta_new
        want["due"][idx] = np.where(
            live, eta_new - 1.0 / np.where(live, rate_new, 1.0), np.inf)
    want_min = float(want["eta"].min()) if slots else math.inf

    got = {k: _t(v) for k, v in st.items()}
    eta_min = event_engine(_t(idx), got["path"], got["rem"], got["rate"],
                           got["eta"], got["due"], _t(bw), _t(act), now)
    assert eta_min == want_min
    for k in ("rem", "rate", "eta", "due", "path"):
        assert _equal(got[k].numpy(), want[k]), k


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("slots", SIZES)
@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_net_rerate_plain_matches_oracle(slots, depth, frac):
    st, bw, act, now = _state(slots + 7 * depth, slots, depth)
    idx = _dirty(slots + 3, slots, frac)
    rate = st["rate"].copy()
    if idx.size:
        rate[idx], _ = oracle_rerate(st["path"][idx], st["rem"][idx], bw,
                                     act, now)
    live = rate > 0.0
    # the reference engine's next-completion scan (network.py:441-444)
    want = (float(np.min(now + st["rem"][live] / rate[live]))
            if live.any() else math.inf)

    got = _t(st["rate"])
    eta = net_rerate(_t(idx), _t(st["path"]), _t(st["rem"]), got, _t(bw),
                     _t(act), now)
    assert eta == want
    assert _equal(got.numpy(), rate)


def test_full_recompute_matches_oracle_rates():
    """Re-rating every slot equals the oracle's full recompute, dead rows
    (no link) included, on both plain versions."""
    st, bw, act, now = _state(5, 4096, 3)
    want_rate, _ = oracle_rerate(st["path"], st["rem"], bw, act, now)
    idx = _t(np.arange(4096, dtype=np.int32))
    rate = _t(st["rate"])
    net_rerate_ref(idx, _t(st["path"]), _t(st["rem"]), rate, _t(bw),
                   _t(act), now)
    assert _equal(rate.numpy(), want_rate)
    t = {k: _t(v) for k, v in st.items()}
    event_engine_ref(idx, t["path"], t["rem"], t["rate"], t["eta"],
                     t["due"], _t(bw), _t(act), now)
    assert _equal(t["rate"].numpy(), want_rate)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CUDA kernel takes CUDA tensors only: no silent CPU route, and
    nothing counted as a launch."""
    st, bw, act, now = _state(0, 8, 3)
    t = {k: _t(v) for k, v in st.items()}
    idx = _t(np.arange(8, dtype=np.int32))
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        event_engine_kernel(idx, t["path"], t["rem"], t["rate"], t["eta"],
                            t["due"], _t(bw), _t(act), now)
    with pytest.raises(ValueError, match="CUDA tensors"):
        net_rerate_kernel(idx, t["path"], t["rem"], t["rate"], _t(bw),
                          _t(act), now)
    assert _cuda.LAUNCHES == before


def test_kernel_sources_and_build_names():
    """Every kernel has its CUDA source beside the shared header, and the
    build file name follows the sources' content."""
    for name in _cuda.KERNELS:
        assert (_cuda.CSRC / f"{name}.cu").exists()
        lib = _cuda._library_path(name)
        assert lib.parent == _cuda.BUILD_DIR
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"
    assert (_cuda.CSRC / "share_rate.cuh").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("n_dirty", [0, 679, 13528])
def test_cuda_kernels_match_plain_versions(n_dirty):
    """On the card: each kernel bit-equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    st, bw, act, now = _state(n_dirty, 16384, 3)
    idx = _dirty(n_dirty, 16384, n_dirty / 16384)
    dev = torch.device("cuda", 0)
    k = {key: torch.tensor(v, device=dev) for key, v in st.items()}
    p = {key: v.clone() for key, v in k.items()}
    cuda = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    a = event_engine_kernel(cuda(idx), k["path"], k["rem"], k["rate"],
                            k["eta"], k["due"], cuda(bw), cuda(act), now)
    b = event_engine_ref(cuda(idx), p["path"], p["rem"], p["rate"],
                         p["eta"], p["due"], cuda(bw), cuda(act), now)
    assert torch.equal(a, b)
    for key in ("rem", "rate", "eta", "due"):
        assert torch.equal(k[key], p[key]), key
    a = net_rerate_kernel(cuda(idx), k["path"], k["rem"], k["rate"],
                          cuda(bw), cuda(act), now)
    b = net_rerate_ref(cuda(idx), p["path"], p["rem"], p["rate"], cuda(bw),
                       cuda(act), now)
    assert torch.equal(a, b)
    assert torch.equal(k["rate"], p["rate"])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _plan_inputs(seed: int, sites: int, pairs: int, served: bool):
    """A burst's planner inputs: quantized bandwidths (ties), sparse
    holders, all-masked columns, and zero or nonzero serve."""
    rng = np.random.default_rng(seed)
    bw = rng.choice([0.0, 6.25e5, 1.25e6, 2.5e6, 1.25e8], (sites, pairs))
    fetch = rng.random((sites, pairs)) < 0.05
    fetch[:, ::7] = False
    local = rng.random((sites, pairs)) < 0.1
    serve = (rng.choice([0.0, 0.5, 1.0, 3.0], sites) if served
             else np.zeros(sites))
    free = rng.choice([0.0, 2.5e7, 1e9], pairs)
    size = np.full(pairs, 5e7)
    return bw, fetch, local, serve, free, size


@pytest.mark.gpu
@pytest.mark.parametrize("served", [False, True])
@pytest.mark.parametrize("sites,pairs", [(500, 1250), (1100, 300), (20, 77),
                                         (3, 0)])
def test_cuda_strategy_plan_matches_plain_and_oracle(sites, pairs, served):
    """strategy_plan on the card (grid_500_evict burst shape; many sites;
    fewer sites than the kernel's site groups; no pair): bit-equal to its
    plain version and to the float64 oracle."""
    dev = _card()
    args = _plan_inputs(sites + pairs, sites, pairs, served)
    t = [torch.tensor(a, device=dev) for a in args]
    ks, kf = strategy_plan_kernel(*t)
    ps, pf = strategy_plan_ref(*t)
    assert torch.equal(ks, ps) and torch.equal(kf, pf)
    if pairs:
        want = oracle_plan(*args)
        got = [ks[0], ks[1], kf[0], kf[1], kf[2]]
        for w, g in zip(want, got):
            assert np.array_equal(w, g.cpu().numpy().astype(np.float64))


def _st_inputs(seed: int, sites: int, files: int, jobs: int):
    rng = np.random.default_rng(seed)
    bw = rng.choice([0.0, 6.25e5, 1.25e6, 1.25e8], (sites, sites))
    presence = rng.random((sites, files)) < 0.05
    online = rng.random(sites) < 0.9
    fetch = presence & online[:, None]
    sizes = rng.choice([5e8, 1e9, 1.7e9], files)
    required = rng.random((jobs, files)) < 0.02
    rel = rng.integers(0, 40, sites) * 37.5
    return bw, fetch, presence, sizes, required, rel, online


@pytest.mark.gpu
@pytest.mark.parametrize("sites,files,jobs", [(52, 100, 50), (500, 600, 50),
                                              (52, 0, 5)])
def test_cuda_st_cost_matches_plain_and_oracle(sites, files, jobs):
    """st_cost on the card (bulk_shortest and the 500-site union shape;
    an empty file axis): bit-equal to its plain version and the oracle,
    infs in the same places."""
    dev = _card()
    args = _st_inputs(sites * files + jobs, sites, files, jobs)
    t = [torch.tensor(a, device=dev) for a in args]
    got = st_cost_kernel(*t)
    assert torch.equal(got, st_cost_ref(*t))
    assert np.array_equal(got.cpu().numpy(), oracle_st_cost(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["cost", "plain"])
@pytest.mark.parametrize("sites,files", [(52, 100), (500, 1000)])
def test_cuda_value_score_matches_plain_and_oracle(sites, files, mode):
    """value_score on the card (economy_starved and the 500-site shape):
    bit-equal to its plain version and the oracle."""
    dev = _card()
    rng = np.random.default_rng(sites + files)
    demand = rng.random((sites, files)) * rng.choice([0.0, 1.0, 9.0],
                                                     (sites, files))
    sizes = rng.choice([1e9, 2e9], files)
    presence = rng.random((sites, files)) < 0.03
    bw = rng.choice([0.0, 1.25e6, 1.25e8], (sites, sites))
    t = [torch.tensor(a, device=dev) for a in (demand, sizes, presence, bw)]
    got = value_score_kernel(*t, mode=mode)
    assert torch.equal(got, value_score_ref(*t, mode=mode))
    want = oracle_value(demand, sizes, presence, bw, mode=mode)
    assert np.array_equal(got.cpu().numpy(), want)
