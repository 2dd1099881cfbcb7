"""The port's two network kernels against the reference's float64 oracles.

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
from repro_torch.kernels import _cuda
from repro_torch.kernels.event_engine import (event_engine,
                                              event_engine_kernel,
                                              event_engine_ref)
from repro_torch.kernels.net_rerate import (net_rerate, net_rerate_kernel,
                                            net_rerate_ref)

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
