"""The port's network kernels against the reference's float64 oracles,
and the CUDA kernels of all five against their plain versions on the card.

On the CPU the port's wrappers run the plain PyTorch versions; they must
be bit-identical (``np.array_equal``, infs in the same places) to
``event_engine_core`` / ``net_rerate_ref`` of ``repro.kernels`` applied the
way the reference engine applies them: to the dirty-slot subset, leaving
every other slot untouched. Inputs are made with numpy from a seed and
hold a mix of released, fresh and carried slots. The network kernels take
the engine's staged alloc/release slot writes with each call; with them,
the plain versions must equal both the old composition (the engine's
scatter, then the plain version without staged rows) and the oracles on
the scattered state. The CUDA kernels themselves are held against the
plain versions on the card (``-m gpu``; ``chip_smoke.py`` does the same at
the main path's shapes).
"""

import copy
import math

import numpy as np
import pytest
import torch

from repro.kernels.event_engine import event_engine_core
from repro.kernels.net_rerate import net_rerate_ref as oracle_rerate
from repro.kernels.st_cost import st_cost_ref as oracle_st_cost
from repro.kernels.strategy_plan import strategy_plan_ref as oracle_plan
from repro.kernels.value_score import value_score_ref as oracle_value
from repro_torch.core import GridTopology, NetworkEngine
from repro_torch.kernels import _cuda
from repro_torch.kernels.event_engine import (event_engine,
                                              event_engine_kernel,
                                              event_engine_ref)
from repro_torch.kernels.net_call import NetInputs, SlotArrays
from repro_torch.kernels.net_rerate import (net_rerate, net_rerate_kernel,
                                            net_rerate_ref)
from repro_torch.kernels.share import scatter_staged
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


NO_STAGED = (np.zeros(0, np.int32), np.zeros(0), np.zeros(0, bool))


def _slot_arrays(st: dict, device="cpu") -> SlotArrays:
    """The kernels' slot tensors from a numpy state (``active`` where the
    path has a link)."""
    t = {k: torch.tensor(v, device=device) for k, v in st.items()}
    active = torch.tensor((st["path"] >= 0).any(1), device=device)
    return SlotArrays(t["path"], t["rem"], t["rate"], t["eta"], t["due"],
                      active)


def _inputs(bw, act, idx, depth, staged=NO_STAGED, st_path=None,
            device="cpu") -> NetInputs:
    slot, rem, flag = staged
    if st_path is None:
        st_path = np.full((len(slot), depth), -1, np.int32)
    return NetInputs(len(bw), depth, device).pack(
        np.stack([bw, act]), slot, rem, flag, st_path, idx)


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

    got = _slot_arrays(st)
    eta_min = event_engine(_inputs(bw, act, idx, depth), got, now)
    assert eta_min == want_min
    for k in ("rem", "rate", "eta", "due", "path"):
        assert _equal(getattr(got, k).numpy(), want[k]), k


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

    got = _slot_arrays(st)
    eta = net_rerate(_inputs(bw, act, idx, depth), got, now)
    assert eta == want
    assert _equal(got.rate.numpy(), rate)


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
    slots = _slot_arrays(st)
    inputs = _inputs(bw, act, np.arange(8), 3)
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        event_engine_kernel(inputs, slots, now)
    with pytest.raises(ValueError, match="CUDA tensors"):
        net_rerate_kernel(inputs, slots, now)
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


STAGED_CASES = ("none", "releases", "staged_in_idx", "empty_idx",
                "all_dead")


def _staged_case(case: str, slots: int, depth: int, seed: int):
    """A state and one call's inputs for ``case``: ``(st, bw, act, now,
    idx, (slot, rem, active), st_path)``. Staged slots are distinct, and so
    are listed ones; releases are never listed (a released slot leaves its
    links' member lists), allocs may be."""
    st, bw, act, now = _state(seed, slots, depth)
    rng = np.random.default_rng(seed + 17)
    if case == "all_dead":
        # every slot released and unrated: no live slot, minimum inf
        st["path"][:] = -1
        st["rem"][:] = 0.0
        st["rate"][:] = 0.0
        st["eta"][:] = np.inf
        st["due"][:] = np.inf
    perm = rng.permutation(slots).astype(np.int32)
    n_st = 0 if case == "none" else max(1, slots // 8)
    staged, rest = perm[:n_st], perm[n_st:]
    alloc = np.zeros(n_st, bool) if case in ("releases", "all_dead") \
        else rng.random(n_st) < 0.6
    rem = np.where(alloc, rng.integers(1, 1000, n_st) * 5e5, 0.0)
    st_path = np.full((n_st, depth), -1, np.int32)
    for j in np.flatnonzero(alloc):
        k = int(rng.integers(1, depth + 1))
        st_path[j, :k] = rng.choice(N_LINKS, k, replace=False)
    listed = rest[: len(rest) // 3]
    if case == "staged_in_idx":
        listed = np.concatenate([staged[alloc], listed])
    elif case == "empty_idx":
        listed = listed[:0]
    elif case == "all_dead":
        listed = rest[: len(rest) // 2]
    return (st, bw, act, now, rng.permutation(listed).astype(np.int32),
            (staged, rem, alloc), st_path)


def _scatter_np(st: dict, active: np.ndarray, staged, st_path) -> None:
    """The engine's staged writes, in numpy (the oracle side)."""
    slot, rem, flag = staged
    st["rem"][slot] = rem
    st["rate"][slot] = 0.0
    st["eta"][slot] = np.inf
    st["due"][slot] = np.inf
    active[slot] = flag
    st["path"][slot] = st_path


def _old_composition(kernel: str, st: dict, bw, act, now, idx, staged,
                     st_path) -> tuple[SlotArrays, float]:
    """The engine's composition before the kernels took staged rows: the
    scatter (``_apply_staged``'s, ``share.scatter_staged``), then the plain
    version without staged rows."""
    s = _slot_arrays(st)
    scatter_staged(tuple(torch.tensor(a) for a in (*staged, st_path)),
                   s.path, s.rem, s.rate, s.eta, s.due, s.active)
    if kernel == "net_rerate":
        m = net_rerate_ref(_t(idx), s.path, s.rem, s.rate, _t(bw), _t(act),
                           now)
    else:
        m = event_engine_ref(_t(idx), s.path, s.rem, s.rate, s.eta, s.due,
                             _t(bw), _t(act), now)
    return s, m.item()


@pytest.mark.parametrize("slots", [64, 1000])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("case", STAGED_CASES)
@pytest.mark.parametrize("kernel", ["net_rerate", "event_engine"])
def test_staged_rows_match_composition_and_oracle(kernel, case, depth,
                                                  slots):
    """The op with staged rows (the engine's call path, plain version on
    the CPU) equals (i) the old composition and (ii) the numpy oracle on
    the scattered state, bit for bit, returned minimum included."""
    st, bw, act, now, idx, staged, st_path = _staged_case(
        case, slots, depth, slots + depth)
    got = _slot_arrays(st)
    op = net_rerate if kernel == "net_rerate" else event_engine
    got_min = op(_inputs(bw, act, idx, depth, staged, st_path), got, now)
    old, old_min = _old_composition(kernel, st, bw, act, now, idx, staged,
                                    st_path)
    keys = ("path", "rem", "rate", "eta", "due", "active")
    assert got_min == old_min
    for k in keys:
        assert torch.equal(getattr(got, k), getattr(old, k)), k

    want = {k: v.copy() for k, v in st.items()}
    want["active"] = (st["path"] >= 0).any(1)
    _scatter_np(want, want["active"], staged, st_path)
    live_idx = idx
    if kernel == "net_rerate":
        if live_idx.size:
            want["rate"][live_idx], _ = oracle_rerate(
                want["path"][live_idx], want["rem"][live_idx], bw, act, now)
        live = want["rate"] > 0.0
        want_min = (float(np.min(now + want["rem"][live] / want["rate"][live]))
                    if live.any() else math.inf)
    else:
        if live_idx.size:
            rem_now, rate_new, eta_new, _ = event_engine_core(
                want["path"][live_idx], want["rem"][live_idx],
                want["rate"][live_idx], want["eta"][live_idx], bw, act, now)
            ok = rate_new > 0.0
            want["rem"][live_idx] = rem_now
            want["rate"][live_idx] = rate_new
            want["eta"][live_idx] = eta_new
            want["due"][live_idx] = np.where(
                ok, eta_new - 1.0 / np.where(ok, rate_new, 1.0), np.inf)
        want_min = float(want["eta"].min())
    assert got_min == want_min
    if case == "all_dead":
        assert got_min == math.inf
    for k in keys:
        assert _equal(getattr(got, k).numpy(), want[k]), k


@pytest.mark.parametrize("n_staged,n_idx", [(0, 0), (1, 0), (0, 5000),
                                            (300, 20000)])
def test_net_inputs_layout_round_trip(n_staged, n_idx):
    """What ``pack`` writes, ``arrays`` reads back (the layout the kernels
    read, ``NetInputs`` in ``csrc/share_rate.cuh``), across buffer growth;
    the byte count matches the C side's ``net_input_bytes``."""
    rng = np.random.default_rng(n_staged + n_idx)
    depth, n_links = 3, 555
    inputs = NetInputs(n_links, depth)
    for rnd in range(2):
        links = rng.uniform(0, 1e8, (2, n_links))
        slot = rng.permutation(40000)[:n_staged].astype(np.int32)
        rem = rng.uniform(0, 1e9, n_staged)
        flag = rng.random(n_staged) < 0.5
        path = rng.integers(-1, n_links, (n_staged, depth))
        idx = list(rng.permutation(40000)[:n_idx])
        inputs.pack(links, list(slot), list(rem), list(flag), path, idx)
        got_idx, bw, act, (g_slot, g_rem, g_flag, g_path) = inputs.arrays()
        assert np.array_equal(got_idx, idx) and got_idx.dtype == np.int32
        assert np.array_equal(bw, links[0]) and np.array_equal(act, links[1])
        assert np.array_equal(g_slot, slot) and np.array_equal(g_rem, rem)
        assert np.array_equal(g_flag != 0, flag)
        assert np.array_equal(g_path, path) and g_path.dtype == np.int32
        nbytes = 8 * (2 * n_links + n_staged) + 4 * (n_staged * (2 + depth)
                                                     + n_idx)
        assert inputs.capacity >= nbytes


def test_net_inputs_refuse_wrong_shapes():
    inputs = NetInputs(4, 3)
    with pytest.raises(ValueError, match="path rows"):
        inputs.pack(np.zeros((2, 4)), [1], [0.0], [False],
                    np.zeros((1, 2), np.int32), [])
    with pytest.raises(ValueError, match="links"):
        inputs.pack(np.zeros((2, 5)), [], [], [], np.zeros((0, 3)), [])
    st, _, _, _ = _state(0, 8, 3)
    t = {k: _t(v) for k, v in st.items()}
    with pytest.raises(ValueError, match="rem"):
        SlotArrays(t["path"], t["rem"].float(), t["rate"], t["eta"],
                   t["due"], torch.zeros(8, dtype=torch.bool))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [200, 3000, 16383, 40000])
@pytest.mark.parametrize("n_dirty", [0, 1, 679, 13528])
def test_cuda_kernels_match_plain_versions(n_dirty, slots):
    """On the card: each kernel, with staged rows (a release, allocs, one
    of them also listed), bit-equal to its plain version on the same packed
    inputs, at slot counts that are not a multiple of the cluster's
    threads, with blocks from one warp (200 slots) to 1,024 threads."""
    dev = _card()
    st, bw, act, now = _state(n_dirty + slots, slots, 3)
    rng = np.random.default_rng(n_dirty)
    perm = rng.permutation(slots).astype(np.int32)
    staged = perm[:3]
    idx = np.concatenate([staged[1:2], perm[3: 3 + max(0, n_dirty - 1)]])
    idx = idx[:n_dirty]
    st_path = np.array([[-1, -1, -1], [5, 40, -1], [7, -1, -1]], np.int32)
    rows = (staged, np.array([0.0, 4e8, 1e6]), np.array([False, True, True]))
    for name, kern, ref in (("net_rerate", net_rerate_kernel, net_rerate_ref),
                            ("event_engine", event_engine_kernel,
                             event_engine_ref)):
        k, p = _slot_arrays(st, dev), _slot_arrays(st, dev)
        inputs = _inputs(bw, act, idx, 3, rows, st_path, device=dev)
        before = _cuda.LAUNCHES[name]
        a = kern(inputs, k, now)
        assert _cuda.LAUNCHES[name] == before + 1
        i, b_, a_, staged_t = inputs.tensors(dev)
        if name == "net_rerate":
            b = net_rerate_ref(i, p.path, p.rem, p.rate, b_, a_, now,
                               staged_t, eta=p.eta, due=p.due,
                               active=p.active)
        else:
            b = event_engine_ref(i, p.path, p.rem, p.rate, p.eta, p.due, b_,
                                 a_, now, staged_t, active=p.active)
        assert a == b.item(), name
        for key in ("path", "rem", "rate", "eta", "due", "active"):
            assert torch.equal(getattr(k, key), getattr(p, key)), (name, key)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_cuda_engine_matches_cpu_engine_across_growth(backend):
    """On the card: an engine history that grows the slot arrays (64 ->
    256 slots) between kernel calls, several staged writes per call,
    record for record equal to the same history on the CPU."""
    import types

    dev = _card()
    kw = dict(lan_bandwidth=100.0, wan_bandwidth=10.0, storage_capacity=1e10,
              tier_fanouts=(4, 13), uplink_bandwidths=(10.0,))
    engines = [NetworkEngine(GridTopology(0, 0, **kw), backend, device=d)
               for d in (dev, "cpu")]
    rng = np.random.default_rng(5)
    live: list = []
    now = 0.0
    for step in range(400):
        for e in engines:
            e.advance(now)
        changed: set = set()
        for _ in range(int(rng.integers(1, 4))):
            if rng.random() < 0.7 or not live:
                links = engines[1].topology.link_ids_for(
                    int(rng.integers(52)), int(rng.integers(52)))
                trs = [types.SimpleNamespace(slot=-1) for _ in engines]
                size = float(rng.integers(1, 2000)) * 5e5
                slots = {e.alloc(t, size, links)
                         for e, t in zip(engines, trs)}
                assert len(slots) == 1
                live.append(trs)
            else:
                trs = live.pop(int(rng.integers(len(live))))
                links = engines[0].release(trs[0])
                assert engines[1].release(trs[1]) == links
            changed.update(links)
        got = [e.rerate(sorted(changed), now) for e in engines]
        assert got[0] == got[1], step
        if backend == "device":
            got = [e.flush(now) for e in engines]
            assert got[0] == got[1], step
        a, b = (e.arrays() for e in engines)
        for key in a:
            assert np.array_equal(a[key], b[key]), (step, key)
        now += float(rng.exponential(5.0))
    assert engines[0].cap == engines[1].cap >= 256


def plan_inputs(seed: int, sites: int, pairs: int, served: bool,
                kind: str = "sparse"):
    """A burst's planner inputs. ``sparse``: quantized bandwidths (ties),
    sparse holders, every seventh column all-masked, zero or nonzero serve.
    ``ties``: one bandwidth everywhere and dense holders, so at zero serve
    every fetchable holder ties and the lowest site id must win across the
    kernel's site groups and blocks. ``masked``: every column all-masked,
    ``local[0, p]`` true on even and false on odd columns (the pick is site
    0 and ``inter_g`` reads that flag)."""
    rng = np.random.default_rng(seed)
    bw = rng.choice([0.0, 6.25e5, 1.25e6, 2.5e6, 1.25e8], (sites, pairs))
    fetch = rng.random((sites, pairs)) < 0.05
    fetch[:, ::7] = False
    local = rng.random((sites, pairs)) < 0.1
    serve = (rng.choice([0.0, 0.5, 1.0, 3.0], sites) if served
             else np.zeros(sites))
    free = rng.choice([0.0, 2.5e7, 1e9], pairs)
    size = np.full(pairs, 5e7)
    if kind == "ties":
        bw = np.full((sites, pairs), 1.25e6)
        fetch = rng.random((sites, pairs)) < 0.3
        local = rng.random((sites, pairs)) < 0.5
    elif kind == "masked":
        fetch = np.zeros((sites, pairs), bool)
        if sites:
            local[0] = np.arange(pairs) % 2 == 0
    return bw, fetch, local, serve, free, size


#: strategy_plan cases on the card: (sites, pairs, kind) and the test id
PLAN_CASES = (
    ((500, 1250, "sparse"), "500-1250"),     # a grid_500_evict burst
    ((1100, 300, "sparse"), "1100-300"),     # more sites than one round
    ((20, 77, "sparse"), "20-77"),           # fewer sites than groups
    ((3, 0, "sparse"), "3-0"),               # no pair
    ((500, 1250, "ties"), "500-1250-ties"),
    ((1100, 300, "ties"), "1100-300-ties"),
    ((500, 1250, "masked"), "500-1250-masked"),
    ((20, 77, "masked"), "20-77-masked"),
    ((500, 1251, "sparse"), "500-1251"),     # pairs not a multiple of 8
    ((64, 13, "sparse"), "64-13"),
    ((1, 100, "sparse"), "1-100"),           # one site
    ((1, 9, "ties"), "1-9-ties"),
)


@pytest.mark.gpu
@pytest.mark.parametrize("served", [False, True])
@pytest.mark.parametrize("sites,pairs,kind", [c for c, _ in PLAN_CASES],
                         ids=[i for _, i in PLAN_CASES])
def test_cuda_strategy_plan_matches_plain_and_oracle(sites, pairs, kind,
                                                     served):
    """strategy_plan on the card (``PLAN_CASES``: the grid_500_evict burst
    shape; many sites; fewer sites than the kernel's site groups; no pair;
    ties everywhere; all-masked columns; ragged pair tiles; one site):
    bit-equal to its plain version and to the float64 oracle."""
    dev = _card()
    args = plan_inputs(sites + pairs, sites, pairs, served, kind)
    t = [torch.tensor(a, device=dev) for a in args]
    ks, kf = strategy_plan_kernel(*t)
    ps, pf = strategy_plan_ref(*t)
    assert torch.equal(ks, ps) and torch.equal(kf, pf)
    if pairs:
        want = oracle_plan(*args)
        got = [ks[0], ks[1], kf[0], kf[1], kf[2]]
        for w, g in zip(want, got):
            assert np.array_equal(w, g.cpu().numpy().astype(np.float64))


@pytest.mark.gpu
def test_cuda_strategy_plan_graph_replay():
    """A call captured in a CUDA graph (as the timing takes it) and
    replayed on new inputs written in place."""
    dev = _card()
    t = [torch.tensor(a, device=dev)
         for a in plan_inputs(0, 500, 1250, True)]
    strategy_plan_kernel(*t)                         # build, load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ks, kf = strategy_plan_kernel(*t)
    for seed, kind in ((1, "sparse"), (2, "ties"), (3, "masked")):
        for dst, src in zip(t, plan_inputs(seed, 500, 1250, True, kind)):
            dst.copy_(torch.tensor(src))
        graph.replay()
        torch.cuda.synchronize()
        ps, pf = strategy_plan_ref(*t)
        assert torch.equal(ks, ps) and torch.equal(kf, pf), kind


def st_inputs(seed: int, sites: int, files: int, jobs: int,
              kind: str = "sparse"):
    """A dispatch burst's cost inputs. ``sparse``: ~4 holders a file (one
    forced), 10% of the sites offline, every fifth file fetchable from its
    offline holders too, ~12 required files a job, a few zero bandwidths.
    ``all_held``: every site holds and may send every file (every term 0).
    ``no_holder``: nothing fetchable (inf wherever a required file is
    missing). ``zero_bw``: 30% of the bw rows zero, every tenth file
    fetchable only from those. ``not_subset``: fetch drawn apart from
    presence. ``job_edges``: job 0 requires no file, job 1 every file.
    ``offline``: every site offline."""
    rng = np.random.default_rng(seed)
    bw = rng.choice([0.0, 6.25e5, 1.25e6, 2.5e6, 1.25e8], (sites, sites),
                    p=[0.02, 0.3, 0.3, 0.28, 0.1])
    presence = rng.random((sites, files)) < min(0.5, 3.0 / max(sites, 1))
    if sites:
        presence[rng.integers(0, sites, files), np.arange(files)] = True
    online = rng.random(sites) < 0.9
    fetch = presence & online[:, None]
    fetch[:, ::5] = presence[:, ::5]
    sizes = rng.choice([5e8, 1e9, 1.7e9], files)
    required = rng.random((jobs, files)) < min(1.0, 12.0 / max(files, 1))
    rel = rng.integers(0, 40, sites) * 37.5
    if kind == "all_held":
        presence[:] = True
        fetch[:] = True
    elif kind == "no_holder":
        fetch[:] = False
    elif kind == "zero_bw":
        dark = rng.random(sites) < 0.3
        bw[dark] = 0.0
        cols = np.arange(files) % 10 == 0
        fetch[:, cols] = dark[:, None] & (rng.random((sites, cols.sum()))
                                          < 0.2)
    elif kind == "not_subset":
        fetch = rng.random((sites, files)) < min(0.5, 4.0 / max(sites, 1))
    elif kind == "job_edges" and jobs >= 2:
        required[0] = False
        required[1] = True
    elif kind == "offline":
        online[:] = False
    return bw, fetch, presence, sizes, required, rel, online


#: st_cost cases: (sites, files, jobs, kind) and the test id
ST_CASES = (
    ((52, 100, 50, "sparse"), "52-100-50-sparse"),       # bulk_shortest
    ((500, 401, 50, "sparse"), "500-401-50-sparse"),     # a 500-site burst
    ((33, 77, 7, "sparse"), "33-77-7-sparse"),           # unaligned rows
    ((1100, 60, 20, "sparse"), "1100-60-20-sparse"),     # beyond one pass
    ((129, 50, 9, "sparse"), "129-50-9-sparse"),         # a ragged span
    ((1, 10, 3, "sparse"), "1-10-3-sparse"),             # one site
    ((52, 100, 50, "all_held"), "52-100-50-all_held"),
    ((52, 100, 50, "no_holder"), "52-100-50-no_holder"),
    ((52, 100, 50, "zero_bw"), "52-100-50-zero_bw"),
    ((500, 401, 50, "zero_bw"), "500-401-50-zero_bw"),
    ((52, 100, 50, "not_subset"), "52-100-50-not_subset"),
    ((500, 401, 50, "not_subset"), "500-401-50-not_subset"),
    ((52, 100, 50, "job_edges"), "52-100-50-job_edges"),
    ((65, 33, 3, "job_edges"), "65-33-3-job_edges"),
    ((52, 100, 50, "offline"), "52-100-50-offline"),
    ((52, 100, 300, "sparse"), "52-100-300-sparse"),     # many job groups
    ((52, 0, 5, "sparse"), "52-0-5-sparse"),             # no file
    ((5, 7, 0, "sparse"), "5-7-0-sparse"),               # no job
)


@pytest.mark.gpu
@pytest.mark.parametrize("sites,files,jobs,kind", [c for c, _ in ST_CASES],
                         ids=[i for _, i in ST_CASES])
def test_cuda_st_cost_matches_plain_and_oracle(sites, files, jobs, kind):
    """st_cost on the card (``ST_CASES``: bulk_shortest and the 500-site
    burst shape; unaligned rows, more sites than one holder pass, a ragged
    128-site span, one site; every file held, nothing fetchable, zero bw
    rows, fetch apart from presence, jobs requiring no file and every
    file, every site offline, many job groups, no file, no job):
    bit-equal to its plain version and the oracle, infs in the same
    places."""
    dev = _card()
    args = st_inputs(sites * 7 + files + jobs, sites, files, jobs, kind)
    t = [torch.tensor(a, device=dev) for a in args]
    got = st_cost_kernel(*t)
    assert torch.equal(got, st_cost_ref(*t))
    assert np.array_equal(got.cpu().numpy(), oracle_st_cost(*args))


@pytest.mark.gpu
def test_cuda_st_cost_graph_replay():
    """A call captured in a CUDA graph (as the timing takes it) and
    replayed on new inputs written in place."""
    dev = _card()
    t = [torch.tensor(a, device=dev) for a in st_inputs(0, 52, 100, 50)]
    st_cost_kernel(*t)                               # build, load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = st_cost_kernel(*t)
    for seed, kind in ((1, "sparse"), (2, "not_subset"), (3, "zero_bw")):
        for dst, src in zip(t, st_inputs(seed, 52, 100, 50, kind)):
            dst.copy_(torch.tensor(src))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, st_cost_ref(*t)), kind


def vs_inputs(seed: int, sites: int, files: int, kind: str = "sparse"):
    """The economy's value-matrix inputs. Holders: ``sparse`` (3% of the
    cells), ``dense`` (every site holds every file), ``empty`` (no holder),
    ``single`` (one holder a file, so only the self-exclusion is left at
    that site), ``zero_bw`` (sparse, with ~30% of the bw rows zero)."""
    rng = np.random.default_rng(seed)
    demand = rng.random((sites, files)) * rng.choice([0.0, 1.0, 9.0],
                                                     (sites, files))
    sizes = rng.choice([1e9, 2e9], files)
    presence = rng.random((sites, files)) < 0.03
    bw = rng.choice([0.0, 1.25e6, 1.25e8], (sites, sites))
    if kind == "dense":
        presence[:] = True
    elif kind == "empty":
        presence[:] = False
    elif kind == "single":
        presence[:] = False
        presence[rng.integers(0, sites, files), np.arange(files)] = True
    elif kind == "zero_bw":
        bw[rng.random(sites) < 0.3] = 0.0
    return demand, sizes, presence, bw


#: value_score cases on the card: (sites, files, kind) and the test id
VS_CASES = (
    ((52, 100, "sparse"), "52-100"),         # economy_starved
    ((500, 1000, "sparse"), "500-1000"),     # the 500-site catalog
    ((52, 100, "dense"), "52-100-dense"),
    ((52, 100, "empty"), "52-100-empty"),
    ((52, 100, "single"), "52-100-single"),
    ((500, 1000, "single"), "500-1000-single"),
    ((1, 10, "dense"), "1-10-dense"),        # one site: no other holder
    ((33, 77, "sparse"), "33-77"),           # unaligned presence rows
    ((33, 77, "dense"), "33-77-dense"),
    ((129, 50, "sparse"), "129-50"),         # a 128-site span and one site
    ((1100, 300, "sparse"), "1100-300"),     # beyond one holder pass
    ((1100, 300, "single"), "1100-300-single"),
    ((1100, 64, "dense"), "1100-64-dense"),
    ((52, 0, "sparse"), "52-0"),             # no file
    ((52, 100, "zero_bw"), "52-100-zero_bw"),
    ((500, 1000, "zero_bw"), "500-1000-zero_bw"),
)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["cost", "plain"])
@pytest.mark.parametrize("sites,files,kind", [c for c, _ in VS_CASES],
                         ids=[i for _, i in VS_CASES])
def test_cuda_value_score_matches_plain_and_oracle(sites, files, kind, mode):
    """value_score on the card (``VS_CASES``: economy_starved and the
    500-site shape; dense, empty and single-holder presence; one site,
    unaligned rows, a ragged 128-site span, more holders than one pass,
    no file; zero bw rows):
    bit-equal to its plain version and the oracle."""
    dev = _card()
    demand, sizes, presence, bw = vs_inputs(sites + files, sites, files, kind)
    t = [torch.tensor(a, device=dev) for a in (demand, sizes, presence, bw)]
    got = value_score_kernel(*t, mode=mode)
    assert torch.equal(got, value_score_ref(*t, mode=mode))
    want = oracle_value(demand, sizes, presence, bw, mode=mode)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["cost", "plain"])
def test_cuda_value_score_graph_replay(mode):
    """A call captured in a CUDA graph (as the timing takes it) and
    replayed on new inputs written in place."""
    dev = _card()
    t = [torch.tensor(a, device=dev) for a in vs_inputs(0, 52, 100)]
    value_score_kernel(*t, mode=mode)                # build, load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = value_score_kernel(*t, mode=mode)
    for seed, kind in ((1, "sparse"), (2, "dense"), (3, "single")):
        for dst, src in zip(t, vs_inputs(seed, 52, 100, kind)):
            dst.copy_(torch.tensor(src))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, value_score_ref(*t, mode=mode)), kind


# -- deep copies (the tie-race sanitizer's twins) ----------------------------

def _started_sim(device, net="numpy"):
    """A paper-style grid of 8 sites with 40 jobs in bursts of 8."""
    from repro_torch.core import (GridConfig, GridSimulator, build_catalog,
                                  build_topology, generate_jobs)

    cfg = GridConfig(n_regions=2, sites_per_region=4)
    topo = build_topology(cfg)
    catalog = build_catalog(cfg, topo)
    sim = GridSimulator(topo, catalog, net=net, device=device)
    for info in catalog.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    for j, job in enumerate(generate_jobs(cfg, 40)):
        sim.submit_job(job, at=(j // 8) * cfg.interarrival * 8)
    return sim


_SLOT_NAMES = ("path", "rem", "rate", "eta", "due", "active")


@pytest.mark.parametrize("net", ["numpy", "device"])
def test_deepcopied_engine_shares_no_storage(net):
    """A copied engine's slot tensors and packed buffer are its own, and
    running the copy leaves the original's as they were."""
    sim = _started_sim("cpu", net)
    sim.run(until=3000.0)
    net_a = sim.network
    twin = copy.deepcopy(sim)
    net_b = twin.network
    for name in _SLOT_NAMES:
        a, b = getattr(net_a, name), getattr(net_b, name)
        assert torch.equal(a, b), name
        assert a.untyped_storage().data_ptr() != \
            b.untyped_storage().data_ptr(), name
        assert getattr(net_b._slots, name) is b, name
    assert not np.shares_memory(net_a._inputs._f64, net_b._inputs._f64)
    assert not np.shares_memory(net_a._inputs._i32, net_b._inputs._i32)
    assert np.shares_memory(net_b._inputs._f64, net_b._inputs._i32)
    before = {n: getattr(net_a, n).clone() for n in _SLOT_NAMES}
    packed = net_a._inputs._f64.tobytes()   # uninitialised words may be NaN
    res = twin.run()
    assert len(res.records) == 40
    for name in _SLOT_NAMES:
        assert torch.equal(getattr(net_a, name), before[name]), name
    assert net_a._inputs._f64.tobytes() == packed
    # the original then runs to the twin's end
    assert sim.run().records == res.records


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["numpy", "device"])
def test_cuda_deepcopied_engine_owns_its_addresses(net):
    """Every address a copied engine caches is its own, and running the
    copy on the card leaves the original's slot tensors and buffers as
    they were."""
    sim = _started_sim(_card(), net)
    sim.run(until=3000.0)
    net_a = sim.network
    twin = copy.deepcopy(sim)
    net_b = twin.network

    def addresses(n):
        return set(n._slots.ptrs) | {n._inputs.host_ptr, n._inputs.dev_ptr,
                                     n._inputs.word_ptr}

    assert len(addresses(net_b)) == 9
    assert not addresses(net_a) & addresses(net_b)
    assert net_b._slots.ptrs == tuple(getattr(net_b, n).data_ptr()
                                      for n in _SLOT_NAMES)
    before = {n: getattr(net_a, n).clone() for n in _SLOT_NAMES}
    packed = net_a._inputs._f64.tobytes()   # uninitialised words may be NaN
    word = net_a._inputs.result()
    res = twin.run()
    torch.cuda.synchronize()
    assert len(res.records) == 40
    for name in _SLOT_NAMES:
        assert torch.equal(getattr(net_a, name), before[name]), name
    assert net_a._inputs._f64.tobytes() == packed
    assert net_a._inputs.result() == word or np.isnan(word)
    assert sim.run().records == res.records
