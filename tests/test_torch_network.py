"""The port's NetworkEngine (``device="cpu"``) against the reference's.

Identical seeded alloc/release/rerate/flush histories drive
``repro.core.network.NetworkEngine`` and the port's engine side by side;
after every step every slot array, the link occupancy, the returned
next-completion time and the completion set are equal bit for bit. Also:
the 3-transfer mid-tier contention fixture of ``tests/test_network.py``, a
``load_arrays`` round trip from a mid-run reference state, and the routes
the port refuses.
"""

import types

import numpy as np
import pytest
import torch

from repro.core import GridTopology as RefTopology
from repro.core.network import NetworkEngine as RefEngine
from repro_torch.core import GridTopology, NetworkEngine

GB = 1e9
KEYS = ("rem", "rate", "eta", "due", "active", "path", "link_bw",
        "link_act")


def _topos(fanouts, uplinks, lan=100.0, path_model="full"):
    kw = dict(lan_bandwidth=lan, wan_bandwidth=uplinks[0],
              storage_capacity=10 * GB, tier_fanouts=fanouts,
              uplink_bandwidths=uplinks, path_model=path_model)
    return RefTopology(0, 0, **kw), GridTopology(0, 0, **kw)


def _ref_arrays(net: RefEngine) -> dict:
    return {k: np.asarray(getattr(net, k)) for k in KEYS}


def _assert_same(ref: RefEngine, port: NetworkEngine, where) -> None:
    got = port.arrays()
    for k, v in _ref_arrays(ref).items():
        assert got[k].shape == v.shape and np.array_equal(got[k], v), \
            (where, k)
    assert port.n_active == ref.n_active, where
    assert [list(m) for m in port.members] == \
        [list(m) for m in ref.members], where
    assert port.stats == ref.stats, where


def _history(backend: str, topos, n_steps: int, seed: int):
    """Random transfer starts/finishes at a random clock on both engines,
    checked after every step; yields the two engines at the end."""
    rt, pt = topos
    ref, port = RefEngine(rt, backend), NetworkEngine(pt, backend,
                                                      device="cpu")
    rng = np.random.default_rng(seed)
    live: list[tuple[object, object]] = []
    now = 0.0
    n = rt.n_sites
    for step in range(n_steps):
        ref.advance(now)
        port.advance(now)
        if rng.random() < 0.55 or not live:
            links = rt.link_ids_for(int(rng.integers(n)),
                                    int(rng.integers(n)))
            a, b = (types.SimpleNamespace(slot=-1) for _ in range(2))
            size = float(rng.integers(1, 2000)) * 5e5
            assert ref.alloc(a, size, links) == port.alloc(b, size, links)
            live.append((a, b))
        else:
            a, b = live.pop(int(rng.integers(len(live))))
            links = ref.release(a)
            assert port.release(b) == links
        eta = (ref.rerate(links, now), port.rerate(links, now))
        assert eta[0] == eta[1], step
        if ref.batched:
            assert ref.flush(now) == port.flush(now), step
        assert np.array_equal(ref.completions(), port.completions()), step
        _assert_same(ref, port, (backend, step))
        now += float(rng.exponential(20.0))
    return ref, port


@pytest.mark.parametrize("backend", ["numpy", "pallas", "device"])
@pytest.mark.parametrize("shape", ["paper", "deep"])
def test_identical_histories(backend, shape):
    topos = (_topos((4, 13), (10.0,)) if shape == "paper"
             else _topos((3, 3, 6), (100.0, 10.0)))
    _history(backend, topos, 300, seed=len(shape) * 7 + len(backend))


def test_topmost_paths_match():
    """The legacy topmost-uplink model runs the numpy engine over
    truncated paths: same arrays on both engines."""
    _history("numpy", _topos((3, 3, 6), (100.0, 10.0),
                             path_model="topmost"), 200, seed=3)


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_three_transfer_min_over_path(backend):
    """Hand-computed fair shares on a (2,2,2) tree (the reference's
    fixture): t1 0->6 is bound by the thin group uplink, t2 1->2 by the
    same uplink, t3 0->1 by its shared NIC."""
    _, topo = _topos((2, 2, 2), (50.0, 10.0))
    net = NetworkEngine(topo, backend=backend, device="cpu")
    slots = {}
    for name, (src, dst) in {"t1": (0, 6), "t2": (1, 2), "t3": (0, 1)}.items():
        tr = types.SimpleNamespace(slot=-1)
        net.alloc(tr, 1e6, topo.link_ids_for(src, dst))
        net.rerate(topo.link_ids_for(src, dst), 0.0)
        slots[name] = tr.slot
    rate = net.arrays()["rate"]
    assert rate[slots["t1"]] == 5.0
    assert rate[slots["t2"]] == 5.0
    assert rate[slots["t3"]] == 50.0
    assert net.rerate((), 0.0) == 1e6 / 50.0


def test_three_transfer_batched_flush():
    _, topo = _topos((2, 2, 2), (50.0, 10.0))
    net = NetworkEngine(topo, backend="device", device="cpu")
    assert net.batched
    slots = {}
    for name, (src, dst) in {"t1": (0, 6), "t2": (1, 2), "t3": (0, 1)}.items():
        tr = types.SimpleNamespace(slot=-1)
        net.alloc(tr, 1e6, topo.link_ids_for(src, dst))
        assert net.rerate(topo.link_ids_for(src, dst), 0.0) is None
        slots[name] = tr.slot
    assert net.dirty
    assert net.flush(0.0) == 1e6 / 50.0
    assert not net.dirty
    rate = net.arrays()["rate"]
    assert [rate[slots[k]] for k in ("t1", "t2", "t3")] == [5.0, 5.0, 50.0]
    assert net.arrays()["rem"][slots["t1"]] == 1e6   # fresh: rem verbatim
    # t3 is due at its eta; t1/t2 are not
    net.advance(1e6 / 50.0)
    assert net.completions() == [slots["t3"]]


def test_capacity_growth_matches():
    """Past 64 in-flight transfers both engines double their slot arrays
    and hand out the same slots."""
    rt, pt = _topos((4, 13), (10.0,))
    ref, port = RefEngine(rt, "device"), NetworkEngine(pt, "device",
                                                       device="cpu")
    links = rt.link_ids_for(0, 51)
    for i in range(150):
        a, b = (types.SimpleNamespace(slot=-1) for _ in range(2))
        assert ref.alloc(a, 1e6 + i, links) == port.alloc(b, 1e6 + i, links)
    ref.rerate(links, 0.0)
    port.rerate(links, 0.0)
    assert ref.flush(0.0) == port.flush(0.0)
    assert port.cap == ref.cap == 256
    _assert_same(ref, port, "growth")


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_load_arrays_round_trip(backend):
    """Load a reference engine's mid-run state into a fresh port engine,
    then run the same occupancy change and re-rate on both."""
    topos = _topos((3, 3, 6), (100.0, 10.0))
    ref, _ = _history(backend, topos, 120, seed=11)
    port = NetworkEngine(topos[1], backend, device="cpu")
    port.load_arrays(_ref_arrays(ref), ref.members)
    port.last = ref.last
    port.stats = dict(ref.stats)
    _assert_same(ref, port, "loaded")
    now = ref.last + 5.0
    ref.advance(now)
    port.advance(now)
    changed = tuple(range(0, ref.n_links, 3))
    eta = ref.rerate(changed, now), port.rerate(changed, now)
    assert eta[0] == eta[1]
    if ref.batched:
        assert ref.flush(now) == port.flush(now)
    _assert_same(ref, port, "after")
    # the loaded engine keeps allocating on the free slots
    tr = types.SimpleNamespace(slot=-1)
    port.alloc(tr, 1e6, topos[1].link_ids_for(0, 53))
    assert port.arrays()["active"][tr.slot]


def test_refused_routes():
    _, topo = _topos((4, 13), (10.0,))
    for backend in ("pallas-interpret", "device-interpret"):
        with pytest.raises(NotImplementedError, match="interpreter"):
            NetworkEngine(topo, backend, device="cpu")
    with pytest.raises(ValueError, match="unknown network backend"):
        NetworkEngine(topo, "bogus", device="cpu")


def test_cuda_without_card_raises(monkeypatch):
    """device='cuda' never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, topo = _topos((4, 13), (10.0,))
    with pytest.raises(RuntimeError, match="is_available"):
        NetworkEngine(topo, "device")
