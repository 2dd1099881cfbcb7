#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. the card: its name and power limit (``nvidia-smi``);
2. build all five CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   each, in parallel);
3. kernel parity at the main path's shapes — 16,384 slots, depth 3, the
   555 links of the 500-site grid, 679 and 13,528 dirty slots (the mean and
   the maximum per flush on ``grid_500_saturated``): each kernel bit-equal
   to its plain PyTorch version on the same inputs, slots outside the index
   list untouched; the device time of both (calls replayed from a CUDA
   graph) and the time of a call through the Python wrapper, beside the
   bound;
4. golden cells on the card: ``fig4/hrs/100`` bit-exact under
   ``net="numpy"`` and ``net="pallas"`` (the ``net_rerate`` path), within
   ``tests/golden_tolerance.json`` under ``net="device"``, and the deep cell
   bit-exact against ``tests/golden_deep.json``;
5. the main path at scale: ``grid_500_saturated`` at full width (500
   sites, the full catalog, ``broker="jax"``, ``net="device"``) with the job
   count cut from 20,000 to 2,000, on the card and on the CPU; all four
   metrics must be equal and the ``event_engine`` kernel must have run;
6. parity and timing of ``strategy_plan``, ``st_cost`` and ``value_score``
   at their paths' shapes: a ``grid_500_evict`` burst (500 sites x 1,250
   pairs, zero and nonzero serve), the ``bulk_shortest`` and 500-site
   dispatch bursts, the ``economy_starved`` (52 x 100) and 500 x 1,000
   value matrices in both modes — each bit-equal to its plain version;
7. the slice's paths (``PATHS``) on the card and on the CPU:
   ``grid_500_evict`` in ``strategy_mode="batch"`` at full width (500
   sites, 10,000 files, 25-file jobs, ``broker="jax"``) with the job count
   cut from 20,000 to 2,000, ``bulk_shortest`` as registered,
   ``economy_starved`` at seed 0 and ``hotset_drift`` under the
   ``predictive`` strategy. All four metrics must equal between the card
   and the CPU and equal the reference's (``REFERENCE``), and each path
   must launch its kernels (``PATH_KERNELS``).

The launch counts of each path are reset just before it runs and read just
after. The second-to-last line is the kernel summary as JSON; the last line
is ``{"ok": true, "device": {...}}``. Without a card, or without the rest
of the repository beside it, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SLOTS, DEPTH = 16384, 3
DIRTY = (679, 13528)          # mean and max dirty slots per flush
SCALE_JOBS = 2000

#: The slice's scenario paths (phase 7): registry name, the spec fields
#: replaced, and the job count (``grid_500_evict`` cut from 20,000).
PATHS = {
    "grid_500_evict": ("grid_500_evict", {"strategy_mode": "batch"}, 2000),
    "bulk_shortest": ("bulk_shortest", {}, 500),
    "economy_starved": ("economy_starved", {}, 500),
    "hotset_drift": ("hotset_drift", {"strategy": "predictive"}, 500),
}
#: The kernels each path must launch on the card.
PATH_KERNELS = {
    "grid_500_evict": ("strategy_plan", "net_rerate"),
    "bulk_shortest": ("st_cost",),
    "economy_starved": ("value_score",),
    "hotset_drift": ("value_score",),
}
#: The reference's metrics of each path (``repro`` on the CPU, seed 0;
#: ``avg_job_time`` is the left-to-right mean of its job records), printed
#: by ``PYTHONPATH=src python tests/test_torch_smoke.py`` on a machine with
#: JAX; ``tests/test_torch_smoke.py`` holds the three short ones to it.
REFERENCE = {
    "grid_500_evict": {
        "avg_job_time": 178.90909695251497, "makespan": 29938.44298370881,
        "avg_inter_comms": 13.1415, "completed_jobs": 2000},
    "bulk_shortest": {
        "avg_job_time": 177305.7129894169, "makespan": 261626.7979223158,
        "avg_inter_comms": 4.896, "completed_jobs": 500},
    "economy_starved": {
        "avg_job_time": 320078.74173721217, "makespan": 386100.0,
        "avg_inter_comms": 7.252, "completed_jobs": 500},
    "hotset_drift": {
        "avg_job_time": 123720.46816159964, "makespan": 165600.0,
        "avg_inter_comms": 3.112, "completed_jobs": 500},
}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP64_FLOPS = 34e12            # H100 SXM float64, outside the tensor cores
ROUNDS, CALLS = 20, 50        # timing: rounds of back-to-back calls


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, rounds: int = ROUNDS, calls: int = CALLS) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured into one
    CUDA graph, replayed between CUDA events, median over ``rounds``
    replays. The host's share of a call (input checks, ctypes, the launch
    itself) is not in it."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def wrapper_ms(fn, rounds: int = ROUNDS, calls: int = CALLS,
               warmup: int = 20) -> float:
    """Time of one eager ``fn()`` call as the engine makes it: CUDA events
    around ``calls`` back-to-back calls, median over ``rounds`` rounds.
    The host issues calls slower than the card runs them, so this is the
    Python wrapper's throughput, not the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def engine_state(seed: int, n_dirty: int, dev):
    """Slot state at the main path's shapes: realistic paths from the
    500-site grid, a mix of released, fresh and carried slots, random
    link occupancy, and ``n_dirty`` distinct dirty slots."""
    import numpy as np
    import torch

    from repro_torch.core import SCENARIOS, build_topology, to_grid_config

    topo = build_topology(to_grid_config(SCENARIOS["grid_500_saturated"]))
    rng = np.random.default_rng(seed)
    links = list(topo.nic_links) + list(topo.wan_links)
    bw = np.array([l.bandwidth for l in links])
    act = rng.integers(0, 40, len(links)).astype(np.float64)
    n_sites = topo.n_sites
    path = np.full((SLOTS, DEPTH), -1, np.int32)
    kind = rng.integers(0, 3, SLOTS)      # 0 released, 1 fresh, 2 carried
    for s in np.flatnonzero(kind > 0):
        ids = topo.link_ids_for(int(rng.integers(n_sites)),
                                int(rng.integers(n_sites)))
        path[s, :len(ids)] = ids
    now = 5e4
    rem = np.where(kind == 1, rng.integers(1, 1000, SLOTS) * 5e5, 0.0)
    rate = np.where(kind == 2, rng.uniform(1e4, 1e7, SLOTS), 0.0)
    eta = np.where(kind == 2, now + rng.uniform(0.0, 1e5, SLOTS), np.inf)
    due = np.where(kind == 2, eta - 1.0 / np.where(rate > 0, rate, 1.0),
                   np.inf)
    idx = np.sort(rng.choice(SLOTS, n_dirty, replace=False)).astype(np.int32)
    t = {k: torch.tensor(v, device=dev) for k, v in dict(
        idx=idx, path=path, rem=rem, rate=rate, eta=eta, due=due,
        bw=bw, act=act).items()}
    return t, now, len(links)


def compare(name, got: dict, want: dict, idx, before: dict) -> float:
    """Bit-equality of every output array (inf in the same places), and
    slots outside ``idx`` untouched. Returns the max abs error (0.0)."""
    import torch

    outside = torch.ones(SLOTS, dtype=torch.bool, device=idx.device)
    outside[idx] = False
    err = 0.0
    for k in got:
        a, b = got[k], want[k]
        if not torch.equal(a, b):
            fin = torch.isfinite(a) & torch.isfinite(b)
            err = max(err, float((a[fin] - b[fin]).abs().max()))
            raise AssertionError(f"{name}: {k} differs from the plain "
                                 f"version (max abs err {err})")
        if k in before and not torch.equal(a[outside], before[k][outside]):
            raise AssertionError(f"{name}: {k} changed outside the dirty "
                                 "slots")
    return err


def phase_kernels(dev) -> dict:
    """Parity and timing of both kernels; returns per-kernel records."""
    from repro_torch.kernels.event_engine import (event_engine_kernel,
                                                  event_engine_ref)
    from repro_torch.kernels.net_rerate import (net_rerate_kernel,
                                                net_rerate_ref)

    out = {}
    for n_dirty in DIRTY:
        t, now, n_links = engine_state(n_dirty, n_dirty, dev)
        # event_engine: flush idx in place, min(eta) over all slots
        keys = ("rem", "rate", "eta", "due")
        k_state = {k: t[k].clone() for k in keys}
        p_state = {k: t[k].clone() for k in keys}
        k_min = event_engine_kernel(t["idx"], t["path"], *k_state.values(),
                                    t["bw"], t["act"], now)
        p_min = event_engine_ref(t["idx"], t["path"], *p_state.values(),
                                 t["bw"], t["act"], now)
        err = compare("event_engine", {**k_state, "eta_min": k_min},
                      {**p_state, "eta_min": p_min}, t["idx"],
                      {k: t[k] for k in keys})
        kern = lambda: event_engine_kernel(  # noqa: E731
            t["idx"], t["path"], *k_state.values(), t["bw"], t["act"], now)
        plain = lambda: event_engine_ref(  # noqa: E731
            t["idx"], t["path"], *p_state.values(), t["bw"], t["act"], now)
        n = n_dirty
        # int32 idx and path rows; rate plus eta (or rem) read and four
        # float64 outputs written per dirty slot; eta read whole for the min
        bytes_ = (4 * n + 4 * DEPTH * n + 16 * n + 8 * SLOTS + 16 * n_links
                  + 32 * n + 8)
        flops = (3 * DEPTH + 8) * n + SLOTS
        out.setdefault("event_engine", []).append(dict(
            n_dirty=n, max_abs_err=err, ms=device_ms(kern),
            plain_ms=device_ms(plain), wrapper_ms=wrapper_ms(kern),
            plain_wrapper_ms=wrapper_ms(plain), bytes=bytes_, flops=flops))
        # net_rerate: re-rate idx in place, scan all live slots
        k_rate, p_rate = t["rate"].clone(), t["rate"].clone()
        k_min = net_rerate_kernel(t["idx"], t["path"], t["rem"], k_rate,
                                  t["bw"], t["act"], now)
        p_min = net_rerate_ref(t["idx"], t["path"], t["rem"], p_rate,
                               t["bw"], t["act"], now)
        err = compare("net_rerate", {"rate": k_rate, "eta_min": k_min},
                      {"rate": p_rate, "eta_min": p_min}, t["idx"],
                      {"rate": t["rate"]})
        kern = lambda: net_rerate_kernel(  # noqa: E731
            t["idx"], t["path"], t["rem"], k_rate, t["bw"], t["act"], now)
        plain = lambda: net_rerate_ref(  # noqa: E731
            t["idx"], t["path"], t["rem"], p_rate, t["bw"], t["act"], now)
        bytes_ = 4 * n + 4 * DEPTH * n + 16 * n_links + 16 * SLOTS + 8 * n + 8
        flops = 3 * DEPTH * n + 4 * SLOTS
        out.setdefault("net_rerate", []).append(dict(
            n_dirty=n, max_abs_err=err, ms=device_ms(kern),
            plain_ms=device_ms(plain), wrapper_ms=wrapper_ms(kern),
            plain_wrapper_ms=wrapper_ms(plain), bytes=bytes_, flops=flops))
    for name, rows in out.items():
        for r in rows:
            r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                      r["flops"] / FP64_FLOPS)
            r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                             >= r["flops"] / FP64_FLOPS else "operations")
            print(f"[kernels] {name} dirty={r['n_dirty']} bit-equal "
                  f"device: kernel={1e3 * r['ms']!r}us "
                  f"plain={1e3 * r['plain_ms']!r}us; "
                  f"through the wrapper: kernel={1e3 * r['wrapper_ms']!r}us "
                  f"plain={1e3 * r['plain_wrapper_ms']!r}us; "
                  f"bytes={r['bytes']} bound={1e3 * r['bound_ms']!r}us "
                  f"({r['bound_by']})")
    return out


def phase_golden(dev) -> dict:
    """Golden cells on the card; returns the launch counts of the
    net_rerate path (numpy + pallas cells)."""
    from repro_torch.core import SCENARIOS, GridConfig, run_experiment
    from repro_torch.kernels import _cuda
    from repro_torch.launch.experiments import run_spec

    tests = os.path.join(ROOT, "tests")
    golden = json.load(open(os.path.join(tests, "golden_metrics.json")))
    tol = json.load(open(os.path.join(tests, "golden_tolerance.json")))
    deep = json.load(open(os.path.join(tests, "golden_deep.json")))
    g = golden["metrics"]["fig4/hrs/100"]
    exact = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "makespan")

    _cuda.reset_launches()
    for net in ("numpy", "pallas"):
        r = run_experiment(GridConfig(), strategy="hrs", n_jobs=100,
                           net=net, device=dev)
        for m in exact:
            if getattr(r, m) != g[m]:
                raise AssertionError(f"fig4/hrs/100 net={net}: {m} "
                                     f"{getattr(r, m)!r} != {g[m]!r}")
        if r.completed_jobs != 100:
            raise AssertionError(f"net={net}: {r.completed_jobs} completed")
        print(f"[golden] fig4/hrs/100 net={net} bit-exact "
              f"avg_job_time={r.avg_job_time!r}")
    rerate_path = dict(_cuda.LAUNCHES)

    r = run_experiment(GridConfig(), strategy="hrs", n_jobs=100,
                       net="device", device=dev)
    for m in ("avg_job_time", "avg_inter_comms", "makespan"):
        got, want = getattr(r, m), g[m]
        rel = 0.0 if got == want else abs(got - want) / max(abs(got),
                                                            abs(want))
        if rel > tol["bounds"][m]:
            raise AssertionError(f"fig4/hrs/100 net=device: {m} rel err "
                                 f"{rel} > {tol['bounds'][m]}")
        print(f"[golden] fig4/hrs/100 net=device {m} rel_err={rel!r} "
              f"(bound {tol['bounds'][m]})")
    if r.completed_jobs != 100:
        raise AssertionError(f"net=device: {r.completed_jobs} completed")

    r = run_spec(SCENARIOS[deep["scenario"]], n_jobs=deep["n_jobs"],
                 device=dev)
    for m in exact + ("completed_jobs",):
        if getattr(r, m) != deep["metrics"][m]:
            raise AssertionError(f"deep cell: {m} {getattr(r, m)!r} != "
                                 f"{deep['metrics'][m]!r}")
    print(f"[golden] {deep['scenario']}/{deep['n_jobs']} bit-exact "
          f"avg_job_time={r.avg_job_time!r}")
    if rerate_path["net_rerate"] == 0:
        raise AssertionError("the numpy/pallas cells never launched "
                             "net_rerate")
    return rerate_path


def phase_scale(dev) -> dict:
    """The main path at full width on the card and on the CPU; returns
    the launch counts of the card run."""
    import torch

    from repro_torch.core import SCENARIOS
    from repro_torch.kernels import _cuda
    from repro_torch.launch.experiments import run_spec

    spec = SCENARIOS["grid_500_saturated"]
    results = {}
    for device in (dev, torch.device("cpu")):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        r = run_spec(spec, n_jobs=SCALE_JOBS, device=device)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        results[device.type] = (r, wall, dict(_cuda.LAUNCHES))
        print(f"[scale] {spec.name} jobs={SCALE_JOBS} sites={spec.n_sites} "
              f"device={device} wall_s={wall!r} "
              f"avg_job_time={r.avg_job_time!r} makespan={r.makespan!r} "
              f"avg_inter_comms={r.avg_inter_comms!r} "
              f"completed={r.completed_jobs} "
              f"flush_passes={r.net_stats['flush_passes']} "
              f"flush_slots={r.net_stats['flush_slots']} "
              f"launches={_cuda.LAUNCHES}")
    (rc, _, launches), (rh, _, host_launches) = results["cuda"], results["cpu"]
    for m in ("avg_job_time", "makespan", "avg_inter_comms",
              "completed_jobs"):
        if getattr(rc, m) != getattr(rh, m):
            raise AssertionError(f"{spec.name}: {m} on the card "
                                 f"{getattr(rc, m)!r} != on the CPU "
                                 f"{getattr(rh, m)!r}")
    if rc.completed_jobs != SCALE_JOBS:
        raise AssertionError(f"{rc.completed_jobs}/{SCALE_JOBS} completed")
    if launches["event_engine"] == 0:
        raise AssertionError("the main path never launched event_engine")
    if any(host_launches.values()):
        raise AssertionError("the CPU run launched a CUDA kernel")
    return launches


def _equal_or_raise(name: str, got, want) -> float:
    """Bit-equality of two result tensors, infs in the same places;
    returns the max abs error over the finite entries (0.0)."""
    import torch

    got, want = got.double(), want.double()
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from the plain version "
                             f"(max abs err {err})")
    return err


def _bound(bytes_: float, flops: float) -> tuple[float, str]:
    b, f = bytes_ / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return 1e3 * max(b, f), ("bytes" if b >= f else "operations")


def _grid(name: str, dev, seed: int):
    """The topology of a registered scenario and a network engine on
    ``dev`` with random link occupancy."""
    import numpy as np

    from repro_torch.core import (SCENARIOS, NetworkEngine, build_topology,
                                  to_grid_config)

    cfg = to_grid_config(SCENARIOS[name])
    topo = build_topology(cfg)
    net = NetworkEngine(topo, device=dev)
    rng = np.random.default_rng(seed)
    net.link_act[:] = rng.integers(0, 30, net.n_links).astype(np.float64)
    return cfg, topo, net, rng


def plan_state(seed: int, served: bool, dev):
    """A ``grid_500_evict`` burst: 50 jobs of 25 files at random sites
    (1,250 pairs), bandwidth columns from the engine, ~5 holders per file
    (a master and replicas), and zero or nonzero serve loads."""
    import numpy as np
    import torch

    cfg, topo, net, rng = _grid("grid_500_evict", dev, seed)
    n_sites, jobs, per_job = topo.n_sites, 50, cfg.files_per_job
    dsts = np.repeat(rng.integers(0, n_sites, jobs), per_job)
    n = dsts.size
    fetch = rng.random((n_sites, n)) < 4.0 / n_sites
    fetch[rng.integers(0, n_sites, n), np.arange(n)] = True
    region = np.array([topo.region_of(s) for s in range(n_sites)])
    local = region[:, None] == region[dsts][None, :]
    serve = (rng.uniform(0.0, 3.0, n_sites) * (rng.random(n_sites) < 0.3)
             if served else np.zeros(n_sites))
    free = rng.choice([0.0, 2.5e7, 1e9], n)
    size = np.full(n, cfg.file_size)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (net.point_bandwidth_columns(dsts), t(fetch), t(local), t(serve),
            t(free), t(size))


def st_state(scenario: str, seed: int, dev):
    """A 50-job dispatch burst of ``scenario``: the bandwidth matrix of the
    engine, ~4 holders per file, the burst's required-file union, uneven
    relative loads and a few offline sites."""
    import numpy as np
    import torch

    from repro_torch.core import generate_jobs

    cfg, topo, net, rng = _grid(scenario, dev, seed)
    n_sites = topo.n_sites
    jobs = generate_jobs(cfg, 50)
    lfns = sorted({l for j in jobs for l in j.required})
    index = {l: i for i, l in enumerate(lfns)}
    n_f = len(lfns)
    presence = rng.random((n_sites, n_f)) < 3.0 / n_sites
    presence[rng.integers(0, n_sites, n_f), np.arange(n_f)] = True
    online = rng.random(n_sites) < 0.97
    fetch = presence & online[:, None]
    required = np.zeros((len(jobs), n_f), bool)
    for j, job in enumerate(jobs):
        required[j, [index[l] for l in job.required]] = True
    rel = rng.integers(0, 50, n_sites) * 60.0
    sizes = np.full(n_f, cfg.file_size)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (net.point_bandwidth_matrix(), t(fetch), t(presence), t(sizes),
            t(required), t(rel), t(online))


def vs_state(scenario: str, seed: int, dev):
    """The economy's value-matrix inputs at ``scenario``'s full catalog:
    decayed demand (mostly zero), ~4 holders per file and the engine's
    bandwidth matrix."""
    import numpy as np
    import torch

    cfg, topo, net, rng = _grid(scenario, dev, seed)
    n_sites, n_f = topo.n_sites, cfg.n_files
    demand = rng.exponential(2.0, (n_sites, n_f)) * \
        (rng.random((n_sites, n_f)) < 0.2)
    presence = rng.random((n_sites, n_f)) < 3.0 / n_sites
    presence[rng.integers(0, n_sites, n_f), np.arange(n_f)] = True
    sizes = np.full(n_f, cfg.file_size)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return t(demand), t(sizes), t(presence), net.point_bandwidth_matrix()


def phase_dense_kernels(dev) -> dict:
    """Parity and timing of strategy_plan, st_cost and value_score at
    their paths' shapes; returns per-kernel records (one per shape)."""
    from repro_torch.kernels.st_cost import st_cost_kernel, st_cost_ref
    from repro_torch.kernels.strategy_plan import (strategy_plan_kernel,
                                                   strategy_plan_ref)
    from repro_torch.kernels.value_score import (value_score_kernel,
                                                 value_score_ref)

    out: dict = {}

    def record(name, shape, kern, plain, err, bytes_, flops, plain_calls):
        bound_ms, bound_by = _bound(bytes_, flops)
        r = dict(shape=shape, max_abs_err=err, ms=device_ms(kern),
                 plain_ms=device_ms(plain, rounds=5, calls=plain_calls),
                 wrapper_ms=wrapper_ms(kern),
                 plain_wrapper_ms=wrapper_ms(plain, rounds=5,
                                             calls=plain_calls, warmup=2),
                 bytes=bytes_, flops=flops, bound_ms=bound_ms,
                 bound_by=bound_by)
        out.setdefault(name, []).append(r)
        print(f"[kernels] {name} {shape} bit-equal device: "
              f"kernel={1e3 * r['ms']!r}us plain={1e3 * r['plain_ms']!r}us; "
              f"through the wrapper: kernel={1e3 * r['wrapper_ms']!r}us "
              f"plain={1e3 * r['plain_wrapper_ms']!r}us; bytes={bytes_} "
              f"flops={flops} bound={1e3 * bound_ms!r}us ({bound_by})")

    for served in (False, True):
        a = plan_state(3 + served, served, dev)
        ks, kf = strategy_plan_kernel(*a)
        ps, pf = strategy_plan_ref(*a)
        err = max(_equal_or_raise("strategy_plan sources", ks, ps),
                  _equal_or_raise("strategy_plan flags", kf, pf))
        n_s, n_p = a[0].shape
        # bw, fetch, local per cell; serve; free, size, sources, flags per
        # pair. A divide and two compares per cell.
        record("strategy_plan", f"sites={n_s} pairs={n_p} "
               f"serve={'nonzero' if served else 'zero'}",
               lambda: strategy_plan_kernel(*a),
               lambda: strategy_plan_ref(*a), err,
               10 * n_s * n_p + 8 * n_s + 16 * n_p + 8 * n_p + 3 * n_p,
               3 * n_s * n_p, 10)
    for scenario in ("bulk_shortest", "grid_500"):
        a = st_state(scenario, 7, dev)
        err = _equal_or_raise("st_cost", st_cost_kernel(*a), st_cost_ref(*a))
        bw, fetch, presence, sizes, required, rel, online = a
        n_s, n_f = presence.shape
        n_j = required.shape[0]
        # a compare per (fetchable holder, site), a divide per (file,
        # site), an add per (required file, site), a max per (job, site)
        flops = (int(fetch.sum()) * n_s + n_f * n_s
                 + int(required.sum()) * n_s + n_j * n_s)
        record("st_cost", f"{scenario} sites={n_s} union={n_f} jobs={n_j}",
               lambda: st_cost_kernel(*a), lambda: st_cost_ref(*a), err,
               8 * n_s * n_s + 2 * n_s * n_f + n_j * n_f + 8 * n_f
               + 9 * n_s + 8 * n_j * n_s, flops, 2)
    for scenario in ("economy_starved", "grid_500"):
        a = vs_state(scenario, 11, dev)
        demand, sizes, presence, bw = a
        n_s, n_f = demand.shape
        for mode in ("cost", "plain"):
            err = _equal_or_raise(
                "value_score", value_score_kernel(*a, mode=mode),
                value_score_ref(*a, mode=mode))
            # a compare per (holder, site) of every file, then a compare
            # (and a divide and a multiply in cost mode) per cell
            flops = int(presence.sum()) * n_s + n_s * n_f * (
                3 if mode == "cost" else 1)
            record("value_score", f"{scenario} sites={n_s} files={n_f} "
                   f"mode={mode}",
                   lambda: value_score_kernel(*a, mode=mode),
                   lambda: value_score_ref(*a, mode=mode), err,
                   17 * n_s * n_f + 8 * n_s * n_s + 8 * n_f, flops, 2)
    return out


def phase_paths(dev) -> dict:
    """The slice's scenario paths on the card and on the CPU; returns the
    card run's launch counts per path."""
    import dataclasses

    import torch

    from repro_torch.core import SCENARIOS
    from repro_torch.kernels import _cuda
    from repro_torch.launch.experiments import run_spec

    launches = {}
    for name, (scenario, replace, n_jobs) in PATHS.items():
        spec = dataclasses.replace(SCENARIOS[scenario], **replace)
        results = []
        for device in (dev, torch.device("cpu")):
            _cuda.reset_launches()
            t0 = time.perf_counter()
            r = run_spec(spec, n_jobs=n_jobs, device=device)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            results.append((r, dict(_cuda.LAUNCHES)))
            print(f"[paths] {name} jobs={n_jobs} sites={spec.n_sites} "
                  f"device={device} wall_s={wall!r} "
                  f"avg_job_time={r.avg_job_time!r} makespan={r.makespan!r} "
                  f"avg_inter_comms={r.avg_inter_comms!r} "
                  f"completed={r.completed_jobs} prefetches={r.prefetches} "
                  f"launches={_cuda.LAUNCHES}")
        (rc, card), (rh, host) = results
        want = REFERENCE[name]
        for m in ("avg_job_time", "makespan", "avg_inter_comms",
                  "completed_jobs"):
            if getattr(rc, m) != getattr(rh, m):
                raise AssertionError(f"{name}: {m} on the card "
                                     f"{getattr(rc, m)!r} != on the CPU "
                                     f"{getattr(rh, m)!r}")
            if getattr(rc, m) != want[m]:
                raise AssertionError(f"{name}: {m} {getattr(rc, m)!r} != "
                                     f"the reference's {want[m]!r}")
        for k in PATH_KERNELS[name]:
            if card[k] == 0:
                raise AssertionError(f"{name} never launched {k}")
        if any(host.values()):
            raise AssertionError(f"{name}: the CPU run launched a kernel")
        launches[name] = card
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _cuda

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[card] {smi}")
    print(f"[card] torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}"
          f" torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = _cuda.build()
    print(f"[build] {', '.join(_cuda.KERNELS)} built in {build_s:.2f}s")
    for name, log in _cuda.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernels = phase_kernels(dev)
    dense = phase_dense_kernels(dev)
    launches = {"net_rerate": phase_golden(dev)["net_rerate"],
                "event_engine": phase_scale(dev)["event_engine"]}
    paths = phase_paths(dev)
    by_path = {name: {p: paths[p][name] for p, ks in PATH_KERNELS.items()
                      if name in ks}
               for name in ("strategy_plan", "st_cost", "value_score")}
    for name, counts in by_path.items():
        launches[name] = sum(counts.values())

    sources = {"event_engine": ("src/repro_torch/csrc/event_engine.cu",
                                "src/repro/kernels/event_engine/kernel.py:39"),
               "net_rerate": ("src/repro_torch/csrc/net_rerate.cu",
                              "src/repro/kernels/net_rerate/kernel.py:38"),
               "strategy_plan": (
                   "src/repro_torch/csrc/strategy_plan.cu",
                   "src/repro/kernels/strategy_plan/kernel.py:45"),
               "st_cost": ("src/repro_torch/csrc/st_cost.cu",
                           "src/repro/kernels/st_cost/kernel.py:44"),
               "value_score": ("src/repro_torch/csrc/value_score.cu",
                               "src/repro/kernels/value_score/kernel.py:38")}
    summary = []
    # net_rerate's own path is phase 4; the slice-2 paths run it too
    rerate_by_path = {"golden": launches["net_rerate"],
                      **{p: paths[p]["net_rerate"] for p in PATHS}}
    for name in ("event_engine", "net_rerate"):
        row = kernels[name][0]      # the mean-dirty shape
        summary.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in kernels[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "wrapper_ms": row["wrapper_ms"],
            "plain_wrapper_ms": row["plain_wrapper_ms"],
            "n_dirty": row["n_dirty"],
            "at_max_dirty": {k: kernels[name][1][k] for k in
                             ("n_dirty", "ms", "plain_ms", "wrapper_ms",
                              "bound_ms")},
            **({"launches_by_path": rerate_by_path}
               if name == "net_rerate" else {}),
        })
    # the first shape of each is its path's: the grid_500_evict burst at
    # zero serve, bulk_shortest, economy_starved in cost mode
    for name in ("strategy_plan", "st_cost", "value_score"):
        rows = dense[name]
        row = rows[0]
        summary.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "wrapper_ms": row["wrapper_ms"],
            "plain_wrapper_ms": row["plain_wrapper_ms"],
            "shape": row["shape"], "launches_by_path": by_path[name],
            "other_shapes": [{k: r[k] for k in
                              ("shape", "ms", "plain_ms", "wrapper_ms",
                               "bound_ms", "bound_by")} for r in rows[1:]],
        })
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
