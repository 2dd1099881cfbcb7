#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. the card: its name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
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
   metrics must be equal and the ``event_engine`` kernel must have run.

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
    launches = {"net_rerate": phase_golden(dev)["net_rerate"],
                "event_engine": phase_scale(dev)["event_engine"]}

    sources = {"event_engine": ("src/repro_torch/csrc/event_engine.cu",
                                "src/repro/kernels/event_engine/kernel.py:39"),
               "net_rerate": ("src/repro_torch/csrc/net_rerate.cu",
                              "src/repro/kernels/net_rerate/kernel.py:38")}
    summary = []
    for name in _cuda.KERNELS:
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
        })
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
