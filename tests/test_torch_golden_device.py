"""The port's batched ``net="device"`` engine (``device="cpu"``) against
the tolerance goldens and against the reference's own ``net="device"`` run.

Two contracts: every fast cell of ``golden_tolerance.json`` stays inside
its relative-error bounds (what ``tests/test_golden_tolerance.py`` holds
the reference to), and the run is the reference's run bit for bit — every
job record equal, makespan and inter-comms equal, and ``avg_job_time``
equal to the left-to-right mean of the reference's records.
"""

import dataclasses
import json
import os

import pytest

import repro.core as ref
from repro.launch.experiments import run_spec as ref_run_spec
from repro_torch.core import (SCENARIOS, GridConfig, GridSimulator,
                              build_catalog, build_topology, generate_jobs)
from repro_torch.launch.experiments import run_spec

_HERE = os.path.dirname(__file__)
TOL = json.load(open(os.path.join(_HERE, "golden_tolerance.json")))
GOLDEN = json.load(open(os.path.join(_HERE, "golden_metrics.json")))["metrics"]
GOLDEN_DEEP = json.load(open(os.path.join(_HERE, "golden_deep.json")))
BOUNDS = TOL["bounds"]


def _rel(got: float, want: float) -> float:
    if got == want:
        return 0.0
    return abs(got - want) / max(abs(got), abs(want))


def _mean_left_to_right(records) -> float:
    total = 0.0
    for r in records:
        total += r.job_time
    return total / max(1, len(records))


def _sim_run(mod, cfg, strategy: str, n: int, **kw):
    """``run_experiment``'s setup at the simulator level, for the
    reference (``mod=repro.core``) or the port, returning the SimResult
    with its per-job records."""
    topo = mod.build_topology(cfg)
    cat = mod.build_catalog(cfg, topo)
    sim = mod.GridSimulator(topo, cat, strategy=strategy, seed=cfg.seed,
                            net="device", **kw)
    for info in cat.files.values():
        sim.storage.bootstrap(info.master_site, info.lfn)
    for j, job in enumerate(mod.generate_jobs(cfg, n)):
        sim.submit_job(job, at=j * cfg.interarrival)
    return sim.run()


class _Port:
    GridSimulator, build_catalog = GridSimulator, build_catalog
    build_topology, generate_jobs = build_topology, generate_jobs


@pytest.mark.parametrize("key", [k for k in TOL["fast_cells"]
                                 if k != "deep_contended"])
def test_device_fast_cells_in_bounds_and_equal_to_reference(key):
    _, strategy, n = key.split("/")
    n = int(n)
    got = _sim_run(_Port, GridConfig(), strategy, n, device="cpu")
    want = _sim_run(ref, ref.GridConfig(), strategy, n)
    assert [dataclasses.astuple(r) for r in got.records] == \
        [dataclasses.astuple(r) for r in want.records]
    assert got.makespan == want.makespan
    assert got.total_inter_comms == want.total_inter_comms
    assert got.net_stats == want.net_stats
    assert got.avg_job_time == _mean_left_to_right(want.records)
    g = GOLDEN[key]
    assert len(got.records) == n
    assert _rel(got.avg_job_time, g["avg_job_time"]) <= BOUNDS["avg_job_time"]
    assert _rel(got.avg_inter_comms, g["avg_inter_comms"]) <= \
        BOUNDS["avg_inter_comms"]
    assert _rel(got.makespan, g["makespan"]) <= BOUNDS["makespan"]


def test_device_deep_cell_in_bounds_and_equal_to_reference():
    spec = dataclasses.replace(SCENARIOS[GOLDEN_DEEP["scenario"]],
                               net="device")
    n = GOLDEN_DEEP["n_jobs"]
    got = run_spec(spec, n_jobs=n, device="cpu")
    want = ref_run_spec(dataclasses.replace(
        ref.SCENARIOS[GOLDEN_DEEP["scenario"]], net="device"), n_jobs=n)
    g = GOLDEN_DEEP["metrics"]
    assert got.completed_jobs == want.completed_jobs == g["completed_jobs"]
    assert got.makespan == want.makespan
    assert got.avg_inter_comms == want.avg_inter_comms
    assert got.total_wan_gb == want.total_wan_gb
    assert got.net_stats == want.net_stats
    for m in ("avg_job_time", "avg_inter_comms", "makespan"):
        assert _rel(getattr(got, m), g[m]) <= BOUNDS[m], m
