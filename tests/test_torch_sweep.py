"""The port's figure sweeps and ``--all`` (``repro_torch.launch.experiments``).

``sweep`` crosses a base scenario's axis with replication strategies, as
the reference's ``repro.launch.experiments.sweep`` does for fig4-fig7
(``benchmarks/run.py``). Its cells are held to the reference's on the
CPU, record for record (every job's times, site, inter-communications and
WAN bytes, and the totals): the reference's ``avg_job_time`` is summed by
Python 3.12's compensated ``sum()``, so the means are compared as the
left-to-right mean of the reference's records, the port's summation. The
fig4 cells at 100 jobs are bit-equal to ``tests/golden_metrics.json``.
``--all`` runs every registered scenario, and writes only where ``--out``
points.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as ref
import repro.core.metrics as ref_metrics
import repro.launch.experiments as ref_experiments
import repro_torch.core as port
import repro_torch.core.metrics as port_metrics
from repro.analysis.tierace import canonical_records as ref_canonical
from repro_torch.analysis.tierace import canonical_records
from repro_torch.launch import experiments

REPO = Path(__file__).resolve().parents[1]
STRATEGIES = ("hrs", "bhr", "lru")


@contextlib.contextmanager
def recording(metrics_module):
    """Collect the result of every simulator ``run_experiment`` makes."""
    base = metrics_module.GridSimulator
    results = []

    class Recording(base):
        def run(self, *a, **kw):
            results.append(super().run(*a, **kw))
            return results[-1]

    metrics_module.GridSimulator = Recording
    try:
        yield results
    finally:
        metrics_module.GridSimulator = base


def _left_to_right_mean(records) -> float:
    total = 0.0
    for r in records:
        total += r.job_time
    return total / max(1, len(records))


def _both(axis, values, **replace):
    base_ref = dataclasses.replace(ref.SCENARIOS["paper_baseline"], **replace)
    base = dataclasses.replace(port.SCENARIOS["paper_baseline"], **replace)
    with recording(ref_metrics) as ref_sims:
        want = ref_experiments.sweep(base_ref, axis=axis, values=values,
                                     strategies=STRATEGIES)
    with recording(port_metrics) as sims:
        got = experiments.sweep(base, axis=axis, values=values,
                                strategies=STRATEGIES, device="cpu")
    return got, sims, want, ref_sims


@pytest.mark.parametrize("axis,values,replace", [
    ("n_jobs", (20, 45), {}),
    ("wan_mbps", (10.0, 1000.0), {"n_jobs": 30}),
], ids=["fig4_n_jobs", "fig7_wan_mbps"])
def test_sweep_cells_match_the_reference(axis, values, replace):
    got, sims, want, ref_sims = _both(axis, values, **replace)
    cells = [(v, s) for v in values for s in STRATEGIES]
    assert list(got) == list(want) == cells
    assert len(sims) == len(ref_sims) == len(cells)
    for (cell, r), sim, ref_sim in zip(got.items(), sims, ref_sims):
        w = want[cell]
        assert canonical_records(sim) == ref_canonical(ref_sim), cell
        assert r.avg_job_time == _left_to_right_mean(ref_sim.records), cell
        for m in ("avg_inter_comms", "makespan", "completed_jobs",
                  "total_wan_gb"):
            assert getattr(r, m) == getattr(w, m), (cell, m)


def test_sweep_fig4_cells_are_the_golden_cells():
    golden = json.loads((REPO / "tests" / "golden_metrics.json")
                        .read_text())["metrics"]
    cells = experiments.sweep(port.SCENARIOS["paper_baseline"],
                              axis="n_jobs", values=(100,),
                              strategies=STRATEGIES, device="cpu")
    for (n, s), r in cells.items():
        g = golden[f"fig4/{s}/{n}"]
        for m, v in g.items():
            assert getattr(r, m) == v, (s, m)
        assert r.completed_jobs == n


def test_sweep_rejects_unknown_axis_and_needs_a_card_by_default():
    base = port.SCENARIOS["paper_baseline"]
    with pytest.raises(ValueError, match="unknown sweep axis"):
        experiments.sweep(base, axis="nope", values=(1,),
                          strategies=("hrs",), device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            experiments.sweep(base, axis="n_jobs", values=(10,),
                              strategies=("hrs",))


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.experiments", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=600)


def test_all_runs_every_registered_scenario(tmp_path):
    """``--all --jobs 30 --device cpu --out PATH``: one row set per
    registered scenario (sweeps only by name), the file written where
    ``--out`` points and nothing under ``results/``."""
    results = {p: p.stat().st_mtime_ns for p in (REPO / "results").iterdir()}
    out = tmp_path / "all.json"
    proc = _cli("--all", "--jobs", "30", "--device", "cpu", "--out",
                str(out), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    payload = json.loads(out.read_text())
    assert sorted(payload["scenarios"]) == sorted(port.SCENARIOS)
    assert payload["sweeps"] == {}
    for name, entry in payload["scenarios"].items():
        rows = entry["rows"]
        assert len(rows) == len(port.SCENARIOS[name].seeds)
        assert all(r["n_jobs"] == 30 and r["completed_jobs"] == 30
                   and r["device"] == "cpu" for r in rows), name
    assert sorted(p.name for p in tmp_path.iterdir()) == ["all.json"]
    assert {p: p.stat().st_mtime_ns
            for p in (REPO / "results").iterdir()} == results


def test_all_is_exclusive_with_scenario_and_list(tmp_path):
    proc = _cli("--all", "--list", cwd=tmp_path)
    assert proc.returncode != 0 and "not allowed with" in proc.stderr
    proc = _cli("--all", "--scenario", "paper_baseline", cwd=tmp_path)
    assert proc.returncode != 0 and "not allowed with" in proc.stderr
