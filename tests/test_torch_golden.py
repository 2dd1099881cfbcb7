"""The port's simulator (``device="cpu"``) against the golden files.

The incremental engines (``net="numpy"`` and ``net="pallas"``, one route in
the port) reproduce ``golden_metrics.json`` and ``golden_deep.json`` bit for
bit — the same cells ``tests/test_golden_metrics.py`` pins for the
reference. ``avg_job_time`` sums job times left to right, the order the
golden files were pinned with.
"""

import json
import os

import pytest

from repro_torch.core import SCENARIOS, GridConfig, run_experiment
from repro_torch.launch.experiments import run_spec

_HERE = os.path.dirname(__file__)
GOLDEN = json.load(open(os.path.join(_HERE, "golden_metrics.json")))["metrics"]
GOLDEN_DEEP = json.load(open(os.path.join(_HERE, "golden_deep.json")))

FAST_CELLS = ["fig4/hrs/100", "fig4/bhr/100", "fig4/lru/100",
              "fig4/hrs/300", "fig4/bhr/300", "fig4/lru/300"]
METRICS = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "makespan")


def _check(key: str, net: str) -> None:
    _, strategy, n = key.split("/")
    n = int(n)
    cfg = GridConfig(n_jobs=n) if key.startswith("fig5") else GridConfig()
    r = run_experiment(cfg, strategy=strategy, n_jobs=n, net=net,
                       device="cpu")
    g = GOLDEN[key]
    for m in METRICS:
        assert getattr(r, m) == g[m], (key, net, m)
    assert r.completed_jobs == n, key


@pytest.mark.parametrize("key", FAST_CELLS)
def test_golden_fig4_subset(key):
    _check(key, "numpy")


@pytest.mark.parametrize("key", FAST_CELLS[:3])
def test_golden_pallas_backend(key):
    _check(key, "pallas")


def test_golden_topmost_matches_on_two_level_grid():
    """On the paper's two-level grid the legacy topmost-uplink model is
    the same path model: same golden floats."""
    _check("fig4/hrs/100", "topmost")


def test_golden_deep_tree_cell():
    g = GOLDEN_DEEP["metrics"]
    r = run_spec(SCENARIOS[GOLDEN_DEEP["scenario"]],
                 n_jobs=GOLDEN_DEEP["n_jobs"], device="cpu")
    for m in METRICS + ("completed_jobs",):
        assert getattr(r, m) == g[m], m
