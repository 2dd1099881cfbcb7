"""The port's conservation auditor (``repro_torch.analysis.conserve``).

The port's counterparts of ``tests/test_conserve.py`` on the port's
``numpy`` and ``device`` routes (``device="cpu"``: the kernels' plain
versions), and each report held against ``repro.analysis.conserve``'s on
the runs the reference makes here: the same check names, the same ``ok``
and the same ``lhs`` / ``rhs``.
"""

import json

import pytest

import repro.analysis.conserve as ref_conserve
from repro_torch.analysis.conserve import (REL_TOL, _close,
                                           conservation_audit,
                                           run_conservation_smoke)

CORE_INVARIANTS = {"I1_byte_ledger", "I3_site_occupancy",
                   "I4_aggregate_replicas", "I5_drained",
                   "I6_prefetch_ledger"}


def assert_all_ok(report):
    bad = {n: c for n, c in report["checks"].items() if not c["ok"]}
    assert report["ok"] and not bad, bad


def test_paper_baseline_ledgers_close_numpy():
    report = conservation_audit("paper_baseline", n_jobs=40, net="numpy",
                                device="cpu")
    assert_all_ok(report)
    assert CORE_INVARIANTS <= set(report["checks"])
    assert report["failure_free"]
    assert "I2_inter_comms" in report["checks"]
    assert "I7_completion" in report["checks"]
    assert report["checks"]["I1_byte_ledger"]["lhs"] > 0


def test_paper_baseline_ledgers_close_device_engine():
    report = conservation_audit("paper_baseline", n_jobs=40, net="device",
                                device="cpu")
    assert_all_ok(report)
    assert report["checks"]["I1_byte_ledger"]["lhs"] > 0


def test_grid_500_smoke_ledgers_close():
    report = conservation_audit("grid_500", n_jobs=40, net="numpy",
                                device="cpu")
    assert_all_ok(report)
    assert report["n_jobs"] == 40


def test_economy_prefetch_ledger_closes_and_is_live():
    report = conservation_audit("economy_starved", n_jobs=60, net="numpy",
                                device="cpu")
    assert_all_ok(report)
    debits, counted, started = report["checks"]["I6_prefetch_ledger"]["lhs"]
    proposed = report["checks"]["I6_prefetch_ledger"]["rhs"]
    assert debits == counted == started > 0
    assert started <= proposed


def test_churn_run_skips_the_strict_counters():
    report = conservation_audit("site_churn", n_jobs=100, net="numpy",
                                device="cpu")
    assert_all_ok(report)
    assert not report["failure_free"]
    assert "I2_inter_comms" not in report["checks"]
    assert "I7_completion" not in report["checks"]


def test_smoke_runner_covers_baseline_and_economy():
    reports = run_conservation_smoke(n_jobs=40, device="cpu")
    assert [r["scenario"] for r in reports] == ["paper_baseline",
                                                "economy_starved"]
    for report in reports:
        assert_all_ok(report)
        json.dumps(report)


def test_close_tolerance_is_tight():
    assert _close(353_500_000_000.0, 353_500_000_000.0)
    assert not _close(353_500_000_000.0, 353_500_000_001.0 * (1 + 1e-6))
    assert not _close(1.0, 2.0)
    assert REL_TOL <= 1e-9 and REL_TOL == ref_conserve.REL_TOL


@pytest.mark.parametrize("scenario,net,n_jobs", [
    ("paper_baseline", "numpy", 40),
    ("paper_baseline", "device", 40),
    ("economy_starved", "numpy", 60),
    ("site_churn", "numpy", 100),
    ("deep_contended", "numpy", 40),
])
def test_reports_match_reference(scenario, net, n_jobs):
    got = conservation_audit(scenario, n_jobs=n_jobs, net=net, device="cpu")
    want = ref_conserve.conservation_audit(scenario, n_jobs=n_jobs, net=net)
    assert got == want


def test_audit_needs_a_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        conservation_audit("paper_baseline", n_jobs=2)
