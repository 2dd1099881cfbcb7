"""``chip_smoke.py``'s pinned reference metrics and its CPU-side pieces.

``chip_smoke.py`` runs on a machine without JAX, so it cannot run the
reference: it holds the reference's metrics of its scenario paths as
constants (``REFERENCE``). They come from this module, run on a machine
with JAX:

    PYTHONPATH=src python tests/test_torch_smoke.py

which prints them as JSON. The tests below re-derive the paths that run
in seconds (``bulk_shortest``, ``economy_starved``, ``hotset_drift``,
``site_churn``) and hold the constants to them exactly; ``grid_500_evict`` at 2,000 jobs
takes about a minute on the CPU and is re-derived only by the command.
``avg_job_time`` is the left-to-right mean of the reference's job records
(the port's summation; the reference's own ``sum()`` is compensated on
Python 3.12).
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_metrics(name: str) -> dict:
    """The four metrics of one of ``chip_smoke.py``'s scenario paths
    (``chip_smoke.PATHS``), run by the reference package on the CPU."""
    import repro.core as ref
    import repro.core.metrics as ref_metrics

    scenario, replace, n_jobs = _chip_smoke().PATHS[name]
    spec = dataclasses.replace(ref.SCENARIOS[scenario], **replace)
    base = ref_metrics.GridSimulator
    sims = []

    class Recording(base):
        def run(self, *a, **kw):
            sims.append(super().run(*a, **kw))
            return sims[-1]

    from repro.launch.experiments import run_spec
    ref_metrics.GridSimulator = Recording
    try:
        r = run_spec(spec, n_jobs=n_jobs)
    finally:
        ref_metrics.GridSimulator = base
    total = 0.0
    for rec in sims[0].records:
        total += rec.job_time
    return {"avg_job_time": total / max(1, len(sims[0].records)),
            "makespan": r.makespan, "avg_inter_comms": r.avg_inter_comms,
            "completed_jobs": r.completed_jobs}


@pytest.mark.parametrize("name", ["bulk_shortest", "economy_starved",
                                  "hotset_drift", "site_churn"])
def test_pinned_reference_metrics(name):
    assert _chip_smoke().REFERENCE[name] == reference_metrics(name)


def test_pinned_paths_cover_the_new_kernels():
    smoke = _chip_smoke()
    assert sorted(smoke.PATHS) == sorted(smoke.REFERENCE)
    assert sorted(k for ks in smoke.PATH_KERNELS.values() for k in ks) == \
        sorted(["net_rerate", "st_cost", "strategy_plan", "value_score",
                "value_score", "net_rerate"])


@pytest.mark.parametrize("S,bound_us,term", [(1024, 128.4, "exponentials"),
                                              (1, 1.536, "bytes")])
def test_scan_bound(S, bound_us, term):
    """Phase 8's bound of the scan at falcon-mamba-7b's shapes (Bz 4,
    Di 8,192, N 16): prefill is set by its 536,870,912 exponentials at the
    special-function rate (its bytes take 121.8 us), decode by its bytes."""
    smoke = _chip_smoke()
    bytes_, flops, exps = smoke.scan_work(4, S, 8192, 16)
    ms, by = smoke.roofline(bytes_, flops, smoke.FP32_FLOPS, exps)
    assert by == term
    assert round(1e3 * ms, 1 if S > 1 else 3) == bound_us
    if S > 1:
        assert round(1e6 * bytes_ / smoke.HBM_BYTES_PER_S, 1) == 121.8


def test_cold_decode_cycles_beyond_l2():
    """The cold decode timing's input and output sets, one per layer, do
    not fit in the L2 together."""
    smoke = _chip_smoke()
    per_layer = smoke.scan_work(smoke.MAMBA_BZ, 1, smoke.MAMBA_DI,
                                smoke.MAMBA_N)[0]
    assert smoke.MAMBA_LAYERS * per_layer > 4 * smoke.L2_BYTES


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a card, and alone in a directory, the script exits
    non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(_ROOT,
                                                       "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(_ROOT, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


if __name__ == "__main__":
    print(json.dumps({name: reference_metrics(name)
                      for name in _chip_smoke().PATHS}, indent=1))
