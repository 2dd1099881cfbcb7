"""The port's telemetry (``repro_torch.obs``) against ``repro.obs``.

The port's counterparts of ``tests/test_obs.py`` on the port's ``numpy``
and ``device`` routes (``device="cpu"``: the kernels' plain versions),
then the same runs held against the reference: the counters and span
activation counts, every ``GridSampler`` channel row and the Chrome
trace's sim-time events equal ``repro``'s, and the golden cells stay
bit-exact with telemetry forced on through ``REPRO_OBS``.
"""

import copy
import json

import numpy as np
import pytest

import repro.core as ref
from repro_torch.core import (GridConfig, OBS_MODES, ScenarioSpec,
                              get_scenario, run_experiment)
from repro_torch.core.simulator import GridSimulator
from repro_torch.launch.experiments import run_scenario, run_spec
from repro_torch.obs import (CHANNELS, DEFAULT_OBS_INTERVAL_S, GridSampler,
                             Probe, RingBuffer, TraceWriter, make_probe)

from test_torch_golden import GOLDEN, METRICS as GOLDEN_METRICS

METRICS = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "total_lan_gb",
           "makespan", "completed_jobs")


def _metrics(r) -> tuple:
    return tuple(getattr(r, m) for m in METRICS)


def _run(cfg=None, **kw):
    return run_experiment(cfg or GridConfig(), device="cpu", **kw)


# -- probe unit behaviour ---------------------------------------------------

def test_span_exclusive_accounting_partitions_wall():
    p = Probe("report")
    with p.span("outer"):
        for _ in range(3):
            with p.span("inner"):
                sum(range(2000))
    assert p.phase_calls == {"outer": 1, "inner": 3}
    assert p.phase_total_s["outer"] >= p.phase_total_s["inner"]
    assert p.phase_self_s["outer"] == pytest.approx(
        p.phase_total_s["outer"] - p.phase_total_s["inner"])
    report = p.finalize()
    assert sum(report.phase_self_s.values()) <= report.wall_s


def test_probe_counters_and_merge():
    p = Probe("report")
    p.count("a")
    p.count("a", 2)
    p.event("SUBMIT", 1.0)
    p.merge_counters("net", {"x": 2, "y": 3.0})
    assert p.counters == {"a": 3, "event.SUBMIT": 1, "net.x": 2, "net.y": 3}
    assert isinstance(p.counters["net.y"], int)


def test_probe_syncs_the_device_around_spans():
    """A probe made for a CUDA simulator waits for the card as each span
    opens and closes and before the wall clock is stamped; a probe
    without ``sync`` (the CPU) and obs off never call it."""
    calls = []
    p = make_probe("report", sync=lambda: calls.append(len(p._stack)))
    with p.span("outer"):
        with p.span("inner"):
            pass
    assert calls == [0, 1, 2, 1]        # enter outer, enter inner, exits
    p.finalize()
    assert len(calls) == 5
    assert make_probe("off", sync=lambda: calls.append(None)) is None
    assert make_probe("report").sync is None
    assert len(calls) == 5


def test_make_probe_modes():
    assert make_probe("off") is None
    assert make_probe("report").sampler is None
    assert make_probe("series").sampler is not None
    assert make_probe("series").trace is None
    tr = make_probe("trace")
    assert tr.sampler is not None and tr.trace is not None
    with pytest.raises(ValueError, match="unknown obs mode"):
        make_probe("verbose")


def test_deepcopy_drops_probe():
    assert copy.deepcopy(Probe("report")) is None


def test_phase_breakdown_partitions_wall():
    p = Probe("report")
    with p.span("broker.dispatch"):
        pass
    bd = p.finalize().phase_breakdown(wall_s=2.0)
    assert set(bd) == {"dispatch_s", "strategy_plan_s", "flush_s", "other_s"}
    assert sum(bd.values()) == pytest.approx(2.0, abs=1e-5)


# -- ring-buffer series -----------------------------------------------------

def test_ring_buffer_wraps_chronologically():
    rb = RingBuffer(4, ("t", "v"))
    for i in range(7):
        rb.append((float(i), float(10 * i)))
    assert rb.n_total == 7 and len(rb) == 4
    assert rb.rows()[:, 0].tolist() == [3.0, 4.0, 5.0, 6.0]
    assert rb.arrays()["v"].tolist() == [30.0, 40.0, 50.0, 60.0]


@pytest.mark.parametrize("net", ["numpy", "device"])
def test_series_channels_from_live_run(net):
    r = _run(n_jobs=60, obs="series", net=net)
    series = r.telemetry.series
    assert set(series) == set(CHANNELS)
    t = series["t"]
    assert r.telemetry.n_samples == len(t) > 1
    assert np.all(np.diff(t) > 0)
    for ch in ("wan_bytes", "accesses", "completed_jobs"):
        assert np.all(np.diff(series[ch]) >= 0), ch
    assert series["completed_jobs"][-1] <= r.completed_jobs
    assert np.all(series["se_used_frac"] >= 0.0)
    assert np.all(series["se_used_frac"] <= 1.0)


# -- trace export -----------------------------------------------------------

def test_trace_round_trip_and_nesting(tmp_path):
    r = _run(n_jobs=60, obs="trace")
    tel = r.telemetry
    path = tmp_path / "run.trace.json"
    tel.save_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X"),
                   key=lambda e: (e["ts"], -e["dur"]))
    assert spans, "no host-phase spans exported"
    stack = []
    for e in spans:
        while stack and e["ts"] >= stack[-1]:
            stack.pop()
        if stack:                      # strictly nested, never straddling
            assert e["ts"] + e["dur"] <= stack[-1]
        stack.append(e["ts"] + e["dur"])
    instants = [e for e in events if e.get("ph") == "i"]
    n_events = sum(v for k, v in tel.counters.items()
                   if k.startswith("event."))
    assert len(instants) == n_events
    jl = tmp_path / "run.events.jsonl"
    tel.save_events_jsonl(str(jl))
    lines = [json.loads(l) for l in jl.read_text().splitlines()]
    assert len(lines) == len(tel.trace)
    assert all(e["ph"] != "M" for e in lines)


def test_trace_writer_caps_events():
    tw = TraceWriter(max_events=3)
    for i in range(5):
        tw.add_instant("E", float(i))
    assert len(tw) == 3 and tw.dropped == 2
    assert tw.to_dict()["otherData"]["dropped_events"] == 2


# -- observation-only: metrics unchanged under every obs mode ---------------

@pytest.mark.parametrize("net", ["numpy", "device"])
@pytest.mark.parametrize("mode", ["report", "series", "trace"])
def test_obs_modes_bit_identical(mode, net):
    base = _metrics(_run(n_jobs=60, net=net))
    assert _metrics(_run(n_jobs=60, net=net, obs=mode)) == base


def _chip_smoke_paths() -> dict:
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.PATHS


@pytest.mark.parametrize("name", ["grid_500_evict", "bulk_shortest",
                                  "economy_starved", "hotset_drift",
                                  "site_churn"])
def test_chip_smoke_paths_bit_identical_under_trace(name):
    """``chip_smoke.py``'s scenario paths (the batched planner, the
    shortest-transfer broker, the economy, churn), cut to 40 jobs."""
    import dataclasses

    scenario, replace, _ = _chip_smoke_paths()[name]
    spec = dataclasses.replace(get_scenario(scenario), **replace)
    base = run_spec(spec, n_jobs=40, device="cpu")
    traced = run_spec(dataclasses.replace(spec, obs="trace"), n_jobs=40,
                      device="cpu")
    assert traced.telemetry.counters["event.CPU_DONE"] >= 40
    assert _metrics(traced) == _metrics(base)
    assert traced.net_stats == base.net_stats


@pytest.mark.parametrize("key", ["fig4/hrs/100", "fig4/bhr/100",
                                 "fig4/lru/100"])
def test_golden_cells_under_repro_obs_trace(key, monkeypatch):
    """The golden cells stay bit-exact with telemetry forced on."""
    monkeypatch.setenv("REPRO_OBS", "trace")
    _, strategy, n = key.split("/")
    r = _run(strategy=strategy, n_jobs=int(n))
    assert r.telemetry is not None and r.telemetry.mode == "trace"
    for m in GOLDEN_METRICS:
        assert getattr(r, m) == GOLDEN[key][m], (key, m)


def test_repro_obs_env_override(monkeypatch):
    base = _run(n_jobs=40)
    assert base.telemetry is None
    monkeypatch.setenv("REPRO_OBS", "trace")
    forced = _run(n_jobs=40)
    assert forced.telemetry is not None and forced.telemetry.mode == "trace"
    assert _metrics(forced) == _metrics(base)
    monkeypatch.setenv("REPRO_OBS", "loud")
    with pytest.raises(ValueError, match="obs mode"):
        _run(n_jobs=10)


def test_obs_events_do_not_change_sim_clock_semantics():
    base = _run(n_jobs=60)
    fine = _run(n_jobs=60, obs="series", obs_interval=50.0)
    assert fine.makespan == base.makespan
    assert fine.telemetry.n_samples > 100


# -- counter/event-stream consistency ---------------------------------------

def _check_counter_invariants(seed: int, net: str = "numpy") -> None:
    cfg = GridConfig(seed=seed, n_regions=2, sites_per_region=3)
    r = _run(cfg, n_jobs=80, obs="series", net=net)
    tel = r.telemetry
    c, calls = tel.counters, tel.phase_calls
    assert c["event.SUBMIT"] + c.get("event.FLUSH", 0) == \
        calls["broker.dispatch"]
    assert c["event.CPU_DONE"] == calls["cpu.done"] == r.completed_jobs == 80
    assert c.get("event.NET", 0) == calls.get("net.events", 0)
    assert tel.n_samples == c.get("event.OBS", 0) + 1
    assert sum(tel.phase_self_s.values()) <= tel.wall_s + 1e-9
    for name, total in tel.phase_total_s.items():
        assert tel.phase_self_s[name] <= total + 1e-12, name
    if net == "device":
        assert calls["net.flush"] == c["net.flush_passes"]


@pytest.mark.parametrize("seed,net", [(0, "numpy"), (3, "numpy"),
                                      (11, "device")])
def test_counter_invariants_seeded(seed, net):
    _check_counter_invariants(seed, net)


def test_counter_invariants_property():
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=2, deadline=None)
    @hypothesis.given(seed=st.integers(0, 2**32 - 1))
    def probe(seed):
        _check_counter_invariants(seed)

    probe()


# -- held against repro -----------------------------------------------------

def _both(obs: str, net: str, n_jobs: int = 60, strategy: str = "hrs"):
    kw = dict(strategy=strategy, n_jobs=n_jobs, obs=obs, net=net)
    return (_run(**kw).telemetry,
            ref.run_experiment(ref.GridConfig(), **kw).telemetry)


@pytest.mark.parametrize("net,strategy", [("numpy", "hrs"),
                                          ("device", "hrs"),
                                          ("numpy", "lru")])
def test_counters_and_span_counts_match_reference(net, strategy):
    got, want = _both("report", net, strategy=strategy)
    assert got.counters == want.counters
    assert got.phase_calls == want.phase_calls
    assert got.net_stats == want.net_stats


@pytest.mark.parametrize("net", ["numpy", "device"])
def test_series_rows_match_reference(net):
    got, want = _both("series", net)
    assert got.n_samples == want.n_samples
    assert sorted(got.series) == sorted(want.series) == sorted(CHANNELS)
    for ch in CHANNELS:
        assert np.array_equal(got.series[ch], want.series[ch]), ch


def test_trace_sim_events_match_reference():
    got, want = _both("trace", "numpy")

    def sim_track(tel):
        return [(e["name"], e["ts"]) for e in tel.trace.events
                if e["ph"] == "i"]

    def span_names(tel):
        return sorted(e["name"] for e in tel.trace.events if e["ph"] == "X")

    assert sim_track(got) == sim_track(want)
    assert span_names(got) == span_names(want)
    assert got.dropped_trace_events == want.dropped_trace_events == 0


def test_economy_counters_match_reference():
    kw = dict(strategy="economic", n_jobs=60, econ_interval=500.0,
              obs="report")
    got = _run(**kw).telemetry
    want = ref.run_experiment(ref.GridConfig(), **kw).telemetry
    assert got.counters["econ.rounds"] > 0
    assert got.counters == want.counters
    assert got.phase_calls == want.phase_calls


# -- result-surface plumbing ------------------------------------------------

def test_prefetch_ledger_surfaces():
    r = run_spec(get_scenario("paper_baseline"), n_jobs=50, device="cpu")
    assert r.prefetches == 0 and r.prefetch_gb == 0.0
    econ = _run(strategy="economic", n_jobs=60, econ_interval=500.0)
    assert econ.prefetches > 0 and econ.prefetch_gb > 0.0


def test_run_scenario_rows_carry_phases(tmp_path):
    spec = ScenarioSpec(name="obs_smoke", description="x",
                        tier_fanouts=(2, 3), n_jobs=60, seeds=(0,),
                        obs="trace")
    row = run_scenario(spec, obs_dir=str(tmp_path), device="cpu")[0]
    assert set(row["phases"]) == {"dispatch_s", "strategy_plan_s",
                                  "flush_s", "other_s"}
    assert sum(row["phases"].values()) == pytest.approx(
        row["wall_s"], abs=0.1 * max(row["wall_s"], 0.01))
    assert row["counters"]["event.SUBMIT"] == 60
    assert (tmp_path / "obs_smoke_s0.telemetry.json").exists()
    assert (tmp_path / "obs_smoke_s0.trace.json").exists()
    assert (tmp_path / "obs_smoke_s0.events.jsonl").exists()


def test_experiments_cli_obs_flag(tmp_path):
    from repro_torch.launch import experiments

    out = tmp_path / "rows.json"
    experiments.main(["--scenario", "paper_baseline", "--jobs", "20",
                      "--device", "cpu", "--obs", "report", "--out",
                      str(out)])
    row = json.load(open(out))["scenarios"]["paper_baseline"]["rows"][0]
    assert row["counters"]["event.CPU_DONE"] == 20
    assert sum(row["phases"].values()) == pytest.approx(row["wall_s"],
                                                        abs=1e-5)


def test_scenario_spec_obs_round_trip():
    spec = ScenarioSpec(name="x", description="x", obs="series",
                        obs_interval_s=120.0)
    clone = ScenarioSpec.from_dict(spec.to_dict())
    assert clone.obs == "series" and clone.obs_interval_s == 120.0
    with pytest.raises(ValueError, match="obs"):
        ScenarioSpec(name="x", description="x", obs="loud")


def test_simulator_rejects_bad_obs_args():
    from repro_torch.core.workload import build_catalog, build_topology
    cfg = GridConfig()
    topo = build_topology(cfg)
    with pytest.raises(ValueError, match="obs mode"):
        GridSimulator(topo, build_catalog(cfg, topo), obs="loud",
                      device="cpu")


def test_default_interval_exported():
    assert DEFAULT_OBS_INTERVAL_S == 300.0
    assert OBS_MODES == ("off", "report", "series", "trace")
    assert GridSampler().ring.capacity == 8192
