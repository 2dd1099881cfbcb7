"""The reference's remaining system tests, held on the port (the CPU
routes), each asserting what the reference's test asserts and, where it
is cheap, equality with the reference:

* ``test_system.py``: the headline reproduction at 300 jobs (hrs < bhr <
  lru on average job time, hrs below lru on inter-region communications,
  HRS's gain over BHR in the 5-60% band), each run equal to
  ``golden_metrics.json``'s ``fig4/*/300``; the data-aware scheduler
  beating the random one under HRS at 150 jobs, each run's job records
  equal to the reference's; greedy generation through ``ServeEngine``
  equal to the argmax of repeated full forwards (reduced granite-3-8b, on
  the port's seeded weights and on the reference's carried over); the
  ~100M example trainer (``repro_torch.examples.train_small_grid``)
  through a failure at step 2 of 3: one restart, from its step-0
  checkpoint.
* ``test_models_smoke.py``: one forward of every reduced config, shapes
  and finite values; every full config's published fields (and the
  reference's); the MoE configs; ``long_500k`` only for the
  sub-quadratic ones; the analytic parameter counts in their band and
  equal to the reference's.
* ``test_grid_runtime.py``: data-locality placement, work sent to the
  data, HRS crossing the WAN once, the loader deterministic; each run's
  site, transfers and totals equal to the reference's.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.core import GridConfig as JaxGridConfig
from repro.core import GridTopology as JaxTopology
from repro.core import metrics as ref_metrics
from repro.core import run_experiment as ref_run_experiment
from repro.data import pipeline as ref_pipeline
from repro.grid.datagrid import DataGridService as JaxGrid
from repro.models import model as JM
from repro_torch.configs import arch_ids, cells, get_config
from repro_torch.core import GridConfig, GridTopology, run_experiment
from repro_torch.core import metrics as port_metrics
from repro_torch.data import pipeline as port_pipeline
from repro_torch.examples import train_small_grid
from repro_torch.grid.datagrid import DataGridService
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine
from test_torch_plan import run_with_result

_HERE = os.path.dirname(__file__)
GOLDEN = json.load(open(os.path.join(_HERE, "golden_metrics.json")))["metrics"]
METRICS = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "makespan")
PACKAGES = {"port": (GridTopology, DataGridService, port_pipeline),
            "reference": (JaxTopology, JaxGrid, ref_pipeline)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ~100M model's steps on many threads, beside
    other test processes, oversubscribe the cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- test_system.py -----------------------------------------------------------

@pytest.fixture(scope="module")
def headline():
    # 300+ jobs: the strategies only diverge once SEs come under sustained
    # pressure
    return {s: run_experiment(GridConfig(), strategy=s, n_jobs=300,
                              device="cpu")
            for s in ("hrs", "bhr", "lru")}


def test_paper_headline_reproduction(headline):
    res = headline
    # orderings (Figs 4-6)
    assert res["hrs"].avg_job_time < res["bhr"].avg_job_time
    assert res["bhr"].avg_job_time < res["lru"].avg_job_time
    assert res["hrs"].avg_inter_comms < res["lru"].avg_inter_comms
    # magnitude: the paper reports "about 12%" HRS over BHR; a broad band
    gain = (res["bhr"].avg_job_time - res["hrs"].avg_job_time) \
        / res["bhr"].avg_job_time
    assert 0.05 < gain < 0.60


@pytest.mark.parametrize("strategy", ["hrs", "bhr", "lru"])
def test_paper_headline_runs_match_the_golden_file(headline, strategy):
    got, want = headline[strategy], GOLDEN[f"fig4/{strategy}/300"]
    for m in METRICS:
        assert getattr(got, m) == want[m], m
    assert got.completed_jobs == 300


@pytest.fixture(scope="module")
def schedulers():
    """(ExperimentResult, SimResult) of both packages under each
    scheduler, HRS, 150 jobs."""
    mp = pytest.MonkeyPatch()
    try:
        return {(pkg, sched): run_with_result(mp, metrics, lambda: run(
                    cfg(), scheduler=sched, strategy="hrs", n_jobs=150,
                    **kw))
                for pkg, metrics, run, cfg, kw in (
                    ("port", port_metrics, run_experiment, GridConfig,
                     {"device": "cpu"}),
                    ("reference", ref_metrics, ref_run_experiment,
                     JaxGridConfig, {}))
                for sched in ("dataaware", "random")}
    finally:
        mp.undo()


def test_scheduler_matters_with_fixed_replication(schedulers):
    data_aware = schedulers["port", "dataaware"][0]
    rand = schedulers["port", "random"][0]
    assert data_aware.avg_job_time < rand.avg_job_time


@pytest.mark.parametrize("scheduler", ["dataaware", "random"])
def test_scheduler_runs_match_reference(schedulers, scheduler):
    got, got_sim = schedulers["port", scheduler]
    want, want_sim = schedulers["reference", scheduler]
    assert [dataclasses.astuple(r) for r in got_sim.records] == \
        [dataclasses.astuple(r) for r in want_sim.records]
    for m in METRICS[1:]:
        assert getattr(got, m) == getattr(want, m), m
    assert got.completed_jobs == want.completed_jobs == 150


@pytest.mark.parametrize("weights", ["port", "reference"])
def test_serving_engine_matches_teacher_forced(weights):
    """Greedy generation against the argmax of repeated full forwards
    (``train_logits``), reduced granite-3-8b in bf16: the port's weights
    from seed 0, or the reference's from ``PRNGKey(0)`` carried over."""
    cfg = get_config("granite-3-8b").reduced()
    if weights == "port":
        params = M.init_params(cfg, seed=0, device="cpu")
    else:
        jp = JM.init_params(ref_configs.get_config("granite-3-8b").reduced(),
                            jax.random.PRNGKey(0))
        params = M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    eng = ServeEngine(cfg, params, max_len=48)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    out = eng.generate(prompt, n_new=4)
    assert out.shape == (2, 4)
    # oracle: greedy continuation via repeated full forward
    cur = prompt
    for t in range(4):
        logits = M.train_logits(cfg, params, {"tokens": torch.tensor(cur)})
        nxt = logits[:, -1].argmax(-1).numpy()[:, None]
        assert (nxt[:, 0] == out[:, t]).all(), f"mismatch at step {t}"
        cur = np.concatenate([cur, nxt], axis=1)


def test_train_small_grid_restarts_once(tmp_path, capsys):
    """The example trainer at its ~100M config, 3 steps of 2 x 32 tokens
    with a node failure at step 2: one restart from the step-0
    checkpoint, the reference's printed lines."""
    out = train_small_grid.main(["--steps", "3", "--batch", "2", "--seq", "32",
                                 "--fail-at", "2", "--ckpt-dir",
                                 str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert out["restarts"] == 1 and out["steps_wasted"] == 2
    assert len(out["history"]) == 5 and out["history"][-1]["step"] == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "restarts: 1, wasted steps: 2" in text
    assert text.startswith("model: gemma3-1b-100m ~92M params")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000000"]


# -- test_models_smoke.py -----------------------------------------------------

B, S = 2, 32
PUBLISHED = {
    "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155),
    "arctic-480b": (35, 7168, 56, 8, 4864, 32000),
    "zamba2-7b": (81, 3584, 32, 32, 14336, 32000),
    "qwen2-72b": (80, 8192, 64, 8, 29568, 152064),
    "gemma2-27b": (46, 4608, 32, 16, 36864, 256000),
    "gemma3-1b": (26, 1152, 4, 1, 6912, 262144),
    "granite-3-8b": (40, 4096, 32, 8, 12800, 49155),
    "whisper-large-v3": (32, 1280, 20, 20, 5120, 51866),
    "internvl2-2b": (24, 2048, 16, 8, 8192, 92553),
    "falcon-mamba-7b": (64, 4096, 1, 1, 0, 65024),
}
APPROX = {
    "qwen2-72b": 72e9, "gemma2-27b": 27e9, "granite-3-8b": 8e9,
    "falcon-mamba-7b": 7e9, "zamba2-7b": 7e9, "arctic-480b": 480e9,
    "gemma3-1b": 1e9, "granite-moe-1b-a400m": 1.3e9,
    "internvl2-2b": 1.9e9, "whisper-large-v3": 1.5e9,
}


def _batch(cfg):
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)))
    if cfg.enc_dec:
        return {"frames": torch.ones((B, S, cfg.d_model),
                                     dtype=torch.bfloat16),
                "tokens": tokens[:, :S // 8], "labels": tokens[:, :S // 8]}
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.ones((B, cfg.vision_tokens,
                                             cfg.d_model),
                                            dtype=torch.bfloat16)
    return batch


def test_registry_covers_the_reference():
    assert sorted(arch_ids()) == sorted(ref_configs.arch_ids()) \
        == sorted(PUBLISHED)


@pytest.mark.parametrize("arch", sorted(PUBLISHED))
def test_forward_shapes_and_finite(arch):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu", max_enc=S,
                           max_dec=S // 8)
    logits = M.train_logits(cfg, params, _batch(cfg))
    exp_s = S // 8 if cfg.enc_dec else S
    assert logits.shape == (B, exp_s, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", sorted(PUBLISHED))
def test_exact_published_config_fields(arch):
    """The full configs carry the assigned hyperparameters, the
    reference's."""
    fields = lambda c: (c.n_layers, c.d_model, c.n_heads,  # noqa: E731
                        c.n_kv_heads, c.d_ff, c.vocab)
    cfg = get_config(arch)
    assert fields(cfg) == PUBLISHED[arch] == fields(
        ref_configs.get_config(arch))
    # the layer pattern covers all layers
    assert cfg.n_groups * len(cfg.layer_pattern) \
        + len(cfg.remainder_pattern) == cfg.n_layers


def test_moe_configs():
    g = get_config("granite-moe-1b-a400m")
    assert g.moe.num_experts == 32 and g.moe.top_k == 8
    a = get_config("arctic-480b")
    assert a.moe.num_experts == 128 and a.moe.top_k == 2 \
        and a.moe.dense_residual


def test_long_500k_only_subquadratic():
    for arch in arch_ids():
        has_long = "long_500k" in cells(arch)
        assert has_long == (arch in ("zamba2-7b", "falcon-mamba-7b"))
        assert cells(arch) == ref_configs.cells(arch)


@pytest.mark.parametrize("arch", sorted(APPROX))
def test_param_counts_order_of_magnitude(arch):
    n = M.count_params_analytic(get_config(arch))
    target = APPROX[arch]
    assert 0.5 * target < n < 1.8 * target, (arch, n, target)
    assert n == JM.count_params_analytic(ref_configs.get_config(arch))


# -- test_grid_runtime.py -----------------------------------------------------

def _grid(pkg, storage=64e9):
    topo_cls, grid_cls, _ = PACKAGES[pkg]
    return grid_cls(topo_cls(2, 4, lan_bandwidth=50e9, wan_bandwidth=3e9,
                             storage_capacity=storage))


def _transfers(stats) -> list:
    return [(t.lfn, t.src, t.dst, t.bytes, t.inter_region, t.stored)
            for t in stats]


def _locality(pkg):
    grid = _grid(pkg)
    grid.register("a", 4e9, master_site=3)
    grid.register("b", 1e9, master_site=6)
    site, stats = grid.place_job(["a", "b"])
    return site, _transfers(stats), _transfers(grid.transfers)


def _to_data(pkg):
    grid = _grid(pkg)
    grid.register("hot", 2e9, master_site=7)
    site, stats = grid.place_job(["hot"])
    return site, _transfers(stats), grid.inter_comm_count()


def _reuse(pkg):
    grid = _grid(pkg)
    grid.register("hot", 2e9, master_site=7)      # region 1
    for dst in (0, 1, 2):                          # region-0 consumers
        grid.ensure_local(["hot"], dst)
    return (grid.inter_comm_count(), grid.wan_bytes(), grid.lan_bytes(),
            _transfers(grid.transfers))


def _loader(pkg):
    _, _, pipeline = PACKAGES[pkg]

    def batch():
        ds = pipeline.SyntheticShardedDataset(pipeline.DataConfig(
            vocab=100, seq_len=16, global_batch=4, n_shards=8))
        return pipeline.GridDataLoader(ds, _grid(pkg, 512e9)).next_batch()

    (b1, s1), (b2, s2) = batch(), batch()
    return b1, b2, s1["site"], s2["site"], _transfers(s1["transfers"])


def test_place_job_prefers_data_locality():
    site, stats, _ = _locality("port")
    assert site == 3                      # most required bytes
    assert len(stats) == 1 and stats[0][0] == "b"


def test_scheduler_sends_job_to_data_not_data_to_job():
    """With a free choice the broker sends work where the data is: zero
    transfers for a sole-replica artifact (the paper's core effect)."""
    site, stats, inter = _to_data("port")
    assert site == 7 and stats == [] and inter == 0


def test_hrs_replication_cuts_wan_traffic_on_reuse():
    """Consumers pinned in the other region: HRS crosses the WAN once,
    then serves every later consumer intra-region."""
    inter, wan, lan, _ = _reuse("port")
    assert inter == 1                              # only the first fetch
    assert wan == 2e9
    assert lan == 4e9                              # two intra-region copies


def test_loader_deterministic_and_local():
    b1, b2, _, _, _ = _loader("port")
    assert (b1["tokens"] == b2["tokens"]).all()
    assert b1["tokens"].shape == (4, 16)
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()


@pytest.mark.parametrize("run", [_locality, _to_data, _reuse, _loader],
                         ids=lambda f: f.__name__.strip("_"))
def test_grid_runtime_matches_reference(run):
    got, want = run("port"), run("reference")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, dict):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            assert g == w
