"""The port's four examples (``repro_torch.examples``) on the CPU against
the reference's (``examples/*.py``) and its golden file.

* ``quickstart``: hrs, bhr and lru at 500 jobs bit-equal to
  ``golden_metrics.json``'s ``fig4/*/500``; ``noreplication`` equal to the
  reference's ``run_experiment`` (``avg_job_time`` against the
  left-to-right mean of its records: Python 3.12's ``sum()`` is
  compensated); the gain line's value.
* ``elastic_failover --reduced``: the healthy and the failed
  discrete-event runs equal to the reference's, restore sources ``{5}``,
  a bit-exact restore.
* ``serve_grid --reduced`` with the weights of the reference example
  (``init_params(PRNGKey(0))``) carried by ``params_from_jax``: each
  request's site, pod and tokens and the grid's totals equal to what the
  reference example prints; ``main`` prints the same routing.
* ``train_small_grid``: the ~100M config equal to the reference
  example's ``make_100m_config()`` field for field, its analytic count
  equal; a 2-layer cut (one ``attn_local``, one ``attn``, d 640, hd 80,
  vocab 32,000, batch 2 x 32 in 2 microbatches): the loss and every
  gradient leaf against ``jax.value_and_grad`` at ``test_torch_train``'s
  tolerances (its three steps with a failure at step 2, one restart, are
  in ``test_torch_system.py``, which keeps this file inside its time);
* each example raises without a card unless given ``--device cpu``.
"""

import dataclasses
import json
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import GridConfig as JaxGridConfig
from repro.core import metrics as ref_metrics
from repro.core import run_experiment as ref_run_experiment
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.examples import (elastic_failover, quickstart, serve_grid,
                                  train_small_grid)
from repro_torch.models import model as M
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import TrainConfig, grad_fn
from test_torch_plan import mean_left_to_right, run_with_result
from test_torch_train import TOL, _close, _pairs

_HERE = os.path.dirname(__file__)
_EXAMPLES = os.path.join(_HERE, os.pardir, "examples")
GOLDEN = json.load(open(os.path.join(_HERE, "golden_metrics.json")))["metrics"]
METRICS = ("avg_job_time", "avg_inter_comms", "total_wan_gb", "makespan")
EXAMPLES = (quickstart, elastic_failover, serve_grid, train_small_grid)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ~100M model's steps on many threads, beside
    other test processes, oversubscribe the cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference_example(name: str) -> dict:
    """The namespace of the reference's ``examples/<name>.py``."""
    return runpy.run_path(os.path.join(_EXAMPLES, f"{name}.py"),
                          run_name=f"reference_{name}")


def _assert_same_run(got: dict, monkeypatch, **kw) -> None:
    """``got`` (an example's metrics of one run) equal to the reference's
    ``run_experiment(**kw)``, ``avg_job_time`` to the left-to-right mean
    of its records."""
    want, sim = run_with_result(monkeypatch, ref_metrics,
                                lambda: ref_run_experiment(JaxGridConfig(),
                                                           **kw))
    assert got["avg_job_time"] == mean_left_to_right(sim.records)
    for m in METRICS[1:]:
        assert got[m] == getattr(want, m), m
    assert got["completed_jobs"] == want.completed_jobs == want.n_jobs


# -- quickstart ---------------------------------------------------------------

@pytest.fixture(scope="module")
def quick():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = quickstart.main(["--device", "cpu"])
    return result, out.getvalue()


@pytest.mark.parametrize("strategy", ["hrs", "bhr", "lru"])
def test_quickstart_matches_the_golden_file(quick, strategy):
    result, _ = quick
    got = result["results"][strategy]
    want = GOLDEN[f"fig4/{strategy}/500"]
    for m in METRICS:
        assert got[m] == want[m], m
    assert got["completed_jobs"] == result["n_jobs"] == 500


def test_quickstart_noreplication_matches_reference(quick, monkeypatch):
    _assert_same_run(quick[0]["results"]["noreplication"], monkeypatch,
                     strategy="noreplication")


def test_quickstart_prints_the_table_and_the_gain(quick):
    result, text = quick
    hrs = GOLDEN["fig4/hrs/500"]["avg_job_time"]
    bhr = GOLDEN["fig4/bhr/500"]["avg_job_time"]
    assert result["hrs_over_bhr_pct"] == 100 * (bhr - hrs) / bhr
    assert f"HRS over BHR: {100 * (bhr - hrs) / bhr:.1f}% faster" in text
    rows = {line.split()[0]: line.split()[1:] for line in text.splitlines()
            if line.split() and line.split()[0] in quickstart.STRATEGIES}
    for s, r in result["results"].items():
        assert rows[s] == [f"{r['avg_job_time']:.0f}s",
                           f"{r['avg_inter_comms']:.2f}",
                           f"{r['total_wan_gb']:.1f}"]


# -- elastic_failover ---------------------------------------------------------

@pytest.fixture(scope="module")
def elastic():
    return elastic_failover.main(["--reduced", "--device", "cpu"])


@pytest.mark.parametrize("run,failures", [("healthy", None),
                                          ("with_failures",
                                           elastic_failover.FAILURES)])
def test_elastic_failover_des_matches_reference(elastic, monkeypatch, run,
                                                failures):
    kw = {} if failures is None else {"failures": list(failures)}
    _assert_same_run(elastic["des"][run], monkeypatch, strategy="hrs",
                     n_jobs=elastic_failover.N_JOBS, **kw)


def test_elastic_failover_restores_from_the_pod_replica(elastic):
    assert elastic["restore_sources"] == [5]
    assert elastic["arch"] == "gemma3-1b" and elastic["layers"] == \
        jax_config("gemma3-1b").reduced().n_layers
    assert elastic["bit_exact"] and elastic["leaves"] > 0


# -- serve_grid ---------------------------------------------------------------

def _table(text: str) -> list:
    """(request, prefix, site, pod, tokens) rows and the inter-pod line of
    a serve_grid run's output."""
    rows, tail = [], None
    for line in text.splitlines():
        parts = line.split(maxsplit=4)
        if len(parts) == 5 and parts[0].isdigit():
            rows.append((int(parts[0]), parts[1], int(parts[2]),
                         int(parts[3]), json.loads(parts[4])))
        elif line.startswith("inter-pod transfers"):
            tail = line
    return rows, tail


@pytest.fixture(scope="module")
def served_reference():
    """What the reference example prints, and its config and weights."""
    import contextlib
    import io

    ns = _reference_example("serve_grid")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ns["main"]()
    jcfg = jax_config("granite-3-8b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return _table(out.getvalue()), jp


def test_serve_grid_matches_reference_example(served_reference):
    (rows, tail), jp = served_reference
    cfg = get_config(serve_grid.ARCH).reduced()
    params = M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    got = serve_grid.serve_requests(cfg, params)
    assert len(rows) == len(got["requests"]) == serve_grid.N_REQUESTS
    for want, r in zip(rows, got["requests"]):
        assert (r["request"], r["prefix"], r["site"], r["pod"],
                r["tokens"]) == want
    assert got["logits"].shape == (serve_grid.N_REQUESTS,
                                   serve_grid.NEW_TOKENS, cfg.vocab)
    assert tail == (f"inter-pod transfers: {got['inter_comms']} (WAN "
                    f"{got['wan_bytes']/1e9:.1f} GB) — prefix locality "
                    "keeps requests in the pod that owns their KV block")


def test_serve_grid_main_routes_as_the_reference(served_reference, capsys):
    """The CLI on the port's own weights: the reference's sites and pods
    (routing reads only the prefix and the prompt length) and totals."""
    (rows, tail), _ = served_reference
    got = serve_grid.main(["--reduced", "--device", "cpu"])
    printed, printed_tail = _table(capsys.readouterr().out)
    assert [r[:4] for r in printed] == [r[:4] for r in rows]
    assert [r["site"] for r in got["requests"]] == [r[2] for r in rows]
    assert printed_tail == tail


# -- train_small_grid ---------------------------------------------------------

@pytest.fixture(scope="module")
def reference_100m():
    return _reference_example("train_small_grid")["make_100m_config"]()


def test_100m_config_matches_reference(reference_100m):
    cfg = train_small_grid.make_100m_config()
    want = dataclasses.asdict(reference_100m)
    got = dataclasses.asdict(cfg)
    assert got == want
    assert cfg.resolved_head_dim() == 80
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(
        reference_100m)


def _cut(cfg):
    return dataclasses.replace(cfg, n_layers=2,
                               layer_pattern=("attn_local", "attn"))


@pytest.fixture(scope="module")
def cut_params(reference_100m):
    """The reference's parameters of the 2-layer cut (its bf16 layout)."""
    jcfg = _cut(reference_100m)
    return jcfg, jax.jit(lambda key: JM.init_params(jcfg, key))(
        jax.random.PRNGKey(1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_100m_cut_loss_and_gradients_match_reference(cut_params, dtype):
    """Two layers of the ~100M config at full width (hd 80), two
    microbatches of 2 x 32 tokens on the port against
    ``jax.value_and_grad`` of the reference's loss over the whole batch
    (equal token counts: the mean of the microbatch means)."""
    jcfg, jp = cut_params
    cfg = _cut(train_small_grid.make_100m_config())
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    p = M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 33)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda q: JM.loss_fn(jcfg, q, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True))(jp)
    loss, _, grads = grad_fn(cfg, TrainConfig(n_microbatches=2), p,
                             {k: torch.tensor(v) for k, v in batch.items()})
    _close(loss, np.float32(jl), TOL[dtype])
    pairs = _pairs(cfg, grads, jg)
    assert len(pairs) == len(tree_leaves(p))
    for name, got, want in pairs:
        _close(got, want, TOL[dtype])


# -- entry points -------------------------------------------------------------

@pytest.mark.parametrize("example", EXAMPLES,
                         ids=[e.__name__.rsplit(".", 1)[1] for e in EXAMPLES])
def test_example_asks_for_the_card(example):
    """Without ``--device cpu`` each example asks for the card and, with
    none, raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        example.main([])
