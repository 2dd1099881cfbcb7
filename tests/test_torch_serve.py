"""The port's serving path against the reference's: configs, parameters,
prefill and decode logits, greedy tokens, the grid router and the CLI.

The reduced forms of every config whose blocks the port serves
(``gemma3-1b`` local/global windows, ``falcon-mamba-7b`` Mamba-1,
``granite-3-8b`` GQA, ``qwen2-72b`` QKV bias, ``gemma2-27b`` both
softcaps, ``granite-moe-1b-a400m`` and ``arctic-480b`` the MoE
feed-forward, the latter with its dense residual, ``zamba2-7b`` Mamba-2
and the shared attention block) run the reference's weights, carried by ``params_from_jax``, with
the norms and biases moved off zero so that a dropped term shows. Logits
are held at every step, teacher-forced along the reference's greedy tokens:
in float32 at 2e-5 (atol and rtol; observed ~4e-7), which catches mask,
RoPE and GQA errors that bf16 noise would hide, and in bf16, as served, at
2e-2 (observed up to one bf16 ulp, 7.8e-3). The port's
``ServeEngine.generate`` tokens are held to the reference's by the margin
rule of ``greedy_agreement``, and its logits up to each row's first token
that differs from the reference's (a bf16 near-tie; later steps see other
inputs). Both packages cache the Mamba blocks' conv states in bf16 even
in a float32 run: in the teacher-forced float32 loop the port's are held
within one bf16 ulp of the reference's and then set to them
(``_follow_conv_caches``), and the engine run, which keeps its own, is
held at ``ENGINE_TOL_F32`` where that rounding moves its float32 logits
past 2e-5 (zamba2-7b). The reference's own engine pads Mamba-2's SSM
state as if it were a K/V cache; ``_JaxEngine`` pads the K/V caches only.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import arch_ids as jax_arch_ids
from repro.configs.base import get_config as jax_config
from repro.core import GridTopology as JaxTopology
from repro.grid.datagrid import DataGridService as JaxGrid
from repro.models import mlp as jax_mlp
from repro.models import model as JM
from repro.serve.engine import GridRouter as JaxRouter
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import arch_ids, get_config
from repro_torch.core import GridTopology
from repro_torch.grid.datagrid import DataGridService
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.models.mlp import gated_mlp
from repro_torch.serve.engine import (GridRouter, Request, ServeEngine,
                                      greedy_agreement)
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, S, NEW = 2, 40, 8          # prompts longer than the reduced 32-key window
#: float32 logits of the port's engine run, which follows its own bf16
#: conv-state rounding (``_follow_conv_caches``), against the reference's
#: where that rounding moves them past TOL: zamba2-7b's Mamba-2 blocks
#: (observed 6.0e-5)
ENGINE_TOL_F32 = {"zamba2-7b": 1e-4}
#: the configs the engine serves (internvl2-2b text-only, as the
#: reference's engine); whisper-large-v3 is held by test_torch_encdec.py
ARCHS = ["gemma3-1b", "falcon-mamba-7b", "granite-3-8b", "qwen2-72b",
         "gemma2-27b", "granite-moe-1b-a400m", "arctic-480b", "zamba2-7b",
         "internvl2-2b"]


def test_registry_and_configs_match_reference():
    """The port registers every config of the reference's registry, each
    equal to the reference's, full and reduced."""
    assert sorted(arch_ids()) == sorted(jax_arch_ids())
    for arch in arch_ids():
        for reduce in (False, True):
            got, want = get_config(arch), jax_config(arch)
            if reduce:
                got, want = got.reduced(), want.reduced()
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_count() == want.param_count()
    with pytest.raises(KeyError, match="unknown arch 'whisper-large-v4'"):
        get_config("whisper-large-v4")


class _JaxEngine(JaxEngine):
    """The reference's engine, its cache growth held to the leaves whose
    sequence axis holds the prompt (the K/V caches). Its own
    ``_pad_cache_leaf`` also pads Mamba-2's SSM state (B, nh, P, N), whose
    nh is below ``max_len`` and P at most 64, which breaks its own decode
    (ROADMAP queue 3); other configs' caches grow as before."""

    def generate(self, tokens, n_new):
        self.prompt_len = tokens.shape[1]
        return super().generate(tokens, n_new)

    def _pad_cache_leaf(self, x):
        if x.ndim >= 4 and x.shape[-3] != self.prompt_len:
            return x
        return super()._pad_cache_leaf(x)


def _follow_conv_caches(caches, ref, where: str) -> None:
    """The Mamba blocks' conv states, which both packages cache in bf16
    even in a float32 run: the port's within one bf16 ulp of the
    reference's, then set to them. A float32 value within 1e-7 of a bf16
    rounding midpoint rounds either way, and the ulp it moves a state by
    (up to 2^-7 relative) would move later float32 logits past 2e-5;
    following the reference's rounding holds each decode step on the same
    inputs."""
    ref = jax.tree.map(np.asarray, ref)

    def walk(got, want, name):
        if isinstance(want, dict):
            for k in want:
                if k == "conv" and isinstance(got[k], dict):
                    for kk in want[k]:
                        follow(got[k], kk, want[k][kk], f"{name}/conv/{kk}")
                elif k == "conv":
                    follow(got, k, want[k], f"{name}/conv")
                else:
                    walk(got[k], want[k], f"{name}/{k}")
        elif isinstance(want, (list, tuple)):
            for i, w in enumerate(want):
                walk(got[i], w, f"{name}/{i}")

    def follow(parent, key, want, name):
        got = parent[key]
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                   rtol=2 ** -7, atol=1e-6, err_msg=f"{where} "
                                   f"{name}")
        parent[key] = torch.from_numpy(
            want.view(np.uint16).copy()).view(torch.bfloat16)

    walk(caches, ref, "caches")


def _reference_params(arch: str, dtype: str):
    """The reference's reduced-config parameters from a fixed key, norms
    and biases moved off zero, optionally cast to float32."""
    jcfg = jax_config(arch).reduced()
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("ln", "norm", "'bq'", "'bk'", "'bv'",
                                   "conv_b")):
            noise = rng.standard_normal(a.shape).astype(np.float32)
            return (a.astype(jnp.float32) + 0.1 * noise).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return jcfg, params


def test_params_from_jax_is_bit_exact():
    """Every leaf, bf16 ones through their bits, lands where the port's
    layout puts it: group g of a stacked leaf is its row g."""
    cfg = get_config("gemma3-1b").reduced()
    jcfg, jp = _reference_params("gemma3-1b", "bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    p = M.params_from_jax(cfg, tree)

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    def same(t, a):
        name = np.asarray(a).dtype.name
        assert t.dtype == getattr(torch, name), (t.dtype, name)
        got = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t)
        np.testing.assert_array_equal(got.numpy(), bits(a))

    same(p["embed"], tree["embed"])
    same(p["final_norm"], tree["final_norm"])
    n_bf16 = 0
    for g in range(cfg.n_groups):
        for name, block in tree["groups"].items():
            for path, leaf in jax.tree_util.tree_leaves_with_path(block):
                t = p["groups"][g][name]
                for key in path:
                    t = t[key.key]
                same(t, leaf[g])
                n_bf16 += t.dtype == torch.bfloat16
    assert n_bf16 > 0 and len(p["groups"]) == cfg.n_groups
    for i, block in enumerate(tree["rest"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(block):
            t = p["rest"][i]
            for key in path:
                t = t[key.key]
            same(t, leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_greedy_tokens_match_reference(arch, dtype):
    cfg = get_config(arch).reduced()
    jcfg, jp = _reference_params(arch, dtype)
    p = M.params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    tol = dict(atol=TOL[dtype], rtol=TOL[dtype])

    engine = _JaxEngine(jcfg, jp, max_len=S + NEW)
    want_tokens = engine.generate(tokens, NEW)
    # the reference's logits along its own greedy tokens, and the port's
    # prefill and decode_step teacher-forced along the same tokens
    jl, jc = engine._prefill(jp, {"tokens": jnp.asarray(tokens)})
    jc = jax.tree.map(engine._pad_cache_leaf, jc)
    caches = M.init_caches(cfg, B, S + NEW, device="cpu",
                           dtype=p["embed"].dtype)
    logits, caches = M.prefill(cfg, p, torch.tensor(tokens), caches=caches)
    ref_logits = []
    for i in range(NEW):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol,
                                   err_msg=f"step {i}")
        ref_logits.append(np.asarray(jl)[:, -1])
        tok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(tok)[:, 0],
                                      want_tokens[:, i])
        jl, jc = engine._decode(jp, jc, tok, jnp.int32(S + i))
        logits, caches = M.decode_step(cfg, p, caches,
                                       torch.tensor(np.asarray(tok)), S + i)
        if dtype == "float32":
            _follow_conv_caches(caches, jc, f"step {i}")

    got_tokens, got_logits = ServeEngine(cfg, p, max_len=S + NEW).generate(
        tokens, NEW, return_logits=True)
    ref_logits = torch.tensor(np.stack(ref_logits, 1))
    assert got_tokens.shape == (B, NEW) and got_logits.shape == (B, NEW,
                                                                 cfg.vocab)
    # a row's logits are held up to its first token that differs from the
    # reference's (a bf16 near-tie): later steps see other inputs. The
    # engine's caches follow their own bf16 conv-state rounding:
    # ``ENGINE_TOL_F32`` where that moves float32 logits past TOL
    if dtype == "float32" and arch in ENGINE_TOL_F32:
        tol = dict(atol=ENGINE_TOL_F32[arch], rtol=ENGINE_TOL_F32[arch])
    for r in range(B):
        differ = np.flatnonzero(got_tokens[r] != want_tokens[r])
        upto = differ[0] + 1 if differ.size else NEW
        np.testing.assert_allclose(got_logits[r, :upto].numpy(),
                                   ref_logits[r, :upto].numpy(), **tol,
                                   err_msg=f"row {r}")
    held = greedy_agreement(got_tokens, want_tokens, ref_logits, **tol)
    assert held > 0


def test_greedy_agreement_rule():
    ref = torch.tensor([[[0.0, 1.0, 0.99], [2.0, 0.0, 0.0]],
                        [[3.0, 0.0, 0.0], [0.0, 0.0, 5.0]]])
    want = np.array([[1, 0], [0, 2]])
    kw = dict(atol=0.01, rtol=0.0)
    assert greedy_agreement(want, want, ref, **kw) == 3   # step (0, 0) tie
    # a near-tie pick ends the row's comparison
    assert greedy_agreement(np.array([[2, 1], [0, 2]]), want, ref, **kw) == 2
    with pytest.raises(AssertionError, match="row 1 step 1"):
        greedy_agreement(np.array([[1, 0], [0, 1]]), want, ref, **kw)


def test_unported_paths_raise():
    """The encoder-decoder and the VLM front end are served and trained:
    every training entry point builds for both reduced configs on the CPU
    (nothing the port serves is refused now); an LM block with
    ``act="gelu"`` builds."""
    for arch in ("whisper-large-v3", "internvl2-2b"):
        cfg = get_config(arch).reduced()
        M.init_params(cfg, device="cpu")
        params, state = init_train_state(cfg, device="cpu")
        assert set(state["m"]) == set(params)
        assert callable(make_train_step(cfg, TrainConfig()))
        run = launch_train.build(cfg, batch=2, seq=8, steps=1, device="cpu")
        assert callable(run["train_step"]) and run["device"].type == "cpu"
    base = get_config("granite-3-8b").reduced()
    p = M.init_params(dataclasses.replace(base, act="gelu"), device="cpu")
    assert set(p["groups"][0]["b0"]["mlp"]) == {"w1", "b1", "w2", "b2"}


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_gated_mlp_matches_reference(act):
    """Both gated activations (``geglu`` is ``jax.nn.gelu``'s tanh form)."""
    rng = np.random.default_rng(9)
    w = {k: rng.standard_normal(s, np.float32) * 0.2
         for k, s in (("wg", (16, 32)), ("wu", (16, 32)), ("wd", (32, 16)))}
    x = rng.standard_normal((3, 5, 16), np.float32)
    got = gated_mlp({k: torch.tensor(v) for k, v in w.items()},
                    torch.tensor(x), act)
    want = jax_mlp.gated_mlp({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# -- the grid router --------------------------------------------------------

def _router_run(topo_cls, grid_cls, router_cls, req_cls, scenario):
    if scenario == "grid_runtime":
        topo = topo_cls(2, 4, lan_bandwidth=50e9, wan_bandwidth=3e9,
                        storage_capacity=64e9)
        prefixes = [("sys-prompt-kv", 1e9, 2)]
        names = ["sys-prompt-kv"] * 4
    else:        # examples/serve_grid.py's pool and its 12 requests
        topo = topo_cls(2, 4, lan_bandwidth=50e9, wan_bandwidth=3.125e9,
                        storage_capacity=64e9)
        prefixes = [(f"prefix{i}", 2e9, s) for i, s in enumerate((0, 3, 6))]
        names = [f"prefix{i % 3}" for i in range(12)]
    grid = grid_cls(topo)
    router = router_cls(grid, n_engines=topo.n_sites)
    for lfn, size, site in prefixes:
        router.register_prefix(lfn, size, master_site=site)
    sites = []
    for i, name in enumerate(names):
        r = req_cls(i, np.zeros(8, np.int32), prefix_id=name)
        sites.append(router.route(r))
        if i % 2:                     # every other request completes at once
            router.complete(sites[-1], r)
    # a consumer pinned in the other pod pulls a prefix across the WAN
    grid.ensure_local([prefixes[0][0]], topo.n_sites - 1)
    transfers = [(t.lfn, t.src, t.dst, t.bytes, t.inter_region, t.stored)
                 for t in grid.transfers]
    return (sites, router.routed, grid.wan_bytes(), grid.lan_bytes(),
            grid.inter_comm_count(), transfers)


@pytest.mark.parametrize("scenario", ["grid_runtime", "serve_grid"])
def test_router_matches_reference(scenario):
    got = _router_run(GridTopology, DataGridService, GridRouter, Request,
                      scenario)
    want = _router_run(JaxTopology, JaxGrid, JaxRouter, JaxRequest, scenario)
    assert got == want
    assert got[4] >= 1               # the pinned consumer crossed the WAN


def test_place_job_matches_reference():
    """``tests/test_grid_runtime.py``'s placements through both services."""
    def run(topo_cls, grid_cls):
        grid = grid_cls(topo_cls(2, 4, lan_bandwidth=50e9, wan_bandwidth=3e9,
                                 storage_capacity=64e9))
        grid.register("a", 4e9, master_site=3)
        grid.register("b", 1e9, master_site=6)
        grid.register("hot", 2e9, master_site=7)
        out = [grid.place_job(["a", "b"]), grid.place_job(["hot"])]
        for dst in (0, 1, 2):
            grid.ensure_local(["hot"], dst)
        return ([(s, [(t.lfn, t.src, t.bytes) for t in st]) for s, st in out],
                grid.inter_comm_count(), grid.wan_bytes(), grid.lan_bytes())

    got = run(GridTopology, DataGridService)
    assert got == run(JaxTopology, JaxGrid)
    assert got[0][0][0] == 3 and got[0][1] == (7, [])


# -- the CLI ----------------------------------------------------------------

def test_launch_serve_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "gemma2-27b", "--reduced",
                              "--requests", "3", "--prompt-len", "12",
                              "--new-tokens", "3", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and lines[0].startswith("req 0 prefix0 site ")
    summary = json.loads(lines[-1])
    assert summary["arch"] == "gemma2-27b" and summary["device"] == "cpu"
    assert summary["peak_bytes"] is None and summary["tokens_per_s"] > 0


def test_launch_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        launch_serve.main(["--arch", "gemma3-1b", "--reduced"])


def test_port_never_imports_ml_dtypes():
    """The card's machine need not have ``ml_dtypes``: bf16 leaves are
    carried through ``uint16``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import importlib, pkgutil, sys\n"
            "import repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'): importlib.import_module(m.name)\n"
            "assert 'ml_dtypes' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr
