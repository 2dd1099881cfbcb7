"""Checkpoints, the data pipeline and the training supervisor of the port
(``repro_torch.checkpoint``, ``repro_torch.data``,
``repro_torch.fault.failures``) against the reference's.

* a tree of bf16, float32 and int32 tensors round-trips bit for bit, at
  any shard count (elastic), bf16 as its bit pattern; ``latest_step``;
* the files are the reference's format: ``repro.checkpoint.ckpt``'s files
  restore in the port and the port's in the reference, bit for bit, with
  the same manifest;
* restore sources: the same HRS choice per chunk as the reference's;
* the loader gives the reference's batches and placement stats step for
  step;
* the supervisor recovers from a failure mid-run (the counterpart of
  ``tests/test_system.py::test_training_with_failures_recovers``), the
  restored state bit-equal to what was saved, and re-issues a straggling
  step on the state it was given.
"""

import dataclasses
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as J
from repro.core import GridTopology as JaxTopology
from repro.data import pipeline as JD
from repro.grid.datagrid import DataGridService as JaxGrid
from repro_torch.checkpoint import ckpt as P
from repro_torch.configs import get_config
from repro_torch.core import GridTopology
from repro_torch.data import pipeline as PD
from repro_torch.fault.failures import FailurePlan, TrainingSupervisor
from repro_torch.grid.datagrid import DataGridService
from repro_torch.launch.train import build, make_step_fn
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.train_step import TrainConfig, make_train_step


def _tree():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    return {"embed": r(10, 4).bfloat16(),
            "groups": [{"b0": {"w": r(3, 5), "ln": r(5)}},
                       {"b0": {"w": r(3, 5), "ln": r(5)}}],
            "step": torch.tensor(7, dtype=torch.int32),
            "norm": r(1).bfloat16()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_round_trip_is_bit_exact(tmp_path, n_shards):
    tree = _tree()
    m = P.save_checkpoint(tree, str(tmp_path), 5, n_shards=n_shards,
                          replicate_to=[1, 6])
    assert m.leaves["embed"]["dtype"] == "bfloat16"
    assert len(m.leaves["embed"]["chunks"]) == min(n_shards, 10)
    out, m2 = P.restore_checkpoint(str(tmp_path), 5, like=tree, device="cpu")
    assert m2 == m and isinstance(out["groups"], list)
    _equal_trees(out, tree)
    raw = np.load(os.path.join(tmp_path, "step_00000005",
                               m.leaves["embed"]["chunks"][0]))
    assert raw.dtype == np.uint16


def test_latest_step(tmp_path):
    assert P.latest_step(str(tmp_path / "none")) is None
    assert P.latest_step(str(tmp_path)) is None
    for step in (4, 12, 8):
        P.save_checkpoint({"x": torch.zeros(2)}, str(tmp_path), step)
    assert P.latest_step(str(tmp_path)) == 12 == J.latest_step(str(tmp_path))


def _np_tree(tree):
    """The same tree as numpy arrays, bf16 as ml_dtypes' bfloat16."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return conv(tree)


def test_reference_files_restore_in_the_port(tmp_path):
    tree = _tree()
    jm = J.save_checkpoint(_np_tree(tree), str(tmp_path), 3, n_shards=3,
                           replicate_to=[2])
    out, m = P.restore_checkpoint(str(tmp_path), 3, like=tree, device="cpu")
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    _equal_trees(out, tree)


def test_port_files_restore_in_the_reference(tmp_path):
    tree = _tree()
    pm = P.save_checkpoint(tree, str(tmp_path), 3, n_shards=3,
                           replicate_to=[2])
    jm = J.save_checkpoint(_np_tree(tree), str(tmp_path / "ref"), 3,
                           n_shards=3, replicate_to=[2])
    assert dataclasses.asdict(pm) == dataclasses.asdict(jm)
    out, _ = J.restore_checkpoint(str(tmp_path), 3, like=_np_tree(tree))
    want = _np_tree(tree)
    assert out["embed"].dtype == jnp.bfloat16
    for path in (("embed",), ("norm",), ("step",), ("groups", 1, "b0", "w")):
        a, b = out, want
        for k in path:
            a, b = a[k], b[k]
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_restore_sources_match_reference():
    kw = dict(lan_bandwidth=50e9, wan_bandwidth=3.125e9,
              storage_capacity=256e9)
    topo, jtopo = GridTopology(2, 4, **kw), JaxTopology(2, 4, **kw)
    m = P.Manifest(step=1, n_shards=2, leaves={}, replicas={
        "a.0.npy": [0], "a.1.npy": [5, 1], "b.0.npy": [4, 6, 2],
        "c.0.npy": [3, 7]})
    jman = J.Manifest(**dataclasses.asdict(m))
    for dst in range(topo.n_sites):
        assert P.choose_restore_sources(m, topo, dst) == \
            J.choose_restore_sources(jman, jtopo, dst)


def test_loader_matches_reference():
    kw = dict(lan_bandwidth=50e9, wan_bandwidth=3e9, storage_capacity=64e9)
    grid, jgrid = (DataGridService(GridTopology(2, 4, **kw)),
                   JaxGrid(JaxTopology(2, 4, **kw)))
    cfg = dict(vocab=256, seq_len=32, global_batch=4, n_shards=8, seed=3)
    loader = PD.GridDataLoader(PD.SyntheticShardedDataset(
        PD.DataConfig(**cfg)), grid)
    jloader = JD.GridDataLoader(JD.SyntheticShardedDataset(
        JD.DataConfig(**cfg)), jgrid)
    assert PD.shard_name(17) == JD.shard_name(17)
    for _ in range(12):
        (b, st), (jb, jst) = loader.next_batch(), jloader.next_batch()
        for k in ("tokens", "labels"):
            assert b[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], jb[k])
        assert st["site"] == jst["site"]
        assert [dataclasses.asdict(t) for t in st["transfers"]] == \
            [dataclasses.asdict(t) for t in jst["transfers"]]
    assert grid.inter_comm_count() == jgrid.inter_comm_count()


def _host_copy(state):
    return [t.clone() for t in tree_leaves(state)]


def test_training_with_failures_recovers(tmp_path):
    """24 steps of the reduced gemma3-1b on the learnable synthetic data,
    a checkpoint every 4 steps, a node failure at step 6: one restart, the
    restored state bit-equal to step 4's, and the loss below its start."""
    cfg = get_config("gemma3-1b").reduced()
    run = build(cfg, batch=4, seq=32, steps=60, device="cpu")
    step = make_train_step(cfg, TrainConfig(opt=OptimizerConfig(
        peak_lr=2e-3, warmup_steps=2, total_steps=60)))
    step_fn = make_step_fn(step, run["loader"].next_batch, run["device"])
    saved = {}

    def keep(state, i):
        out = step_fn(state, i)
        if i + 1 == 4:
            saved[4] = _host_copy(out[0])
        return out

    sup = TrainingSupervisor(keep, str(tmp_path), ckpt_every=4,
                             plan=FailurePlan(fail_at_steps=(6,)))
    state, hist = sup.run((run["params"], run["opt"]), 24)
    assert sup.stats.restarts == 1 and sup.stats.steps_wasted == 2
    assert len(hist) >= 24
    losses = [h["loss"] for h in hist]
    assert min(losses[-6:]) < losses[0] - 0.15
    restored, _ = P.restore_checkpoint(str(tmp_path), 4,
                                       like=(run["params"], run["opt"]),
                                       device="cpu")
    for a, b in zip(tree_leaves(restored), saved[4]):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def test_straggler_is_reissued_on_its_input_state(tmp_path):
    """A step past the deadline runs again on the state it was given (a
    functional step applies once), and the backup's result is kept."""
    calls = []

    def step_fn(state, i):
        calls.append(i)
        return {"x": state["x"] + 1}, {"loss": torch.tensor(0.0)}

    sup = TrainingSupervisor(step_fn, str(tmp_path), ckpt_every=100,
                             plan=FailurePlan(slow_steps=(3,),
                                              straggle_factor=1e6))
    state, hist = sup.run({"x": torch.zeros(())}, 6)
    assert sup.stats.stragglers_mitigated == 1
    assert calls.count(3) == 2 and float(state["x"]) == 6.0
