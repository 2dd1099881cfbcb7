"""The mesh, the sharding rules, the batch anchors, the sharded train step,
``reshard_for_mesh`` and grid placement of the port
(``repro_torch.launch.{mesh,shardings}``, ``repro_torch.models.shardctx``,
``repro_torch.train.train_step``, ``repro_torch.checkpoint.ckpt``,
``repro_torch.grid.placement``) against the reference's.

* ``SHAPES`` and ``cells`` equal the reference's; only the sub-quadratic
  configs have ``long_500k``;
* every parameter leaf of every config at full size gets, on its trailing
  dimensions, the reference's ``param_pspec`` on the ``single``, ``multi``
  and (4, 2) axis sizes, and the leaf sets map one to one; so do the
  leaves ``params_from_jax`` carries across;
* ``batch_pspec`` and ``cache_pspec`` equal the reference's for every
  config's caches, the ``long_500k`` batch-1 ones included;
* placements from a spec give local shapes of the global shape divided by
  the sharding axes' sizes, on a fake (4, 2) mesh;
* ``anchor_batch`` is a no-op without a mesh and shards the batch over
  ``data`` when it divides;
* on a one-rank ``gloo`` mesh the sharded train step equals the step
  without a mesh bit for bit (reduced gemma3-1b and granite-moe-1b-a400m,
  one group each, plain versions), and ``reshard_for_mesh`` round-trips
  bit for bit;
* ``mesh_to_topology`` builds the reference's topology from the
  reference's figures, and the two-pod grid from the H100 defaults.

Every test that makes a process group destroys it when it ends.
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro.configs import base as JB
from repro.grid import placement as JP
from repro.grid.placement import mesh_to_topology as jax_mesh_to_topology
from repro.launch import shardings as JS
from repro.models import model as JM
from repro_torch.checkpoint import ckpt as P
from repro_torch.configs import SHAPES, arch_ids, cells, get_config
from repro_torch.grid.placement import mesh_to_topology
from repro_torch.launch import dryrun as D
from repro_torch.launch import shardings as S
from repro_torch.launch.mesh import (axis_sizes, data_axes, dp_size,
                                     make_debug_mesh, model_size)
from repro_torch.models import model as M
from repro_torch.models import shardctx
from repro_torch.train.optimizer import (adamw_update, init_opt_state,
                                        tree_leaves)
from repro_torch.train.train_step import TrainConfig, grad_fn, make_train_step

AXES = {"single": (("data", "model"), (16, 16)),
        "multi": (("pod", "data", "model"), (2, 16, 16)),
        "debug": (("data", "model"), (4, 2))}
STACKED = ("groups", "enc_blocks", "dec_blocks")


def _stubs(kind):
    """The reference's stub mesh and the port's, of one shape."""
    names, shape = AXES[kind]
    ref = SimpleNamespace(axis_names=names,
                          devices=SimpleNamespace(shape=shape))
    port = SimpleNamespace(mesh_dim_names=names, shape=shape, ndim=len(shape))
    return ref, port


def _norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _ref_leaves(tree) -> dict:
    """{path of names: leaf} of a reference tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(JS._keystr(e) for e in kp): leaf for kp, leaf in leaves}


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _ref_path(path: tuple) -> tuple:
    """The reference's path of a port parameter: the per-group (per-layer)
    index after a stacked key goes."""
    if path and path[0] in STACKED:
        return (path[0],) + path[2:]
    return path


def _ref_cache_path(path: tuple) -> tuple:
    """The reference's path of a port cache: both keep a list of groups;
    the encoder-decoder's per-layer lists are stacked leaves there."""
    if path and path[0].startswith(("self_", "cross_")):
        return path[:1]
    return path


def _ref_params(arch):
    cfg = JB.get_config(arch)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return jax.eval_shape(lambda k: JM.init_params(cfg, k), key)


@contextlib.contextmanager
def _group(backend: str, world: int):
    """The default process group for one test, destroyed after it."""
    if backend == "fake":
        with D.fake_group(world):
            yield
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- shapes and cells --------------------------------------------------------

def test_shapes_equal_reference():
    assert list(SHAPES) == list(JB.SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JB.SHAPES[name])


@pytest.mark.parametrize("arch", arch_ids())
def test_cells_equal_reference(arch):
    assert cells(arch) == JB.cells(arch)


def test_long_500k_only_subquadratic():
    for arch in arch_ids():
        has_long = "long_500k" in cells(arch)
        assert has_long == (arch in ("zamba2-7b", "falcon-mamba-7b"))


# -- the rules -----------------------------------------------------------------

@pytest.mark.parametrize("arch", arch_ids())
def test_param_specs_match_reference(arch):
    ref = _ref_leaves(_ref_params(arch))
    port = list(_port_leaves(D.abstract(M.init_params, get_config(arch))))
    seen = {}
    for path, leaf in port:
        rpath = _ref_path(path)
        assert rpath in ref, path
        seen[rpath] = seen.get(rpath, 0) + 1
        rshape = tuple(ref[rpath].shape)
        lead = len(rshape) - leaf.dim()
        assert rshape[lead:] == tuple(leaf.shape), path
        for kind in AXES:
            sizes = dict(zip(*AXES[kind]))
            want = _norm(JS.param_pspec(rpath, rshape, sizes))
            got = S.param_pspec(path, tuple(leaf.shape), sizes)
            # the reference's spec of the stacked axis is None
            assert all(a is None for a in want[:lead]), (path, want)
            assert got == want[lead:], (path, kind, got, want)
    # one to one: every reference leaf, each stacked one once a group
    cfg = get_config(arch)
    n = {"groups": cfg.n_groups, "enc_blocks": cfg.n_encoder_layers,
         "dec_blocks": cfg.n_layers}
    assert set(seen) == set(ref)
    for rpath, count in seen.items():
        assert count == n.get(rpath[0], 1), rpath


@pytest.mark.parametrize("arch", ["whisper-large-v3"])
def test_params_from_jax_placements_match_reference(arch):
    """The leaves params_from_jax carries across get the placements the
    reference's rule gives their reference leaves."""
    jcfg = JB.get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    port = M.params_from_jax(get_config(arch).reduced(), jp)
    ref = _ref_leaves(jp)
    for kind in AXES:
        _, mesh = _stubs(kind)
        sizes = axis_sizes(mesh)
        got = S.param_shardings(mesh, port)
        for path, leaf in _port_leaves(port):
            rpath = _ref_path(path)
            lead = ref[rpath].ndim - leaf.dim()
            want = _norm(JS.param_pspec(rpath, ref[rpath].shape, sizes))
            pl = S.placements(want[lead:], mesh)
            node = got
            for key in path:
                node = node[int(key) if isinstance(node, list) else key]
            assert tuple(node) == pl, (path, kind)


def test_batch_specs_match_reference():
    for kind in AXES:
        ref_mesh, mesh = _stubs(kind)
        for shape in ((256, 4096), (32, 32768, 1280), (1, 1), (6, 8),
                      (512, 1)):
            assert _norm(S.batch_pspec("tokens", shape, mesh)) == _norm(
                JS.batch_pspec("tokens", shape, ref_mesh)), (kind, shape)


@pytest.mark.parametrize("arch", arch_ids())
def test_cache_specs_match_reference(arch):
    jcfg, cfg = JB.get_config(arch), get_config(arch)
    shapes = [SHAPES["decode_32k"]] + (
        [SHAPES["long_500k"]] if "long_500k" in cells(arch) else [])
    for shape in shapes:
        B, L = shape.global_batch, shape.seq_len
        ref = _ref_leaves(jax.eval_shape(lambda: JM.init_caches(jcfg, B, L)))
        port = list(_port_leaves(D.abstract(M.init_caches, cfg, B, L)))
        assert {_ref_cache_path(p) for p, _ in port} == set(ref)
        for kind in AXES:
            ref_mesh, mesh = _stubs(kind)
            for path, leaf in port:
                rpath = _ref_cache_path(path)
                rshape = tuple(ref[rpath].shape)
                lead = len(rshape) - leaf.dim()
                want = _norm(JS.cache_pspec(rpath, rshape, ref_mesh, jcfg))
                got = _norm(S.cache_pspec(path, tuple(leaf.shape), mesh, cfg))
                assert got == want[lead:], (path, kind, got, want)


def test_mesh_helpers():
    for kind, (names, shape) in AXES.items():
        _, mesh = _stubs(kind)
        assert axis_sizes(mesh) == dict(zip(names, shape))
        assert data_axes(mesh) == tuple(a for a in ("pod", "data")
                                        if a in names)
        assert dp_size(mesh) == int(np.prod(shape[:-1]))
        assert model_size(mesh) == shape[-1]


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(1, 1, device_type="cpu")


# -- placements and anchors on a fake (4, 2) mesh -----------------------------

def test_placements_give_local_shapes():
    with _group("fake", 8):
        mesh = make_debug_mesh(4, 2, device_type="cpu")
        assert S.placements((("data",), "model"), mesh) == (Shard(0),
                                                            Shard(1))
        assert S.placements((None, "data", None), mesh) == (Shard(1),
                                                            Replicate())
        assert S.placements((), mesh) == (Replicate(), Replicate())
        with pytest.raises(ValueError):
            S.placements(("model", "model"), mesh)
        cases = [((8, 6), ("data", "model")), ((8, 6), ("model", "data")),
                 ((3, 8, 4), (None, ("data",), "model")),
                 ((12,), ("model",)), ((5, 7), ())]
        with FakeTensorMode():
            for shape, spec in cases:
                meta = torch.empty(shape, device="meta")
                t = D._fake(meta, mesh, spec)
                want = list(shape)
                for dim, e in enumerate(spec):
                    for ax in (e if isinstance(e, tuple) else (e,)):
                        if ax is not None:
                            want[dim] //= {"data": 4, "model": 2}[ax]
                assert tuple(t.to_local().shape) == tuple(want), spec
                assert tuple(t.shape) == shape
                assert S.local_shape(shape, spec, mesh) == tuple(want)


def test_anchor_batch_without_a_mesh_returns_its_input():
    x = torch.ones(8, 3)
    assert shardctx.anchor_batch(x) is x
    assert shardctx.dp_size() == 1
    assert shardctx.unshard({"w": x})["w"] is x


def test_anchor_batch_shards_the_batch_over_data():
    with _group("fake", 8):
        mesh = make_debug_mesh(4, 2, device_type="cpu")
        shardctx.set_mesh(mesh, data_axes(mesh))
        try:
            with FakeTensorMode():
                for rows, want in ((8, (Shard(0), Replicate())),
                                   (6, (Replicate(), Replicate()))):
                    x = D._fake(torch.empty((rows, 3), device="meta"), mesh,
                                ())
                    y = shardctx.anchor_batch(x)
                    assert tuple(y.placements) == want, rows
                    assert tuple(y.shape) == (rows, 3)
                # a dimension other than 0, and a non-DTensor left alone
                x = D._fake(torch.empty((3, 8), device="meta"), mesh, ())
                assert tuple(shardctx.anchor_batch(x, 1).placements) == (
                    Shard(1), Replicate())
                plain = torch.empty(8, 3)
                assert shardctx.anchor_batch(plain) is plain
        finally:
            shardctx.clear()
    assert shardctx.dp_size() == 1


# -- one rank: the sharded step and resharding --------------------------------

def _tiny_batch(cfg, b=4, s=16):
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (b, s + 1))
    return {"tokens": torch.tensor(tok[:, :-1]),
            "labels": torch.tensor(tok[:, 1:])}


@pytest.mark.parametrize("arch,micro", [("gemma3-1b", 1),
                                        ("granite-moe-1b-a400m", 2)])
def test_sharded_train_step_equals_the_step_without_a_mesh(arch, micro):
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern))
    tcfg = TrainConfig(n_microbatches=micro, remat=False)
    params = M.init_params(cfg, seed=2, device="cpu")
    state = init_opt_state(params)
    batch = _tiny_batch(cfg)
    # the step without a mesh: its gradient, then its update
    l0, _, g0 = grad_fn(cfg, tcfg, params, batch)
    p0, s0, _, _ = adamw_update(tcfg.opt, g0, params, state)
    with _group("gloo", 1):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        sizes = axis_sizes(mesh)
        dt = lambda spec, t: DTensor.from_local(  # noqa: E731
            t, mesh, S.placements(spec, mesh), run_check=False)
        ps = S.tree_map_with_path(
            lambda path, t: dt(S.param_pspec(path, tuple(t.shape), sizes), t),
            params)
        ss = {k: (S.tree_map_with_path(
            lambda path, t: dt(S.param_pspec(path, tuple(t.shape), sizes), t),
            v) if k != "step" else dt((), v)) for k, v in state.items()}
        bs = {k: dt(S.batch_pspec(k, tuple(v.shape), mesh), v)
              for k, v in batch.items()}
        pins = dict(mesh=mesh, dp_axes=data_axes(mesh),
                    grad_shardings=S.param_shardings(mesh, params))
        shardctx.set_mesh(mesh, data_axes(mesh))
        try:
            with implicit_replication():
                l1, _, g1 = grad_fn(cfg, tcfg, ps, bs, **pins)
            p1, s1, m1 = make_train_step(cfg, tcfg, **pins)(ps, ss, bs)
        finally:
            shardctx.clear()
        whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa
        assert torch.equal(whole(l1), l0)
        for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
            assert torch.equal(whole(a), b)
        assert torch.equal(whole(m1["loss"]), l0)
        for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
            assert isinstance(a, DTensor)
            assert torch.equal(whole(a), b)
        for key in ("master", "m", "v"):
            for a, b in zip(tree_leaves(s1[key]), tree_leaves(s0[key])):
                assert torch.equal(whole(a), b), key


def test_reshard_for_mesh_round_trips(tmp_path):
    cfg = get_config("gemma3-1b").reduced()
    params = M.init_params(cfg, seed=1, device="cpu")
    P.save_checkpoint(params, str(tmp_path), 3, n_shards=2)
    restored, _ = P.restore_checkpoint(str(tmp_path), 3, like=params,
                                       device="cpu")
    with _group("gloo", 1):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        sizes = axis_sizes(mesh)

        def fn(path, leaf):
            if path[-1].startswith("ln"):
                return None                     # left as it is
            return S.placements(S.param_pspec(path, tuple(leaf.shape),
                                              sizes), mesh)

        placed = P.reshard_for_mesh(restored, mesh, fn)
        pairs = list(zip(_port_leaves(placed), _port_leaves(restored)))
        assert len(pairs) == len(tree_leaves(params))
        for (path, a), (_, b) in pairs:
            if path[-1].startswith("ln"):
                assert a is b
                continue
            assert isinstance(a, DTensor)
            assert tuple(a.placements) == fn(path, b)
            assert torch.equal(a.full_tensor(), b)
            assert a.dtype == b.dtype


# -- placement -------------------------------------------------------------------

def _topo_fields(t) -> dict:
    return {"regions": t.n_regions, "sites": t.sites_per_region,
            "n_sites": t.n_sites,
            "nic": [(link.name, link.bandwidth) for link in t.nic_links],
            "wan": [(link.name, link.bandwidth) for link in t.wan_links],
            "site": [dataclasses.asdict(s) for s in t.sites]}


@pytest.mark.parametrize("kind", ["single", "multi", "debug"])
def test_mesh_to_topology_with_reference_figures(kind):
    ref_mesh, mesh = _stubs(kind)
    want = jax_mesh_to_topology(ref_mesh, chips_per_host=8)
    got = mesh_to_topology(mesh, gpus_per_host=8,
                           host_storage=JP.HOST_STORAGE,
                           gpu_flops=JP.TPU_V5E_FLOPS,
                           lan_bandwidth=JP.ICI_BW, wan_bandwidth=JP.DCN_BW)
    assert _topo_fields(got) == _topo_fields(want)


def test_mesh_to_topology_two_pods():
    _, mesh = _stubs("multi")
    topo = mesh_to_topology(mesh, gpus_per_host=8)
    assert topo.n_regions == 2
    assert topo.sites_per_region == 32     # 256 GPUs / 8 per host
    assert topo.wan_links[0].bandwidth < topo.nic_links[0].bandwidth
