"""``chip_smoke.py``'s attribution of device time to the MoE feed-forward
and to Mamba-2's chunk work, and its count of routing flips, on the CPU
(no JAX).

The profiler trace of a training step names kernels, not modules:
``scoped_device_us`` gives a kernel to the ``moe`` family when the
operator that launched it runs inside ``moe_ffn``'s profiler range (the
forward, and its recompute under remat) or inside the backward node of
such an operator. On the CPU there are no kernels, so each top-level
operator here stands for the kernel it would launch.
"""

import importlib.util
import os

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.mamba import SSD_SCOPE
from repro_torch.train.train_step import TrainConfig, grad_fn

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_events(remat: bool, arch: str = "granite-moe-1b-a400m"):
    """A reduced config's first step under the CPU profiler; every
    operator not called by another operator gets one 1 µs "kernel" of its
    own name."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=gen)
             for k in ("tokens", "labels")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        grad_fn(cfg, TrainConfig(remat=remat), params, batch,
                backend="plain")
    events = prof.events()
    for e in events:
        parent = e.cpu_parent
        if (e.device_type == DeviceType.CPU and e.name.startswith("aten::")
                and not (parent is not None
                         and parent.name.startswith("aten::"))):
            e.append_kernel(e.name, 0, 1.0)
        if e.is_user_annotation:
            # a range's own device row, as a trace on the card has it
            e.append_kernel(e.name, 0, 1.0)
    return events


@pytest.mark.parametrize("remat", [True, False])
def test_moe_scope_takes_the_feed_forward_and_its_backward(remat):
    smoke = _chip_smoke()
    events = _step_events(remat)
    scoped = smoke.scoped_device_us(events, smoke.MOE_SCOPE)
    # the routing, the dispatch's gathers, the grouped products, and the
    # backward of the gathers
    for op in ("aten::argsort", "aten::searchsorted", "aten::gather",
               "aten::bmm", "aten::gather_backward"):
        assert scoped.get(op), (op, sorted(scoped))
    # the embedding's gather and its backward, the rotary tables, the
    # norms' rsqrt, the loss, and the ranges themselves stay outside
    for op in ("aten::embedding", "aten::index", "aten::_index_put_impl_",
               "aten::cos", "aten::rsqrt", "aten::logsumexp",
               smoke.MOE_SCOPE, "train_segment"):
        assert op not in scoped, op
    # under remat a layer's recompute runs inside the backward node of its
    # last operator (the feed-forward's): only what moe_ffn's range holds
    # is the scope's, so the attention's recomputed rotary stays outside
    every = {}
    for e in events:
        for k in e.kernels:
            every[k.name] = every.get(k.name, 0.0) + k.duration
    assert all(us <= every[name] for name, us in scoped.items())


def test_step_families_split_the_scope():
    smoke = _chip_smoke()
    by_name = {"nvjet_tst_gemm": (10.0, 2), "void gather_kernel": (4.0, 1),
               "void elementwise_kernel": (6.0, 3),
               "void dkdv_f32_kernel<64>": (3.0, 1),
               "void dq_f32_kernel<64>": (2.0, 1),
               "void delta_f32_kernel<64>": (1.0, 1),
               "Memcpy DtoD": (0.5, 1)}
    scoped = {"nvjet_tst_gemm": 7.0, "void gather_kernel": 4.0,
              "void elementwise_kernel": 2.0}
    fam = smoke.step_families(by_name, scoped)
    assert fam["gemm"] == 10.0 and fam["moe"] == 6.0
    assert fam["other"] == 4.0 and fam["copy"] == 0.5
    assert fam["flash_attention_bwd"] == 6.0
    assert sum(fam.values()) == sum(us for us, _ in by_name.values())
    # no scope: nothing is the moe family's
    assert smoke.step_families(by_name, {})["moe"] == 0.0


@pytest.mark.parametrize("remat", [True, False])
def test_ssd_scope_takes_the_chunk_work_and_its_backward(remat):
    """zamba2-7b's Mamba-2 blocks: the decay's cumsum and exponentials and
    the chunk products, forward, recompute and backward, are the ``ssd``
    range's; the projections before it, the conv and the norm after it,
    and the attention block's operators are not."""
    smoke = _chip_smoke()
    assert smoke.SSD_SCOPE == SSD_SCOPE
    events = _step_events(remat, "zamba2-7b")
    scoped = smoke.scoped_device_us(events, smoke.SSD_SCOPE)
    # the cumsum's backward is a flip and a cumsum
    for op in ("aten::cumsum", "aten::exp", "aten::where", "aten::matmul",
               "aten::bmm", "aten::einsum", "aten::flip"):
        assert scoped.get(op), (op, sorted(scoped))
    for op in ("aten::softplus", "aten::softplus_backward", "aten::sigmoid",
               "aten::rsqrt", "aten::logsumexp", "aten::cos",
               smoke.SSD_SCOPE, "train_segment"):
        assert op not in scoped, op


def test_step_families_take_the_ssd_scope_before_gemm():
    """The chunk range's share of every kernel not of a hand-written
    kernel's family goes to ``ssd``, its GEMMs included; the rest of a
    GEMM stays ``gemm``; the hand-written kernels keep theirs."""
    smoke = _chip_smoke()
    by_name = {"sm80_xmma_gemm_f32f32": (10.0, 4),
               "void elementwise_kernel": (6.0, 3),
               "void flash_kernel_mma<112>": (2.0, 1),
               "Memcpy DtoD": (0.5, 1)}
    ssd = {"sm80_xmma_gemm_f32f32": 7.0, "void elementwise_kernel": 5.0,
           "void flash_kernel_mma<112>": 2.0}
    fam = smoke.step_families(by_name, {}, ssd)
    assert fam["ssd"] == 12.0 and fam["gemm"] == 3.0
    assert fam["other"] == 1.0 and fam["flash_attention"] == 2.0
    assert fam["moe"] == 0.0 and fam["copy"] == 0.5
    assert sum(fam.values()) == sum(us for us, _ in by_name.values())
    assert smoke.step_families(by_name, {})["ssd"] == 0.0


def test_flips_by_router_counts_each_layer_at_its_first_routing():
    smoke = _chip_smoke()
    z = torch.zeros((1, 4, 3), dtype=torch.uint8)
    a = z.clone()
    a[0, 1, 2] = 1                 # token 1 chose another expert
    b = z.clone()
    b[0, 3, 0] = 1                 # token 3 kept another expert
    gap = torch.zeros((1, 4))
    runs_a = [(a, z, gap, 10), (z, b, gap, 20), (z, z, gap, 10)]
    runs_b = [(z, z, gap, 10), (z, z, gap, 20), (a, b, gap, 10)]
    assert smoke.flips_by_router(runs_a, runs_b) == {10: 1, 20: 1}
    flips = smoke.route_flips(runs_a, runs_b)["prefill"]
    assert flips["routes"] == 12 and flips["chose_other_experts"] == 2
    assert flips["kept_other_experts"] == 2
