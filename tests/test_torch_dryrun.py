"""The dry run, the trace analysis and the roofline of the port
(``repro_torch.launch.{dryrun,traceanalysis,roofline}``,
``repro_torch.kernels.shapeonly``).

* on a fake (4, 2) mesh the reference's four held cells, reduced and with
  the shapes shrunk as ``tests/test_dryrun_small.py`` shrinks them, trace
  to a record with FLOPs, bytes, memory and collectives;
* at (1, 1) the reduced granite-3-8b prefill counts exactly the products
  and the attention FLOPs written out below;
* collectives whose rank group spans two 8-rank nodes are InfiniBand
  traffic, the others NVLink;
* ``model_flops_per_device`` equals the reference's for every arch x cell
  x mesh x mode; the roofline terms use the H100 figures and
  ``fits_hbm`` holds at 80 GB;
* the kernels' work formulas count the mask's pairs and keys, and the
  shape-only route answers fake tensors with the kernel's shapes and its
  work, never real ones.
"""

import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro.launch import roofline as JR
from repro_torch.configs import ShapeConfig, arch_ids, cells, get_config
from repro_torch.kernels import shapeonly
from repro_torch.kernels.flash_attention import (attention_mask,
                                                 flash_attention,
                                                 flash_attention_kernel,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.work import (attention_work,
                                                      needed_keys,
                                                      visible_pairs)
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.traceanalysis import TraceCounter, spans_nodes

#: the shrunk shapes of tests/test_dryrun_small.py
SMALL = {
    "train_4k": ShapeConfig("train_4k", 256, 8, "train"),
    "decode_32k": ShapeConfig("decode_32k", 512, 8, "decode"),
    "prefill_32k": ShapeConfig("prefill_32k", 256, 8, "prefill"),
}
HELD = [("granite-3-8b", "train_4k"), ("gemma3-1b", "decode_32k"),
        ("falcon-mamba-7b", "prefill_32k"),
        ("granite-moe-1b-a400m", "train_4k")]


@pytest.mark.parametrize("arch,shape", HELD)
def test_held_cells_trace_on_a_fake_mesh(arch, shape):
    with D.fake_group(8):
        mesh = make_debug_mesh(4, 2, device_type="cpu")
        counter, meta = D.trace_cell(arch, SMALL[shape], mesh,
                                     cfg=get_config(arch).reduced())
    rec = D.record(counter)
    assert meta["mode"] == SMALL[shape].kind
    assert rec["matmul_flops_per_device"] > 0
    assert rec["kernel_flops_per_device"] > 0
    assert rec["hbm_bytes_per_device"] > 0
    assert rec["peak_bytes"] > 0
    assert sum(rec["collective_counts"].values()) > 0
    assert rec["collective_wire_bytes_nvlink"] > 0      # 8 ranks, one node
    assert rec["collective_wire_bytes_ib"] == 0
    kernel = ("selective_scan" if arch == "falcon-mamba-7b"
              else "flash_attention")
    assert rec["kernels"][kernel]["calls"] > 0
    if SMALL[shape].kind == "train":
        assert meta["n_micro"] >= 1
        bwd = kernel + "_bwd"
        assert rec["kernels"][bwd]["calls"] == rec["kernels"][kernel][
            "calls"] // 2                            # remat runs it twice


def test_one_rank_prefill_counts_every_product():
    cfg = get_config("granite-3-8b").reduced()
    shape = ShapeConfig("prefill", 48, 3, "prefill")
    with D.fake_group(1):
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        counter, _ = D.trace_cell("granite-3-8b", shape, mesh, cfg=cfg)
    rec = D.record(counter)
    B, S = shape.global_batch, shape.seq_len
    T, Dm, F, V = B * S, cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    per_layer = (2 * T * Dm * H * hd          # q
                 + 2 * 2 * T * Dm * KV * hd   # k, v
                 + 2 * T * H * hd * Dm        # o
                 + 3 * 2 * T * Dm * F)        # gate, up, down
    head = 2 * B * Dm * V                     # the last position's logits
    assert rec["matmul_flops_per_device"] == cfg.n_layers * per_layer + head
    pairs = S * (S + 1) // 2                  # causal
    assert rec["kernel_flops_per_device"] == cfg.n_layers * 4 * B * H * hd \
        * pairs
    assert rec["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    assert sum(rec["collective_counts"].values()) == 0


def test_collectives_split_by_node():
    assert not spans_nodes(range(8))
    assert not spans_nodes(range(8, 16))
    assert spans_nodes(range(16))
    assert spans_nodes([0, 8, 16, 24])
    assert spans_nodes([7, 8])
    assert not spans_nodes([0, 3], gpus_per_node=4)
    with D.fake_group(32):
        mesh = make_debug_mesh(4, 8, device_type="cpu")   # model: one node
        with FakeTensorMode():
            local = torch.empty(64, 32, dtype=torch.bfloat16)
            for axis, nvlink in (("model", True), ("data", False)):
                pl = [Partial() if n == axis else Replicate()
                      for n in mesh.mesh_dim_names]
                x = DTensor.from_local(local, mesh, pl, run_check=False)
                with TraceCounter() as counter:
                    x.redistribute(mesh, [Replicate(), Replicate()])
                st = counter.stats
                wire = 2.0 * 64 * 32 * 2               # all-reduce: 2 x
                assert st.collective_counts["all-reduce"] == 1
                assert st.collective_result_bytes["all-reduce"] == 64 * 32 * 2
                assert (st.collective_wire_bytes_nvlink,
                        st.collective_wire_bytes_ib) == (
                    (wire, 0.0) if nvlink else (0.0, wire))


@pytest.mark.parametrize("arch", arch_ids())
def test_model_flops_match_reference(arch):
    for shape in cells(arch):
        for mesh in ("single", "multi"):
            for mode in ("train", "prefill", "decode"):
                assert R.model_flops_per_device(arch, shape, mesh, mode) == \
                    JR.model_flops_per_device(arch, shape, mesh, mode)


def test_roofline_row_uses_h100_figures():
    rec = {"arch": "gemma3-1b", "shape": "train_4k", "mesh": "single",
           "mode": "train", "matmul_flops_per_device": 989e12,
           "kernel_flops_per_device": 989e12,
           "hbm_bytes_per_device": 3.35e12, "peak_bytes": 80e9,
           "collective_wire_bytes_nvlink": 450e9,
           "collective_wire_bytes_ib": 100e9}
    row = R.roofline_row(rec)
    assert math.isclose(row["compute_s"], 2.0)
    assert math.isclose(row["memory_s"], 1.0)
    assert math.isclose(row["collective_s"], 3.0)
    assert row["dominant"] == "collective"
    assert row["fits_hbm"] is True
    assert R.roofline_row(dict(rec, peak_bytes=80e9 + 1))["fits_hbm"] is False
    assert (R.BF16_FLOPS, R.HBM_BW, R.HBM_BYTES) == (989e12, 3.35e12, 80e9)
    assert "collective" in R.fmt_table([row])


def test_work_formulas_count_the_mask():
    for sq, skv, causal, window, q_offset, kv_len in (
            (64, 64, True, None, 0, None), (64, 64, True, 16, 0, None),
            (1, 100, True, None, 99, 100), (1, 100, True, 7, 50, 51),
            (30, 90, False, None, 0, None), (30, 90, True, 40, 60, 80),
            (5, 3, True, None, 0, None)):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_len=kv_len)
        mask = attention_mask(sq, skv, device="cpu", **kw)
        assert visible_pairs(sq, skv, **kw) == int(mask.sum())
        assert needed_keys(sq, skv, **kw) == int(mask.any(0).sum())


def test_shape_only_route_answers_fake_tensors_only():
    B, H, KV, S, hd = 2, 4, 2, 40, 16
    reported = []
    with shapeonly.collecting(lambda *a: reported.append(a)):
        with FakeTensorMode():
            q = torch.empty(B, S, H, hd).transpose(1, 2)
            k = torch.empty(B, S, KV, hd).transpose(1, 2)
            out = flash_attention(q, k, k, window=8)
            assert tuple(out.shape) == (B, H, S, hd)
            o, lse, o32 = flash_attention_kernel(q, k, k, with_lse=True)
            assert (tuple(lse.shape), o32.dtype) == ((B, H, S),
                                                     torch.float32)
        assert len(reported) == 2
        name, flops, bytes_ = reported[0]
        assert name == "flash_attention"
        assert (bytes_, flops) == attention_work(B, H, KV, hd, S, S, size=4,
                                                 window=8)
        # real CPU tensors: the plain version, nothing reported
        q = torch.randn(B, H, S, hd)
        k = torch.randn(B, KV, S, hd)
        torch.testing.assert_close(flash_attention(q, k, k),
                                   flash_attention_ref(q, k, k))
        assert len(reported) == 2
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_kernel(q, k, k)
