"""Roofline analysis from the dry-run records, with H100 SXM figures (the
counterpart of ``repro.launch.roofline``).

The figures below are the datasheet's for one NVIDIA H100 SXM5 80GB in an
HGX H100 node; every other module of the port that needs one reads it
here (``chip_smoke.py``'s bounds, :mod:`repro_torch.grid.placement`'s
defaults). A table built from them is a prediction, not a measurement.
Terms, all per device (per card; each record is one rank's trace):

  compute    = (matmul_flops + kernel_flops) / BF16_FLOPS
  memory     = hbm_bytes / HBM_BW
  collective = wire_nvlink / NVLINK_BW + wire_ib / IB_BW

MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE) per device, plus one
more forward for the full remat (the reference's convention); its ratio
to the traced FLOPs exposes replication and recompute waste.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs.base import SHAPES, get_config
from ..models.model import count_params_analytic

#: dense bf16 on the tensor cores (datasheet: 989.4 TFLOP/s without
#: sparsity)
BF16_FLOPS = 989e12
#: float32 and float64 outside the tensor cores (datasheet: 67 and 34)
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
#: HBM3: 3.35 TB/s and 80 GB
HBM_BW = 3.35e12
HBM_BYTES = 80e9
#: NVLink 4 within the node: 900 GB/s a GPU both ways, 450 each way
NVLINK_BW = 450e9
#: InfiniBand between nodes: one ConnectX-7 NDR port (400 Gb/s) a GPU
IB_BW = 50e9
#: GPUs an HGX H100 node joins by NVLink
GPUS_PER_NODE = 8
PEAK_FLOPS = BF16_FLOPS
CHIPS = {"single": 256, "multi": 512}


def model_flops_per_device(arch: str, shape_name: str, mesh: str,
                           mode: str) -> float:
    """Useful arithmetic per device per step (6ND convention)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = count_params_analytic(cfg, active_only=True)
    # exclude the embedding table from N (standard 6ND convention), keep head
    n_active -= cfg.vocab * cfg.d_model
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.enc_dec:
            tokens = shape.global_batch * (shape.seq_len +
                                           shape.seq_len // 8) // 2
        flops = 6 * n_active * tokens          # fwd(2) + bwd(4)
        flops += 2 * n_active * tokens         # full remat: one extra fwd
    elif mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        flops = 2 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        flops = 2 * n_active * tokens
    return flops / CHIPS[mesh]


def load_records(results_dir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def roofline_row(rec: dict) -> dict:
    arch, shape, mesh = rec["arch"], rec["shape"], rec["mesh"]
    flops = rec["matmul_flops_per_device"] + rec["kernel_flops_per_device"]
    compute = flops / PEAK_FLOPS
    memory = rec["hbm_bytes_per_device"] / HBM_BW
    nvlink = rec["collective_wire_bytes_nvlink"] / NVLINK_BW
    ib = rec["collective_wire_bytes_ib"] / IB_BW
    coll = nvlink + ib
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    useful = model_flops_per_device(arch, shape, mesh, rec.get("mode", "train"))
    step = max(terms.values())
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "mode": rec.get("mode"),
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "collective_nvlink_s": nvlink, "collective_ib_s": ib,
        "dominant": dominant,
        "model_flops_per_dev": useful,
        "traced_flops_per_dev": flops,
        "useful_ratio": useful / max(flops, 1.0),
        "peak_gb": rec["peak_bytes"] / 1e9,
        "fits_hbm": rec["peak_bytes"] <= HBM_BYTES,
        # roofline fraction: useful flops time over the actual bound
        "roofline_fraction": (useful / PEAK_FLOPS) / step if step else 0.0,
    }


def build_table(results_dir: str, mesh: str = "single") -> list[dict]:
    rows = []
    for rec in load_records(results_dir):
        if not rec.get("ok") or rec["mesh"] != mesh:
            continue
        rows.append(roofline_row(rec))
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    return rows


def fmt_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'md':3s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'coll_s':>10s} {'dom':>10s} {'useful%':>8s} "
           f"{'roofl%':>7s} {'peakGB':>7s} {'fits':>5s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mode'][:3]:3s} "
            f"{r['compute_s']:10.4f} {r['memory_s']:10.4f} "
            f"{r['collective_s']:10.4f} {r['dominant']:>10s} "
            f"{100*r['useful_ratio']:8.1f} {100*r['roofline_fraction']:7.1f} "
            f"{r['peak_gb']:7.2f} {str(r['fits_hbm'])[:5]:>5s}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="roofline table of the dry-run "
                                 "records (H100 SXM figures)")
    ap.add_argument("--results", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json-out", default="results/roofline_torch.json")
    args = ap.parse_args(argv)
    rows = build_table(args.results, args.mesh)
    print(fmt_table(rows))
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\nwrote {args.json_out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
