"""Training launcher: ``--arch <id>`` selects a registered architecture
(the counterpart of ``repro.launch.train``).

Runs on the CUDA card unless ``--device cpu``. On the CPU use ``--reduced``
(the smoke-scale config); on the card gemma3-1b trains at full width (bf16
weights, float32 master, m and v: 16 bytes a parameter, 16 GB).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --reduced --device cpu --steps 20

Each step draws a batch from the grid-placed synthetic pipeline
(:mod:`repro_torch.data.pipeline`), makes it the family's batch
(:func:`family_batch`, as the reference's launcher: the encoder-decoder's
``seq`` frames and ``seq // 8`` decoder tokens, a VLM's patch
embeddings), moves it to the device and runs the functional train step
(:mod:`repro_torch.train.train_step`) under the checkpoint/restart
supervisor (:mod:`repro_torch.fault.failures`).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs.base import arch_ids, get_config
from ..core.topology import GridTopology
from ..data.pipeline import DataConfig, GridDataLoader, SyntheticShardedDataset
from ..device import resolve_device
from ..fault.failures import TrainingSupervisor
from ..grid.datagrid import DataGridService
from ..models.encdec import DEC_RATIO
from ..train.optimizer import OptimizerConfig
from ..train.train_step import (TrainConfig, check_trainable, init_train_state,
                                make_train_step)


def check_seq(cfg, seq: int) -> None:
    """Raise ``ValueError`` for a VLM whose ``seq`` is shorter than its
    ``vision_tokens`` patch embeddings (the reference fails there too)."""
    if cfg.vision_tokens and seq < cfg.vision_tokens:
        raise ValueError(f"seq {seq} is shorter than {cfg.name}'s "
                         f"vision_tokens {cfg.vision_tokens}")


def family_batch(cfg, batch: dict, *, device: "str | torch.device",
                 embeds: torch.Tensor | None = None) -> dict:
    """The reference launcher's batch for ``cfg``'s family, on ``device``,
    from a loader batch of (B, seq) ``tokens`` and ``labels``: for the
    encoder-decoder the tokens and labels cut to ``seq // 8`` and
    ``frames`` (B, seq, D); for a VLM ``vision_embeds`` (B,
    vision_tokens, D); else the batch as it is. The frames or patch
    embeddings are ``embeds`` when given, else bf16 ones, as the
    reference's."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    B, seq = out["tokens"].shape
    check_seq(cfg, seq)
    if cfg.enc_dec:
        key, shape = "frames", (B, seq, cfg.d_model)
        for name in ("tokens", "labels"):
            out[name] = out[name][:, :seq // DEC_RATIO]
    elif cfg.vision_tokens:
        key, shape = "vision_embeds", (B, cfg.vision_tokens, cfg.d_model)
    else:
        return out
    if embeds is None:
        embeds = torch.ones(shape, dtype=torch.bfloat16, device=dev)
    elif tuple(embeds.shape) != shape:
        raise ValueError(f"{key} {tuple(embeds.shape)}, want {shape}")
    out[key] = embeds.to(dev)
    return out


def build(cfg, *, batch: int, seq: int, steps: int, microbatches: int = 1,
          compress_grads: bool = False, device: "str | torch.device" = "cuda",
          seed: int = 0, n_shards: int = 16, warmup_steps: int = 10) -> dict:
    """The launcher's pieces: the grid (HRS, data-aware) and its loader
    over ``n_shards`` shards, seeded parameters and optimizer state on
    ``device``, and the train step (AdamW at 3e-4 after ``warmup_steps``,
    cosine to ``steps``). Raises for a config the port does not train
    (:func:`check_trainable`) and for a ``seq`` its family cannot take
    (:func:`check_seq`)."""
    check_trainable(cfg)
    check_seq(cfg, seq)
    dev = resolve_device(device)
    topo = GridTopology(2, 4, lan_bandwidth=50e9, wan_bandwidth=3.125e9,
                        storage_capacity=256e9)
    grid = DataGridService(topo)
    ds = SyntheticShardedDataset(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, n_shards=n_shards))
    tcfg = TrainConfig(
        n_microbatches=microbatches,
        opt=OptimizerConfig(peak_lr=3e-4, warmup_steps=warmup_steps,
                            total_steps=steps,
                            compress_grads=compress_grads))
    params, opt = init_train_state(cfg, seed=seed, device=dev,
                                   compress_grads=compress_grads)
    return {"grid": grid, "loader": GridDataLoader(ds, grid), "params": params,
            "opt": opt, "tcfg": tcfg, "device": dev,
            "train_step": make_train_step(cfg, tcfg)}


def make_step_fn(train_step, next_batch, device: torch.device, *, cfg=None,
                 embeds: torch.Tensor | None = None):
    """The supervisor's ``step_fn(state, i)``: ``next_batch()`` gives a
    numpy batch (``GridDataLoader.next_batch``), made ``cfg``'s family
    batch on ``device`` (:func:`family_batch`, with ``embeds``); without
    ``cfg`` the batch is moved as it is. The step reports the train
    step's metrics as they are (``loss``, ``grad_norm``, ``lr``, ...)."""

    def step_fn(state, i):
        p, o = state
        batch, _ = next_batch()
        b = (family_batch(cfg, batch, device=device, embeds=embeds)
             if cfg is not None else
             {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
        p, o, m = train_step(p, o, b)
        return (p, o), m

    return step_fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=arch_ids())
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab} reduced={args.reduced} device={args.device}")
    run = build(cfg, batch=args.batch, seq=args.seq, steps=args.steps,
                microbatches=args.microbatches,
                compress_grads=args.compress_grads, device=args.device)
    step_fn = make_step_fn(run["train_step"], run["loader"].next_batch,
                           run["device"], cfg=cfg)
    sup = TrainingSupervisor(step_fn, args.ckpt_dir,
                             ckpt_every=args.ckpt_every)
    t0 = time.perf_counter()
    state, hist = sup.run((run["params"], run["opt"]), args.steps)
    wall = time.perf_counter() - t0
    for h in hist[:: max(1, len(hist) // 8)]:
        print(f"step {h['step']:4d} loss {h['loss']:.4f}")
    print(f"done. final loss {hist[-1]['loss']:.4f}; "
          f"grid inter-pod={run['grid'].inter_comm_count()}; "
          f"wall_s={wall!r}")


if __name__ == "__main__":
    main()
