"""End-to-end run: train a ~100M-param gemma3-family model for a few
hundred steps with the full substrate — grid-placed data shards (HRS),
checkpointing, and the fault-tolerant supervisor (the port's copy of
``examples/train_small_grid.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_small_grid \\
        --steps 200 [--fail-at 60] [--device cpu]

The model is gemma3-1b's family cut to 12 layers of width 640 with head
dim 80, so both flash attention kernels run at hd 80 on the card. The
pieces are ``repro_torch.launch.train``'s (``build``, ``make_step_fn``):
32 shards on the two-pod grid, two microbatches a step, AdamW at 3e-4
after 20 warm-up steps. Unlike the reference's run, which raises on a
failure before its first checkpoint (step 25), the initial state is
checkpointed as step 0, so any ``--fail-at`` restarts.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

from ..checkpoint.ckpt import save_checkpoint
from ..configs import get_config
from ..device import resolve_device
from ..fault.failures import FailurePlan, TrainingSupervisor
from ..launch import train as launch_train
from ..models.model import count_params_analytic

CKPT_EVERY = 25
MICROBATCHES, N_SHARDS, WARMUP_STEPS = 2, 32, 20


def make_100m_config():
    """gemma3 family at ~100M params (12 layers, d=640, vocab 32k)."""
    cfg = get_config("gemma3-1b")
    return dataclasses.replace(
        cfg, n_layers=12, d_model=640, n_heads=8, n_kv_heads=2, d_ff=2560,
        head_dim=80, vocab=32000, local_window=256,
        layer_pattern=("attn_local",) * 5 + ("attn",))


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
          fail_at: int | None, device="cuda", on_step=None) -> dict:
    """``steps`` steps of ``cfg`` under the supervisor, a checkpoint every
    ``CKPT_EVERY`` steps (and of the initial state) in ``ckpt_dir``, a
    node failure injected at ``fail_at``. ``on_step(step, state)``, when
    given, sees the state after each step run. Returns the history, the
    supervisor's counts and the grid's transfers."""
    run = launch_train.build(cfg, batch=batch, seq=seq, steps=steps,
                             microbatches=MICROBATCHES, device=device,
                             n_shards=N_SHARDS, warmup_steps=WARMUP_STEPS)
    step_fn = launch_train.make_step_fn(
        run["train_step"], run["loader"].next_batch, run["device"], cfg=cfg)
    if on_step is not None:
        inner = step_fn

        def step_fn(state, i):
            result = inner(state, i)
            on_step(i, result[0])
            return result

    state = (run["params"], run["opt"])
    del run["params"], run["opt"]
    save_checkpoint(state, ckpt_dir, 0)
    plan = FailurePlan(fail_at_steps=(fail_at,) if fail_at else ())
    sup = TrainingSupervisor(step_fn, ckpt_dir, ckpt_every=CKPT_EVERY,
                             plan=plan)
    state, hist = sup.run(state, steps)
    grid = run["grid"]
    return {"state": state, "history": hist,
            "restarts": sup.stats.restarts,
            "steps_wasted": sup.stats.steps_wasted,
            "steps_run": sup.stats.steps_run,
            "stragglers_mitigated": sup.stats.stragglers_mitigated,
            "grid": {"transfers": len(grid.transfers),
                     "inter_comms": grid.inter_comm_count(),
                     "wan_bytes": grid.wan_bytes(),
                     "lan_bytes": grid.lan_bytes()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_100m_config()
    n_params = count_params_analytic(cfg)
    print(f"model: {cfg.name}-100m ~{n_params/1e6:.0f}M params")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="grid_train_")
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=ckpt_dir, fail_at=args.fail_at, device=dev)
    hist = out["history"]
    for h in hist[:: max(1, len(hist) // 10)]:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.2f}  lr {h['lr']:.2e}")
    print(f"\nfinal loss: {hist[-1]['loss']:.4f} "
          f"(first {hist[0]['loss']:.4f})")
    print(f"restarts: {out['restarts']}, wasted steps: "
          f"{out['steps_wasted']}")
    g = out["grid"]
    print(f"grid: {g['transfers']} transfers, {g['inter_comms']} inter-pod, "
          f"WAN {g['wan_bytes']/1e9:.1f} GB / LAN {g['lan_bytes']/1e9:.1f} GB")
    print(f"checkpoints in {ckpt_dir}")
    del out["state"]
    return {**out, "ckpt_dir": ckpt_dir, "params": n_params}


if __name__ == "__main__":
    main()
