"""granite-moe-1b-a400m's first-step loss on each route (card only).

For parameter seeds 0-3, at full width and depth on ``chip_smoke.py``
phase 14 (c)'s batch (``TRAIN_B`` x ``TRAIN_S`` from the launcher's
loader), the loss of one step's forward on four routes: the kernels and
the plain route, with the weights in bf16 and in float32. Prints, a
route a line, the final hidden state's and the head's dtypes, the token
NLL (the chunks' float32 sums over the token count) and ``moe_aux``, then
how far each route's NLL lies from the float32 plain route's in units of
the NLL's float32 resolution (one ulp of a chunk sum over the tokens).
No test runs it.

    PYTHONPATH=src python dev/moe_first_loss.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train.optimizer import tree_map  # noqa: E402
from repro_torch.train.train_step import micro_loss  # noqa: E402


def main() -> None:
    dev = torch.device("cuda", 0)
    cfg = get_config("granite-moe-1b-a400m")
    print(cs.nvidia_smi())
    for seed in range(4):
        run = launch_train.build(cfg, batch=cs.TRAIN_B, seq=cs.TRAIN_S,
                                 steps=1, device=dev, seed=seed)
        batch, _ = run["loader"].next_batch()
        b = launch_train.family_batch(cfg, batch, device=dev)
        params = run.pop("params")
        run.pop("opt")
        p32 = tree_map(lambda t: t.float(), params)
        out = {}
        for label, p, backend in (("kernels bf16", params, "auto"),
                                  ("plain bf16", params, "plain"),
                                  ("kernels f32", p32, "auto"),
                                  ("plain f32", p32, "plain")):
            with torch.no_grad(), cs.watch_nll() as w:
                loss, m = micro_loss(cfg, run["tcfg"], p, b, backend=backend)
            nll = sum(float(c[2]) for c in w.calls) / sum(c[3] for c in
                                                          w.calls)
            big = max(abs(float(c[2])) for c in w.calls)
            quantum = float(np.spacing(np.float32(big))) / sum(
                c[3] for c in w.calls)
            out[label] = (nll, float(loss), float(m["moe_aux"]), quantum,
                          w.summary())
        ref = out["plain f32"][0]
        for label, (nll, loss, aux, q, summary) in out.items():
            print(f"seed {seed} {label}: {summary}; loss {loss!r} moe_aux "
                  f"{aux!r}; NLL - plain f32 NLL = {nll - ref!r} "
                  f"({(nll - ref) / q:+.1f} x the NLL's resolution {q!r})")
        del params, p32
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
