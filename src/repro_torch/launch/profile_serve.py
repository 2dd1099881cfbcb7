"""Where a serving run's time goes on the device.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        [--arch gemma3-1b] [--reduced] [--device cuda]

Builds the model of ``--arch`` from seeded weights and serves the serving
path's batch (4 requests of 1,024-token prompts) twice under
``torch.profiler``: once prefill only (no new token), once with 16 new
tokens, each after an unprofiled warm-up. For each window it prints the
wall time, the device's busy time (the sum of the CUDA kernels' durations:
one stream, so they do not overlap) and its share of the wall, and the
device time by kernel family (the two hand-written kernels, cuBLAS GEMMs,
everything else) and by kernel. The decode loop's share is the difference
of the two windows.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np

from ..configs.base import arch_ids, get_config
from ..device import resolve_device
from ..models import model as M
from ..serve.engine import ServeEngine

REQUESTS, PROMPT, NEW = 4, 1024, 16
#: (family, substrings of the kernel name), first match wins
FAMILIES = (("flash_attention", ("flash_kernel",)),
            ("selective_scan", ("scan_kernel",)),
            ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def window(engine: ServeEngine, tokens: np.ndarray, n_new: int,
           label: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = engine.device
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    engine.generate(tokens, n_new)                      # warm-up
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.generate(tokens, n_new)
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _, _ in rows)
    by_family: dict[str, float] = defaultdict(float)
    for t, key, _ in rows:
        by_family[family(key)] += t
    print(f"[profile] {engine.cfg.name} {label} wall_ms_under_profiler="
          f"{1e3 * wall!r} device_busy_ms={busy / 1e3!r} "
          f"busy_share={busy / 1e6 / wall:.4%}")
    for fam, t in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   family {fam:<16} device_ms={t / 1e3:10.3f} "
              f"share_of_busy={t / max(busy, 1e-9):7.2%}")
    for t, key, count in sorted(rows, reverse=True)[:10]:
        print(f"[profile]   kernel {key[:64]:<64} device_ms={t / 1e3:10.3f} "
              f"count={count}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=arch_ids(), default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    engine = ServeEngine(cfg, M.init_params(cfg, seed=0, device=dev),
                         max_len=PROMPT + NEW)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (REQUESTS, PROMPT)).astype(np.int32)
    window(engine, tokens, 0, "prefill")
    window(engine, tokens, NEW, f"prefill+{NEW} decode steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
