"""Where the flash attention backward's device time goes, by ablation.

    PYTHONPATH=src python dev/ablate_bwd.py [--rounds 2]

Builds ``csrc/flash_attention_bwd.cu`` as it is and in variants that each
take one part out of both product kernels (the score products S and dP,
the output products dV, dK and dQ, the elementwise pass that makes P and
dS, dK/dV's sum across the cluster, or all four at once), swaps each
build in behind ``flash_attention_bwd_kernel`` and times it at the
training path's backward shapes: gemma3-1b's global and local layers and
gemma2-27b's heads with a softcap. A variant computes wrong gradients;
only its time means anything: what the full build's time drops by when a
part goes is that part's share of the critical path. Times are device
times of one call (50 calls replayed from a CUDA graph between CUDA
events, median of 20 replays) and each kernel's time a launch from
``torch.profiler``, for every build in turn, forward then backward, for
``--rounds`` rounds. Needs a CUDA card and ``nvcc``; nothing is built at
import.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import flash_attention_lse_ref
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_kernel

SOURCE = _cuda.CSRC / "flash_attention_bwd.cu"
#: name, B, H, KV, S, hd, window, softcap (chip_smoke.py's BWD_CASES)
CASES = (
    ("gemma3-1b global", 4, 4, 1, 1024, 256, None, None),
    ("gemma3-1b local", 4, 4, 1, 1024, 256, 512, None),
    ("gemma2-27b softcap", 4, 32, 16, 512, 128, None, 50.0),
)
#: a product that is not issued, in place of wgmma_bf16
_SKIP = """
template <int N, int TB>
__device__ inline void skip_product(float (&)[N / 2], uint64_t, uint64_t,
                                    int) {}
"""
#: each part's edits of the source: (text, replacement, occurrences)
PARTS = {
    "scores": [("wgmma_bf16<C::kNS, 0>(", "skip_product<C::kNS, 0>(", 4)],
    "outputs": [("wgmma_bf16<C::kND, 1>(", "skip_product<C::kND, 1>(", 3)],
    "elementwise": [
        ("cst.prob(st[e], lse2, &gs[e])", "(gs[e] = 1.f, st[e] + lse2)", 1),
        ("cst.prob(sc[e], lse2[half], &gs[e])",
         "(gs[e] = 1.f, sc[e] + lse2[half])", 1)],
    "cluster_sum": [("idx0 = rank * C::kCons + threadIdx.x;",
                     "idx0 = rank * C::kCons + threadIdx.x + kTotal;", 1)],
}
VARIANTS = {"full": (), "no_scores": ("scores",),
            "no_outputs": ("outputs",), "no_elementwise": ("elementwise",),
            "no_cluster_sum": ("cluster_sum",),
            "skeleton": ("scores", "outputs", "elementwise", "cluster_sum")}


def variant_source(parts) -> str:
    """The backward's source with ``parts`` taken out."""
    src = SOURCE.read_text()
    anchor = "using T = __nv_bfloat16;\n"
    src = src.replace(anchor, anchor + _SKIP, 1)
    for part in parts:
        for old, new, count in PARTS[part]:
            if src.count(old) != count:
                raise RuntimeError(f"ablate_bwd: {old!r} occurs "
                                   f"{src.count(old)} times in {SOURCE.name}, "
                                   f"want {count}: update PARTS")
            src = src.replace(old, new)
    return src


def build(names) -> dict:
    """Compile every variant in ``names`` at once; returns each one's C entry
    point."""
    out_dir = _cuda.BUILD_DIR / "ablate_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(VARIANTS[name]))
        lib = out_dir / f"lib{name}.so"
        cmd = [_cuda._nvcc(), *_cuda.nvcc_flags("flash_attention_bwd"), "-I",
               str(_cuda.CSRC), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    symbol, argtypes = _cuda._SIGNATURES["flash_attention_bwd"]
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablate_bwd: {name} failed to build\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _inputs(case, dev, rng):
    _, B, H, KV, S, hd, window, cap = case
    t = lambda n: torch.tensor(  # noqa: E731
        rng.standard_normal((B, S, n, hd), np.float32),
        device=dev).bfloat16().transpose(1, 2)
    q, k, v, do = t(H), t(KV), t(KV), t(H)
    kw = dict(causal=True, window=window, softcap=cap)
    _, lse, o = flash_attention_lse_ref(q, k, v, **kw)
    return (q, k, v, o, lse, do), kw


def device_us(fn, rounds: int = 20, calls: int = 50) -> float:
    """Device µs of one ``fn()``: ``calls`` calls in one CUDA graph between
    CUDA events, median over ``rounds`` replays."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(1e3 * start.elapsed_time(stop) / calls)
    return statistics.median(times)


def kernel_us(fn, calls: int = 20) -> dict:
    """Each kernel's µs a launch under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)", e.key)
        if e.device_type == DeviceType.CUDA and m and e.count:
            out[m.group(1)] = e.self_device_time_total / e.count
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="write the times as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_bwd: needs a CUDA card")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    fns = build(VARIANTS)
    print(f"[ablate_bwd] built {len(fns)} variants in "
          f"{time.perf_counter() - t0:.1f}s; {torch.cuda.get_device_name(0)}")
    rng = np.random.default_rng(17)
    cases = [(case[0], *_inputs(case, dev, rng)) for case in CASES]
    saved = _cuda._loaded.get("flash_attention_bwd")
    runs: dict = {}
    try:
        for r in range(args.rounds):
            order = list(fns) if r % 2 == 0 else list(fns)[::-1]
            for name in order:
                _cuda._loaded["flash_attention_bwd"] = fns[name]
                for label, call_args, kw in cases:
                    call = lambda: flash_attention_bwd_kernel(  # noqa: E731
                        *call_args, **kw)
                    us, split = device_us(call), kernel_us(call)
                    runs.setdefault(name, {}).setdefault(label, []).append(
                        {"us": us, "kernels_us": split})
                    print(f"[ablate_bwd] {name} {label}: {us!r} us, by "
                          f"kernel {split}", flush=True)
    finally:
        if saved is None:
            _cuda._loaded.pop("flash_attention_bwd", None)
        else:
            _cuda._loaded["flash_attention_bwd"] = saved
    for name, by_case in runs.items():
        for label, rs in by_case.items():
            print(f"[ablate_bwd] summary {name} {label}: "
                  f"{[r['us'] for r in rs]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
