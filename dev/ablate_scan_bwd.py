"""Where the selective scan backward's device time goes, by ablation.

    PYTHONPATH=src python dev/ablate_scan_bwd.py [--rounds 2] [--out FILE]

Builds two designs of ``selective_scan_bwd`` — the first version, kept
beside this script in ``dev/scan_bwd_first/`` (its ``.cu`` and the
``selective_scan.cuh`` it was written against), and the current
``src/repro_torch/csrc`` — each as it is and in variants that each take
one part out (``PARTS``): the exponentials (the first version's second
one), the dB/dC sums over a warp's channels, the dx/ddt sums over a
channel's lanes, the copies of each round's inputs into shared memory;
for the first version a build forced to two 256-thread blocks an SM, for
the current one its a(t) history in shared memory and its second pass
through the first half of a round. A variant
computes wrong gradients; only its time means anything: what a design's
time drops by when a part goes is that part's share of its critical path.

Every build is swapped in behind ``selective_scan_bwd_kernel`` and timed
at falcon-mamba-7b's training layer (Bz 4, S 1,024, Di 8,192, N 16) in
float32 (``--dtypes`` adds bf16), in turns: every build once a round, the
order reversed on odd rounds, for ``--rounds`` rounds. A time is the
device time of one call (10 calls replayed from a CUDA graph between CUDA
events, median of 20 replays); beside it each kernel's µs a launch from
``torch.profiler`` and ptxas's registers and spills of the backward walk.
Needs a CUDA card and ``nvcc``; nothing is built at import.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.selective_scan import (round_states,
                                                selective_scan_kernel)
from repro_torch.kernels.selective_scan_bwd import selective_scan_bwd_kernel

HERE = Path(__file__).resolve().parent
#: design name -> the directory holding its selective_scan_bwd.cu and
#: selective_scan.cuh
DESIGNS = {"first": HERE / "scan_bwd_first", "current": _cuda.CSRC}
#: falcon-mamba-7b's training layer
SHAPE = (4, 1024, 8192, 16)
#: stand-ins the variants call in place of what they take out
_STUBS = """
__device__ inline void skip_granule(char*, const char*, int) {}
"""
#: each design's parts: name -> the edits of its .cu, (text, replacement,
#: occurrences)
PARTS = {
    "first": {
        # the walk back's exponential becomes one FMA
        "second_exp": [("const float av = exp2f(dtv * a2[j]);",
                        "const float av = dtv * a2[j] + 1.f;", 1)],
        "channel_sums": [
            ("channel_sum(dc, wl)", "((dc[0] + dc[1]) + (dc[2] + dc[3]))",
             1),
            ("channel_sum(db, wl)", "((db[0] + db[1]) + (db[2] + db[3]))",
             1)],
        "lane_sums": [("lane_sum2(gdotb * dtv, gdotb * xv + gpa, wl)",
                       "(gdotb * dtv + (gdotb * xv + gpa))", 1)],
        "copies": [("    copy_granule(", "    skip_granule(", 5)],
        "two_blocks": [("__launch_bounds__(kThreads)\n    scan_bwd_kernel",
                        "__launch_bounds__(kThreads, 2)\n    scan_bwd_kernel",
                        1)],
    },
    "current": {
        "exp": [("ex2_ftz(dtv * a2[j])", "(dtv * a2[j] + 1.f)", 1)],
        "channel_sums": [("channel_sum8(v, wl)",
                          "(((v[0] + v[1]) + (v[2] + v[3])) + "
                          "((v[4] + v[5]) + (v[6] + v[7])))", 1)],
        "lane_sums": [("lane_sum2(gdotb * dtv, gdotb * xv + kLn2 * gpa2, wl)",
                       "(gdotb * dtv + (gdotb * xv + kLn2 * gpa2))", 1)],
        "copies": [("    copy_granule(", "    skip_granule(", 7)],
        # the round's a(t) in shared memory: neither stored nor read back
        # (a register value in its place)
        "history": [("store_history(sm.hist, i, tid, av);", "", 1),
                    ("load_history(sm.hist, ", "load_history_skip(dtv, ", 2)],
        # the second forward pass through the first half of a round
        "recompute": [("if (i == kHalf - 1) {", "if (false) {", 1)],
    },
}
_HISTORY_STUB = """
__device__ inline void load_history_skip(float dtv, int i, int,
                                         float (&av)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) av[j] = dtv * (float)(i + j);
}
"""


def variants() -> dict:
    """Build name -> (design, parts): each design as it is, with each part
    out, and with every part but the forced occupancy out."""
    out = {}
    for design, parts in PARTS.items():
        out[design] = (design, ())
        for part in parts:
            label = part if part == "two_blocks" else f"no_{part}"
            out[f"{design}-{label}"] = (design, (part,))
        out[f"{design}-skeleton"] = (design, tuple(
            p for p in parts if p != "two_blocks"))
    return out


def variant_source(design: str, parts) -> str:
    """``design``'s backward source with ``parts`` taken out."""
    src = (DESIGNS[design] / "selective_scan_bwd.cu").read_text()
    anchor = '#include "selective_scan.cuh"\n\nnamespace {\n'
    if anchor not in src:
        raise RuntimeError(f"ablate_scan_bwd: no {anchor!r} in {design}")
    stubs = _STUBS + (_HISTORY_STUB if design == "current" else "")
    src = src.replace(anchor, anchor + stubs, 1)
    for part in parts:
        for old, new, count in PARTS[design][part]:
            if src.count(old) != count:
                raise RuntimeError(f"ablate_scan_bwd: {old!r} occurs "
                                   f"{src.count(old)} times in {design}, "
                                   f"want {count}: update PARTS")
            src = src.replace(old, new)
    return src


def ptxas(log: str) -> dict:
    """ptxas's registers and spill stores of each backward walk kernel."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out.setdefault(fn, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "scan_bwd_kernel" in k}


def build(names: dict) -> tuple[dict, dict]:
    """Compile every build at once; returns each one's C entry point and
    its ptxas report."""
    root = _cuda.BUILD_DIR / "ablate_scan_bwd"
    procs = {}
    for name, (design, parts) in names.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(DESIGNS[design] / "selective_scan.cuh", d)
        src = d / "selective_scan_bwd.cu"
        src.write_text(variant_source(design, parts))
        lib = d / "libselective_scan_bwd.so"
        cmd = [_cuda._nvcc(), *_cuda.nvcc_flags("selective_scan_bwd"), "-I",
               str(d), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    symbol, argtypes = _cuda._SIGNATURES["selective_scan_bwd"]
    fns, logs = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablate_scan_bwd: {name} failed to build\n"
                               f"{log}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name], logs[name] = fn, ptxas(log)
    return fns, logs


def inputs(dtype, dev, seed: int = 19) -> tuple:
    """The scan's inputs at ``SHAPE`` (nonzero h0), the forward's round
    states, dy and dh_last."""
    Bz, S, Di, N = SHAPE
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    t = lambda a, d=torch.float32: torch.tensor(  # noqa: E731
        a, device=dev).to(d)
    dt = (np.log1p(np.exp(n(Bz, S, Di))) * 0.1).astype(np.float32)
    args = (t(n(Bz, S, Di), dtype), t(dt, dtype), t(n(Bz, S, N), dtype),
            t(n(Bz, S, N), dtype), t(-np.exp(n(Di, N) * 0.3)), t(n(Di)),
            t(n(Bz, Di, N)))
    states = round_states(args[0], args[6])
    selective_scan_kernel(*args, states)
    return args, states, t(n(Bz, S, Di), dtype), t(n(Bz, Di, N))


def device_us(fn, rounds: int = 20, calls: int = 10) -> float:
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


def kernel_us(fn, calls: int = 10) -> dict:
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
        m = re.search(r"(scan_bwd\w*_kernel)", e.key)
        if e.device_type == DeviceType.CUDA and m and e.count:
            out[m.group(1)] = e.self_device_time_total / e.count
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dtypes", nargs="+", default=["float32"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--designs", nargs="+", default=list(DESIGNS),
                    choices=list(DESIGNS))
    ap.add_argument("--whole", action="store_true",
                    help="build each design whole only, no part taken out")
    ap.add_argument("--extra", nargs="*", default=[], metavar="NAME=DIR",
                    help="also time, whole, the design whose "
                         "selective_scan_bwd.cu and selective_scan.cuh "
                         "lie in DIR")
    ap.add_argument("--out", help="write the times as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_scan_bwd: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    _cuda.build(("selective_scan",))
    names = {k: v for k, v in variants().items()
             if v[0] in args.designs and not (args.whole and v[1])}
    for extra in args.extra:
        name, path = extra.split("=", 1)
        DESIGNS[name] = Path(path).resolve()
        names[name] = (name, ())
    fns, logs = build(names)
    print(f"[ablate_scan_bwd] built {len(fns)} variants in "
          f"{time.perf_counter() - t0:.1f}s; {smi}", flush=True)
    for name in fns:
        print(f"[ablate_scan_bwd] ptxas {name}: {logs[name]}", flush=True)
    saved = _cuda._loaded.get("selective_scan_bwd")
    runs: dict = {}
    try:
        for dtype in args.dtypes:
            call_args = inputs(getattr(torch, dtype), dev)
            call = lambda: selective_scan_bwd_kernel(  # noqa: E731
                *call_args[0], *call_args[1:])
            for r in range(args.rounds):
                order = list(fns) if r % 2 == 0 else list(fns)[::-1]
                for name in order:
                    _cuda._loaded["selective_scan_bwd"] = fns[name]
                    us, split = device_us(call), kernel_us(call)
                    runs.setdefault(dtype, {}).setdefault(name, []).append(
                        {"us": us, "kernels_us": split})
                    print(f"[ablate_scan_bwd] {dtype} {name}: {us!r} us, by "
                          f"kernel {split}", flush=True)
            del call_args
            torch.cuda.empty_cache()
    finally:
        if saved is None:
            _cuda._loaded.pop("selective_scan_bwd", None)
        else:
            _cuda._loaded["selective_scan_bwd"] = saved
    for dtype, by_name in runs.items():
        for name, rs in by_name.items():
            print(f"[ablate_scan_bwd] summary {dtype} {name}: "
                  f"{[r['us'] for r in rs]} (median "
                  f"{statistics.median(r['us'] for r in rs)!r})")
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "shape": SHAPE, "ptxas": logs,
                       "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
