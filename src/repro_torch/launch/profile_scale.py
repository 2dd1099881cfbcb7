"""Where a scale run's time goes: per-layer host time and device time.

    PYTHONPATH=src python -m repro_torch.launch.profile_scale \\
        [--scenario grid_500_saturated] [--jobs 2000] [--device cuda] \\
        [--strategy-mode batch] [--trace-jobs 500]

Runs the scenario once with exclusive (self-time) timers wrapped around the
layers' entry methods — the batch brokers, the strategies (the batched
planner's burst pass and its device part), the replication economy, the
network engine's bandwidth queries, flush / completions / re-rate / slot
lifecycle — and prints each
layer's share of the wall time; what no timer covers is the event loop's
own bookkeeping. With ``--trace-jobs N`` > 0 it then runs N jobs under
``torch.profiler`` and prints the device's busy time (the sum of the CUDA
kernels' durations: one stream, so they do not overlap), busy time per
flush, the network kernels' launches beside the network calls (one
cluster launch per re-rate or flush), and the top device kernels and
host operators. The timers wrap
methods of this process only; the package is unchanged.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from collections import defaultdict

import torch

from repro_torch.core import (SCENARIOS, EconomicStrategy, HRSStrategy,
                              NetworkEngine, PredictiveStrategy,
                              ReplicationOptimizer)
from repro_torch.core.replica import _BatchedStrategy
from repro_torch.core.scheduler import DataAwareScheduler
from repro_torch.core.torchsched import (TorchScheduler,
                                         TorchShortestTransferBroker)
from repro_torch.device import resolve_device
from repro_torch.kernels import _cuda
from repro_torch.launch.experiments import device_name, run_spec

#: (class, method, layer) of every timed entry point
TIMED = (
    (TorchScheduler, "select_batch", "broker.select_batch"),
    (TorchShortestTransferBroker, "select_batch", "broker.select_batch"),
    (DataAwareScheduler, "select_site", "broker.select_site"),
    (HRSStrategy, "plan_fetch", "strategy.plan_fetch"),
    (EconomicStrategy, "plan_fetch", "strategy.plan_fetch"),
    (PredictiveStrategy, "plan_fetch", "strategy.plan_fetch"),
    (_BatchedStrategy, "plan_fetch", "strategy.plan_fetch"),
    (_BatchedStrategy, "plan_batch", "strategy.plan_batch"),
    (_BatchedStrategy, "_plan_on_device", "strategy.plan_on_device"),
    (ReplicationOptimizer, "step", "econ.step"),
    (ReplicationOptimizer, "value_matrix", "econ.value_matrix"),
    (NetworkEngine, "point_bandwidth_columns", "net.bandwidth_query"),
    (NetworkEngine, "point_bandwidth_matrix", "net.bandwidth_query"),
    (NetworkEngine, "flush", "net.flush"),
    (NetworkEngine, "completions", "net.completions"),
    (NetworkEngine, "rerate", "net.rerate"),
    (NetworkEngine, "advance", "net.advance"),
    (NetworkEngine, "alloc", "net.alloc_release"),
    (NetworkEngine, "release", "net.alloc_release"),
)


class ExclusiveTimers:
    """Self time per layer: a nested timed call's time is charged to it
    and subtracted from its caller, so the layers partition the time they
    cover."""

    def __init__(self) -> None:
        self.self_s: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self._stack: list[float] = []      # child time of each open call

    def wrap(self, layer: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                child = self._stack.pop()
                self.self_s[layer] += dt - child
                self.calls[layer] += 1
                if self._stack:
                    self._stack[-1] += dt
        return timed

    def install(self) -> list:
        saved = []
        for cls, name, layer in TIMED:
            fn = getattr(cls, name)
            saved.append((cls, name, fn))
            setattr(cls, name, self.wrap(layer, fn))
        return saved

    @staticmethod
    def uninstall(saved) -> None:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def layer_breakdown(spec, n_jobs: int, dev: torch.device) -> None:
    timers = ExclusiveTimers()
    saved = timers.install()
    try:
        _cuda.reset_launches()
        t0 = time.perf_counter()
        r = run_spec(spec, n_jobs=n_jobs, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        ExclusiveTimers.uninstall(saved)
    print(f"[layers] {spec.name} jobs={n_jobs} device={device_name(dev)} "
          f"wall_s={wall!r} completed={r.completed_jobs} "
          f"flush_passes={r.net_stats['flush_passes']} "
          f"launches={dict(_cuda.LAUNCHES)}")
    covered = 0.0
    for layer, s in sorted(timers.self_s.items(), key=lambda kv: -kv[1]):
        covered += s
        print(f"[layers]   {layer:<22} self_s={s:10.4f} "
              f"share={s / wall:7.2%} calls={timers.calls[layer]} "
              f"us_per_call={1e6 * s / timers.calls[layer]:.1f}")
    print(f"[layers]   {'other (event loop)':<22} self_s={wall - covered:10.4f} "
          f"share={(wall - covered) / wall:7.2%}")


def device_trace(spec, n_jobs: int, dev: torch.device) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r = run_spec(spec, n_jobs=n_jobs, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # device-side rows only (kernels, copies): a host operator's row
    # repeats the device time of the kernels it launched
    dev_rows = [(e.self_device_time_total, e.key, e.count) for e in rows
                if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in dev_rows)
    flushes = r.net_stats["flush_passes"]
    # network kernel calls: a flush each (net="device"), else a re-rate
    net_calls = flushes or r.net_stats["rerate_calls"]
    net_kernels = sum(c for _, key, c in dev_rows if "cluster_kernel" in key)
    print(f"[trace] {spec.name} jobs={n_jobs} device={device_name(dev)} "
          f"wall_s_under_profiler={wall!r} device_busy_s={busy_us / 1e6!r} "
          f"busy_share={busy_us / 1e6 / wall:.4%} flushes={flushes} "
          f"device_us_per_flush={busy_us / max(1, flushes):.2f} "
          f"net_calls={net_calls} network_kernel_launches={net_kernels} "
          f"device_ops={sum(c for _, _, c in dev_rows)}")
    for t, key, count in sorted(dev_rows, reverse=True)[:12]:
        print(f"[trace]   device {key[:60]:<60} total_us={t:12.1f} "
              f"count={count}")
    host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in rows
                   if e.device_type != DeviceType.CUDA), reverse=True)[:12]
    for t, key, count in host:
        print(f"[trace]   host   {key[:60]:<60} self_us={t:12.1f} "
              f"count={count}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="grid_500_saturated")
    ap.add_argument("--jobs", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--strategy-mode", default=None,
                    choices=("sequential", "batch"),
                    help="override the scenario's strategy_mode")
    ap.add_argument("--trace-jobs", type=int, default=0,
                    help="also run this many jobs under torch.profiler")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = SCENARIOS[args.scenario]
    if args.strategy_mode is not None:
        spec = dataclasses.replace(spec, strategy_mode=args.strategy_mode)
    layer_breakdown(spec, args.jobs, dev)
    if args.trace_jobs > 0:
        device_trace(spec, args.trace_jobs, dev)


if __name__ == "__main__":
    main()
