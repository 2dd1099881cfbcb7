"""Fault injection, for both the grid simulator and the training runtime
(the counterpart of ``repro.fault.failures``).

Two halves:

* **Grid side**: :func:`churn_schedule` expands a
  :class:`~repro_torch.core.scenarios.ChurnSpec` into deterministic site
  failure/recovery events for the discrete-event simulator. The scenario
  engine (:func:`repro_torch.core.scenarios.injections`) drives it to build
  the site-churn regimes.
* **Runtime side**: :class:`TrainingSupervisor` wraps a step function with
  checkpoint/restart, deterministic failure injection
  (:class:`FailurePlan`) and straggler re-issue. On real hardware the
  failure signal comes from the cluster manager; here the plan injects it
  so tests and ``chip_smoke.py`` can prove the recovery path end to end.
"""

from __future__ import annotations

import dataclasses
import random as _random
import time
from typing import TYPE_CHECKING, Any, Callable

import torch

from ..checkpoint.ckpt import latest_step, restore_checkpoint, save_checkpoint

if TYPE_CHECKING:                      # the spec's module imports this one
    from ..core.scenarios import ChurnSpec


def churn_schedule(spec: "ChurnSpec", n_sites: int,
                   seed: int = 0) -> list[tuple[int, float, float]]:
    """Expand a :class:`ChurnSpec` into ``(site, at, duration)`` tuples for
    :func:`repro_torch.core.run_experiment`'s ``failures`` argument.

    Failure times are evenly spaced over the window with a small jittered
    offset; sites are drawn without replacement until the pool is exhausted
    (then with replacement), so short schedules never hit one site twice.
    """
    if spec.n_failures <= 0:
        return []
    rng = _random.Random(seed ^ 0x5EED)
    start, end = spec.window
    span = max(0.0, end - start)
    pool = list(range(n_sites))
    rng.shuffle(pool)
    out = []
    for i in range(spec.n_failures):
        site = pool[i] if i < len(pool) else rng.randrange(n_sites)
        frac = (i + rng.random()) / spec.n_failures
        at = start + frac * span
        duration = rng.expovariate(1.0 / spec.mean_downtime_s)
        out.append((site, at, max(1.0, duration)))
    return out


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """fail_at_steps: steps at which a simulated node failure kills the run
    (state is lost, restart restores the latest checkpoint).
    slow_steps: steps that take ``straggle_factor`` x longer (straggler)."""

    fail_at_steps: tuple[int, ...] = ()
    slow_steps: tuple[int, ...] = ()
    straggle_factor: float = 5.0


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class SupervisorStats:
    restarts: int = 0
    steps_run: int = 0
    steps_wasted: int = 0
    stragglers_mitigated: int = 0


def _device_of(state) -> torch.device:
    """The device of the first tensor in ``state`` (the CPU if none)."""
    if isinstance(state, torch.Tensor):
        return state.device
    items = state.values() if isinstance(state, dict) else (
        state if isinstance(state, (list, tuple)) else ())
    for item in items:
        dev = _device_of(item)
        if dev.type != "cpu":
            return dev
    return torch.device("cpu")


class TrainingSupervisor:
    """Checkpoint/restart + straggler mitigation around a pure step fn.

    step_fn(state, step_idx) -> (state, metrics). ``state`` must be a
    checkpointable tree (params + opt state). Straggler mitigation is
    deadline-based re-issue: a step exceeding ``deadline x median`` is
    re-executed on the same input state (a functional step function makes
    the re-issue free of divergence; the backup result wins). A restore
    puts the state back on the device the running state was on.
    """

    def __init__(self, step_fn: Callable, ckpt_dir: str, *,
                 ckpt_every: int = 10, keep_last: int = 3,
                 plan: FailurePlan = FailurePlan(),
                 deadline: float = 4.0) -> None:
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.plan = plan
        self.deadline = deadline
        self.stats = SupervisorStats()
        self._durations: list[float] = []

    def _maybe_checkpoint(self, state, step: int) -> None:
        if step % self.ckpt_every == 0:
            save_checkpoint(state, self.ckpt_dir, step)

    def run(self, state, n_steps: int, *, start_step: int = 0):
        """Run to n_steps with recovery; returns (state, history)."""
        history: list[dict[str, Any]] = []
        step = start_step
        failed_already: set[int] = set()
        device = _device_of(state)
        while step < n_steps:
            try:
                if step in self.plan.fail_at_steps and step not in failed_already:
                    failed_already.add(step)
                    raise SimulatedFailure(f"node failure at step {step}")
                t0 = time.perf_counter()
                new_state, metrics = self.step_fn(state, step)
                dt = time.perf_counter() - t0
                if step in self.plan.slow_steps:
                    dt *= self.plan.straggle_factor     # simulated straggler
                med = sorted(self._durations)[len(self._durations) // 2] \
                    if self._durations else dt
                if self._durations and dt > self.deadline * med:
                    # re-issue the step (speculative backup wins)
                    new_state, metrics = self.step_fn(state, step)
                    self.stats.stragglers_mitigated += 1
                state = new_state
                self._durations.append(dt)
                history.append({"step": step, **{k: float(v)
                                                 for k, v in metrics.items()}})
                self.stats.steps_run += 1
                step += 1
                self._maybe_checkpoint(state, step)
            except SimulatedFailure:
                self.stats.restarts += 1
                last = latest_step(self.ckpt_dir)
                if last is None:
                    raise RuntimeError("failure before first checkpoint")
                state, _ = restore_checkpoint(self.ckpt_dir, last, like=state,
                                              device=device)
                self.stats.steps_wasted += step - last
                step = last
        return state, history
