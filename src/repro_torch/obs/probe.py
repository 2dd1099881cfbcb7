"""Host-phase timers + counters: the probe half of the telemetry layer.

The counterpart of ``repro.obs.probe``. A :class:`Probe` carries the three
per-run telemetry surfaces:

* **spans** — ``with probe.span("broker.dispatch"): ...`` wall-clock
  phase timers with *exclusive* (self-time) accounting: a span's self
  time is its inclusive wall time minus the inclusive time of the spans
  nested inside it, so the per-phase self times are a partition of
  measured wall and always sum to <= the run's total wall clock.
* **counters** — ``probe.count("plan_cache.keep")`` monotonic integer
  counters, plus ``probe.event(name, sim_t)`` which counts one DES
  event (``event.<KIND>``) and, in trace mode, records a sim-time
  instant in the Chrome trace.
* **attachments** — an optional :class:`~repro_torch.obs.series.GridSampler`
  (sim-time ring-buffer series) and
  :class:`~repro_torch.obs.trace.TraceWriter` (Chrome trace export), owned
  here so the simulator holds exactly one telemetry handle.

CUDA work is asynchronous: a launch returns before the card has run it.
A probe made for a simulator on a CUDA device therefore takes a ``sync``
callable (the synchronize of the stream the engine's kernels and copies
run on) and calls it as each span opens and closes and before the run's
wall clock is stamped, so the device time of the work a phase issued is
charged to that phase, not to whichever later span first reads back to
the host.

The probe is *observation-only by construction*: it never holds a
reference to the simulator and none of its methods take mutable engine
state (``GridSampler.sample(sim)`` reads through the sim argument).

Zero-overhead-when-disabled contract: the simulator stores ``None``
instead of a probe when ``obs="off"``, so the engine hot paths pay one
``is None`` check and nothing else (no device synchronisation either);
this module is only imported, never entered.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable, Optional

if TYPE_CHECKING:                      # imports for annotations only
    from .report import TelemetryReport
    from .series import GridSampler
    from .trace import TraceWriter

#: ``obs=`` engine-flag vocabulary, weakest to strongest. Each mode is a
#: superset of the previous one:
#:
#: * ``"off"``     — no probe at all (the default; hot paths pay one
#:                   ``is None`` check).
#: * ``"report"``  — host-phase span timers + counters, aggregated into a
#:                   :class:`~repro_torch.obs.report.TelemetryReport`.
#: * ``"series"``  — report + sim-time ring-buffer samplers driven by the
#:                   periodic OBS event (link/SE/queue utilization).
#: * ``"trace"``   — series + Chrome trace-event export (host-phase spans
#:                   on a wall-clock track, DES events on a sim-time
#:                   track) and a JSONL event log.
OBS_MODES = ("off", "report", "series", "trace")

#: Default sim-seconds between OBS sampling events (series/trace modes).
#: One sample per ~5 simulated minutes keeps a paper-baseline run (~30 k
#: sim-seconds) at ~100 rows and a grid_500 run (~1.5 M sim-seconds) well
#: inside the default ring capacity.
DEFAULT_OBS_INTERVAL_S = 300.0


class _Span:
    """One active ``probe.span(name)`` context. Exclusive-time
    bookkeeping: ``child_s`` accumulates the *inclusive* seconds of
    directly nested spans, so on exit ``inclusive - child_s`` is this
    span's self time."""

    __slots__ = ("probe", "name", "t0", "child_s")

    def __init__(self, probe: "Probe", name: str) -> None:
        self.probe = probe
        self.name = name
        self.t0 = 0.0
        self.child_s = 0.0

    def __enter__(self) -> "_Span":
        p = self.probe
        if p.sync is not None:
            p.sync()          # work issued before the span is not its own
        self.t0 = time.perf_counter()
        p._stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        p = self.probe
        if p.sync is not None:
            p.sync()          # the device work this span issued
        incl = time.perf_counter() - self.t0
        p._stack.pop()
        name = self.name
        p.phase_self_s[name] = (p.phase_self_s.get(name, 0.0)
                                + incl - self.child_s)
        p.phase_total_s[name] = p.phase_total_s.get(name, 0.0) + incl
        p.phase_calls[name] = p.phase_calls.get(name, 0) + 1
        if p._stack:
            p._stack[-1].child_s += incl
        if p.trace is not None:
            p.trace.add_span(name, self.t0 - p._t0, incl)


class Probe:
    """Per-run telemetry collector (see module doc).

    Spans may nest arbitrarily; re-entering the same name recursively is
    allowed (each activation is its own :class:`_Span`). The probe is
    single-threaded by design — the DES engine is. ``sync``, when given,
    waits for the device the simulator runs on (see module doc).
    """

    def __init__(self, mode: str, *,
                 sampler: Optional["GridSampler"] = None,
                 trace: Optional["TraceWriter"] = None,
                 sync: Optional[Callable[[], None]] = None) -> None:
        if mode not in OBS_MODES or mode == "off":
            raise ValueError(f"Probe mode must be an enabled OBS mode, "
                             f"got {mode!r} (want one of {OBS_MODES[1:]})")
        self.mode = mode
        self.sampler = sampler
        self.trace = trace
        self.sync = sync
        self.counters: dict[str, int] = {}
        self.phase_self_s: dict[str, float] = {}
        self.phase_total_s: dict[str, float] = {}
        self.phase_calls: dict[str, int] = {}
        self._stack: list[_Span] = []
        self._t0 = time.perf_counter()
        self.wall_s = 0.0

    # -- recording ---------------------------------------------------------
    def span(self, name: str) -> _Span:
        """Context manager timing one phase activation."""
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Bump a monotonic counter."""
        self.counters[name] = self.counters.get(name, 0) + n

    def event(self, kind_name: str, sim_t: float) -> None:
        """Record one handled DES event: bumps ``event.<KIND>`` and, in
        trace mode, adds a sim-time instant to the Chrome trace."""
        key = "event." + kind_name
        self.counters[key] = self.counters.get(key, 0) + 1
        if self.trace is not None:
            self.trace.add_instant(kind_name, sim_t)

    def merge_counters(self, prefix: str, values: dict) -> None:
        """Fold an engine-owned counter dict (e.g. ``NetworkEngine.stats``)
        into the probe under ``prefix.<key>`` names."""
        for k in sorted(values):
            key = f"{prefix}.{k}"
            self.counters[key] = self.counters.get(key, 0) + int(values[k])

    # -- lifecycle ---------------------------------------------------------
    def elapsed_us(self, name: str) -> float:
        """Total *inclusive* microseconds spent in phase ``name``."""
        return self.phase_total_s.get(name, 0.0) * 1e6

    def finalize(self, *, net_stats: dict | None = None) -> "TelemetryReport":
        """Stamp the run's wall clock (after the device has finished) and
        build the :class:`~repro_torch.obs.report.TelemetryReport`.
        Idempotent on the timing state (wall advances monotonically if
        called twice)."""
        from .report import TelemetryReport  # deferred: report imports probe
        if self.sync is not None:
            self.sync()
        self.wall_s = time.perf_counter() - self._t0
        series = None
        if self.sampler is not None:
            series = self.sampler.arrays()
        return TelemetryReport(
            mode=self.mode,
            wall_s=self.wall_s,
            phase_self_s=dict(self.phase_self_s),
            phase_total_s=dict(self.phase_total_s),
            phase_calls=dict(self.phase_calls),
            counters=dict(self.counters),
            net_stats=dict(net_stats or {}),
            series=series,
            n_samples=0 if self.sampler is None else self.sampler.n_total,
            trace=self.trace,
            dropped_trace_events=(0 if self.trace is None
                                  else self.trace.dropped),
        )

    def __deepcopy__(self, memo: dict) -> None:
        """Deep copies drop the probe (-> ``None``): the tie-race
        sanitizer's twin engines replay instants for *comparison* and
        must not double-count events into the primary's telemetry —
        the same convention as the catalog/storage ``__deepcopy__``
        contracts dropping listeners."""
        return None


def make_probe(mode: str, *,
               series_capacity: int = 8192,
               trace_max_events: int = 1_000_000,
               sync: Optional[Callable[[], None]] = None) -> Optional[Probe]:
    """Build the probe for an ``obs=`` mode (``None`` for ``"off"``).

    ``"report"`` is timers + counters only; ``"series"`` attaches the
    ring-buffer :class:`~repro_torch.obs.series.GridSampler`; ``"trace"``
    additionally attaches a :class:`~repro_torch.obs.trace.TraceWriter`.
    ``sync`` waits for the simulator's CUDA device (``None`` on the CPU);
    with ``"off"`` it is never called.
    """
    if mode not in OBS_MODES:
        raise ValueError(f"unknown obs mode {mode!r} "
                         f"(want one of {OBS_MODES})")
    if mode == "off":
        return None
    sampler = None
    trace = None
    if mode in ("series", "trace"):
        from .series import GridSampler
        sampler = GridSampler(capacity=series_capacity)
    if mode == "trace":
        from .trace import TraceWriter
        trace = TraceWriter(max_events=trace_max_events)
    return Probe(mode, sampler=sampler, trace=trace, sync=sync)
