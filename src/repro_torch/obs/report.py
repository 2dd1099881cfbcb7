"""Per-run telemetry aggregate: :class:`TelemetryReport`.

The counterpart of ``repro.obs.report``. The report is what
``GridSimulator.run()`` hands back on ``SimResult`` (and
``run_experiment`` forwards on ``ExperimentResult``) when an ``obs=``
mode is enabled: frozen span totals, counters, the network engine's
kernel stats, the optional sim-time series, and the optional trace
writer. It is a plain data carrier — all measurement happened in
:mod:`repro_torch.obs.probe` — plus two conveniences:

* :meth:`TelemetryReport.phase_breakdown` buckets span *self* times into
  the four-way dispatch / strategy_plan / flush / other split. By
  construction the buckets partition ``wall_s`` exactly (``other`` is
  the remainder), which is what makes an "engine-bound vs planner-bound"
  claim measured rather than inferred.
* :meth:`TelemetryReport.to_dict` gives a JSON-safe projection (numpy
  series become lists; the trace is summarized, not embedded — use
  :meth:`save_trace` / :meth:`save_events_jsonl` for the full export).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    import numpy as np
    from .trace import TraceWriter

#: Span names feeding each bucket of :meth:`TelemetryReport.phase_breakdown`.
#: ``flush`` covers the whole network-engine surface — per-event rerates,
#: fused flush passes, and NET completion handling — because that is the
#: axis the numpy-vs-device engines trade against each other.
DISPATCH_PHASES = ("broker.dispatch",)
PLAN_PHASES = ("strategy.plan",)
FLUSH_PHASES = ("net.rerate", "net.flush", "net.events")


@dataclasses.dataclass
class TelemetryReport:
    """Aggregated telemetry for one simulator run (see module doc)."""

    mode: str                            # the obs= mode that produced it
    wall_s: float                        # probe-creation -> finalize wall
    phase_self_s: dict[str, float]       # exclusive seconds per span name
    phase_total_s: dict[str, float]      # inclusive seconds per span name
    phase_calls: dict[str, int]          # activations per span name
    counters: dict[str, int]             # probe counters (event.*, plan_cache.*, net.*)
    net_stats: dict[str, int]            # raw NetworkEngine.stats snapshot
    series: Optional[dict[str, "np.ndarray"]] = None   # sim-time channels
    n_samples: int = 0                   # OBS samples taken (may exceed ring)
    trace: Optional["TraceWriter"] = None
    dropped_trace_events: int = 0

    def phase_breakdown(self, wall_s: float | None = None) -> dict[str, float]:
        """Four-bucket wall partition: dispatch / strategy_plan / flush /
        other. ``wall_s`` defaults to the report's own wall clock; pass
        a caller-measured wall (e.g. a BENCH row's ``wall_s``) to
        partition that instead."""
        wall = self.wall_s if wall_s is None else wall_s
        dispatch = sum(self.phase_self_s.get(n, 0.0) for n in DISPATCH_PHASES)
        plan = sum(self.phase_self_s.get(n, 0.0) for n in PLAN_PHASES)
        flush = sum(self.phase_self_s.get(n, 0.0) for n in FLUSH_PHASES)
        other = wall - dispatch - plan - flush
        return {
            "dispatch_s": round(dispatch, 6),
            "strategy_plan_s": round(plan, 6),
            "flush_s": round(flush, 6),
            "other_s": round(other, 6),
        }

    def to_dict(self) -> dict:
        """JSON-safe projection (series as lists, trace summarized)."""
        d = {
            "mode": self.mode,
            "wall_s": round(self.wall_s, 6),
            "phase_self_s": {k: round(v, 6)
                             for k, v in sorted(self.phase_self_s.items())},
            "phase_total_s": {k: round(v, 6)
                              for k, v in sorted(self.phase_total_s.items())},
            "phase_calls": dict(sorted(self.phase_calls.items())),
            "counters": dict(sorted(self.counters.items())),
            "net_stats": dict(sorted(self.net_stats.items())),
            "phases": self.phase_breakdown(),
            "n_samples": self.n_samples,
        }
        if self.series is not None:
            d["series"] = {k: [float(x) for x in v]
                           for k, v in self.series.items()}
        if self.trace is not None:
            d["trace_events"] = len(self.trace)
            d["dropped_trace_events"] = self.dropped_trace_events
        return d

    def save_trace(self, path) -> None:
        """Write the Perfetto-loadable Chrome trace JSON (trace mode only)."""
        if self.trace is None:
            raise ValueError("no trace captured: run with obs='trace'")
        self.trace.save(path)

    def save_events_jsonl(self, path) -> None:
        """Write the line-per-event JSONL log (trace mode only)."""
        if self.trace is None:
            raise ValueError("no trace captured: run with obs='trace'")
        self.trace.save_jsonl(path)
