"""Structured trace export: Chrome trace-event JSON + JSONL event log.

The counterpart of ``repro.obs.trace``. :class:`TraceWriter` accumulates
trace events in the Chrome trace-event format (the ``{"traceEvents":
[...]}`` JSON object array flavor), which loads directly in Perfetto
(https://ui.perfetto.dev) and legacy ``chrome://tracing``. Two tracks
keep host time and sim time apart:

* **pid 1 "host"** — ``"ph": "X"`` complete events for host-phase spans
  (``broker.dispatch``, ``net.flush`` …). Timestamps are microseconds of
  wall clock relative to probe creation, durations are the span's
  inclusive wall time.
* **pid 2 "sim"** — ``"ph": "i"`` instant events, one per handled DES
  event (SUBMIT, NET, CPU_DONE …). Timestamps are *simulated* seconds
  rendered as microseconds, so one trace-viewer microsecond reads as one
  sim second on this track.

Event volume is bounded by ``max_events``; overflow increments
:attr:`TraceWriter.dropped` instead of growing without limit (the count
is surfaced on the TelemetryReport). The same event list serializes to a
line-per-event JSONL log via :meth:`save_jsonl` for ``jq``-style
post-processing.
"""

from __future__ import annotations

import json

PID_HOST = 1
PID_SIM = 2


class TraceWriter:
    """Bounded in-memory Chrome trace-event accumulator."""

    def __init__(self, max_events: int = 1_000_000) -> None:
        if max_events <= 0:
            raise ValueError(f"max_events must be > 0, got {max_events}")
        self.max_events = int(max_events)
        self.dropped = 0
        self.events: list[dict] = [
            {"ph": "M", "pid": PID_HOST, "tid": 0, "name": "process_name",
             "args": {"name": "host phases (wall us)"}},
            {"ph": "M", "pid": PID_SIM, "tid": 0, "name": "process_name",
             "args": {"name": "DES events (sim s as us)"}},
        ]
        self._meta = len(self.events)

    def __len__(self) -> int:
        return len(self.events) - self._meta

    def add_span(self, name: str, ts_s: float, dur_s: float) -> None:
        """Complete (``"X"``) host-phase event; wall seconds -> us."""
        if len(self) >= self.max_events:
            self.dropped += 1
            return
        self.events.append({
            "ph": "X", "pid": PID_HOST, "tid": 0, "name": name,
            "ts": round(ts_s * 1e6, 3), "dur": round(dur_s * 1e6, 3),
        })

    def add_instant(self, name: str, sim_t_s: float,
                    args: dict | None = None) -> None:
        """Instant (``"i"``) DES event on the sim-time track."""
        if len(self) >= self.max_events:
            self.dropped += 1
            return
        ev = {"ph": "i", "pid": PID_SIM, "tid": 0, "name": name,
              "ts": round(sim_t_s * 1e6, 3), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def to_dict(self) -> dict:
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def save(self, path) -> None:
        """Write the Perfetto-loadable trace JSON."""
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh)

    def save_jsonl(self, path) -> None:
        """Write one JSON object per line (metadata events excluded)."""
        with open(path, "w") as fh:
            for ev in self.events[self._meta:]:
                fh.write(json.dumps(ev))
                fh.write("\n")
