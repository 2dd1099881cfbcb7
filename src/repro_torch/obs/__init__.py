"""repro_torch.obs — phase-timed, trace-exporting telemetry for the simulator.

The counterpart of ``repro.obs``. The simulator is instrumented with
:class:`~repro_torch.obs.probe.Probe` spans and counters under the
reference's names; ``obs=`` engine flags (plumbed like ``net=``/``econ=``
through ``GridSimulator``, ``run_experiment``, ``ScenarioSpec``,
``launch/experiments.py`` and ``launch/simulate.py``) select how much is
collected:

========  ============================================================
mode      collects
========  ============================================================
off       nothing — hot paths pay a single ``is None`` check (default)
report    host-phase timers + counters -> :class:`TelemetryReport`
series    report + sim-time ring-buffer channels (periodic OBS event)
trace     series + Chrome trace (Perfetto) JSON and JSONL event log
========  ============================================================

The layer is observation-only: enabling any mode leaves every metric
bit-identical, on the CPU and on the card. On the card each span waits
for the device as it opens and closes (:mod:`repro_torch.obs.probe`).
"""

from .probe import (DEFAULT_OBS_INTERVAL_S, OBS_MODES, Probe, make_probe)
from .report import (DISPATCH_PHASES, FLUSH_PHASES, PLAN_PHASES,
                     TelemetryReport)
from .series import CHANNELS, GridSampler, RingBuffer
from .trace import TraceWriter

__all__ = [
    "CHANNELS",
    "DEFAULT_OBS_INTERVAL_S",
    "DISPATCH_PHASES",
    "FLUSH_PHASES",
    "GridSampler",
    "OBS_MODES",
    "PLAN_PHASES",
    "Probe",
    "RingBuffer",
    "TelemetryReport",
    "TraceWriter",
    "make_probe",
]
