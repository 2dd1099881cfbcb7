"""Sim-time telemetry series: ring buffers fed by the periodic OBS event.

The counterpart of ``repro.obs.series``. The simulator arms a periodic ``OBS`` event (mirroring the ECON auction
clock) whose handler calls :meth:`GridSampler.sample` with the live
engine. Each call appends one row of grid-state channels — link
utilization, SE occupancy, queue depths, cumulative WAN/LAN bytes,
replica hit/miss totals — into a fixed-capacity :class:`RingBuffer`, so
telemetry memory is O(capacity) regardless of run length. The arrays are
queryable per channel as numpy vectors (:meth:`GridSampler.arrays`) and
are the raw input signal for the ROADMAP's observed-throughput channel
scheduler (sliding-window byte rates come from differencing the
cumulative channels against ``t``).

Everything here is read-only over the engine: ``sample`` touches
``sim.*`` attributes through plain reads and aggregate numpy reductions,
never a mutating call. The network engine's link occupancy
(``link_act``) lives in a host array, so a sample reads no device
tensor.
"""

from __future__ import annotations

import numpy as np

#: Channels captured per OBS sample, in column order. Cumulative
#: channels (``wan_bytes``, ``lan_bytes``, ``accesses``, ``hits``,
#: ``prefetch_bytes``, ``completed_jobs``) are monotone totals at sample
#: time — difference adjacent rows for rates.
CHANNELS = (
    "t",                  # sim-clock seconds of the sample
    "active_transfers",   # in-flight file transfers (NetworkEngine.n_active)
    "busy_links",         # links (NIC + WAN) with nonzero allocated rate
    "wan_busy_links",     # busy links restricted to the WAN slice
    "link_busy_frac",     # busy_links / n_links
    "queued_jobs",        # CPU-queue depth across sites (incl. tombstones)
    "running_jobs",       # jobs currently holding a CPU slot
    "completed_jobs",     # records emitted so far
    "se_used_frac",       # mean site storage occupancy (used / capacity)
    "wan_bytes",          # cumulative WAN bytes moved
    "lan_bytes",          # cumulative LAN bytes moved
    "accesses",           # cumulative catalog accesses
    "hits",               # cumulative local-replica hits
    "prefetch_bytes",     # cumulative speculative-prefetch bytes
)


class RingBuffer:
    """Fixed-capacity multi-channel sample store.

    Rows are float64; once ``capacity`` rows have been appended the
    oldest are overwritten. :meth:`arrays` returns each channel in
    chronological order (oldest surviving row first).
    """

    def __init__(self, capacity: int, channels: tuple[str, ...]) -> None:
        if capacity <= 0:
            raise ValueError(f"RingBuffer capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self.channels = tuple(channels)
        self._data = np.zeros((self.capacity, len(self.channels)), np.float64)
        self.n_total = 0          # rows ever appended (may exceed capacity)

    def append(self, row) -> None:
        self._data[self.n_total % self.capacity] = row
        self.n_total += 1

    def __len__(self) -> int:
        return min(self.n_total, self.capacity)

    def rows(self) -> np.ndarray:
        """Surviving rows, oldest first, shape ``(len(self), n_channels)``."""
        n = len(self)
        if self.n_total <= self.capacity:
            return self._data[:n].copy()
        head = self.n_total % self.capacity
        return np.concatenate([self._data[head:], self._data[:head]])

    def arrays(self) -> dict[str, np.ndarray]:
        """Per-channel chronological vectors keyed by channel name."""
        rows = self.rows()
        return {name: rows[:, i].copy()
                for i, name in enumerate(self.channels)}


class GridSampler:
    """Reads one row of :data:`CHANNELS` from a live ``GridSimulator``.

    Duck-typed against the engine (``sim.now``, ``sim.network``,
    ``sim.topology`` …) so the obs package never imports ``repro_torch.core``
    — the simulator imports *us*, not the reverse.
    """

    def __init__(self, capacity: int = 8192) -> None:
        self.ring = RingBuffer(capacity, CHANNELS)

    @property
    def n_total(self) -> int:
        return self.ring.n_total

    def sample(self, sim) -> None:
        """Append one sample of grid state at ``sim.now`` (read-only)."""
        net = sim.network
        n_links = net.n_links
        n_sites = len(sim.topology.sites)
        busy = int(np.count_nonzero(net.link_act > 0.0))
        # Link index space is NIC links [0, n_sites) then WAN links.
        wan_busy = int(np.count_nonzero(net.link_act[n_sites:] > 0.0))
        queued = 0
        for q in sim._cpu_queue.values():
            queued += len(q)
        running = 0
        for js in sim._running.values():
            if js is not None:
                running += 1
        used_frac = 0.0
        for site in sim.topology.sites:
            used_frac += site.used_storage / site.storage_capacity
        used_frac /= max(n_sites, 1)
        acc = sim.access
        self.ring.append((
            sim.now,
            float(net.n_active),
            float(busy),
            float(wan_busy),
            busy / max(n_links, 1),
            float(queued),
            float(running),
            float(len(sim.records)),
            used_frac,
            float(sim.total_wan_bytes),
            float(sim.total_lan_bytes),
            float(acc.accesses),
            float(acc.hits),
            float(acc.prefetch_bytes),
        ))

    def arrays(self) -> dict[str, np.ndarray]:
        return self.ring.arrays()
