"""Access-history tracking: the demand signal behind proactive replication.

The paper's HRS is purely *reactive* — every replication decision happens at
fetch time, driven by nothing but the current catalog and LRU clocks. The
economy subsystem (:mod:`repro.core.economy`) instead acts on *observed
access patterns*, which is what this module provides: an
:class:`AccessHistory` maintaining exponentially-decayed per-(site, file)
access counts in dense numpy arrays, fed from the simulator's fetch/hit
path, with region- and grid-level aggregation views.

Design notes:

* **Lazy per-cell decay.** A count decays as ``c(t) = c(t0) * 2^-((t-t0)/
  half_life)``. Storing a per-cell last-update stamp makes each ``record``
  O(1) (decay one cell, add the weight) while a full-matrix
  :meth:`snapshot` is a single vectorized ``counts * exp2(-(now - stamps)
  / half_life)`` pass — no per-event matrix sweeps.
* **Shift-invariant ordering.** The ratio of two decayed counts is
  independent of the evaluation time (both decay by the same factor), so
  rankings produced by :meth:`scores` are valid for *any* ``now`` at or
  after the last recorded event. Strategies may therefore order evictions
  without being told the clock.
* **Accounting parity.** ``fetches`` / ``remote_fetches`` / ``wan_bytes``
  / ``lan_bytes`` are incremented by the simulator at exactly the points
  where it accounts its own inter-communication metrics, so they agree
  with :class:`repro_torch.core.metrics.ExperimentResult` by construction
  (pinned by ``tests/test_access.py``). Proactive (economy-initiated)
  transfers are counted separately as ``prefetches``.

The tracker is pure observation: recording never mutates catalog, storage
or topology state, so wiring it into the simulator leaves the HRS/BHR/LRU
golden paths bit-identical.
"""

from __future__ import annotations

import numpy as np

from .catalog import ReplicaCatalog
from .topology import GridTopology

#: Default decay half-life (seconds of simulated time). Four hours against
#: the paper's 60 s interarrival means a file's score reflects roughly its
#: last ~240 job arrivals. Tuned empirically on ``hotset_drift`` /
#: ``cache_starved`` at 2k jobs: shorter half-lives (1-2 h) track a shift
#: faster but are too noisy to rank the steady hot set, and ranking
#: quality dominates — 4 h beat 1 h / 2 h / 8 h for both access-aware
#: strategies on both regimes.
DEFAULT_HALF_LIFE_S = 14400.0


class AccessHistory:
    """Exponentially-decayed per-(site, file) access counts (dense numpy).

    ``counts[s, f]`` is the decayed access count of file ``f`` at site
    ``s``, valid at time ``stamps[s, f]``; :meth:`snapshot` brings the
    whole matrix to a common ``now``. File axis order is ``sorted(catalog.
    files)`` (the same convention as :class:`repro_torch.core.torchsched.
    JaxScheduler`), exposed via ``lfns`` / ``lfn_index``.
    """

    def __init__(self, catalog: ReplicaCatalog, topology: GridTopology, *,
                 half_life_s: float = DEFAULT_HALF_LIFE_S) -> None:
        if half_life_s <= 0:
            raise ValueError(f"half_life_s must be positive, got {half_life_s}")
        self.catalog = catalog
        self.topology = topology
        self.half_life_s = float(half_life_s)
        self.lfns: list[str] = sorted(catalog.files)
        self.lfn_index: dict[str, int] = {l: i for i, l in enumerate(self.lfns)}
        self.sizes = np.array([catalog.size(l) for l in self.lfns])
        n_sites, n_files = topology.n_sites, len(self.lfns)
        self.counts = np.zeros((n_sites, n_files))
        self.stamps = np.zeros((n_sites, n_files))
        self._n_catalog = len(catalog.files)
        # per-site decayed *serving* load: how often each site has recently
        # been the source of a transfer (strategies use it to spread load
        # across equally-fast replicas)
        self.serve_counts = np.zeros(n_sites)
        self.serve_stamps = np.zeros(n_sites)
        # exact (undecayed) accounting totals
        self.accesses = 0          # demand events (one per required file per job)
        self.hits = 0              # resolved from the local SE
        self.fetches = 0           # transfers started on behalf of jobs
        self.remote_fetches = 0    # ... of which inter-region (paper metric)
        self.wan_bytes = 0.0
        self.lan_bytes = 0.0
        self.prefetches = 0        # proactive (economy) transfers
        self.prefetch_bytes = 0.0
        self.last_now = 0.0

    # -- catalog sync ------------------------------------------------------
    def sync(self) -> None:
        """Pick up files registered in the catalog *after* construction
        (ad-hoc tests, dynamic workloads): rebuild the file axis in sorted
        order, carrying existing counts/stamps over by LFN. No-op when the
        catalog is unchanged."""
        if len(self.catalog.files) == self._n_catalog:
            return
        lfns = sorted(self.catalog.files)
        n_sites = self.counts.shape[0]
        counts = np.zeros((n_sites, len(lfns)))
        stamps = np.zeros((n_sites, len(lfns)))
        for j, lfn in enumerate(lfns):
            old = self.lfn_index.get(lfn)
            if old is not None:
                counts[:, j] = self.counts[:, old]
                stamps[:, j] = self.stamps[:, old]
        self.lfns = lfns
        self.lfn_index = {l: i for i, l in enumerate(lfns)}
        self.sizes = np.array([self.catalog.size(l) for l in lfns])
        self.counts, self.stamps = counts, stamps
        self._n_catalog = len(self.catalog.files)

    def _findex(self, lfn: str) -> int:
        idx = self.lfn_index.get(lfn)
        if idx is None:
            self.sync()
            idx = self.lfn_index[lfn]
        return idx

    # -- decay helpers -----------------------------------------------------
    def _decay_cell(self, site: int, fidx: int, now: float) -> None:
        dt = now - self.stamps[site, fidx]
        if dt > 0.0:
            self.counts[site, fidx] *= 2.0 ** (-dt / self.half_life_s)
            self.stamps[site, fidx] = now

    # -- recording (called by the simulator) -------------------------------
    def record_access(self, site: int, lfn: str, now: float,
                      weight: float = 1.0) -> None:
        """One unit of demand for ``lfn`` at ``site`` (job placement)."""
        fidx = self._findex(lfn)
        self._decay_cell(site, fidx, now)
        self.counts[site, fidx] += weight
        self.accesses += 1
        if now > self.last_now:
            self.last_now = now

    def record_hit(self, site: int, lfn: str, now: float) -> None:
        """A required file resolved from ``site``'s own SE."""
        del lfn, now  # demand was already recorded at placement
        self.hits += 1

    def _record_serve(self, src: int, now: float) -> None:
        """Decay-then-increment the source site's serving load."""
        dt = now - self.serve_stamps[src]
        if dt > 0.0:
            self.serve_counts[src] *= 2.0 ** (-dt / self.half_life_s)
            self.serve_stamps[src] = now
        self.serve_counts[src] += 1.0
        if now > self.last_now:
            self.last_now = now

    def record_fetch(self, src: int, dst: int, lfn: str, size: float,
                     inter_region: bool, now: float) -> None:
        """A job-driven transfer started (same call point as the
        simulator's own inter-communication accounting)."""
        self.fetches += 1
        if inter_region:
            self.remote_fetches += 1
            self.wan_bytes += size
        else:
            self.lan_bytes += size
        self._record_serve(src, now)

    def record_prefetch(self, src: int, dst: int, lfn: str, size: float,
                        now: float) -> None:
        """A proactive (economy-initiated) transfer started."""
        del dst, lfn
        self.prefetches += 1
        self.prefetch_bytes += size
        self._record_serve(src, now)

    # -- views -------------------------------------------------------------
    def snapshot(self, now: float | None = None) -> np.ndarray:
        """The full decayed ``(n_sites, n_files)`` count matrix at ``now``
        (default: the latest recorded time). Normalizes in place — stamps
        all move to ``now`` — and returns a copy."""
        self.sync()     # no-op unless files were registered late
        now = self.last_now if now is None else now
        dt = now - self.stamps
        np.multiply(self.counts, 2.0 ** (-np.maximum(dt, 0.0) / self.half_life_s),
                    out=self.counts)
        self.stamps[dt > 0.0] = now
        return self.counts.copy()

    def site_counts(self, site: int, now: float | None = None) -> np.ndarray:
        """Decayed counts for one site, ``(n_files,)``."""
        self.sync()     # no-op unless files were registered late
        now = self.last_now if now is None else now
        dt = np.maximum(now - self.stamps[site], 0.0)
        return self.counts[site] * 2.0 ** (-dt / self.half_life_s)

    def region_counts(self, now: float | None = None) -> np.ndarray:
        """Decayed counts aggregated per region, ``(n_regions, n_files)``:
        row r is exactly the sum of its member sites' rows."""
        snap = self.snapshot(now)
        out = np.zeros((len(self.topology.regions), snap.shape[1]))
        for region in self.topology.regions:
            out[region.region_id] = snap[region.site_ids].sum(axis=0)
        return out

    def grid_counts(self, now: float | None = None) -> np.ndarray:
        """Grid-wide decayed counts, ``(n_files,)``."""
        return self.snapshot(now).sum(axis=0)

    def serve_load(self, site: int, now: float | None = None) -> float:
        """Decayed count of transfers recently served *by* ``site``."""
        now = self.last_now if now is None else now
        dt = max(now - self.serve_stamps[site], 0.0)
        return float(self.serve_counts[site] * 2.0 ** (-dt / self.half_life_s))

    def serve_loads(self, now: float | None = None) -> np.ndarray:
        """Vector :meth:`serve_load` for every site at once,
        ``(n_sites,)`` — the batched planners' serve-discount column. The
        same ufunc arithmetic as the scalar path, so entry ``s`` equals
        ``serve_load(s)`` bit for bit."""
        now = self.last_now if now is None else now
        dt = np.maximum(now - self.serve_stamps, 0.0)
        return self.serve_counts * 2.0 ** (-dt / self.half_life_s)

    def scores(self, site: int, lfns: list[str] | tuple[str, ...]
               ) -> np.ndarray:
        """Decayed popularity scores for ``lfns`` at ``site``, evaluated at
        the latest recorded time. Decay is multiplicative and uniform in
        the evaluation time, so the *ordering* of these scores is the same
        for any later ``now`` — strategies can rank eviction candidates
        without knowing the clock."""
        if any(l not in self.lfn_index for l in lfns):
            self.sync()
        idx = np.fromiter((self.lfn_index[l] for l in lfns), np.intp,
                          len(lfns))
        if idx.size == 0:
            return np.zeros(0)
        dt = np.maximum(self.last_now - self.stamps[site, idx], 0.0)
        return self.counts[site, idx] * 2.0 ** (-dt / self.half_life_s)
