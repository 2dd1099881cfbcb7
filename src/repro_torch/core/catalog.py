"""Centralized Replica Catalogue (paper §3.1, Fig. 2).

Indexes which sites hold which files; handles queries from the scheduler and
the per-site replica managers. Master copies are pinned (the paper assumes
"master site always has a safe copy before deleting").

Change notification: array-backed mirrors of the holder table (the jax
brokers' presence bitmap — :class:`repro_torch.core.torchsched.TorchScheduler`) keep
themselves current *incrementally* instead of rebuilding a ``(sites,
files)`` scan per dispatch batch. They register through
:meth:`ReplicaCatalog.add_listener`; every holder-table mutation calls the
matching ``on_register_file`` / ``on_add_replica`` / ``on_remove_replica``
callback after the catalog state has changed. With no listeners the hooks
cost one truthiness check per mutation.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np


@dataclasses.dataclass(frozen=True)
class FileInfo:
    lfn: str                 # logical file name
    size: float              # bytes
    master_site: int         # site holding the pinned master copy


class ReplicaCatalog:
    def __init__(self) -> None:
        self.files: dict[str, FileInfo] = {}
        self._holders: dict[str, set[int]] = {}
        self._listeners: list[weakref.ref] = []
        # lazily-bound region index: site -> region map from the first
        # topology that asks a region query, plus per-file region holder
        # counts maintained on every mutation (duplicated_in_region is on
        # the HRS eviction hot path — millions of calls per run)
        self._region_map: list[int] | None = None
        self._region_topo: weakref.ref | None = None
        self._region_counts: dict[str, dict[int, int]] = {}

    def __deepcopy__(self, memo: dict) -> "ReplicaCatalog":
        """Deep copy *without* listeners. Listeners are per-instance
        mirrors of per-instance engine state (presence bitmaps); a copied
        catalog (the tie-race sanitizer's twin engine) must never notify
        the original's mirrors. weakref.ref is also deep-copied atomically
        by the stdlib, so keeping the list would alias the originals."""
        clone = self.__class__.__new__(self.__class__)
        memo[id(self)] = clone
        clone.files = dict(self.files)          # FileInfo is frozen
        clone._holders = {lfn: set(h) for lfn, h in self._holders.items()}
        clone._listeners = []
        # region index rebinds lazily against the twin's own topology
        clone._region_map = None
        clone._region_topo = None
        clone._region_counts = {}
        return clone

    # -- change listeners ---------------------------------------------------
    def add_listener(self, listener: object) -> None:
        """Subscribe ``listener`` to holder-table changes. It must provide
        ``on_register_file(lfn)``, ``on_add_replica(lfn, site_id)`` and
        ``on_remove_replica(lfn, site_id)``; each fires *after* the
        mutation it reports (idempotent mutations still notify). Held by
        weak reference: a mirror that is no longer referenced anywhere
        else is collected instead of being notified forever."""
        self._listeners = [r for r in self._listeners if r() is not None]
        self._listeners.append(weakref.ref(listener))

    def _notify(self, method: str, *args) -> None:
        for ref in self._listeners:
            sub = ref()
            if sub is not None:
                getattr(sub, method)(*args)

    # -- registration (paper: "replica manager sends file register request
    #    to RC and RC adds this site to the list of sites") ----------------
    def register_file(self, lfn: str, size: float, master_site: int) -> None:
        if lfn in self.files:
            raise ValueError(f"duplicate file registration: {lfn}")
        self.files[lfn] = FileInfo(lfn, size, master_site)
        self._holders[lfn] = {master_site}
        if self._region_map is not None:
            self._region_counts[lfn] = {self._region_map[master_site]: 1}
        self._notify("on_register_file", lfn)

    def add_replica(self, lfn: str, site_id: int) -> None:
        h = self._holders[lfn]
        if site_id not in h:
            h.add(site_id)
            if self._region_map is not None:
                rc = self._region_counts[lfn]
                r = self._region_map[site_id]
                rc[r] = rc.get(r, 0) + 1
        self._notify("on_add_replica", lfn, site_id)

    def remove_replica(self, lfn: str, site_id: int) -> None:
        info = self.files[lfn]
        if site_id == info.master_site:
            raise ValueError(f"cannot delete master copy of {lfn}")
        h = self._holders[lfn]
        if site_id in h:
            h.discard(site_id)
            if self._region_map is not None:
                rc = self._region_counts[lfn]
                rc[self._region_map[site_id]] -= 1
        self._notify("on_remove_replica", lfn, site_id)

    # -- queries -----------------------------------------------------------
    def holders(self, lfn: str) -> set[int]:
        return set(self._holders[lfn])

    def has_replica(self, lfn: str, site_id: int) -> bool:
        return site_id in self._holders[lfn]

    def size(self, lfn: str) -> float:
        return self.files[lfn].size

    def n_copies(self, lfn: str) -> int:
        return len(self._holders[lfn])

    def is_master(self, lfn: str, site_id: int) -> bool:
        return self.files[lfn].master_site == site_id

    def files_at(self, site_id: int) -> list[str]:
        return [lfn for lfn, h in self._holders.items() if site_id in h]

    def bytes_at_site(self, required: list[str], site_id: int) -> float:
        """Paper eq. (1): S_s = sum of sizes of required files present at s."""
        return sum(
            self.files[lfn].size for lfn in required if site_id in self._holders[lfn]
        )

    def fetchable_holders(self, lfn: str, topology) -> list[int]:
        """Holders a fetch may source from. Master copies are durable (the
        paper assumes the master site 'always has a safe copy'), so a master
        remains fetchable even while its site is marked failed."""
        master = self.files[lfn].master_site
        return sorted(
            h for h in self._holders[lfn]
            if topology.sites[h].online or h == master
        )

    def _bind_region_index(self, topology) -> list[int]:
        """(Re)build the site->region map and the per-file region holder
        counts against ``topology``. Bound to one topology at a time —
        rebinding (a fresh topology instance, e.g. a sanitizer twin)
        rebuilds both from the current holder table."""
        rm = [topology.region_of(s) for s in range(len(topology.sites))]
        self._region_map = rm
        self._region_topo = weakref.ref(topology)
        counts: dict[str, dict[int, int]] = {}
        for lfn, holders in self._holders.items():
            rc: dict[int, int] = {}
            for h in holders:
                r = rm[h]
                rc[r] = rc.get(r, 0) + 1
            counts[lfn] = rc
        self._region_counts = counts
        return rm

    def region_counts_np(self, topology, lfns: list[str]) -> np.ndarray:
        """Per-region holder counts as a dense ``(n_regions, len(lfns))``
        array — the bootstrap read of the array-backed strategy mirror
        (:class:`repro.core.replica.StorageTensorView`), served from the
        same incrementally-maintained counts :meth:`duplicated_in_region`
        answers from instead of a holder-table rescan."""
        if self._region_map is None or (
                self._region_topo is not None
                and self._region_topo() is not topology):
            self._bind_region_index(topology)
        out = np.zeros((topology.n_regions, len(lfns)), np.int64)
        for j, lfn in enumerate(lfns):
            for r, n in self._region_counts[lfn].items():
                out[r, j] = n
        return out

    def duplicated_in_region(self, lfn: str, site_id: int, topology) -> bool:
        """True if some *other* site in site_id's region also holds lfn.

        O(1): answered from the incrementally-maintained per-file region
        holder counts (region membership is static per topology, so the
        count is a pure function of the holder table)."""
        rm = self._region_map
        if rm is None or (self._region_topo is not None
                          and self._region_topo() is not topology):
            rm = self._bind_region_index(topology)
        n = self._region_counts[lfn].get(rm[site_id], 0)
        if site_id in self._holders[lfn]:
            n -= 1
        return n > 0
