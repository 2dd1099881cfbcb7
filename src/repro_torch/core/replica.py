"""Replica management strategies: HRS (paper §3.3), BHR, LRU baselines.

The counterpart of ``repro.core.replica``. A strategy answers one question:
*given that site ``dst`` needs file ``lfn`` which it does not hold, where do
we fetch it from and what happens to local storage?* The simulator executes
the returned plan. Storage bookkeeping (LRU clocks, pinning of in-use files)
lives in ``StorageState`` so strategies stay pure decision functions.

Every strategy exists in two interchangeable forms, as in the reference:

* the *sequential* classes — one ``plan_fetch`` call per missing file,
  walking holder lists and LRU orders in Python; and
* the *batched* classes (``strategy_mode="batch"``, same registry keys) —
  one ``plan_batch`` call per arrival burst that scores every (job,
  missing-file) pair at once through the
  :mod:`repro_torch.kernels.strategy_plan` op on the network engine's
  device (the CUDA kernel on the card, its plain PyTorch version on the
  CPU) and resolves eviction contents with masked reductions over a
  :class:`StorageTensorView`, the dense array mirror of catalog + SE state
  maintained cell-by-cell through change listeners.

Every batched plan is bit-identical to the reference's batched plan on the
same state, and a singleton burst's plan to its sequential twin's.

The view's arrays stay on the host: its listener channels fire once per
catalog or storage change, and a device-resident view would pay a launch
per cell write. Per burst, the fetchable-holder mask goes up in one copy,
the same-region mask is computed on the device from the region map, and
the bandwidth columns are gathered on the device by the network engine.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import weakref
from typing import Iterable, Optional

import numpy as np
import torch

from ..kernels.strategy_plan import strategy_plan
from .catalog import ReplicaCatalog
from .topology import GridTopology


@dataclasses.dataclass
class FetchPlan:
    lfn: str
    src: int
    dst: int
    store: bool                    # keep in dst's SE (vs temporary buffer)
    evictions: list[str]           # lfns to delete from dst's SE first
    inter_region: bool             # paper's "inter-communication" metric
    remote_access: bool = False    # BHR: stream without storing


class StorageState:
    """Per-site SE contents with LRU clocks and pins.

    Recency is kept as a per-site list sorted by ``(last_access, add_seq)``
    maintained incrementally with bisect, so ``lru_order`` is a copy instead
    of a full sort per call. ``add_seq`` (monotonic registration counter)
    reproduces exactly the seed engine's tie-break: a stable sort by access
    time over dict-insertion order.
    """

    def __init__(self, catalog: ReplicaCatalog, topology: GridTopology) -> None:
        self.catalog = catalog
        self.topology = topology
        # site -> {lfn: last_access_time}; insertion kept, times updated
        self._contents: dict[int, dict[str, float]] = {
            s.site_id: {} for s in topology.sites
        }
        self._pins: dict[int, dict[str, int]] = {s.site_id: {} for s in topology.sites}
        self._add_seq: dict[int, dict[str, int]] = {
            s.site_id: {} for s in topology.sites
        }
        self._lru: dict[int, list[tuple[float, int, str]]] = {
            s.site_id: [] for s in topology.sites
        }
        self._seq = 0
        self._listeners: list[weakref.ref] = []

    # -- change listeners ---------------------------------------------------
    def add_listener(self, listener: object) -> None:
        """Subscribe ``listener`` to SE mutations — the
        :meth:`repro_torch.core.catalog.ReplicaCatalog.add_listener` pattern for
        storage state, so array mirrors (:class:`StorageTensorView`) track
        LRU clocks and pins cell-by-cell instead of rescanning per burst.
        It must provide ``on_storage_add(site, lfn, now, seq)``,
        ``on_storage_touch(site, lfn, now)``, ``on_storage_remove(site,
        lfn)`` and ``on_storage_pin(site, lfn, count)`` /
        ``on_storage_unpin(site, lfn, count)``; each fires *after* the
        mutation it reports. Held weakly; dead references are pruned on
        registration."""
        self._listeners = [r for r in self._listeners if r() is not None]
        self._listeners.append(weakref.ref(listener))

    def _notify(self, method: str, *args) -> None:
        for ref in self._listeners:
            sub = ref()
            if sub is not None:
                getattr(sub, method)(*args)

    def __deepcopy__(self, memo: dict) -> "StorageState":
        """Deep copy *without* listeners (the catalog's ``__deepcopy__``
        contract): a copied store — the tie-race sanitizer's twin engine —
        must never notify the original's mirrors."""
        import copy

        clone = self.__class__.__new__(self.__class__)
        memo[id(self)] = clone
        clone.catalog = copy.deepcopy(self.catalog, memo)
        clone.topology = copy.deepcopy(self.topology, memo)
        clone._contents = {s: dict(d) for s, d in self._contents.items()}
        clone._pins = {s: dict(d) for s, d in self._pins.items()}
        clone._add_seq = {s: dict(d) for s, d in self._add_seq.items()}
        clone._lru = {s: list(l) for s, l in self._lru.items()}
        clone._seq = self._seq
        clone._listeners = []
        return clone

    def _lru_insert(self, site: int, lfn: str, now: float) -> None:
        self._seq += 1
        self._add_seq[site][lfn] = self._seq
        bisect.insort(self._lru[site], (now, self._seq, lfn))

    def _lru_discard(self, site: int, lfn: str) -> None:
        key = (self._contents[site][lfn], self._add_seq[site][lfn], lfn)
        lst = self._lru[site]
        i = bisect.bisect_left(lst, key)
        if i < len(lst) and lst[i] == key:
            lst.pop(i)

    # -- mutation ----------------------------------------------------------
    def add(self, site: int, lfn: str, now: float) -> None:
        size = self.catalog.size(lfn)
        st = self.topology.sites[site]
        assert st.free_storage >= size - 1e-9, (
            f"SE overflow at site {site}: need {size}, free {st.free_storage}"
        )
        if lfn in self._contents[site]:
            # Re-add of a file already on the SE (two store transfers can
            # race for the same key when a temp fetch pops the in-flight
            # entry): refresh the clock, keep the original insertion rank.
            # The duplicate's reservation was already released by the
            # caller, so counting the size again would leak used_storage —
            # one byte ledger entry per resident replica (I3/I4).
            self.touch(site, lfn, now)
        else:
            self._contents[site][lfn] = now
            self._lru_insert(site, lfn, now)
            self._notify("on_storage_add", site, lfn, now, self._seq)
            st.used_storage += size
        self.catalog.add_replica(lfn, site)

    def bootstrap(self, site: int, lfn: str, now: float = 0.0) -> None:
        """Place an initial (master) copy that is already registered in the
        catalog — fills SE bookkeeping without re-registering."""
        if lfn in self._contents[site]:
            self.touch(site, lfn, now)   # re-bootstrap: refresh, don't dup
        else:
            self._contents[site][lfn] = now
            self._lru_insert(site, lfn, now)
            self._notify("on_storage_add", site, lfn, now, self._seq)
        self.topology.sites[site].used_storage += self.catalog.size(lfn)

    def remove(self, site: int, lfn: str) -> None:
        assert not self.is_pinned(site, lfn), f"evicting pinned {lfn}@{site}"
        self._lru_discard(site, lfn)
        del self._contents[site][lfn]
        del self._add_seq[site][lfn]
        self._notify("on_storage_remove", site, lfn)
        self.topology.sites[site].used_storage -= self.catalog.size(lfn)
        self.catalog.remove_replica(lfn, site)

    def lose(self, site: int, lfn: str) -> None:
        """Failure path: the SE is gone, so the replica disappears no matter
        what pins were held."""
        self._pins[site].pop(lfn, None)
        self.remove(site, lfn)

    def touch(self, site: int, lfn: str, now: float) -> None:
        if lfn in self._contents[site]:
            if self._contents[site][lfn] != now:
                key = (self._contents[site][lfn], self._add_seq[site][lfn], lfn)
                lst = self._lru[site]
                i = bisect.bisect_left(lst, key)
                if i < len(lst) and lst[i] == key:
                    lst.pop(i)
                    bisect.insort(lst, (now, self._add_seq[site][lfn], lfn))
            self._contents[site][lfn] = now
            self._notify("on_storage_touch", site, lfn, now)

    def pin(self, site: int, lfn: str) -> None:
        self._pins[site][lfn] = self._pins[site].get(lfn, 0) + 1
        self._notify("on_storage_pin", site, lfn, self._pins[site][lfn])

    def unpin(self, site: int, lfn: str) -> None:
        n = self._pins[site].get(lfn, 0) - 1
        if n <= 0:
            self._pins[site].pop(lfn, None)
        else:
            self._pins[site][lfn] = n
        self._notify("on_storage_unpin", site, lfn, max(n, 0))

    def is_pinned(self, site: int, lfn: str) -> bool:
        return self._pins[site].get(lfn, 0) > 0

    # -- queries -----------------------------------------------------------
    def holds(self, site: int, lfn: str) -> bool:
        return lfn in self._contents[site]

    def site_contents(self, site: int) -> list[str]:
        """All lfns currently in the site's SE (snapshot copy)."""
        return list(self._contents[site])

    def lru_order(self, site: int) -> list[str]:
        """Site contents, least-recently-used first."""
        return [lfn for _, _, lfn in self._lru[site]]

    def evictable(self, site: int, lfn: str) -> bool:
        """Masters and pinned (in-use) files are never evicted."""
        return not self.catalog.is_master(lfn, site) and not self.is_pinned(site, lfn)

    def free(self, site: int) -> float:
        return self.topology.sites[site].free_storage


class StorageTensorView:
    """Dense array mirror of catalog + SE state for the batched planners.

    One ``(sites, files)`` tensor bundle — catalog presence, per-region
    holder counts, LRU clocks (``atime`` + insertion ``seq``, exactly the
    :class:`StorageState` sort key) and pin counts — kept current
    *cell-by-cell* through both change-listener channels
    (:meth:`ReplicaCatalog.add_listener` and
    :meth:`StorageState.add_listener`), so per-burst reductions never
    rescan holder tables or LRU lists. File *registration* is absorbed
    lazily: :meth:`sync` rebuilds the whole bundle when the catalog's file
    count moved (the :class:`repro_torch.core.jaxsched.JaxScheduler`
    presence-bitmap pattern), and every public reader syncs first — the
    SL012 coherence rule covers this class automatically.
    """

    def __init__(self, catalog: ReplicaCatalog, topology: GridTopology,
                 storage: StorageState) -> None:
        self.catalog = catalog
        self.topology = topology
        self.storage = storage
        self._n_files = -1
        self.sync()
        catalog.add_listener(self)
        storage.add_listener(self)

    # -- rebuild / sync -----------------------------------------------------
    def sync(self) -> None:
        """Rebuild the file axis if files were registered since the last
        build; no-op (one length check) otherwise."""
        if len(self.catalog.files) != self._n_files:
            self._rebuild()

    def _rebuild(self) -> None:
        cat, topo, store = self.catalog, self.topology, self.storage
        lfns = sorted(cat.files)
        self.lfns: list[str] = lfns
        self.lfn_index: dict[str, int] = {l: j for j, l in enumerate(lfns)}
        n_files, n_sites = len(lfns), topo.n_sites
        self.sizes = np.fromiter((cat.size(l) for l in lfns), np.float64,
                                 n_files)
        self.masters = np.fromiter((cat.files[l].master_site for l in lfns),
                                   np.intp, n_files)
        self.region_map = np.fromiter((topo.region_of(s)
                                       for s in range(n_sites)),
                                      np.intp, n_sites)
        self.cat_present = np.zeros((n_sites, n_files), bool)
        for j, lfn in enumerate(lfns):
            self.cat_present[sorted(cat.holders(lfn)), j] = True
        self.region_counts = cat.region_counts_np(topo, lfns)
        self.st_present = np.zeros((n_sites, n_files), bool)
        self.st_atime = np.zeros((n_sites, n_files))
        self.st_seq = np.zeros((n_sites, n_files), np.int64)
        self.st_pins = np.zeros((n_sites, n_files), np.int64)
        # owner-module read of the SE bookkeeping maps (coherence rule
        # SL013 scopes them to this file, like SL011 does for the catalog)
        for s in range(n_sites):
            seqs = store._add_seq[s]
            for lfn, atime in store._contents[s].items():
                j = self.lfn_index[lfn]
                self.st_present[s, j] = True
                self.st_atime[s, j] = atime
                self.st_seq[s, j] = seqs[lfn]
            for lfn, n_pins in store._pins[s].items():
                self.st_pins[s, self.lfn_index[lfn]] = n_pins
        self._n_files = n_files

    # -- catalog listener channel -------------------------------------------
    def on_register_file(self, lfn: str) -> None:
        pass                      # file-count change; next sync() rebuilds

    def on_add_replica(self, lfn: str, site: int) -> None:
        j = self.lfn_index.get(lfn)
        if j is None:
            return                # registered after last rebuild
        # the catalog notifies idempotent mutations too — guard the count
        # increment with our own presence cell, like the catalog's
        # internal `if site not in holders`
        if not self.cat_present[site, j]:
            self.cat_present[site, j] = True
            self.region_counts[self.region_map[site], j] += 1

    def on_remove_replica(self, lfn: str, site: int) -> None:
        j = self.lfn_index.get(lfn)
        if j is None:
            return
        if self.cat_present[site, j]:
            self.cat_present[site, j] = False
            self.region_counts[self.region_map[site], j] -= 1

    # -- storage listener channel -------------------------------------------
    def on_storage_add(self, site: int, lfn: str, now: float,
                       seq: int) -> None:
        j = self.lfn_index.get(lfn)
        if j is None:
            return
        self.st_present[site, j] = True
        self.st_atime[site, j] = now
        self.st_seq[site, j] = seq

    def on_storage_touch(self, site: int, lfn: str, now: float) -> None:
        j = self.lfn_index.get(lfn)
        if j is not None:
            self.st_atime[site, j] = now

    def on_storage_remove(self, site: int, lfn: str) -> None:
        j = self.lfn_index.get(lfn)
        if j is None:
            return
        self.st_present[site, j] = False
        self.st_pins[site, j] = 0     # `lose` drops pins without unpinning

    def on_storage_pin(self, site: int, lfn: str, count: int) -> None:
        j = self.lfn_index.get(lfn)
        if j is not None:
            self.st_pins[site, j] = count

    def on_storage_unpin(self, site: int, lfn: str, count: int) -> None:
        j = self.lfn_index.get(lfn)
        if j is not None:
            self.st_pins[site, j] = count

    # -- burst reads (used by the batched planners) -------------------------
    def file_indices(self, lfns: "Iterable[str]") -> np.ndarray:
        self.sync()
        idx = self.lfn_index
        lfns = list(lfns)
        return np.fromiter((idx[l] for l in lfns), np.intp, len(lfns))

    def fetch_mask(self, js: np.ndarray, online: np.ndarray) -> np.ndarray:
        """``(sites, pairs)`` fetchable-holder mask for file columns
        ``js``: online holders, plus the durable master rows regardless of
        liveness — :meth:`ReplicaCatalog.fetchable_holders` as one gather."""
        self.sync()
        mask = self.cat_present[:, js] & online[:, None]
        m = self.masters[js]
        ar = np.arange(js.size)
        mask[m, ar] = self.cat_present[m, js]
        return mask

    def lru_evictable(self, dst: int) -> np.ndarray:
        """Evictable residents of ``dst`` (non-master, unpinned) as file
        indices in LRU order — ``(atime, seq)`` ascending, the exact
        :meth:`StorageState.lru_order` key (unique per cell, so the lfn
        tie-break is never reached)."""
        self.sync()
        row = (self.st_present[dst] & (self.masters != dst)
               & (self.st_pins[dst] == 0))
        cand = np.flatnonzero(row)
        if cand.size <= 1:
            return cand
        return cand[np.lexsort((self.st_seq[dst, cand],
                                self.st_atime[dst, cand]))]

    def region_dup(self, dst: int, js: np.ndarray) -> np.ndarray:
        """Vector :meth:`ReplicaCatalog.duplicated_in_region`: some
        *other* site in ``dst``'s region also holds file ``js[i]``."""
        self.sync()
        n = (self.region_counts[self.region_map[dst], js]
             - self.cat_present[dst, js])
        return n > 0

    def refetch_costs(self, dst: int, js: np.ndarray, bw_col: np.ndarray,
                      online: np.ndarray) -> np.ndarray:
        """Seconds to re-stage each file (columns ``js``) at ``dst`` from
        its best *other* fetchable holder — the vectorized
        ``_AccessAwareStrategy._refetch_cost`` (``inf`` when no other copy
        exists or its bandwidth is zero)."""
        self.sync()
        h = self.fetch_mask(js, online)
        h[dst, :] = False
        best = np.where(h, bw_col[:, None], -np.inf).max(axis=0,
                                                         initial=-np.inf)
        good = best > 0.0
        return np.where(good, self.sizes[js] / np.where(good, best, 1.0),
                        np.inf)


def _best_bandwidth_source(
    candidates: list[int], dst: int, topology: GridTopology
) -> int:
    """Max available-bandwidth source (HRS's replica-selection criterion)."""
    return max(candidates, key=lambda s: (topology.point_bandwidth(s, dst), -s))


class ReplicaStrategy:
    """Base interface. Subclasses implement ``plan_fetch``.

    ``access`` is the shared :class:`repro_torch.core.access.AccessHistory` the
    simulator feeds from its fetch/hit path; it is ``None`` for the
    history-blind paper strategies and required by the access-aware ones
    (``economic`` / ``predictive``, which also set ``uses_economy`` so
    the simulator arms the periodic :class:`repro_torch.core.economy.
    ReplicationOptimizer`).
    """

    name = "base"
    uses_economy = False         # arm the proactive ReplicationOptimizer?
    econ_model = "economic"      # VALUE_MODELS entry the optimizer scores with

    def __init__(self, catalog: ReplicaCatalog, topology: GridTopology,
                 storage: StorageState, access=None) -> None:
        self.catalog = catalog
        self.topology = topology
        self.storage = storage
        self.access = access

    def _online_holders(self, lfn: str) -> list[int]:
        """Holders we may fetch from (see ReplicaCatalog.fetchable_holders)."""
        return self.catalog.fetchable_holders(lfn, self.topology)

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        raise NotImplementedError

    # Shared helper: evict files in ``order`` (already filtered; any
    # iterable, consumed only as far as needed) until ``need`` bytes are
    # free at ``site``. Returns evicted list or [] when impossible.
    def _evict_until(self, site: int, need: float,
                     order: "Iterable[str]") -> list[str]:
        freed = self.storage.free(site)
        out: list[str] = []
        for lfn in order:
            if freed >= need:
                break
            out.append(lfn)
            freed += self.catalog.size(lfn)
        return out if freed >= need else []


class HRSStrategy(ReplicaStrategy):
    """Hierarchical Replication Strategy — the paper's contribution (§3.3).

    1. Prefer replicas in the local region; pick the max-available-bandwidth
       candidate.
    2. Intra-region fetch with insufficient space -> temporary buffer (the
       replica is NOT stored; it is dropped when the job completes).
    3. Inter-region fetch with insufficient space -> two-phase LRU eviction:
       first local replicas duplicated elsewhere in the same region, then
       local replicas duplicated in other regions. Masters/pinned are safe.
       If space still cannot be made, fall back to the temporary buffer.
    """

    name = "hrs"

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        holders = self._online_holders(lfn)
        region = self.topology.region_of(dst)
        local = [h for h in holders if self.topology.region_of(h) == region]
        size = self.catalog.size(lfn)
        if local:
            src = _best_bandwidth_source(local, dst, self.topology)
            store = self.storage.free(dst) >= size
            return FetchPlan(lfn, src, dst, store=store, evictions=[],
                             inter_region=False)
        src = _best_bandwidth_source(holders, dst, self.topology)
        if self.storage.free(dst) >= size:
            return FetchPlan(lfn, src, dst, store=True, evictions=[],
                             inter_region=True)
        # two-phase LRU eviction, scanned lazily: phase 1 (region-duplicated
        # replicas) in LRU order, then phase 2 (the rest) in LRU order —
        # `_evict_until` stops consuming once enough space is freed
        lru = [f for f in self.storage.lru_order(dst) if self.storage.evictable(dst, f)]
        dup = self.catalog.duplicated_in_region
        evictions = self._evict_until(dst, size, itertools.chain(
            (f for f in lru if dup(f, dst, self.topology)),
            (f for f in lru if not dup(f, dst, self.topology))))
        if evictions:
            return FetchPlan(lfn, src, dst, store=True, evictions=evictions,
                             inter_region=True)
        return FetchPlan(lfn, src, dst, store=False, evictions=[],
                         inter_region=True)


class HRSSinglePhaseStrategy(HRSStrategy):
    """Ablation: HRS with its two-phase eviction collapsed to plain LRU.

    Isolates the contribution of the paper's novel eviction order (evict
    region-duplicated replicas first, protecting sole-in-region copies
    whose re-fetch would cross the WAN) from the rest of HRS (region-
    priority source selection + temp buffer)."""

    name = "hrs_singlephase"

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        holders = self._online_holders(lfn)
        region = self.topology.region_of(dst)
        local = [h for h in holders if self.topology.region_of(h) == region]
        size = self.catalog.size(lfn)
        if local:
            src = _best_bandwidth_source(local, dst, self.topology)
            store = self.storage.free(dst) >= size
            return FetchPlan(lfn, src, dst, store=store, evictions=[],
                             inter_region=False)
        src = _best_bandwidth_source(holders, dst, self.topology)
        if self.storage.free(dst) >= size:
            return FetchPlan(lfn, src, dst, store=True, evictions=[],
                             inter_region=True)
        evictions = self._evict_until(       # single phase, lazy LRU scan
            dst, size, (f for f in self.storage.lru_order(dst)
                        if self.storage.evictable(dst, f)))
        if evictions:
            return FetchPlan(lfn, src, dst, store=True, evictions=evictions,
                             inter_region=True)
        return FetchPlan(lfn, src, dst, store=False, evictions=[],
                         inter_region=True)


class BHRStrategy(ReplicaStrategy):
    """Bandwidth Hierarchy based Replication (Park et al. [5]), as described
    in the paper §2/§4.2: replicate if there is space; if the file is
    available within the same region, access it remotely (no replication);
    otherwise make room with plain LRU and replicate. Source selection
    searches *all* sites for the best (max-bandwidth) replica, with no
    intra-region priority.
    """

    name = "bhr"

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        holders = self._online_holders(lfn)
        src = _best_bandwidth_source(holders, dst, self.topology)
        size = self.catalog.size(lfn)
        inter = self.topology.is_inter_region(src, dst)
        if self.storage.free(dst) >= size:
            return FetchPlan(lfn, src, dst, store=True, evictions=[],
                             inter_region=inter)
        region = self.topology.region_of(dst)
        in_region = [h for h in holders if self.topology.region_of(h) == region]
        if in_region:
            rsrc = _best_bandwidth_source(in_region, dst, self.topology)
            return FetchPlan(lfn, rsrc, dst, store=False, evictions=[],
                             inter_region=False, remote_access=True)
        evictions = self._evict_until(
            dst, size, (f for f in self.storage.lru_order(dst)
                        if self.storage.evictable(dst, f)))
        if evictions:
            return FetchPlan(lfn, src, dst, store=True, evictions=evictions,
                             inter_region=inter)
        return FetchPlan(lfn, src, dst, store=False, evictions=[],
                         inter_region=inter)


class LRUStrategy(ReplicaStrategy):
    """Plain LRU replication (paper §4.2): always replicate, evicting the
    least-recently-used files to make room. No region awareness anywhere;
    the source is simply the max-bandwidth holder over all sites."""

    name = "lru"

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        holders = self._online_holders(lfn)
        src = _best_bandwidth_source(holders, dst, self.topology)
        size = self.catalog.size(lfn)
        inter = self.topology.is_inter_region(src, dst)
        if self.storage.free(dst) >= size:
            return FetchPlan(lfn, src, dst, store=True, evictions=[],
                             inter_region=inter)
        evictions = self._evict_until(
            dst, size, (f for f in self.storage.lru_order(dst)
                        if self.storage.evictable(dst, f)))
        if evictions:
            return FetchPlan(lfn, src, dst, store=True, evictions=evictions,
                             inter_region=inter)
        return FetchPlan(lfn, src, dst, store=False, evictions=[],
                         inter_region=inter)


class _AccessAwareStrategy(ReplicaStrategy):
    """Shared machinery for the history-driven strategies: guaranteed
    non-None ``access`` plus source selection and eviction ordering that
    consult it."""

    uses_economy = True

    def __init__(self, catalog: ReplicaCatalog, topology: GridTopology,
                 storage: StorageState, access=None) -> None:
        if access is None:
            from .access import AccessHistory   # deferred: avoid cycle cost
            access = AccessHistory(catalog, topology)
        super().__init__(catalog, topology, storage, access)

    def _select_source(self, candidates: list[int], dst: int) -> int:
        """Max effective bandwidth, discounted by how busy a candidate has
        recently been *serving* transfers (AccessHistory's decayed serve
        counts) — equally-fast replicas rotate instead of dog-piling one
        source. Ties break toward the lowest site id."""
        def key(h: int) -> tuple[float, int]:
            bw = self.topology.point_bandwidth(h, dst)
            return (bw / (1.0 + self.access.serve_load(h)), -h)
        return max(candidates, key=key)

    def _plan_trade(self, lfn: str, src: int, dst: int, inter: bool,
                    size: float, value_in: float,
                    retention) -> FetchPlan:
        """The shared eviction trade: evict cheapest-retention-value
        first, but only while the incoming file's value stays strictly
        ahead of the total evicted; a losing (or unfillable) trade
        streams through the temporary buffer instead. ``retention`` maps
        the evictable resident list to its per-file retention values —
        the only thing the two access-aware strategies disagree on."""
        resident = [f for f in self.storage.lru_order(dst)
                    if self.storage.evictable(dst, f)]
        values = np.asarray(retention(resident), float)
        freed = self.storage.free(dst)
        evictions: list[str] = []
        value_out = 0.0
        for i in np.argsort(values, kind="stable"):
            if freed >= size:
                break
            value_out += float(values[int(i)])
            if value_out >= value_in:
                break                        # the trade went net-negative
            evictions.append(resident[int(i)])
            freed += self.catalog.size(resident[int(i)])
        if freed >= size and value_out < value_in:
            return FetchPlan(lfn, src, dst, store=True, evictions=evictions,
                             inter_region=inter)
        return FetchPlan(lfn, src, dst, store=False, evictions=[],
                         inter_region=inter)

    def _refetch_cost(self, lfn: str, site: int) -> float:
        """Seconds to re-stage ``lfn`` at ``site`` from its best *other*
        holder; infinite when no other copy exists (losing the last
        non-master copy is priced as unaffordable)."""
        holders = [h for h in
                   self.catalog.fetchable_holders(lfn, self.topology)
                   if h != site]
        if not holders:
            return float("inf")
        bw = max(self.topology.point_bandwidth(h, site) for h in holders)
        if bw <= 0.0:
            return float("inf")
        return self.catalog.size(lfn) / bw


class PredictiveStrategy(_AccessAwareStrategy):
    """Popularity-prediction replication (CMS access-pattern study line).

    Stores a fetched file only when its predicted future accesses (the
    decayed count — the access that triggered this fetch is already in it)
    beat the summed prediction of everything that must be evicted to make
    room; a losing trade streams through the temporary buffer instead,
    keeping the cache full of files the history says will be read again.
    Retention is hierarchy-aware in the HRS spirit: a sole-in-region copy
    counts double (its re-fetch would cross the WAN). Sources are picked
    region-local first, by effective bandwidth discounted for recent
    serving load. Enables the periodic optimizer under the ``popularity``
    value model, so rising files are staged ahead of demand — the
    drifting-hot-set regime (``hotset_drift``) is where this beats
    reactive HRS.
    """

    name = "predictive"
    econ_model = "popularity"
    #: retention multiplier for sole-in-region copies (WAN re-fetch risk)
    sole_copy_weight = 2.0

    def _retention_scores(self, site: int,
                          lfns: list[str]) -> np.ndarray:
        scores = self.access.scores(site, lfns)
        dup = np.array([self.catalog.duplicated_in_region(l, site,
                                                          self.topology)
                        for l in lfns], bool)
        return np.where(dup, scores, self.sole_copy_weight * scores)

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        holders = self._online_holders(lfn)
        region = self.topology.region_of(dst)
        local = [h for h in holders if self.topology.region_of(h) == region]
        src = self._select_source(local or holders, dst)
        inter = self.topology.is_inter_region(src, dst)
        size = self.catalog.size(lfn)
        if self.storage.free(dst) >= size:
            return FetchPlan(lfn, src, dst, store=True, evictions=[],
                             inter_region=inter)
        # the trade: predicted accesses in vs predicted accesses evicted
        score_in = float(self.access.scores(dst, [lfn])[0])
        return self._plan_trade(
            lfn, src, dst, inter, size, score_in,
            lambda resident: self._retention_scores(dst, resident))


class EconomicStrategy(_AccessAwareStrategy):
    """OptorSim-style economic replication.

    A replica is bought only when the trade clears: the incoming file's
    value (predicted local accesses x the transfer cost each would pay
    without it) must exceed the total retention value of everything
    evicted to make room. Eviction scans cheapest-retention-value first;
    a losing trade falls back to the temporary buffer (stream, don't
    store). Enables the periodic optimizer under the ``economic`` value
    model, which runs the same pricing proactively grid-wide.
    """

    name = "economic"
    econ_model = "economic"

    def _retention_value(self, lfn: str, site: int) -> float:
        score = float(self.access.scores(site, [lfn])[0])
        return score * self._refetch_cost(lfn, site)

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        holders = self._online_holders(lfn)
        src = self._select_source(holders, dst)
        size = self.catalog.size(lfn)
        inter = self.topology.is_inter_region(src, dst)
        if self.storage.free(dst) >= size:
            return FetchPlan(lfn, src, dst, store=True, evictions=[],
                             inter_region=inter)
        # value of owning the incoming file: predicted accesses x the
        # cost of fetching it (what each future access would pay)
        score_in = float(self.access.scores(dst, [lfn])[0])
        bw = self.topology.point_bandwidth(src, dst)
        value_in = score_in * (size / bw if bw > 0.0 else float("inf"))
        return self._plan_trade(
            lfn, src, dst, inter, size, value_in,
            lambda resident: [self._retention_value(f, dst)
                              for f in resident])


class NoReplicationStrategy(ReplicaStrategy):
    """Always stream remotely, never store. Lower bound for replication."""

    name = "noreplication"

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        holders = self._online_holders(lfn)
        src = _best_bandwidth_source(holders, dst, self.topology)
        return FetchPlan(lfn, src, dst, store=False, evictions=[],
                         inter_region=self.topology.is_inter_region(src, dst))


# -- batched planners (strategy_mode="batch") ------------------------------

class _BatchedStrategy(ReplicaStrategy):
    """Shared machinery for the batched planners.

    ``plan_batch`` scores one arrival burst — every (job, missing-file)
    pair — in a single :func:`repro_torch.kernels.strategy_plan.strategy_plan`
    pass on the network engine's device, over the engine-shared bandwidth
    columns
    (:meth:`repro_torch.core.network.NetworkEngine.point_bandwidth_columns`),
    the :class:`StorageTensorView` fetchable-holder mask, the same-region
    mask and the decayed serve loads, then assembles per-pair
    :class:`FetchPlan` objects on the host with the strategy-specific
    ``_assemble``. Eviction contents (two-phase LRU order,
    retention-vs-refetch trades) are masked reductions over the view,
    touching only the pairs whose no-eviction store verdict failed. Each
    plan is bit-identical to the reference's batched plan, and a singleton
    burst's to the sequential twin strategy's ``plan_fetch``, against the
    same state.
    """

    #: the simulator routes arrival bursts through ``plan_batch`` (and
    #: calls ``invalidate_online`` from the failure-injection paths) when
    #: this is set
    batched = True
    #: discount source bandwidth by decayed serving load (the
    #: access-aware key); zero serve is an IEEE no-op division by 1.0,
    #: so one kernel formula covers both key types
    serve_weighted = False
    #: ``_assemble`` reads the pair's bandwidth column when the
    #: no-eviction store verdict fails; ``plan_batch`` then brings those
    #: columns back from the device, in one copy
    reads_bw_col = False

    def __init__(self, catalog: ReplicaCatalog, topology: GridTopology,
                 storage: StorageState, access=None, *, network=None,
                 view: Optional[StorageTensorView] = None,
                 backend: str = "auto") -> None:
        if network is None:
            raise ValueError(
                f"strategy_mode='batch' ({self.name!r}) plans off the "
                "engine-shared NetworkEngine bandwidth state; pass "
                "network=")
        if backend not in PLAN_BACKENDS:
            raise ValueError(f"unknown strategy_plan backend {backend!r} "
                             f"(want one of {PLAN_BACKENDS})")
        if backend == "interpret":
            raise NotImplementedError(
                "backend='interpret' runs a Pallas kernel under the Pallas "
                "interpreter; the port has no interpreter route — use "
                "backend='auto'")
        super().__init__(catalog, topology, storage, access)
        self.network = network
        self.view = view if view is not None else StorageTensorView(
            catalog, topology, storage)
        self._online: Optional[np.ndarray] = None
        self._region_dev: Optional[torch.Tensor] = None   # built at first use

    # -- engine hooks -------------------------------------------------------
    def invalidate_online(self) -> None:
        """Drop the cached online-site vector. The simulator calls this
        from its failure/recovery paths; liveness changes are rare next
        to fetches, so the vector is rebuilt lazily instead of per-site."""
        self._online = None

    def _online_mask(self) -> np.ndarray:
        if self._online is None:
            self._online = np.fromiter(
                (s.online for s in self.topology.sites), bool,
                self.topology.n_sites)
        return self._online

    # -- planning -----------------------------------------------------------
    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        """Singleton replan route (burst-cache misses, re-staging rounds,
        event-broker singleton bursts): the exact :func:`strategy_plan`
        oracle formulas inlined on 1-D views, skipping the pair-axis
        gathers — bit-identical to ``plan_batch([(lfn, dst)])[0]``."""
        view = self.view
        view.sync()
        j = view.lfn_index[lfn]
        online = self._online_mask()
        bw = self.network.point_bandwidth_column(dst)
        fetchm = view.cat_present[:, j] & online
        m = int(view.masters[j])
        fetchm[m] = view.cat_present[m, j]
        # serve = 0 divides by exactly 1.0 (IEEE no-op), same as the oracle
        eff = (bw / (1.0 + self.access.serve_loads())
               if self.serve_weighted else bw)
        key_g = np.where(fetchm, eff, -1.0)
        src_g = int(np.argmax(key_g))            # first max = lowest id
        localm = view.region_map == view.region_map[dst]
        fl = fetchm & localm
        has_l = bool(fl.any())
        src_l = int(np.argmax(np.where(fl, eff, -1.0))) if has_l else 0
        inter_g = not bool(localm[src_g])
        free = float(self.topology.sites[dst].free_storage)
        size = float(view.sizes[j])
        return self._assemble(lfn, dst, size, free, bw, src_g, src_l,
                              has_l, inter_g, free >= size)

    def refresh_plan(self, plan: FetchPlan) -> FetchPlan:
        """Re-verdict a burst-cached plan whose store/eviction half went
        stale while the source is still good (the simulator's
        ``_live_plan`` guard). The default replans from scratch;
        strategies whose ``_assemble`` verdict needs nothing beyond the
        plan's own (src, inter_region) override with a source-preserving
        re-verdict, skipping the bandwidth column and argmax entirely."""
        return self.plan_fetch(plan.lfn, plan.dst)

    def _reverdict(self, plan: FetchPlan) -> FetchPlan:
        """Source-preserving :meth:`refresh_plan`: recompute free space
        and rerun ``_assemble`` with the cached source standing in for
        both the global and local pick. Only valid for strategies whose
        every ``_assemble`` branch encodes ``has_l`` as
        ``not inter_region`` (or ignores it) and never reads the
        bandwidth column."""
        view = self.view
        view.sync()
        size = float(view.sizes[view.lfn_index[plan.lfn]])
        free = float(self.topology.sites[plan.dst].free_storage)
        return self._assemble(plan.lfn, plan.dst, size, free, None,
                              plan.src, plan.src, not plan.inter_region,
                              plan.inter_region, free >= size)

    def plan_batch(self, pairs: list[tuple[str, int]]) -> list[FetchPlan]:
        """Plan every ``(lfn, dst)`` pair of one burst in one pass."""
        view = self.view
        view.sync()
        n = len(pairs)
        js = view.file_indices(l for l, _ in pairs)
        dsts = np.fromiter((d for _, d in pairs), np.intp, n)
        online = self._online_mask()
        fetch = view.fetch_mask(js, online)
        serve = (self.access.serve_loads() if self.serve_weighted
                 else np.zeros(self.topology.n_sites))
        free = np.fromiter(
            (self.topology.sites[d].free_storage for d in dsts),
            np.float64, n)
        size = view.sizes[js]
        bw, sources, flags = self._plan_on_device(dsts, fetch, serve, free,
                                                  size)
        src_g, src_l = sources
        has_l, inter_g, store_ok = flags
        cols: dict[int, np.ndarray] = {}
        if self.reads_bw_col and not store_ok.all():
            rows = np.flatnonzero(~store_ok)
            picked = bw[:, torch.from_numpy(rows).to(bw.device)]
            cols = dict(zip(rows.tolist(), picked.cpu().numpy().T))
        # pre-compute the LRU eviction lists for every pair whose verdict
        # needs one, rowwise across the burst instead of per pair
        evs: dict[int, list[str]] = {}
        mask = self._evict_mask(has_l, store_ok)
        if mask is not None and mask.any():
            rows = np.flatnonzero(mask)
            evs = dict(zip(
                rows.tolist(),
                self._lru_evictions_multi(dsts[rows], size[rows],
                                          free[rows],
                                          two_phase=self.two_phase)))
        return [
            self._assemble(pairs[p][0], int(dsts[p]), float(size[p]),
                           float(free[p]), cols.get(p), int(src_g[p]),
                           int(src_l[p]), bool(has_l[p]), bool(inter_g[p]),
                           bool(store_ok[p]), evictions=evs.get(p))
            for p in range(n)
        ]

    def _plan_on_device(self, dsts: np.ndarray, fetch: np.ndarray,
                        serve: np.ndarray, free: np.ndarray,
                        size: np.ndarray
                        ) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """The burst's ``strategy_plan`` pass on the engine's device:
        returns the ``(sites, pairs)`` bandwidth columns (left on the
        device) and the host ``(2, pairs)`` int32 sources and ``(3,
        pairs)`` bool flags. Up: the fetch mask and one float64 buffer
        (serve, free, size, destinations); the same-region mask is built on
        the device. Down: the sources and the flags."""
        net = self.network
        bw = net.point_bandwidth_columns(dsts)
        dev = bw.device
        n_sites, n = fetch.shape
        if self._region_dev is None:
            self._region_dev = net.to_device(self.view.region_map.copy())
        buf = np.concatenate([serve, free, size, dsts.astype(np.float64)])
        t = net.to_device(buf)
        serve_t = t[:n_sites]
        free_t = t[n_sites: n_sites + n]
        size_t = t[n_sites + n: n_sites + 2 * n]
        dst_t = t[n_sites + 2 * n:].long()
        rm = self._region_dev
        local = rm[:, None] == rm[dst_t][None, :]
        # the view's column gather comes back column-major; the kernel
        # reads row-major rows
        fetch_t = torch.from_numpy(np.ascontiguousarray(fetch)).to(dev)
        sources, flags = strategy_plan(bw, fetch_t, local, serve_t, free_t,
                                       size_t)
        return bw, sources.cpu().numpy(), flags.cpu().numpy()

    #: eviction-order flavor consumed by ``_evict_mask`` pre-computation
    #: (HRS's region-duplicated-first order when True)
    two_phase = False

    def _evict_mask(self, has_l: np.ndarray,
                    store_ok: np.ndarray) -> Optional[np.ndarray]:
        """Which pairs of a burst need an LRU eviction list pre-computed
        (``None``: the strategy plans evictions itself per pair — the
        access-aware trade rules)."""
        return None

    def _assemble(self, lfn: str, dst: int, size: float, free: float,
                  bw_col: np.ndarray, src_g: int, src_l: int, has_l: bool,
                  inter_g: bool, store_ok: bool,
                  evictions: Optional[list[str]] = None) -> FetchPlan:
        raise NotImplementedError

    # Vectorized ``_evict_until`` over a pre-filtered eviction order:
    # left-to-right cumulative frees (``np.cumsum`` accumulates in
    # sequence, matching the sequential ``freed += size`` association
    # order bit for bit), evict up to the first prefix that covers
    # ``need`` — or nothing when even the full order cannot.
    def _lru_evictions(self, dst: int, need: float, free: float, *,
                       two_phase: bool = False) -> list[str]:
        view = self.view
        order = view.lru_evictable(dst)
        if order.size == 0:
            return []
        if two_phase:
            dup = view.region_dup(dst, order)
            order = np.concatenate((order[dup], order[~dup]))
        freed = np.cumsum(np.concatenate(([free], view.sizes[order])))
        hit = np.flatnonzero(freed >= need)
        if hit.size == 0:
            return []
        return [view.lfns[int(i)] for i in order[:int(hit[0])]]

    # `_lru_evictions` for a whole burst. All of a job's files land on
    # its site, so the burst's eviction-needing pairs share a handful of
    # destinations: build each destination's LRU order and cumulative
    # free-space prefix ONCE (the exact singleton arrays — same
    # lexsort, same two-phase partition, same left-assoc cumsum with the
    # free space prepended), then cut each pair at its own first covering
    # prefix. ``freed`` is nondecreasing (sizes are nonnegative), so the
    # left bisect equals the singleton's first ``freed >= need`` index.
    def _lru_evictions_multi(self, dsts: np.ndarray, needs: np.ndarray,
                             frees: np.ndarray, *,
                             two_phase: bool = False) -> list[list[str]]:
        view = self.view
        out: list[list[str]] = [[] for _ in range(len(dsts))]
        lfns = view.lfns
        for dst in np.unique(dsts):
            rows = np.flatnonzero(dsts == dst)
            order = view.lru_evictable(int(dst))
            if order.size == 0:
                continue
            if two_phase:
                dup = view.region_dup(int(dst), order)
                order = np.concatenate((order[dup], order[~dup]))
            sizes_o = view.sizes[order]
            # one prefix per distinct free-space reading (one in practice:
            # the burst snapshots every pair's free space at the same
            # instant, but the grouping must not assume it)
            for free in np.unique(frees[rows]):
                sub = rows[frees[rows] == free]
                freed = np.cumsum(np.concatenate(([free], sizes_o)))
                cuts = np.searchsorted(freed, needs[sub], side="left")
                for p, cut in zip(sub, cuts):
                    if cut < freed.size:
                        out[p] = [lfns[int(i)] for i in order[:int(cut)]]
        return out


class BatchedHRSStrategy(_BatchedStrategy):
    """Batched :class:`HRSStrategy` (region priority, temp-buffer
    fallback, two-phase LRU eviction)."""

    name = "hrs"
    two_phase = True

    def _evict_mask(self, has_l, store_ok):
        return ~(has_l | store_ok)

    def _assemble(self, lfn, dst, size, free, bw_col, src_g, src_l, has_l,
                  inter_g, store_ok, evictions=None):
        if has_l:
            return FetchPlan(lfn, src_l, dst, store=store_ok, evictions=[],
                             inter_region=False)
        if store_ok:
            return FetchPlan(lfn, src_g, dst, store=True, evictions=[],
                             inter_region=True)
        if evictions is None:
            evictions = self._lru_evictions(dst, size, free,
                                            two_phase=self.two_phase)
        if evictions:
            return FetchPlan(lfn, src_g, dst, store=True,
                             evictions=evictions, inter_region=True)
        return FetchPlan(lfn, src_g, dst, store=False, evictions=[],
                         inter_region=True)

    # every branch above maps has_l <-> not inter_region and ignores the
    # bandwidth column, so the cheap source-preserving re-verdict applies
    refresh_plan = _BatchedStrategy._reverdict


class BatchedHRSSinglePhaseStrategy(BatchedHRSStrategy):
    """Batched :class:`HRSSinglePhaseStrategy` (eviction ablation)."""

    name = "hrs_singlephase"
    two_phase = False


class BatchedBHRStrategy(_BatchedStrategy):
    """Batched :class:`BHRStrategy` (in-region remote access, plain
    LRU eviction)."""

    name = "bhr"

    def _evict_mask(self, has_l, store_ok):
        return ~(has_l | store_ok)

    def _assemble(self, lfn, dst, size, free, bw_col, src_g, src_l, has_l,
                  inter_g, store_ok, evictions=None):
        if store_ok:
            return FetchPlan(lfn, src_g, dst, store=True, evictions=[],
                             inter_region=inter_g)
        if has_l:
            return FetchPlan(lfn, src_l, dst, store=False, evictions=[],
                             inter_region=False, remote_access=True)
        if evictions is None:
            evictions = self._lru_evictions(dst, size, free)
        if evictions:
            return FetchPlan(lfn, src_g, dst, store=True,
                             evictions=evictions, inter_region=inter_g)
        return FetchPlan(lfn, src_g, dst, store=False, evictions=[],
                         inter_region=inter_g)


class BatchedLRUStrategy(_BatchedStrategy):
    """Batched :class:`LRUStrategy` (always replicate, plain LRU)."""

    name = "lru"

    def _evict_mask(self, has_l, store_ok):
        return ~store_ok

    def _assemble(self, lfn, dst, size, free, bw_col, src_g, src_l, has_l,
                  inter_g, store_ok, evictions=None):
        if store_ok:
            return FetchPlan(lfn, src_g, dst, store=True, evictions=[],
                             inter_region=inter_g)
        if evictions is None:
            evictions = self._lru_evictions(dst, size, free)
        if evictions:
            return FetchPlan(lfn, src_g, dst, store=True,
                             evictions=evictions, inter_region=inter_g)
        return FetchPlan(lfn, src_g, dst, store=False, evictions=[],
                         inter_region=inter_g)

    # src_g-only planning, has_l unused: the cheap re-verdict applies
    refresh_plan = _BatchedStrategy._reverdict


class BatchedNoReplicationStrategy(_BatchedStrategy):
    """Batched :class:`NoReplicationStrategy` (stream, never store)."""

    name = "noreplication"

    def _assemble(self, lfn, dst, size, free, bw_col, src_g, src_l, has_l,
                  inter_g, store_ok, evictions=None):
        return FetchPlan(lfn, src_g, dst, store=False, evictions=[],
                         inter_region=inter_g)

    def refresh_plan(self, plan):
        return plan          # never stores: nothing to re-verdict


class _BatchedAccessAwareStrategy(_BatchedStrategy):
    """Batched counterpart of :class:`_AccessAwareStrategy`: guaranteed
    non-None ``access``, serve-load-discounted source keys, and the
    vectorized retention-vs-refetch eviction trade."""

    uses_economy = True
    serve_weighted = True

    def __init__(self, catalog, topology, storage, access=None,
                 **kwargs) -> None:
        if access is None:
            from .access import AccessHistory   # deferred: avoid cycle cost
            access = AccessHistory(catalog, topology)
        super().__init__(catalog, topology, storage, access, **kwargs)

    def _trade_evictions(self, dst: int, size: float, free: float,
                         value_in: float, resident: np.ndarray,
                         res_lfns: list[str],
                         values: np.ndarray) -> Optional[list[str]]:
        """Vectorized ``_AccessAwareStrategy._plan_trade`` core: evict
        cheapest-retention-value first up to the first prefix that covers
        ``size``, store only while the incoming value stays strictly
        ahead of the total evicted. Returns the eviction list for a
        winning trade, ``None`` for a losing or unfillable one."""
        view = self.view
        order = np.argsort(values, kind="stable")
        freed = np.cumsum(np.concatenate(
            ([free], view.sizes[resident[order]])))
        space = np.flatnonzero(freed >= size)
        if space.size == 0:
            return None
        k = int(space[0])          # >= 1: free < size on this path
        # the sequential loop's `value_out < value_in` gate. Retention
        # values are nonnegative, so the running sum is nondecreasing and
        # this one compare also covers its early value-break; a NaN sum
        # (inf refetch cost x zero score) fails the compare — a failed
        # trade, exactly like the sequential accumulator
        cum_v = np.cumsum(values[order])
        if not cum_v[k - 1] < value_in:
            return None
        return [res_lfns[int(i)] for i in order[:k]]


class BatchedPredictiveStrategy(_BatchedAccessAwareStrategy):
    """Batched :class:`PredictiveStrategy` (popularity trade, sole-copy
    retention weighting, region-local source priority)."""

    name = "predictive"
    econ_model = "popularity"
    sole_copy_weight = PredictiveStrategy.sole_copy_weight

    def _assemble(self, lfn, dst, size, free, bw_col, src_g, src_l, has_l,
                  inter_g, store_ok, evictions=None):
        src = src_l if has_l else src_g
        inter = False if has_l else inter_g
        if store_ok:
            return FetchPlan(lfn, src, dst, store=True, evictions=[],
                             inter_region=inter)
        view = self.view
        resident = view.lru_evictable(dst)
        res_lfns = [view.lfns[int(i)] for i in resident]
        scores = self.access.scores(dst, res_lfns)
        dup = view.region_dup(dst, resident)
        values = np.where(dup, scores, self.sole_copy_weight * scores)
        score_in = float(self.access.scores(dst, [lfn])[0])
        evictions = self._trade_evictions(dst, size, free, score_in,
                                          resident, res_lfns, values)
        if evictions is None:
            return FetchPlan(lfn, src, dst, store=False, evictions=[],
                             inter_region=inter)
        return FetchPlan(lfn, src, dst, store=True, evictions=evictions,
                         inter_region=inter)

    # local source => inter_region False in every branch, bandwidth
    # column unused: the cheap source-preserving re-verdict applies
    refresh_plan = _BatchedStrategy._reverdict


class BatchedEconomicStrategy(_BatchedAccessAwareStrategy):
    """Batched :class:`EconomicStrategy` (OptorSim valuation: predicted
    accesses x transfer cost, against refetch-priced retention)."""

    name = "economic"
    econ_model = "economic"
    reads_bw_col = True

    def _assemble(self, lfn, dst, size, free, bw_col, src_g, src_l, has_l,
                  inter_g, store_ok, evictions=None):
        if store_ok:
            return FetchPlan(lfn, src_g, dst, store=True, evictions=[],
                             inter_region=inter_g)
        view = self.view
        resident = view.lru_evictable(dst)
        res_lfns = [view.lfns[int(i)] for i in resident]
        scores = self.access.scores(dst, res_lfns)
        refetch = view.refetch_costs(dst, resident, bw_col,
                                     self._online_mask())
        values = scores * refetch
        score_in = float(self.access.scores(dst, [lfn])[0])
        bw_sd = float(bw_col[src_g])
        value_in = score_in * (size / bw_sd if bw_sd > 0.0
                               else float("inf"))
        evictions = self._trade_evictions(dst, size, free, value_in,
                                          resident, res_lfns, values)
        if evictions is None:
            return FetchPlan(lfn, src_g, dst, store=False, evictions=[],
                             inter_region=inter_g)
        return FetchPlan(lfn, src_g, dst, store=True, evictions=evictions,
                         inter_region=inter_g)


#: Replication-strategy registry, keyed by each strategy's ``name``
#: attribute: ``hrs`` (the paper's contribution), ``hrs_singlephase``
#: (eviction ablation), ``bhr``, ``lru``, ``noreplication``, plus the
#: access-history-driven pair ``economic`` (OptorSim-style valuation) and
#: ``predictive`` (decayed-popularity prediction), which also arm the
#: proactive replication economy. These names are what ``GridSimulator``,
#: ``run_experiment`` and ``ScenarioSpec.strategy`` accept.
STRATEGIES: dict[str, type[ReplicaStrategy]] = {
    c.name: c for c in (HRSStrategy, HRSSinglePhaseStrategy, BHRStrategy,
                        LRUStrategy, NoReplicationStrategy,
                        EconomicStrategy, PredictiveStrategy)
}

#: Planning engines accepted by :func:`make_strategy` / ``GridSimulator``'s
#: ``strategy_mode`` flag.
STRATEGY_MODES = ("sequential", "batch")

#: The batched planners' ``backend`` values, the reference's. The port's
#: route follows the network engine's device (the CUDA kernel on the card,
#: the plain PyTorch version on the CPU), so ``"auto"``, ``"pallas"`` and
#: ``"numpy"`` are that one route; ``"interpret"`` (the Pallas
#: interpreter) raises ``NotImplementedError``.
PLAN_BACKENDS = ("auto", "pallas", "interpret", "numpy")

#: ``strategy_mode="batch"`` counterparts — same keys, every strategy has
#: a batched twin that plans whole arrival bursts in one
#: :mod:`repro_torch.kernels.strategy_plan` pass.
BATCH_STRATEGIES: dict[str, type[_BatchedStrategy]] = {
    c.name: c for c in (BatchedHRSStrategy, BatchedHRSSinglePhaseStrategy,
                        BatchedBHRStrategy, BatchedLRUStrategy,
                        BatchedNoReplicationStrategy,
                        BatchedEconomicStrategy, BatchedPredictiveStrategy)
}


def make_strategy(name: str, catalog: ReplicaCatalog, topology: GridTopology,
                  storage: StorageState, access=None, *,
                  mode: str = "sequential", network=None,
                  backend: str = "auto") -> ReplicaStrategy:
    """Instantiate a replication strategy from :data:`STRATEGIES` (or,
    with ``mode="batch"``, :data:`BATCH_STRATEGIES`) by name.

    Strategies are pure decision functions over the shared ``catalog`` /
    ``topology`` / ``storage`` state — the simulator executes the
    :class:`FetchPlan` they return. ``access`` is the shared
    :class:`repro_torch.core.access.AccessHistory` (the access-aware strategies
    build a private empty one when omitted, e.g. in unit tests). The
    batched planners additionally need the engine's
    :class:`repro_torch.core.network.NetworkEngine` as ``network``; their
    :mod:`repro_torch.kernels.strategy_plan` pass runs on its device
    (``backend``: see :data:`PLAN_BACKENDS`). Raises ``KeyError`` for
    unknown names, ``ValueError`` for unknown modes and backends.
    """
    if mode == "sequential":
        return STRATEGIES[name](catalog, topology, storage, access)
    if mode != "batch":
        raise ValueError(f"unknown strategy_mode {mode!r} "
                         "(want 'sequential' | 'batch')")
    return BATCH_STRATEGIES[name](catalog, topology, storage, access,
                                  network=network, backend=backend)
