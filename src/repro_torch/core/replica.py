"""Replica management strategies: HRS (paper §3.3), BHR, LRU baselines.

The counterpart of ``repro.core.replica``. A strategy answers one question:
*given that site ``dst`` needs file ``lfn`` which it does not hold, where do
we fetch it from and what happens to local storage?* The simulator executes
the returned plan. Storage bookkeeping (LRU clocks, pinning of in-use files)
lives in ``StorageState`` so strategies stay pure decision functions.

This slice carries the sequential strategies — one ``plan_fetch`` per
missing file, walking holder lists and LRU orders in Python, exactly as the
reference does. Still to port, and raising ``NotImplementedError``: the
access-aware ``economic`` and ``predictive`` strategies (they arm the
replication economy, ROADMAP queue 1 item 5) and ``strategy_mode="batch"``
(the ``strategy_plan`` kernel, ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import weakref
from typing import Iterable

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
        storage state, so array mirrors (the reference's ``StorageTensorView``) track
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
    the simulator arms the periodic :class:`repro.core.economy.
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


class _NotPortedStrategy(ReplicaStrategy):
    """A registry name whose strategy is not ported yet."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            f"strategy {self.name!r} drives the replication economy, which "
            "is not ported yet (ROADMAP queue 1 item 5)")


class EconomicStrategy(_NotPortedStrategy):
    name = "economic"


class PredictiveStrategy(_NotPortedStrategy):
    name = "predictive"


class NoReplicationStrategy(ReplicaStrategy):
    """Always stream remotely, never store. Lower bound for replication."""

    name = "noreplication"

    def plan_fetch(self, lfn: str, dst: int) -> FetchPlan:
        holders = self._online_holders(lfn)
        src = _best_bandwidth_source(holders, dst, self.topology)
        return FetchPlan(lfn, src, dst, store=False, evictions=[],
                         inter_region=self.topology.is_inter_region(src, dst))


#: Replication-strategy registry, keyed by each strategy's ``name``
#: attribute: ``hrs`` (the paper's contribution), ``hrs_singlephase``
#: (eviction ablation), ``bhr``, ``lru``, ``noreplication``, plus the
#: access-history-driven ``economic`` and ``predictive``, which raise until
#: the economy is ported. The keys are the reference's: scenario specs are
#: validated against them.
STRATEGIES: dict[str, type[ReplicaStrategy]] = {
    c.name: c for c in (HRSStrategy, HRSSinglePhaseStrategy, BHRStrategy,
                        LRUStrategy, NoReplicationStrategy,
                        EconomicStrategy, PredictiveStrategy)
}

#: Planning engines accepted by :func:`make_strategy` / ``GridSimulator``'s
#: ``strategy_mode`` flag.
STRATEGY_MODES = ("sequential", "batch")


def make_strategy(name: str, catalog: ReplicaCatalog, topology: GridTopology,
                  storage: StorageState, access=None, *,
                  mode: str = "sequential") -> ReplicaStrategy:
    """Instantiate a replication strategy from :data:`STRATEGIES` by name.
    Raises ``KeyError`` for unknown names, ``ValueError`` for unknown
    modes and ``NotImplementedError`` for ``mode="batch"``."""
    if mode == "batch":
        raise NotImplementedError(
            "strategy_mode='batch' runs on the strategy_plan kernel, which "
            "is not ported yet (ROADMAP queue 1 item 4)")
    if mode != "sequential":
        raise ValueError(f"unknown strategy_mode {mode!r} "
                         "(want 'sequential' | 'batch')")
    return STRATEGIES[name](catalog, topology, storage, access)
