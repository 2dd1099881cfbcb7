"""Hierarchical n-tier grid topology (paper §3.1, generalized).

The paper studies one fixed two-level hierarchy: regions connected by slow
inter-region links (WAN; cross-pod DCN on a TPU cluster), each containing
sites that share a fast intra-region fabric (LAN; ICI on a pod). This module
generalizes that to an arbitrary tier *tree* described by ``tier_fanouts``:

    (4, 13)      -> the paper's grid: 4 regions x 13 sites
    (2, 4, 7)    -> 2 clusters, each 4 groups of 7 sites (56 sites, 4 tiers
                    counting the root)
    (2, 3, 3, 3) -> a 5-tier hierarchy, 54 sites

Leaves are sites; every internal node below the root owns an *uplink* whose
bandwidth is given per level (top-down) by ``uplink_bandwidths``. The
innermost groups (the leaf's immediate parent) play the paper's "region"
role: replica strategies treat them as the locality domain and the paper's
inter-communication metric counts transfers that leave them.

Bandwidth model (source-side): each site has an outbound NIC at LAN speed.
A transfer that stays inside its leaf group is bottlenecked by the source
NIC. A transfer that leaves the group is accounted on the source NIC plus
**every** uplink it crosses on the source side (``uplink_path``): its rate
is the min over those links of each link's fair share, so a thin mid-tier
uplink saturated by through-traffic throttles transfers even when the
topmost crossed link is fat. For two-level trees the path is just {source
NIC, source-region WAN uplink} — exactly the paper's rule. Links are
fair-shared among concurrent transfers.

``path_model`` selects the accounting: ``"full"`` (default, the per-link
path above) or ``"topmost"`` — the pre-refactor legacy model that contends
only on the topmost crossed uplink, kept so the fidelity gap is measurable
(``benchmarks/run.py net_sweep``; the ``net="topmost"`` engine flag).

Heterogeneity knobs (all optional, defaults reproduce the paper):
  * ``uplink_scale``: per-uplink bandwidth multipliers, e.g. a "fat region"
    whose WAN uplink is 10x the others (DIANA-style network awareness);
  * ``storage_scale``: per-region SE-capacity multipliers (cache-starved or
    storage-rich regions);
  * ``compute_capacities`` / ``storage_capacities``: explicit per-site
    overrides.

Units are abstract but consistent: bandwidth in bytes/sec, storage in bytes,
compute in ops/sec ("MIPS" in the paper, FLOP/s on a TPU cluster).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence


@dataclasses.dataclass
class Site:
    """A grid site: CE + SE (paper Fig. 1). Maps to a TPU host."""

    site_id: int
    region_id: int
    compute_capacity: float          # ops/sec (paper: MIPS; here FLOP/s)
    storage_capacity: float          # bytes (paper: 10 GB per SE)
    # -- dynamic state, owned by the simulator / runtime --
    used_storage: float = 0.0
    queued_work: float = 0.0         # ops queued (paper: SizeofJobs_i, in MI)
    online: bool = True

    @property
    def free_storage(self) -> float:
        return self.storage_capacity - self.used_storage

    def relative_load(self) -> float:
        """Paper eq. (2): RelativeLoad_i = SizeofJobs_i / C_i."""
        return self.queued_work / self.compute_capacity


@dataclasses.dataclass
class Region:
    region_id: int
    site_ids: list[int]


@dataclasses.dataclass
class Link:
    """A shared fair-share link. Transfers on it split bandwidth equally."""

    name: str
    bandwidth: float                 # bytes/sec aggregate
    active: int = 0                  # number of concurrent transfers

    def share(self, n: int | None = None) -> float:
        n = self.active if n is None else n
        return self.bandwidth / max(1, n)


class GridTopology:
    """n-tier hierarchy of sites (see module docstring).

    The two-positional-argument form ``GridTopology(n_regions,
    sites_per_region, ...)`` builds the paper's two-level tree and is
    unchanged from the original API. Deeper trees are requested with
    ``tier_fanouts`` (which overrides the two positional counts) plus
    ``uplink_bandwidths``, one bandwidth per internal level, top-down;
    for two-level trees ``uplink_bandwidths`` defaults to
    ``(wan_bandwidth,)``.
    """

    def __init__(
        self,
        n_regions: int,
        sites_per_region: int,
        *,
        lan_bandwidth: float,
        wan_bandwidth: float,
        storage_capacity: float,
        compute_capacities: Iterable[float] | None = None,
        seed: int = 0,
        tier_fanouts: Sequence[int] | None = None,
        uplink_bandwidths: Sequence[float] | None = None,
        uplink_scale: Sequence[tuple[int, int, float]] = (),
        storage_scale: Sequence[tuple[int, float]] = (),
        storage_capacities: Iterable[float] | None = None,
        path_model: str = "full",
    ) -> None:
        if path_model not in ("full", "topmost"):
            raise ValueError(f"path_model must be 'full' or 'topmost', "
                             f"got {path_model!r}")
        self.path_model = path_model
        fanouts = (tuple(tier_fanouts) if tier_fanouts is not None
                   else (n_regions, sites_per_region))
        if len(fanouts) < 2 or any(f < 1 for f in fanouts):
            raise ValueError(f"tier_fanouts must be >=2 positive levels, "
                             f"got {fanouts!r}")
        if uplink_bandwidths is None:
            if len(fanouts) != 2:
                raise ValueError(
                    "uplink_bandwidths (one per internal level, top-down) is "
                    f"required for {len(fanouts)}-level fanouts {fanouts!r}")
            uplinks_bw = (wan_bandwidth,)
        else:
            uplinks_bw = tuple(uplink_bandwidths)
            if len(uplinks_bw) != len(fanouts) - 1:
                raise ValueError(
                    f"need {len(fanouts) - 1} uplink bandwidths for fanouts "
                    f"{fanouts!r}, got {len(uplinks_bw)}")
        self.tier_fanouts = fanouts
        self.n_regions = 1
        for f in fanouts[:-1]:
            self.n_regions *= f
        self.sites_per_region = fanouts[-1]
        self.lan_bandwidth = lan_bandwidth
        self.wan_bandwidth = uplinks_bw[0]
        self.uplink_bandwidths = uplinks_bw

        n_sites = self.n_regions * self.sites_per_region
        storage_caps = (list(storage_capacities)
                        if storage_capacities is not None else None)
        region_storage_factor: dict[int, float] = {}
        for region, factor in storage_scale:
            if not 0 <= region < self.n_regions:
                raise ValueError(
                    f"storage_scale region {region} out of range "
                    f"(0..{self.n_regions - 1})")
            region_storage_factor[region] = factor

        self.sites: list[Site] = []
        self.regions: list[Region] = []
        caps = list(compute_capacities) if compute_capacities is not None else None
        # Deterministic heterogeneous capacities when not given: the paper
        # assumes heterogeneous MIPS but gives no table; spread 1x..4x.
        sid = 0
        for r in range(self.n_regions):
            ids = []
            for _ in range(self.sites_per_region):
                if caps is not None:
                    cap = caps[sid % len(caps)]
                else:
                    cap = 1e9 * (1 + ((sid * 2654435761 + seed) % 4))
                if storage_caps is not None:
                    store = storage_caps[sid % len(storage_caps)]
                else:
                    store = storage_capacity * region_storage_factor.get(r, 1.0)
                self.sites.append(
                    Site(site_id=sid, region_id=r, compute_capacity=cap,
                         storage_capacity=store)
                )
                ids.append(sid)
                sid += 1
            self.regions.append(Region(region_id=r, site_ids=ids))
        assert sid == n_sites

        # -- link fabric ---------------------------------------------------
        # Ancestor table: _anc[site] = global node index of the site's
        # ancestor at each internal level, top-down (level 1 .. depth-1).
        # For the two-level tree this is just ``(region_id,)``.
        depth = len(fanouts)
        self._n_uplink_levels = depth - 1
        self._anc: list[tuple[int, ...]] = []
        for s in range(n_sites):
            anc = []
            nodes_below = n_sites
            for level in range(1, depth):
                nodes_below //= fanouts[level - 1]
                anc.append(s // nodes_below)
            self._anc.append(tuple(anc))
        # Flatten uplinks by level (top-down), so for two-level trees the
        # uplink index of a region's WAN link equals its region id.
        self._uplink_offset: list[int] = []
        self.wan_links: list[Link] = []
        n_nodes = 1
        scale: dict[tuple[int, int], float] = {}
        nodes_at = [1]
        for f in fanouts[:-1]:
            nodes_at.append(nodes_at[-1] * f)
        for level, node, factor in uplink_scale:
            if not 1 <= level <= depth - 1:
                raise ValueError(
                    f"uplink_scale level {level} out of range (1-based, "
                    f"1..{depth - 1})")
            if not 0 <= node < nodes_at[level]:
                raise ValueError(
                    f"uplink_scale node {node} out of range for level "
                    f"{level} (0..{nodes_at[level] - 1})")
            scale[(level, node)] = factor
        for level in range(1, depth):
            n_nodes *= fanouts[level - 1]
            self._uplink_offset.append(len(self.wan_links))
            bw = uplinks_bw[level - 1]
            for node in range(n_nodes):
                self.wan_links.append(
                    Link(f"up{level}.{node}", bw * scale.get((level, node), 1.0)))
        self.nic_links = [Link(f"nic{s.site_id}", lan_bandwidth) for s in self.sites]
        # Per-site uplink ids, top-down: _site_uplinks[s][lvl] is the index
        # into wan_links of the uplink owned by s's ancestor at internal
        # level lvl+1. uplink_path slices this table from the divergence
        # level, so path queries stay O(depth).
        self._site_uplinks: list[tuple[int, ...]] = [
            tuple(off + a for off, a in zip(self._uplink_offset, self._anc[s]))
            for s in range(n_sites)
        ]
        # flat region-id table: region_of is the replica strategies' inner
        # loop (millions of calls per run at the 500-site scale point)
        self._region_ids: list[int] = [s.region_id for s in self.sites]

    # -- structure queries ------------------------------------------------
    @property
    def n_sites(self) -> int:
        return len(self.sites)

    @property
    def depth(self) -> int:
        """Number of tier levels, counting the leaf (site) level."""
        return len(self.tier_fanouts)

    def region_of(self, site_id: int) -> int:
        return self._region_ids[site_id]

    def same_region(self, a: int, b: int) -> bool:
        return self.region_of(a) == self.region_of(b)

    def sites_in_region(self, region_id: int) -> list[int]:
        return list(self.regions[region_id].site_ids)

    def online_sites(self) -> list[int]:
        return [s.site_id for s in self.sites if s.online]

    def ancestors(self, site_id: int) -> tuple[int, ...]:
        """Global node index of each internal-level ancestor, top-down."""
        return self._anc[site_id]

    # -- bandwidth model ---------------------------------------------------
    def uplink_index(self, src: int, dst: int) -> int:
        """Index into ``wan_links`` of the topmost uplink a src->dst transfer
        crosses on the source side, or -1 for an intra-region transfer.

        For two-level trees this is exactly ``region_of(src)`` whenever the
        regions differ (one uplink per region, level-ordered flattening).
        """
        a = self._anc[src]
        b = self._anc[dst]
        if a[-1] == b[-1]:
            return -1
        for off, x, y in zip(self._uplink_offset, a, b):
            if x != y:
                return off + x
        raise AssertionError("ancestor tables inconsistent")

    def uplink_path(self, src: int, dst: int) -> tuple[int, ...]:
        """Indices into ``wan_links`` of every uplink a src->dst transfer
        crosses on the source side, topmost first; ``()`` for intra-region.

        Under ``path_model="topmost"`` this degrades to the legacy
        single-uplink accounting (the topmost crossed link only). For
        two-level trees both models return the same one-element path.
        """
        a = self._anc[src]
        b = self._anc[dst]
        if a[-1] == b[-1]:
            return ()
        for lvl, (x, y) in enumerate(zip(a, b)):
            if x != y:
                if self.path_model == "topmost":
                    return (self._site_uplinks[src][lvl],)
                return self._site_uplinks[src][lvl:]
        raise AssertionError("ancestor tables inconsistent")

    def links_for(self, src: int, dst: int) -> list[Link]:
        """Links traversed by a src->dst transfer (source-side model):
        the source NIC plus every crossed uplink (see ``uplink_path``)."""
        return [self.nic_links[src]] + [
            self.wan_links[u] for u in self.uplink_path(src, dst)]

    def link_ids_for(self, src: int, dst: int) -> tuple[int, ...]:
        """``links_for`` as indices into the unified link space used by
        :class:`repro_torch.core.network.NetworkEngine`: NICs occupy ids
        ``0..n_sites-1`` (id == site id) and ``wan_links[i]`` is id
        ``n_sites + i``."""
        n = len(self.sites)
        return (src,) + tuple(n + u for u in self.uplink_path(src, dst))

    def pair_link_matrix(self) -> "np.ndarray":
        """Every pair's :meth:`link_ids_for` row as one ``(n_sites,
        n_sites, depth)`` int tensor, -1 where no link is crossed
        (``[src, dst, 0]`` is always the source NIC). Built vectorized
        from the ancestor tables — at 500 sites the per-pair Python loop
        is 250k ``link_ids_for`` calls, which used to dominate broker
        construction. This is the shared path-tensor snapshot behind both
        :meth:`repro.core.network.NetworkEngine.point_bandwidth_matrix`
        and the jitted shortest-transfer broker; consumers mask on
        ``>= 0``, so hole positions within a row carry no meaning."""
        import numpy as np
        n = len(self.sites)
        levels = self._n_uplink_levels
        anc = np.asarray(self._anc, dtype=np.intp).reshape(n, levels)
        uplinks = np.asarray(self._site_uplinks,
                             dtype=np.intp).reshape(n, levels)
        out = np.full((n, n, self.depth), -1, np.intp)
        out[:, :, 0] = np.arange(n)[:, None]           # source NIC
        differs = anc[:, None, :] != anc[None, :, :]   # (S, S, levels)
        crosses = differs[:, :, -1]                    # leaf-group differs
        # first divergent level; meaningless where nothing differs, but
        # those pairs are masked by ``crosses`` below
        div = np.argmax(differs, axis=2)
        lvl = np.arange(levels)[None, None, :]
        if self.path_model == "topmost":
            use = crosses[:, :, None] & (lvl == div[:, :, None])
        else:
            use = crosses[:, :, None] & (lvl >= div[:, :, None])
        out[:, :, 1:] = np.where(use, uplinks[:, None, :] + n, -1)
        return out

    def point_bandwidth(self, src: int, dst: int) -> float:
        """Available bandwidth if one more transfer joined src->dst.

        This is what HRS uses for "maximum bandwidth available" replica
        selection: the bottleneck link's equal share with one more flow.
        (Open-coded ``min over links_for`` — this is the replica-selection
        inner loop.)
        """
        nic = self.nic_links[src]
        bw = nic.bandwidth / max(1, nic.active + 1)
        for u in self.uplink_path(src, dst):
            wan = self.wan_links[u]
            wbw = wan.bandwidth / max(1, wan.active + 1)
            if wbw < bw:
                bw = wbw
        return bw

    def is_inter_region(self, src: int, dst: int) -> bool:
        return not self.same_region(src, dst)
