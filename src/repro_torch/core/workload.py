"""Workload generation per the paper's Table 1.

5 job types; each job requires 12 files out of a catalog of 100 files
(50 GB total / 500 MB each); jobs are drawn uniformly from the 5 types.
Masters are distributed round-robin over sites (the paper does not fix the
initial placement; round-robin across all regions gives every region some
local data, which is the setting where the hierarchy matters).

Reproduction note (see DESIGN.md §8 and EXPERIMENTS.md): with *literally
fixed* 12-file sets per type, the system reaches a static equilibrium — each
type claims one home site holding its whole 6 GB working set (< 10 GB SE),
no eviction ever fires, and all replication strategies coincide exactly. The
paper's reported differences require per-job variation in the accessed
files. We therefore draw each job's 12 files Zipf-weighted from a
type-specific preference order over the catalog (``zipf_alpha``); setting
``zipf_alpha=None`` recovers the degenerate fixed-set reading.
"""

from __future__ import annotations

import dataclasses
import random as _random

from .catalog import ReplicaCatalog
from .quantities import GB, MB, MBPS_TO_BYTES_PER_S
from .scheduler import Job
from .topology import GridTopology


@dataclasses.dataclass
class GridConfig:
    """One experiment's full grid + workload configuration.

    The defaults reproduce the paper's Table 1 exactly: a 4-region x 13-site
    two-level grid with 10 GB SEs, 1000/10 Mbps LAN/WAN, 500 jobs drawn from
    5 types each requiring 12 of 100 x 500 MB files. Bandwidths are in
    bytes/s, sizes in bytes, job length in ops.

    Beyond-paper topology knobs (all default to "off", i.e. the paper grid):

    ``tier_fanouts``
        An n-level tier tree, e.g. ``(2, 4, 7)`` = 2 clusters of 4 groups of
        7 sites. When set it overrides ``n_regions``/``sites_per_region``
        (which describe the two-level special case) and requires
        ``uplink_bandwidths``, one per internal level, top-down.
    ``uplink_scale``
        Per-uplink bandwidth multipliers ``(level, node, factor)`` for
        heterogeneous ("fat-region") fabrics; level 1 is the topmost.
    ``storage_scale``
        Per-region SE-capacity multipliers ``(region, factor)``.

    Instances are usually produced from a named :class:`repro_torch.core.scenarios.
    ScenarioSpec` via ``to_grid_config`` rather than built by hand.
    """

    n_regions: int = 4
    sites_per_region: int = 13
    storage_capacity: float = 10 * GB
    lan_bandwidth: float = 1000.0 * MBPS_TO_BYTES_PER_S
    wan_bandwidth: float = 10.0 * MBPS_TO_BYTES_PER_S
    n_jobs: int = 500
    n_job_types: int = 5
    files_per_job: int = 12
    file_size: float = 500 * MB
    total_file_bytes: float = 50 * GB        # -> 100 distinct files
    job_length: float = 60e9                 # ops; transfer-dominated regime
    interarrival: float = 60.0               # seconds between submissions
    zipf_alpha: float | None = 0.9           # per-job file draw skew (None=fixed sets)
    hotset_shifts: int = 0                   # mid-run hot-set reshuffles (drift)
    seed: int = 0
    # -- beyond-paper topology shape (None/() = the paper's 2-level grid) --
    tier_fanouts: tuple[int, ...] | None = None
    uplink_bandwidths: tuple[float, ...] | None = None   # bytes/s, top-down
    uplink_scale: tuple[tuple[int, int, float], ...] = ()
    storage_scale: tuple[tuple[int, float], ...] = ()

    @classmethod
    def from_dict(cls, d: dict) -> "GridConfig":
        """Inverse of ``dataclasses.asdict`` (of this class or of the
        reference package's ``GridConfig``): list-valued fields come back
        as the tuples the frozen topology knobs expect."""
        d = dict(d)
        for key in ("tier_fanouts", "uplink_bandwidths"):
            if d.get(key) is not None:
                d[key] = tuple(d[key])
        for key in ("uplink_scale", "storage_scale"):
            if key in d:
                d[key] = tuple(tuple(row) for row in d[key])
        return cls(**d)

    @property
    def n_files(self) -> int:
        return int(self.total_file_bytes / self.file_size)

    @property
    def n_sites(self) -> int:
        if self.tier_fanouts is not None:
            n = 1
            for f in self.tier_fanouts:
                n *= f
            return n
        return self.n_regions * self.sites_per_region


def build_topology(cfg: GridConfig, path_model: str = "full") -> GridTopology:
    return GridTopology(
        cfg.n_regions, cfg.sites_per_region,
        lan_bandwidth=cfg.lan_bandwidth, wan_bandwidth=cfg.wan_bandwidth,
        storage_capacity=cfg.storage_capacity, seed=cfg.seed,
        tier_fanouts=cfg.tier_fanouts,
        uplink_bandwidths=cfg.uplink_bandwidths,
        uplink_scale=cfg.uplink_scale, storage_scale=cfg.storage_scale,
        path_model=path_model,
    )


def build_catalog(cfg: GridConfig, topology: GridTopology) -> ReplicaCatalog:
    catalog = ReplicaCatalog()
    n_sites = topology.n_sites
    for i in range(cfg.n_files):
        master = (i * 7) % n_sites    # deterministic spread over regions
        catalog.register_file(f"lfn{i:04d}", cfg.file_size, master)
    return catalog


def job_type_filesets(cfg: GridConfig) -> list[list[str]]:
    """Each job type's 12 required files, deterministic under the seed.

    Types overlap partially (drawn without replacement per type from the
    full catalog) — overlap is what makes replication pay off.
    """
    rng = _random.Random(cfg.seed + 1)
    names = [f"lfn{i:04d}" for i in range(cfg.n_files)]
    return [rng.sample(names, cfg.files_per_job) for _ in range(cfg.n_job_types)]


def type_preference_orders(cfg: GridConfig, phase: int = 0) -> list[list[str]]:
    """A preference-ordered permutation of the whole catalog per job type.

    ``phase`` re-seeds the permutation — phase 0 is the classic ordering
    (bit-identical to the pre-``hotset_shifts`` generator); higher phases
    are the shifted hot sets of a drifting workload.
    """
    rng = _random.Random(cfg.seed + 1 + 7919 * phase)
    names = [f"lfn{i:04d}" for i in range(cfg.n_files)]
    orders = []
    for _ in range(cfg.n_job_types):
        perm = list(names)
        rng.shuffle(perm)
        orders.append(perm)
    return orders


def _zipf_draw(rng: _random.Random, order: list[str], k: int, alpha: float,
               cum: list[float]) -> list[str]:
    """k distinct files, position i of `order` weighted 1/(i+1)^alpha."""
    chosen: set[int] = set()
    total = cum[-1]
    while len(chosen) < k:
        u = rng.random() * total
        lo, hi = 0, len(cum) - 1
        while lo < hi:                      # first cum[i] > u
            mid = (lo + hi) // 2
            if cum[mid] > u:
                hi = mid
            else:
                lo = mid + 1
        chosen.add(lo)
    return [order[i] for i in sorted(chosen)]


def generate_jobs(cfg: GridConfig, n_jobs: int | None = None) -> list[Job]:
    rng = _random.Random(cfg.seed + 2)
    n = cfg.n_jobs if n_jobs is None else n_jobs
    jobs = []
    if cfg.zipf_alpha is None:
        if cfg.hotset_shifts:
            raise ValueError("hotset_shifts needs a Zipf workload "
                             "(zipf_alpha=None draws fixed per-type "
                             "filesets, which cannot drift)")
        filesets = job_type_filesets(cfg)
        for j in range(n):
            jt = rng.randrange(cfg.n_job_types)
            jobs.append(Job(job_id=j, job_type=jt, required=list(filesets[jt]),
                            length=cfg.job_length))
        return jobs
    # hot-set drift: the job stream is split into hotset_shifts + 1 equal
    # phases, each drawing from its own preference orders. With the default
    # hotset_shifts=0 this is exactly the classic single-phase generator
    # (same rng consumption, same orders) — bit-identical workloads.
    n_phases = cfg.hotset_shifts + 1
    orders_by_phase = [type_preference_orders(cfg, p) for p in range(n_phases)]
    weights = [1.0 / (i + 1) ** cfg.zipf_alpha for i in range(cfg.n_files)]
    cum = []
    acc = 0.0
    for w in weights:
        acc += w
        cum.append(acc)
    for j in range(n):
        jt = rng.randrange(cfg.n_job_types)
        orders = orders_by_phase[j * n_phases // max(1, n)]
        req = _zipf_draw(rng, orders[jt], cfg.files_per_job, cfg.zipf_alpha, cum)
        jobs.append(Job(job_id=j, job_type=jt, required=req,
                        length=cfg.job_length))
    return jobs
