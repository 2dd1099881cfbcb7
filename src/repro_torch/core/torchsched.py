"""Vectorized dataaware dispatch for the batch broker (``broker="jax"``).

The counterpart of the ``dataaware`` part of ``repro.core.jaxsched``: the
paper's decision — argmax over sites of ``S_s``, the bytes of the job's
required files a site already holds, with a relative-load tie-break — as
tensor ops over

  presence:  bool[n_sites, n_files]  — replica catalog as a bitmap
  sizes:     f64[n_files]            — file sizes
  required:  bool[n_files]           — the job's R_j as a mask
  load:      f32[n_sites]            — queued work per site
  capacity:  f32[n_sites]            — CE capacity per site
  online:    bool[n_sites]

Scores are float64. The reference scores in float32 and calls the sums
exact because file sizes are uniform, but with 500 MB files a sum of nine
or more is not representable in float32, and the rounding then depends on
the GEMM's summation order: sites holding the same files can score apart.
In float64 every such sum is an exact integer, so any order (CPU BLAS,
cuBLAS) gives the same scores. The tie-break keeps the reference's float32
``load / capacity``; ``torch.argmin`` returns the first minimum, as
``jnp.argmin`` does.

The presence bitmap is kept current on the host by catalog change
listeners (one cell per replica add/evict/loss) and goes to the device
once per dispatched burst.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from .catalog import ReplicaCatalog
from .topology import GridTopology


def select_site_vec(presence, sizes, required, load, capacity, online):
    """Paper §3.2 for one job. Returns the chosen site index (0-d)."""
    s = (presence & required[None, :]).to(sizes.dtype) @ sizes  # [n_sites]
    s = torch.where(online, s, -1.0)
    tie = s >= s.max()                                          # max-S_s sites
    rel = torch.where(tie, load / capacity, math.inf)
    return torch.argmin(rel)                          # first min = min (rel, id)


def select_sites_batch(presence, sizes, masks, load, capacity, online):
    """Batched :func:`select_site_vec` as one GEMM:
    ``(masks * sizes) @ presence.T`` gives every job's per-site bytes."""
    w = masks.to(sizes.dtype) * sizes                           # [jobs, files]
    s = w @ presence.T.to(sizes.dtype)                          # [jobs, sites]
    s = torch.where(online[None, :], s, -1.0)
    tie = s >= s.max(dim=1, keepdim=True).values
    rel = torch.where(tie, (load / capacity)[None, :], math.inf)
    return torch.argmin(rel, dim=1)


class TorchScheduler:
    """Array-backed mirror of (catalog, topology) for batched dispatch.

    The presence bitmap is maintained **incrementally** on the host: the
    broker registers as a catalog change listener and flips single cells
    as replicas are added/evicted/lost. Files registered after
    construction are picked up by the lazy :meth:`sync`, which rebuilds
    the file axis carrying maintained columns over.
    """

    def __init__(self, catalog: ReplicaCatalog, topology: GridTopology, *,
                 device: "str | torch.device" = "cuda") -> None:
        self.catalog = catalog
        self.topology = topology
        self.device = resolve_device(device)
        self.lfns = sorted(catalog.files)
        self.lfn_index = {l: i for i, l in enumerate(self.lfns)}
        self._sizes_np = np.array([catalog.size(l) for l in self.lfns],
                                  np.float64)
        self.sizes = torch.tensor(self._sizes_np, device=self.device)
        self._n_catalog = len(catalog.files)
        self._presence: np.ndarray | None = None    # built on first use
        catalog.add_listener(self)

    # -- catalog change listeners (incremental presence maintenance) -------
    def on_register_file(self, lfn: str) -> None:
        """New file axis entry; the next :meth:`sync` rebuilds."""

    def on_add_replica(self, lfn: str, site_id: int) -> None:
        if self._presence is not None:
            j = self.lfn_index.get(lfn)
            if j is not None:
                self._presence[site_id, j] = True

    def on_remove_replica(self, lfn: str, site_id: int) -> None:
        if self._presence is not None:
            j = self.lfn_index.get(lfn)
            if j is not None:
                self._presence[site_id, j] = False

    # -- catalog sync ------------------------------------------------------
    def sync(self) -> None:
        """Pick up files registered in the catalog *after* construction:
        rebuild the file axis in sorted order, carrying the maintained
        presence columns over by LFN and filling new columns from the
        catalog. No-op when the catalog is unchanged."""
        if len(self.catalog.files) == self._n_catalog:
            return
        old_index = self.lfn_index
        old_presence = self._presence
        self.lfns = sorted(self.catalog.files)
        self.lfn_index = {l: i for i, l in enumerate(self.lfns)}
        self._sizes_np = np.array([self.catalog.size(l) for l in self.lfns],
                                  np.float64)
        self.sizes = torch.tensor(self._sizes_np, device=self.device)
        if old_presence is not None:
            presence = np.zeros((self.topology.n_sites, len(self.lfns)), bool)
            for j, lfn in enumerate(self.lfns):
                i = old_index.get(lfn)
                if i is not None:
                    presence[:, j] = old_presence[:, i]
                else:
                    self._fill_column(presence, j, lfn)
            self._presence = presence
        self._n_catalog = len(self.catalog.files)

    def _fill_column(self, presence: np.ndarray, j: int, lfn: str) -> None:
        """One file's presence column from the catalog's holder set."""
        for h in sorted(self.catalog.holders(lfn)):
            presence[h, j] = True

    # -- host-side snapshot pieces -----------------------------------------
    def presence_np(self) -> np.ndarray:
        """bool[n_sites, n_files] replica bitmap (all holders); the live
        maintained array — treat it as read-only."""
        self.sync()
        if self._presence is None:
            presence = np.zeros((self.topology.n_sites, len(self.lfns)), bool)
            for j, lfn in enumerate(self.lfns):
                self._fill_column(presence, j, lfn)
            self._presence = presence
        return self._presence

    def site_state_np(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(load, capacity, online) per-site vectors."""
        load = np.array([s.queued_work for s in self.topology.sites], np.float32)
        cap = np.array([s.compute_capacity for s in self.topology.sites], np.float32)
        online = np.array([s.online for s in self.topology.sites], bool)
        return load, cap, online

    def required_np(self, required_sets: list[list[str]]) -> np.ndarray:
        """bool[n_jobs, n_files] requirement masks (R_j rows)."""
        self.sync()
        m = np.zeros((len(required_sets), len(self.lfns)), dtype=bool)
        for i, req in enumerate(required_sets):
            for lfn in req:
                m[i, self.lfn_index[lfn]] = True
        return m

    @staticmethod
    def _check_online(online: np.ndarray) -> None:
        """All-offline guard: raise what the sequential policy's empty
        ``max`` raises instead of dispatching to (offline) site 0."""
        if not online.any():
            raise ValueError("no online sites to dispatch to")

    def snapshot(self):
        load, cap, online = self.site_state_np()
        self._check_online(online)
        dev = self.device
        return (torch.tensor(self.presence_np(), device=dev), self.sizes,
                torch.tensor(load, device=dev), torch.tensor(cap, device=dev),
                torch.tensor(online, device=dev))

    def select_batch(self, required_sets: list[list[str]]) -> list[int]:
        presence, sizes, load, cap, online = self.snapshot()
        masks = torch.tensor(self.required_np(required_sets),
                             device=self.device)
        # one device-to-host copy for the whole batch
        return select_sites_batch(presence, sizes, masks, load, cap,
                                  online).tolist()
