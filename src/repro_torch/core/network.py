"""Path-contention fluid network engine over device-resident slot tensors.

The counterpart of ``repro.core.network``: the same slot-indexed fluid
model (a transfer's rate is the min over *every* link of its padded
``(slots, depth)`` path of ``bandwidth / max(1, active)``, over the unified
NIC + WAN link space of ``GridTopology.link_ids_for``), the same backends
(the ``net=`` flag) and the same results bit for bit. What moves is where
the per-slot state lives: ``rem``, ``rate``, ``eta``, ``due``, ``active``
and the path matrix are tensors on the engine's ``device``, and every
re-rate goes through a kernel (:mod:`repro_torch.kernels`).

Backends:

``"numpy"`` / ``"pallas"``
    Incremental re-rating: the union of the changed links' member slots is
    re-rated, then the whole array is scanned for the next completion — the
    ``net_rerate`` kernel. The reference guarantees the two give identical
    results, so they are one route here. On the CPU, ``"numpy"`` keeps the
    reference's scalar fast path for unions of at most four slots.

``"device"``
    The batched event engine: ``rerate`` only marks links dirty and the
    simulator calls :meth:`flush` once per drained event instant, which
    re-rates the dirty neighbourhood (the merged members of the dirty
    links, never the whole array — a full-array flush would move cached
    etas by an ulp), reconstructs remaining bytes from the cached
    ``(rate, eta)`` pair and returns the earliest eta — the
    ``event_engine`` kernel.

On ``device="cuda"`` the kernels run on the card; on ``device="cpu"`` the
same calls run their plain PyTorch versions in float64. The Pallas
interpreter routes of the reference (``"pallas-interpret"``,
``"device-interpret"``) have no counterpart.

Host/device traffic: link occupancy (``link_bw``/``link_act``), member
lists and the path matrix's master copy stay on the host, because the
topology ``Link`` objects mirror them and alloc/release are host events.
Slot writes made by :meth:`alloc`/:meth:`release` are staged on the host
and applied in one scatter before anything reads the slot tensors, so a
transfer start costs no launch; link arrays and the re-rate index list go
up in one copy per kernel call.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.event_engine import event_engine
from ..kernels.net_rerate import net_rerate
from .topology import GridTopology

# A transfer is complete when less than one byte remains (see the
# reference engine: sub-byte residue would starve the event loop).
_DONE_EPS = 1.0

BACKENDS = ("numpy", "pallas", "pallas-interpret", "device",
            "device-interpret")


class NetworkEngine:
    """Slot-indexed fluid-model transfer network (see module docstring)."""

    def __init__(self, topology: GridTopology, backend: str = "numpy", *,
                 device: "str | torch.device" = "cuda") -> None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown network backend {backend!r} "
                             f"(want one of {BACKENDS})")
        if backend.endswith("-interpret"):
            raise NotImplementedError(
                f"net={backend!r} runs a Pallas kernel under the Pallas "
                "interpreter; the port has no interpreter route — use "
                f"net={backend.split('-')[0]!r}")
        self.topology = topology
        self.backend = backend
        self.device = resolve_device(device)
        self.batched = backend == "device"
        # the reference's scalar fast path for tiny unions, kept on the CPU
        self._scalar_rates = (backend == "numpy"
                              and self.device.type == "cpu")
        n_sites = topology.n_sites
        self.n_links = n_sites + len(topology.wan_links)
        # the engine is the sole bookkeeper of link occupancy: alloc and
        # release update both the topology Link objects and the float
        # mirror link_act (exact — the counts are small integers). Both
        # rows live in one host buffer so a kernel call uploads them in
        # one copy.
        self._link_objs = list(topology.nic_links) + list(topology.wan_links)
        self._links = np.array(
            [[l.bandwidth for l in self._link_objs],
             [float(l.active) for l in self._link_objs]], np.float64)
        # per-link member slots as insertion-ordered dicts: iteration order
        # is allocation order, so re-rate batches are reproducible
        self.members: list[dict[int, None]] = [
            {} for _ in range(self.n_links)]
        self.max_links = topology.depth        # NIC + up to depth-1 uplinks
        self.cap = 64
        dev = self.device
        self.rem = torch.zeros(self.cap, dtype=torch.float64, device=dev)
        self.rate = torch.zeros(self.cap, dtype=torch.float64, device=dev)
        # per-slot completion time cached by the last flush (inf where the
        # slot has no rate) and the deadline due = eta - eps/rate
        self.eta = torch.full((self.cap,), math.inf, dtype=torch.float64,
                              device=dev)
        self.due = torch.full((self.cap,), math.inf, dtype=torch.float64,
                              device=dev)
        self.active = torch.zeros(self.cap, dtype=torch.bool, device=dev)
        # int32 on the device, as the kernels read it
        self.path = torch.full((self.cap, self.max_links), -1,
                               dtype=torch.int32, device=dev)
        # host master copy of the path matrix (alloc/release write it,
        # release and the scalar fast path read it)
        self._path = np.full((self.cap, self.max_links), -1, np.int64)
        # slot -> (rem, active) written by alloc/release since the last
        # scatter; rate 0, eta/due inf and the host path row go with it
        self._staged: dict[int, tuple[float, bool]] = {}
        self.obj: list[Optional[object]] = [None] * self.cap
        self._free = list(range(self.cap - 1, -1, -1))
        self.n_active = 0
        self.last = 0.0                        # last advance() timestamp
        self.dirty = False                     # batched: flush pending?
        # batched: links whose occupancy moved since the last flush
        self._dirty_links: dict[int, None] = {}
        # per-event work counters, as in the reference engine
        self.stats = {"rerate_calls": 0, "rerate_slots": 0,
                      "flush_passes": 0, "flush_slots": 0}

    @property
    def link_bw(self) -> np.ndarray:
        return self._links[0]

    @property
    def link_act(self) -> np.ndarray:
        return self._links[1]

    # -- slot lifecycle ----------------------------------------------------
    def _grow(self) -> None:
        old = self.cap
        self.cap = old * 2
        dev = self.device

        def ext(t: torch.Tensor, fill) -> torch.Tensor:
            pad = torch.full((old,) + tuple(t.shape[1:]), fill,
                             dtype=t.dtype, device=dev)
            return torch.cat([t, pad])

        self.rem = ext(self.rem, 0.0)
        self.rate = ext(self.rate, 0.0)
        self.eta = ext(self.eta, math.inf)
        self.due = ext(self.due, math.inf)
        self.active = ext(self.active, False)
        self.path = ext(self.path, -1)
        self._path = np.concatenate(
            [self._path, np.full((old, self.max_links), -1, np.int64)])
        self.obj.extend([None] * old)
        self._free.extend(range(self.cap - 1, old - 1, -1))

    def alloc(self, tr, size: float, links: tuple[int, ...]) -> int:
        """Claim a slot for ``tr`` (sets ``tr.slot``), register it on every
        link of ``links`` (unified ids, source NIC first)."""
        if not self._free:
            self._grow()
        slot = self._free.pop()
        tr.slot = slot
        row = self._path[slot]
        row[:] = -1
        row[: len(links)] = links
        # unrated: rate 0, eta/due inf, so a flush reads rem verbatim
        self._staged[slot] = (size, True)
        self.obj[slot] = tr
        self.n_active += 1
        act = self._links[1]
        for li in links:
            self.members[li][slot] = None
            act[li] += 1.0
            self._link_objs[li].active += 1
        return slot

    def release(self, tr) -> tuple[int, ...]:
        """Free ``tr``'s slot and de-register its links; returns the link
        ids whose occupancy changed (feed them back into ``rerate``)."""
        slot = tr.slot
        links = tuple(int(li) for li in self._path[slot] if li >= 0)
        self._staged[slot] = (0.0, False)
        self._path[slot, :] = -1
        self.obj[slot] = None
        self.n_active -= 1
        act = self._links[1]
        for li in links:
            self.members[li].pop(slot, None)
            act[li] -= 1.0
            self._link_objs[li].active -= 1
        self._free.append(slot)
        tr.slot = -1
        return links

    def _apply_staged(self) -> None:
        """Scatter the staged alloc/release writes into the slot tensors
        (one host-to-device copy). Every reader of the slot tensors calls
        this first."""
        if not self._staged:
            return
        staged, self._staged = self._staged, {}
        slots = list(staged)
        n, depth = len(slots), self.max_links
        buf = np.empty((3 + depth, n))
        buf[0] = slots
        buf[1:3] = np.array(list(staged.values()), np.float64).T
        buf[3:] = self._path[slots].T
        t = self._to_device(buf)
        idx = t[0].long()
        self.rem[idx] = t[1]
        # index_fill_, not `x[idx] = scalar`: the latter copies the scalar
        # to the device and synchronises
        self.rate.index_fill_(0, idx, 0.0)
        self.eta.index_fill_(0, idx, math.inf)
        self.due.index_fill_(0, idx, math.inf)
        self.active[idx] = t[2] > 0.0
        self.path[idx] = t[3:].T.int()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t if self.device.type == "cpu" else t.to(self.device)

    def _kernel_inputs(self, slots: list[int]
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(idx, link_bw, link_act)`` on the device, in one copy; ``idx``
        is int32, as the kernels take it."""
        n_links = self.n_links
        buf = np.empty(2 * n_links + len(slots))
        buf[: 2 * n_links] = self._links.ravel()
        buf[2 * n_links:] = slots
        t = self._to_device(buf)
        return (t[2 * n_links:].int(), t[:n_links],
                t[n_links: 2 * n_links])

    # -- state transfer ----------------------------------------------------
    def load_arrays(self, arrays: dict, members) -> None:
        """Put the engine into a given mid-run state: ``arrays`` holds
        numpy ``rem``, ``rate``, ``eta``, ``due``, ``path``, ``active``,
        ``link_bw`` and ``link_act`` (a reference engine's arrays), and
        ``members`` its per-link member slot lists, in order. Free slots
        are the inactive ones, lowest handed out first; slot owners are
        unknown (``obj`` is cleared)."""
        dev = self.device
        rem = np.asarray(arrays["rem"], np.float64)
        self.cap = rem.shape[0]
        for name in ("rem", "rate", "eta", "due"):
            setattr(self, name, torch.tensor(
                np.asarray(arrays[name], np.float64), device=dev))
        active = np.asarray(arrays["active"], bool)
        self.active = torch.tensor(active, device=dev)
        self._path = np.array(arrays["path"], np.int64)
        self.max_links = self._path.shape[1]
        self.path = torch.tensor(self._path, dtype=torch.int32, device=dev)
        self._links[0] = arrays["link_bw"]
        self._links[1] = arrays["link_act"]
        for li, link in enumerate(self._link_objs):
            link.active = int(self._links[1][li])
        self.members = [dict.fromkeys(int(s) for s in m) for m in members]
        self.obj = [None] * self.cap
        self._free = [s for s in range(self.cap - 1, -1, -1)
                      if not active[s]]
        self.n_active = int(active.sum())
        self._staged = {}
        self._dirty_links = {}
        self.dirty = False

    def arrays(self) -> dict[str, np.ndarray]:
        """Host copies of the engine state, keyed as :meth:`load_arrays`
        takes them."""
        self._apply_staged()
        out = {name: getattr(self, name).cpu().numpy().copy()
               for name in ("rem", "rate", "eta", "due", "active", "path")}
        out["link_bw"] = self.link_bw.copy()
        out["link_act"] = self.link_act.copy()
        return out

    # -- fluid model -------------------------------------------------------
    def advance(self, now: float) -> None:
        """Integrate all active transfers to ``now``. The batched backend
        reconstructs ``rem`` from ``(rate, eta)`` instead, so there
        advancing just moves the clock."""
        if self.batched:
            self.last = now
            return
        dt = now - self.last
        if dt > 0:
            self._apply_staged()
            # rate*dt and the subtraction are separate ops: never an FMA
            torch.clamp_min(self.rem - self.rate * dt, 0.0, out=self.rem)
        self.last = now

    def completions(self) -> list[int]:
        """Slot indices of active transfers with < 1 byte remaining, in
        ascending order (one device-to-host copy of the mask)."""
        self._apply_staged()
        if self.batched:
            # released/fresh slots carry due = inf, so the deadline
            # compare alone is the active-and-due mask
            done = self.due <= self.last
        else:
            done = self.active & (self.rem <= _DONE_EPS)
        return np.flatnonzero(done.cpu().numpy()).tolist()

    def _member_union(self, links) -> list[int]:
        """Member slots of ``links``, merged in link order then allocation
        order (a slot on several of the links appears once)."""
        links = list(links)
        if len(links) == 1:
            return list(self.members[links[0]])
        merged: dict[int, None] = {}
        for li in links:
            merged.update(self.members[li])
        return list(merged)

    def rerate(self, changed: Iterable[int], now: float) -> Optional[float]:
        """Refresh rates after the occupancy of ``changed`` links moved;
        return the next completion time (None when nothing is draining).
        On the batched backend this only records the dirty links."""
        self.stats["rerate_calls"] += 1
        if self.batched:
            for li in changed:
                self._dirty_links[li] = None
            self.dirty = True
            return None
        slots = self._member_union(changed)
        self.stats["rerate_slots"] += len(slots)
        self._apply_staged()
        if self._scalar_rates and len(slots) <= 4:
            # the reference's scalar fast path: rates in Python floats
            # (the same IEEE divisions), then the scan alone on the tensors
            bw, act = self._links
            rates = []
            for sl in slots:
                r = math.inf
                for li in self._path[sl]:
                    if li < 0:
                        break
                    s = bw[li] / max(1.0, act[li])
                    if s < r:
                        r = s
                rates.append(r)
            if slots:
                self.rate[slots] = torch.tensor(rates, dtype=torch.float64)
            slots = []
        idx, bw_t, act_t = self._kernel_inputs(slots)
        eta = net_rerate(idx, self.path, self.rem, self.rate, bw_t, act_t,
                         now)
        if self.n_active == 0 or not math.isfinite(eta):
            return None
        return eta

    def flush(self, now: float) -> Optional[float]:
        """Batched backend only: fold every occupancy change recorded since
        the last flush into one fused reconstruct + re-rate + deadline pass
        over the dirty neighbourhood, clear the dirty state, and return the
        earliest completion time over all slots (None when nothing is
        draining)."""
        self.dirty = False
        self.last = now
        self.stats["flush_passes"] += 1
        if self.n_active == 0:
            self._dirty_links.clear()
            return None
        slots = self._member_union(self._dirty_links)
        self._dirty_links.clear()
        self.stats["flush_slots"] += len(slots)
        self._apply_staged()
        idx, bw_t, act_t = self._kernel_inputs(slots)
        eta_min = event_engine(idx, self.path, self.rem, self.rate, self.eta,
                               self.due, bw_t, act_t, now)
        return eta_min if math.isfinite(eta_min) else None
