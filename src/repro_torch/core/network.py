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
Slot writes made by :meth:`alloc`/:meth:`release` are staged on the host,
so a transfer start costs no launch. A re-rate or flush packs the link
rows, the staged writes and the index list into one buffer
(:class:`~repro_torch.kernels.net_call.NetInputs`), and its kernel applies
the staged writes first: on the card, one copy up from page-locked memory,
one launch and one sync per call. The other readers of the slot tensors
(``advance``, ``completions``, ``arrays``) apply the staged writes in one
scatter of their own first (:meth:`_apply_staged`); :meth:`slot_state`
and :meth:`rem_now` lay them over a host copy instead.

The point-bandwidth queries (:meth:`point_bandwidth_matrix`,
:meth:`point_bandwidth_columns`) serve the batched planners, the
shortest-transfer broker and the replication economy: a gather-min of the
link shares over the static ``(sites, sites, depth)`` pair-path tensor,
which goes to the device once, as int32; the link arrays go up in one copy
per query. The singleton planner route reads one column on the host
(:meth:`point_bandwidth_column`).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.event_engine import event_engine
from ..kernels.net_call import NetInputs, SlotArrays
from ..kernels.net_rerate import net_rerate
from ..kernels.share import scatter_staged
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
        self._bind()
        # the kernel calls' packed host inputs, reused call after call
        self._inputs = NetInputs(self.n_links, self.max_links, dev)
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
        # the static (sites, sites, depth) pair-path tensor, built at first
        # use: the host copy (np.intp, -1 padded) feeds the per-destination
        # host columns, the device copy (int32, -1 mapped to the inf
        # sentinel index n_links) the device gather-mins
        self._pair_paths: Optional[np.ndarray] = None
        self._pair_idx: Optional[torch.Tensor] = None
        self._col_paths: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    @property
    def link_bw(self) -> np.ndarray:
        return self._links[0]

    @property
    def link_act(self) -> np.ndarray:
        return self._links[1]

    def _bind(self) -> None:
        """Check the slot tensors as the kernels take them; called wherever
        they are made or replaced, not per kernel call."""
        self._slots = SlotArrays(self.path, self.rem, self.rate, self.eta,
                                 self.due, self.active)

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
        self._bind()
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
        (one host-to-device copy). The readers of the slot tensors other
        than the kernel calls (which take the staged rows themselves,
        :meth:`_pack`) call this first."""
        if not self._staged:
            return
        staged, self._staged = self._staged, {}
        slots = list(staged)
        depth = self.max_links
        buf = np.empty((3 + depth, len(slots)))
        buf[0] = slots
        buf[1:3] = np.array(list(staged.values()), np.float64).T
        buf[3:] = self._path[slots].T
        t = self.to_device(buf)
        scatter_staged((t[0], t[1], t[2], t[3:].T), self.path, self.rem,
                       self.rate, self.eta, self.due, self.active)

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the engine's device in one host-to-device copy (on
        the CPU, a tensor sharing ``a``'s memory)."""
        t = torch.from_numpy(a)
        return t if self.device.type == "cpu" else t.to(self.device)

    def _pack(self, slots: list[int]) -> NetInputs:
        """One kernel call's inputs, packed: the link rows, the staged
        alloc/release writes (which the call applies first, so they are
        cleared here) and the index list ``slots``."""
        staged, self._staged = self._staged, {}
        st = list(staged)
        vals = list(staged.values())
        return self._inputs.pack(self._links, st, [v[0] for v in vals],
                                 [v[1] for v in vals], self._path[st], slots)

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
        self._bind()
        if self._inputs.depth != self.max_links:
            self._inputs = NetInputs(self.n_links, self.max_links, dev)
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

    # -- bandwidth queries -------------------------------------------------
    def point_bandwidth(self, src: int, dst: int) -> float:
        """Available bandwidth if one more transfer joined ``src -> dst``,
        from the engine's host link arrays: the min over the pair's links
        of ``bandwidth / (active + 1)``, equal bit for bit to
        :meth:`GridTopology.point_bandwidth` (the replication economy's
        source pick reads it)."""
        bw_l, act = self._links
        bw = math.inf
        for li in self.topology.link_ids_for(src, dst):
            share = bw_l[li] / (act[li] + 1.0)
            if share < bw:
                bw = share
        return float(bw)

    def _pair_path_host(self) -> np.ndarray:
        if self._pair_paths is None:
            self._pair_paths = self.topology.pair_link_matrix()
        return self._pair_paths

    def _device_shares(self, extra: Optional[np.ndarray] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(shares, extra)`` on the device from one copy: the per-link
        ``bandwidth / (active + 1)`` with an ``inf`` sentinel appended at
        index ``n_links`` (where the path tensor's padding points), and
        ``extra`` (float64 values sent up in the same buffer)."""
        n = self.n_links
        extra = np.empty(0) if extra is None else extra
        buf = np.empty(2 * n + extra.size)
        buf[: 2 * n] = self._links.ravel()
        buf[2 * n:] = extra
        t = self.to_device(buf)
        shares = torch.empty(n + 1, dtype=torch.float64, device=t.device)
        shares[:n] = t[:n] / (t[n: 2 * n] + 1.0)
        shares[n:].fill_(math.inf)
        if self._pair_idx is None:
            p = self._pair_path_host()
            self._pair_idx = self.to_device(
                np.where(p >= 0, p, n).astype(np.int32))
        return shares, t[2 * n:]

    def point_bandwidth_matrix(self) -> torch.Tensor:
        """``B[h, s]`` = :meth:`point_bandwidth` for every (source, dst)
        pair as one ``(sites, sites)`` float64 tensor on the engine's
        device: a gather-min of the link shares over the static pair-path
        tensor, which lives on the device (int32, 3 MB at 500 sites); the
        link arrays go up in one copy per call. The shared snapshot the
        shortest-transfer broker and the replication economy price with.
        Divide and min are exact, so it equals the reference's numpy
        matrix bit for bit."""
        shares, _ = self._device_shares()
        return shares[self._pair_idx].amin(dim=-1)

    def point_bandwidth_columns(self, dsts) -> torch.Tensor:
        """Destination columns of :meth:`point_bandwidth_matrix`,
        ``(sites, len(dsts))`` on the device, without building the full
        matrix — the batched planners' per-burst read. Destinations repeat
        within a burst, so each distinct column is gathered once and then
        replicated (the unique runs on the host, and goes up with the link
        arrays in one copy)."""
        u, inv = np.unique(np.asarray(dsts, np.intp), return_inverse=True)
        shares, ix = self._device_shares(np.concatenate([u, inv]))
        ix = ix.long()
        cols = shares[self._pair_idx[:, ix[: u.size], :]].amin(dim=-1)
        return cols[:, ix[u.size:]]

    def point_bandwidth_column(self, dst: int) -> np.ndarray:
        """One destination column, ``(sites,)``, on the host: the batched
        planners' singleton replan route, which needs it on the host
        anyway. The reference's numpy expression over the host link arrays
        and a cached slice of the host path tensor — bit-identical to
        ``point_bandwidth_columns([dst])[:, 0]``."""
        cached = self._col_paths.get(dst)
        if cached is None:
            p = self._pair_path_host()[:, dst, :]
            cached = (np.ascontiguousarray(np.maximum(p, 0)), p >= 0)
            self._col_paths[dst] = cached
        idx, valid = cached
        share = self.link_bw / (self.link_act + 1.0)
        return np.where(valid, share[idx], np.inf).min(axis=-1)

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

    def slot_state(self, now: Optional[float] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """``(rem_now(now), rate)`` per slot as host arrays, from one
        device-to-host copy, with the staged alloc/release writes laid
        over it (the slot tensors are not touched)."""
        rem, rate, eta = torch.stack(
            [self.rem, self.rate, self.eta]).cpu().numpy()
        for slot, (size, _) in self._staged.items():
            rem[slot], rate[slot], eta[slot] = size, 0.0, math.inf
        if self.batched:
            # the reference's expression, in numpy on the host as there
            if now is None:
                now = self.last
            carried = rate > 0.0
            eta_c = np.where(carried, eta, 0.0)
            rem = np.maximum(
                np.where(carried, rate * (eta_c - now), rem), 0.0)
        return rem, rate

    def rem_now(self, now: Optional[float] = None) -> np.ndarray:
        """Remaining bytes per slot at ``now`` (default: the clock set by
        the last :meth:`advance`/:meth:`flush`), as a host array. On the
        batched backend this reconstructs ``rate * (eta - now)`` for slots
        the last flush rated — the exact formulation the flush pass itself
        uses — and reads the stored ``rem`` for fresh/released slots; on
        the incremental backends ``rem`` is already integrated and is
        returned as it stands."""
        return self.slot_state(now)[0]

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
        if self._scalar_rates and len(slots) <= 4:
            # the reference's scalar fast path (CPU only): rates in Python
            # floats (the same IEEE divisions), written after the staged
            # writes, then the scan alone on the tensors
            self._apply_staged()
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
        eta = net_rerate(self._pack(slots), self._slots, now)
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
        eta_min = event_engine(self._pack(slots), self._slots, now)
        return eta_min if math.isfinite(eta_min) else None
