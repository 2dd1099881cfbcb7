"""The call shape both network kernels share (``csrc/share_rate.cuh``).

An engine call of ``net_rerate`` or ``event_engine`` takes two things:

:class:`SlotArrays`
    The engine's per-slot tensors (``path``, ``rem``, ``rate``, ``eta``,
    ``due``, ``active``), checked once when they are made or replaced
    (the engine's ``__init__``, ``_grow``, ``load_arrays``), not on every
    call. On a card it also holds their device addresses.
:class:`NetInputs`
    The call's host inputs, packed into one buffer: the link rows
    (``link_bw``, ``link_act``), the slot writes that alloc/release staged
    since the last call (slot, rem, active flag, path row), and the int32
    index list. On a card the buffer is page-locked, persistent and grown
    by doubling, and the kernel's entry point moves it up in one copy into
    a persistent device buffer; the kernel writes its minimum into a
    page-locked host word. Both buffers are reused across calls: every
    kernel call ends in a stream sync, so the previous copy has finished
    before the host packs the next call.

The plain versions read the same packed buffer (:meth:`NetInputs.tensors`),
so the CPU tests exercise the layout the kernels read.

Both classes cache raw addresses (the slot tensors' ``data_ptr``, the
page-locked and device buffers, the mapped result word). A ``deepcopy``
that copied those integers would send a copy's launches into the
original's memory, so each class's ``__deepcopy__`` gives the copy its
own buffers and recomputes every address (the tie-race sanitizer's twin
engines are deep copies).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..device import resolve_device
from . import _cuda

class SlotArrays:
    """An engine's per-slot tensors as the network kernels take them:
    one device, contiguous, ``path`` int32 ``(slots, depth)``, ``rem`` /
    ``rate`` / ``eta`` / ``due`` float64 ``(slots,)``, ``active`` bool
    ``(slots,)``. Raises on anything else."""

    __slots__ = ("path", "rem", "rate", "eta", "due", "active", "device",
                 "n_slots", "depth", "ptrs")

    def __init__(self, path: torch.Tensor, rem: torch.Tensor,
                 rate: torch.Tensor, eta: torch.Tensor, due: torch.Tensor,
                 active: torch.Tensor) -> None:
        n = rem.numel()
        _cuda.check_args("slot arrays", [
            ("path", path, torch.int32, (n, path.shape[-1])),
            *((label, t, torch.float64, (n,)) for label, t in
              (("rem", rem), ("rate", rate), ("eta", eta), ("due", due))),
            ("active", active, torch.bool, (n,))], cuda=False)
        self.path, self.rem, self.rate = path, rem, rate
        self.eta, self.due, self.active = eta, due, active
        self.device = rem.device
        self.n_slots, self.depth = n, path.shape[1]
        self.ptrs = (tuple(t.data_ptr() for t in
                           (path, rem, rate, eta, due, active))
                     if self.device.type == "cuda" else None)

    @property
    def nbytes(self) -> int:
        """Bytes of the six slot tensors."""
        return sum(t.numel() * t.element_size() for t in
                   (self.path, self.rem, self.rate, self.eta, self.due,
                    self.active))

    def __deepcopy__(self, memo: dict) -> "SlotArrays":
        """Copies of the tensors (shared through ``memo`` with the rest of
        a deep-copied engine) and their own addresses."""
        return SlotArrays(*(copy.deepcopy(t, memo) for t in
                            (self.path, self.rem, self.rate, self.eta,
                             self.due, self.active)))


class NetInputs:
    """One call's host inputs in one buffer (see the module docstring);
    the layout is ``NetInputs`` of ``csrc/share_rate.cuh``: float64
    ``link_bw[L]``, ``link_act[L]``, ``st_rem[S]``, then int32
    ``st_slot[S]``, ``st_active[S]``, ``st_path[S * depth]``, ``idx[N]``."""

    def __init__(self, n_links: int, depth: int,
                 device: "str | torch.device" = "cpu") -> None:
        self.n_links, self.depth = n_links, depth
        self.device = resolve_device(device)
        self.n_staged = self.n_idx = 0
        self.capacity = 0
        if self.device.type == "cuda":
            # the mapped page-locked word the kernel writes its minimum to
            self._word = torch.empty(1, dtype=torch.float64, pin_memory=True)
            self._result = self._word.numpy()
            self.word_ptr = self._word.data_ptr()
        self._reserve(16 * n_links + 64 * (depth + 4))

    def __deepcopy__(self, memo: dict) -> "NetInputs":
        """A copy with its own host buffer (page-locked on a card), device
        buffer and mapped result word, holding the same packed call."""
        clone = NetInputs(self.n_links, self.depth, self.device)
        clone._reserve(self.capacity)
        clone._f64.view(np.uint8)[: self.capacity] = self._f64.view(np.uint8)
        clone.n_staged, clone.n_idx = self.n_staged, self.n_idx
        if self.device.type == "cuda":
            clone._result[0] = self._result[0]
        return clone

    def _reserve(self, nbytes: int) -> None:
        if nbytes <= self.capacity:
            return
        cap = max(nbytes, 2 * self.capacity)
        cap += -cap % 8
        if self.device.type == "cuda":
            host = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
            self._dev = torch.empty(cap, dtype=torch.uint8,
                                    device=self.device)
            self.host_ptr, self.dev_ptr = (host.data_ptr(),
                                           self._dev.data_ptr())
            self._host = host
            raw = host.numpy()
        else:
            raw = np.empty(cap, np.uint8)
        self._f64, self._i32 = raw.view(np.float64), raw.view(np.int32)
        self.capacity = cap

    def pack(self, links: np.ndarray, st_slot, st_rem, st_active,
             st_path: np.ndarray, idx) -> "NetInputs":
        """Write one call's inputs: ``links`` the ``(2, L)`` float64 link
        rows; the staged rows (``st_slot``, ``st_rem``, ``st_active``
        sequences and the ``(S, depth)`` ``st_path`` rows; no slot twice);
        ``idx`` the slots to re-rate or flush (no slot twice)."""
        n_links, depth = self.n_links, self.depth
        n_st, n_idx = len(st_slot), len(idx)
        if links.shape != (2, n_links) or st_path.shape != (n_st, depth):
            raise ValueError(f"net inputs: want links (2, {n_links}) and "
                             f"path rows ({n_st}, {depth}), got "
                             f"{links.shape} and {st_path.shape}")
        self._reserve(8 * (2 * n_links + n_st)
                      + 4 * (n_st * (2 + depth) + n_idx))
        f, i = self._f64, self._i32
        f[: 2 * n_links] = links.reshape(-1)
        f[2 * n_links: 2 * n_links + n_st] = st_rem
        o = 2 * (2 * n_links + n_st)
        i[o: o + n_st] = st_slot
        i[o + n_st: o + 2 * n_st] = st_active
        o += 2 * n_st
        i[o: o + n_st * depth] = st_path.reshape(-1)
        o += n_st * depth
        i[o: o + n_idx] = idx
        self.n_staged, self.n_idx = n_st, n_idx
        return self

    @property
    def nbytes(self) -> int:
        """Bytes of the packed call (what one kernel call copies up)."""
        return (8 * (2 * self.n_links + self.n_staged)
                + 4 * (self.n_staged * (2 + self.depth) + self.n_idx))

    def arrays(self) -> tuple:
        """Views of the packed buffer: ``(idx, link_bw, link_act,
        (st_slot, st_rem, st_active, st_path))``, numpy."""
        n_links, n_st, depth = self.n_links, self.n_staged, self.depth
        f, i = self._f64, self._i32
        st_rem = f[2 * n_links: 2 * n_links + n_st]
        o = 2 * (2 * n_links + n_st)
        st_slot, st_active = i[o: o + n_st], i[o + n_st: o + 2 * n_st]
        o += 2 * n_st
        st_path = i[o: o + n_st * depth].reshape(n_st, depth)
        o += n_st * depth
        return (i[o: o + self.n_idx], f[:n_links], f[n_links: 2 * n_links],
                (st_slot, st_rem, st_active, st_path))

    def tensors(self, device: "str | torch.device" = "cpu") -> tuple:
        """:meth:`arrays` as the plain versions take them, on ``device``:
        on the CPU, tensors sharing the buffer's memory (read them before
        the next :meth:`pack`)."""
        def t(a):
            return torch.as_tensor(a, device=device)

        idx, bw, act, (slot, rem, flag, path) = self.arrays()
        return t(idx), t(bw), t(act), (t(slot), t(rem), t(flag), t(path))

    def result(self) -> float:
        """The minimum the last kernel call wrote (valid after the call,
        which ends in a stream sync)."""
        return float(self._result[0])


def launch(name: str, inputs: NetInputs, slots: SlotArrays,
           now: float) -> float:
    """One engine call of network kernel ``name``: one copy up, one cluster
    launch, one stream sync; returns the minimum. Raises unless both sides
    are on one CUDA device and agree on the path depth."""
    dev = slots.device
    if dev.type != "cuda" or inputs.device != dev:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"slot arrays on {dev} and inputs for "
                         f"{inputs.device}")
    if inputs.depth != slots.depth:
        raise ValueError(f"{name}: inputs of depth {inputs.depth}, slot "
                         f"arrays of depth {slots.depth}")
    err = _cuda.entry_point(name)(
        inputs.host_ptr, inputs.dev_ptr, inputs.n_links, inputs.n_staged,
        inputs.n_idx, *slots.ptrs, slots.depth, slots.n_slots, float(now),
        inputs.word_ptr, _cuda.stream(dev), dev.index)
    _cuda.check(name, err)
    return inputs.result()
