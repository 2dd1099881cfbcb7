"""Kernel registry spec — the shape every kernel package of the port exports.

The counterpart of ``repro.kernels.spec``. Each package under
:mod:`repro_torch.kernels` exposes a module-level ``SPEC: KernelSpec`` in
its ``__init__``; the kernel audit (:mod:`repro_torch.analysis.kernel_audit`)
enforces it for every kernel:

* ``max_rank`` — rank cap on every tensor the plain version makes: 2 for
  the simulation kernels (no ``(sites, files, sites)`` /
  ``(jobs, files, sites)`` broadcast), 3/4 for the model kernels (their
  inputs are rank 3/4).
* ``budget_bytes`` — the peak bytes the kernel may hold at the audit
  shapes: on the CPU, the operand-plus-result bytes of every op of the
  plain version; on the card, the CUDA route's input bytes plus what the
  call allocates. The simulation kernels run in float64 on the card where
  the reference traced float32, so each simulation budget is the
  reference's times 2 and no more; the model kernels keep the reference's
  (float32 inputs, as there).
* ``make_inputs`` / ``make_small_inputs`` — seeded builders of the audit
  inputs, at the reference's audit shapes and seeds, in the port's own
  argument forms (``NetInputs`` / ``SlotArrays`` of :mod:`.net_call` for
  the two network kernels, tensors on the device passed in). The
  simulation kernels' inputs are float64 draws of the same generator
  calls (not rounded through float32), their masks bool.
* ``arg_units`` / ``out_units`` — per-operand dimension signature in the
  vocabulary of :mod:`repro_torch.analysis.units`, the reference's; the
  operands are :attr:`InputCase.operands`, the reference's positional
  arguments in its order.
* ``tol`` — the model kernels' tolerance against their plain versions
  (those of ``tests/test_kernels.py``); the simulation kernels are
  bit-equal (``None``).

This module imports no ``torch.cuda`` at import time: builders make
tensors on the device they are given, when called.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import numpy as np
import torch

from .net_call import NetInputs, SlotArrays


@dataclasses.dataclass
class InputCase:
    """One audit call.

    Attributes:
      args / kwargs: what the kernel and its plain version take.
      operands: the reference's positional arguments, in its order, as
        tensors (their shapes and units are the reference's).
    """

    args: tuple
    kwargs: dict
    operands: tuple


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Registry entry for one kernel package.

    Attributes:
      name: registry key, matches the package name.
      module: import path of the package (``repro_torch.kernels.<name>``).
      kernel_attr: the CUDA route in ``<module>.kernel`` (raises on CPU
        tensors; counts its launches).
      ref_attr: the plain PyTorch version in ``<module>.ref``, taking the
        kernel's arguments.
      domain: ``"sim"`` (float64, bit-equal to the plain version) or
        ``"model"`` (float32/bf16, within ``tol``).
      max_rank: max rank of any tensor the plain version makes.
      budget_bytes: peak-bytes budget at the audit shapes (see module doc).
      make_inputs: audit-shape builder, ``make_inputs(device)``.
      make_small_inputs: the small-shape inputs (simulation kernels, and
        the scan backward's ragged edges).
      multi_output: the reference kernel returns a tuple.
      arg_units: dimension per operand (:attr:`InputCase.operands`).
      out_units: dimension per output of the reference kernel.
      tol: atol and rtol against the plain version (model kernels).
      outputs: what a call produced, as tensors, from ``(case, result)``;
        default the result (a tuple or one tensor).
      host_read: how the CUDA route hands its result to the host by
        design, when it does (the network kernels' mapped word).
    """

    name: str
    module: str
    kernel_attr: str
    ref_attr: str
    domain: str
    max_rank: int
    budget_bytes: int
    make_inputs: Callable[..., InputCase]
    make_small_inputs: Callable[..., InputCase] | None = None
    multi_output: bool = False
    arg_units: tuple[str, ...] = ()
    out_units: tuple[str, ...] = ()
    tol: float | None = None
    outputs: Callable[[InputCase, Any], tuple] | None = None
    host_read: str | None = None

    def load_kernel(self) -> Callable[..., Any]:
        """Import and return the CUDA route."""
        mod = importlib.import_module(self.module + ".kernel")
        return getattr(mod, self.kernel_attr)

    def load_ref(self) -> Callable[..., Any]:
        """Import and return the plain PyTorch version."""
        mod = importlib.import_module(self.module + ".ref")
        return getattr(mod, self.ref_attr)


# ---------------------------------------------------------------------------
# Input builders: the reference's shapes, seeds and generator calls
# (``repro.kernels.spec``), in float64.
# ---------------------------------------------------------------------------


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _net_case(path: np.ndarray, state: dict, bw: np.ndarray,
              act: np.ndarray, now: float, device, order: tuple) -> InputCase:
    """A network kernel's call over every slot: the slot arrays, the
    packed link rows and index list (no staged rows), and the
    reference-order operands ``order`` (names of ``path``, the slot
    state, ``bw``, ``act``, ``now``)."""
    device = torch.device(device)
    n, depth = path.shape
    slots = SlotArrays(_t(path.astype(np.int32), device),
                       *(_t(state[k], device)
                         for k in ("rem", "rate", "eta", "due")),
                       _t(state["active"], device))
    inputs = NetInputs(bw.shape[0], depth, device)
    inputs.pack(np.stack([bw, act]), [], [], [],
                np.empty((0, depth), np.int32), np.arange(n, dtype=np.int32))
    named = {"path": slots.path, "rem": slots.rem, "rate": slots.rate,
             "eta": slots.eta, "bw": _t(bw, device), "act": _t(act, device),
             "now": torch.tensor(now, dtype=torch.float64, device=device)}
    return InputCase((inputs, slots, now), {},
                     tuple(named[k] for k in order))


def _slot_outputs(case: InputCase, result) -> tuple:
    """Every slot tensor a network call may write, and its minimum."""
    slots = case.args[1]
    return (slots.path, slots.rem, slots.rate, slots.eta, slots.due,
            slots.active,
            torch.as_tensor(result, dtype=torch.float64).reshape(()))


def _net_rerate_inputs(slots: int, links: int, levels: int, seed: int = 2,
                       device="cpu") -> InputCase:
    rng = np.random.default_rng(seed)
    path = np.where(rng.random((slots, levels)) < 0.35, -1,
                    rng.integers(0, links, (slots, levels)))
    path[:, 0] = rng.integers(0, links, slots)
    rem = rng.random(slots) * 1e9
    bw = rng.random(links) * 1e8 + 1e5
    act = rng.integers(0, 12, links).astype(np.float64)
    # every slot is re-rated: its old rate, eta and due are overwritten
    state = {"rem": rem, "rate": np.zeros(slots),
             "eta": np.full(slots, np.inf), "due": np.full(slots, np.inf),
             "active": (path >= 0).any(1)}
    return _net_case(path, state, bw, act, 321.5, device,
                     ("path", "rem", "bw", "act", "now"))


def _event_engine_inputs(slots: int, links: int, levels: int, seed: int = 3,
                         device="cpu") -> InputCase:
    rng = np.random.default_rng(seed)
    path = np.where(rng.random((slots, levels)) < 0.35, -1,
                    rng.integers(0, links, (slots, levels)))
    path[:, 0] = rng.integers(0, links, slots)
    # mix of slot states: ~1/4 released (all-padding path, zeroed state),
    # ~1/3 freshly allocated (no cached rate yet, rem used verbatim), the
    # rest carried over from a previous flush with a finite (rate, eta)
    freed = rng.random(slots) < 0.25
    path[freed] = -1
    rem = rng.random(slots) * 1e9
    rate = rng.random(slots) * 1e7 + 1.0
    fresh = rng.random(slots) < 0.3
    rate[fresh | freed] = 0.0
    rem[freed] = 0.0
    now = 321.5
    eta = now + rng.random(slots) * 5e3
    eta[rate == 0.0] = np.inf
    bw = rng.random(links) * 1e8 + 1e5
    act = rng.integers(0, 12, links).astype(np.float64)
    state = {"rem": rem, "rate": rate, "eta": eta,
             "due": np.full(slots, np.inf), "active": ~freed}
    return _net_case(path, state, bw, act, now, device,
                     ("path", "rem", "rate", "eta", "bw", "act", "now"))


def _value_score_inputs(sites: int, files: int, seed: int = 2,
                        device="cpu") -> InputCase:
    rng = np.random.default_rng(seed)
    demand = rng.random((sites, files)) * 20.0
    sizes = rng.random(files) * 1e9 + 1e6
    presence = rng.random((sites, files)) < 0.25
    presence[0, :] = True
    bw = rng.random((sites, sites)) * 1.25e8 + 1e5
    args = tuple(_t(a, device) for a in (demand, sizes, presence, bw))
    return InputCase(args, {"mode": "cost"}, args)


def _st_cost_inputs(sites: int, files: int, jobs: int, seed: int = 2,
                    device="cpu") -> InputCase:
    rng = np.random.default_rng(seed)
    bw = rng.random((sites, sites)) * 1.25e8 + 1e5
    presence = rng.random((sites, files)) < 0.2
    presence[0, :] = True
    online = rng.random(sites) < 0.85
    online[0] = True
    fetch_mask = presence & online[:, None]
    fetch_mask[0, :] = presence[0, :]
    sizes = rng.random(files) * 1e9 + 1e6
    required = rng.random((jobs, files)) < min(0.5, 12.0 / files)
    rel = rng.random(sites) * 50.0
    args = tuple(_t(a, device) for a in (bw, fetch_mask, presence, sizes,
                                         required, rel, online))
    return InputCase(args, {}, args)


def _strategy_plan_inputs(sites: int, pairs: int, seed: int = 2,
                          device="cpu") -> InputCase:
    rng = np.random.default_rng(seed)
    bw = rng.random((sites, pairs)) * 1.25e8 + 1e5
    fetch = rng.random((sites, pairs)) < 0.15
    fetch[rng.integers(0, sites, pairs), np.arange(pairs)] = True
    # region-block structure: contiguous site ranges share a region, each
    # pair's destination region is one of them
    n_regions = max(2, sites // 8)
    region = np.arange(sites) * n_regions // sites
    local = region[:, None] == rng.integers(0, n_regions, pairs)[None, :]
    serve = np.where(rng.random(sites) < 0.5, rng.random(sites) * 9.0, 0.0)
    size = rng.random(pairs) * 1e9 + 1e6
    free = np.where(rng.random(pairs) < 0.5,
                    rng.random(pairs) * 2e9, rng.random(pairs) * 1e8)
    args = tuple(_t(a, device) for a in (bw, fetch, local, serve, free,
                                         size))
    return InputCase(args, {}, args)


def _selective_scan_inputs(Bz: int, S: int, Di: int, N: int, seed: int = 2,
                           device="cpu") -> InputCase:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bz, S, Di)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((Bz, S, Di)))) * 0.1
          ).astype(np.float32)
    B = rng.standard_normal((Bz, S, N)).astype(np.float32)
    C = rng.standard_normal((Bz, S, N)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((Di, N)))).astype(np.float32)
    D = rng.standard_normal(Di).astype(np.float32)
    h0 = np.zeros((Bz, Di, N), np.float32)
    args = tuple(_t(a, device) for a in (x, dt, B, C, A, D, h0))
    return InputCase(args, {}, args)


def _flash_attention_inputs(B: int, H: int, KV: int, Sq: int, Skv: int,
                            hd: int, seed: int = 2,
                            device="cpu") -> InputCase:
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Skv, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Skv, hd)).astype(np.float32)
    args = tuple(_t(a, device) for a in (q, k, v))
    return InputCase(args, {"causal": True}, args)


def _flash_attention_bwd_inputs(B: int, H: int, KV: int, S: int, hd: int,
                                seed: int = 2, device="cpu") -> InputCase:
    """bf16 q, k, v and dO drawn from ``seed``; o (float32, before its
    rounding) and lse from the plain forward (causal) on the same device,
    as the training path saves them."""
    # imported here: the kernel packages import this module as they load
    from .flash_attention.ref import flash_attention_lse_ref

    rng = np.random.default_rng(seed)
    bf = lambda *s: _t(rng.standard_normal(s).astype(np.float32),  # noqa
                       device).to(torch.bfloat16)
    q, k, v = bf(B, H, S, hd), bf(B, KV, S, hd), bf(B, KV, S, hd)
    do = bf(B, H, S, hd)
    _, lse, o = flash_attention_lse_ref(q, k, v, causal=True)
    args = (q, k, v, o, lse, do)
    return InputCase(args, {"causal": True}, args)


def _selective_scan_bwd_inputs(Bz: int, S: int, Di: int, N: int,
                               seed: int = 2, device="cpu") -> InputCase:
    """float32 x, dt, B, C, A, D and a nonzero h0 drawn from ``seed`` as the
    forward's audit inputs; the round states from the plain forward on the
    same device, as the training path saves them; dy and a nonzero
    dh_last."""
    # imported here: the kernel packages import this module as they load
    from .selective_scan.kernel import round_states
    from .selective_scan.ref import selective_scan_ref

    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = n(Bz, S, Di)
    dt = (np.log1p(np.exp(n(Bz, S, Di))) * 0.1).astype(np.float32)
    B, C = n(Bz, S, N), n(Bz, S, N)
    A = (-np.exp(n(Di, N))).astype(np.float32)
    D, h0, dy, dh_last = n(Di), n(Bz, Di, N), n(Bz, S, Di), n(Bz, Di, N)
    x, dt, B, C, A, D, h0, dy, dh_last = (
        _t(a, device) for a in (x, dt, B, C, A, D, h0, dy, dh_last))
    states = round_states(x, h0)
    selective_scan_ref(x, dt, B, C, A, D, h0, states)
    args = (x, dt, B, C, A, D, h0, states, dy, dh_last)
    return InputCase(args, {}, args)


#: The network kernels read their minimum back from a page-locked host word
#: the launch writes before its stream sync (``kernels/net_call.py``).
_MAPPED_WORD = ("one stream sync per call, then a read of the mapped "
                "page-locked host word the kernel wrote its minimum to")

#: Budgets: the reference's (``repro.kernels.spec``), the simulation ones
#: times 2 for float64 (see the module doc).
NET_RERATE_SPEC = KernelSpec(
    name="net_rerate", module="repro_torch.kernels.net_rerate",
    kernel_attr="net_rerate_kernel", ref_attr="net_rerate_packed",
    domain="sim", max_rank=2, budget_bytes=2 * 24_000,
    make_inputs=lambda device="cpu": _net_rerate_inputs(256, 60, 5,
                                                        device=device),
    make_small_inputs=lambda device="cpu": _net_rerate_inputs(
        37, 23, 4, device=device),
    arg_units=("count", "bytes", "bytes_per_s", "count", "sim_seconds"),
    out_units=("bytes_per_s", "sim_seconds"),
    outputs=_slot_outputs, host_read=_MAPPED_WORD,
)

EVENT_ENGINE_SPEC = KernelSpec(
    name="event_engine", module="repro_torch.kernels.event_engine",
    kernel_attr="event_engine_kernel", ref_attr="event_engine_packed",
    domain="sim", max_rank=2, budget_bytes=2 * 20_000,
    make_inputs=lambda device="cpu": _event_engine_inputs(256, 60, 5,
                                                          device=device),
    make_small_inputs=lambda device="cpu": _event_engine_inputs(
        37, 23, 4, device=device),
    multi_output=True,
    arg_units=("count", "bytes", "bytes_per_s", "sim_seconds",
               "bytes_per_s", "count", "sim_seconds"),
    out_units=("bytes", "bytes_per_s", "sim_seconds", "sim_seconds"),
    outputs=_slot_outputs, host_read=_MAPPED_WORD,
)

ST_COST_SPEC = KernelSpec(
    name="st_cost", module="repro_torch.kernels.st_cost",
    kernel_attr="st_cost_kernel", ref_attr="st_cost_ref",
    domain="sim", max_rank=2, budget_bytes=2 * 450_000,
    make_inputs=lambda device="cpu": _st_cost_inputs(52, 100, 50,
                                                     device=device),
    make_small_inputs=lambda device="cpu": _st_cost_inputs(8, 24, 5,
                                                           device=device),
    arg_units=("bytes_per_s", "count", "count", "bytes", "count",
               "score", "count"),
    out_units=("sim_seconds",),
)

STRATEGY_PLAN_SPEC = KernelSpec(
    name="strategy_plan", module="repro_torch.kernels.strategy_plan",
    kernel_attr="strategy_plan_kernel", ref_attr="strategy_plan_ref",
    domain="sim", max_rank=2, budget_bytes=2 * 1_100_000,
    make_inputs=lambda device="cpu": _strategy_plan_inputs(500, 50,
                                                           device=device),
    make_small_inputs=lambda device="cpu": _strategy_plan_inputs(
        24, 7, device=device),
    multi_output=True,
    arg_units=("bytes_per_s", "count", "count", "score", "bytes",
               "bytes"),
    out_units=("count", "count", "count", "count", "count"),
)

VALUE_SCORE_SPEC = KernelSpec(
    name="value_score", module="repro_torch.kernels.value_score",
    kernel_attr="value_score_kernel", ref_attr="value_score_ref",
    domain="sim", max_rank=2, budget_bytes=2 * 200_000,
    make_inputs=lambda device="cpu": _value_score_inputs(52, 100,
                                                         device=device),
    make_small_inputs=lambda device="cpu": _value_score_inputs(
        13, 20, device=device),
    arg_units=("score", "bytes", "count", "bytes_per_s"),
    out_units=("score",),
)

SELECTIVE_SCAN_SPEC = KernelSpec(
    name="selective_scan", module="repro_torch.kernels.selective_scan",
    kernel_attr="selective_scan_kernel", ref_attr="selective_scan_ref",
    domain="model", max_rank=3, budget_bytes=2_200_000,
    make_inputs=lambda device="cpu": _selective_scan_inputs(
        1, 512, 256, 16, device=device),
    multi_output=True,
    arg_units=("score", "score", "score", "score", "score",
               "score", "score"),
    out_units=("score", "score"),
    tol=2e-4,               # ten times float32's, as tests/test_kernels.py
)

FLASH_ATTENTION_SPEC = KernelSpec(
    name="flash_attention", module="repro_torch.kernels.flash_attention",
    kernel_attr="flash_attention_kernel", ref_attr="flash_attention_ref",
    domain="model", max_rank=4, budget_bytes=1_700_000,
    make_inputs=lambda device="cpu": _flash_attention_inputs(
        1, 2, 2, 256, 1024, 64, device=device),
    arg_units=("score", "score", "score"),
    out_units=("score",),
    tol=2e-5,               # float32's, as tests/test_kernels.py
)
#: No reference SPEC: the reference differentiates its jnp scan. The budget
#: is the call's bytes at the forward's audit shape (Bz 1, S 512, Di 256,
#: N 16): its inputs (2,212,864: x, dt and dy 1,572,864, the 32 round
#: states 524,288), its outputs (1,147,904) and the float32 partials of dB,
#: dC, dA and dD (279,552), 3,640,320 in all, held to 3,700,000. The small
#: inputs take the kernel's ragged edges: S past a round, Di past a
#: 64-channel block, N below 16.
SELECTIVE_SCAN_BWD_SPEC = KernelSpec(
    name="selective_scan_bwd", module="repro_torch.kernels.selective_scan_bwd",
    kernel_attr="selective_scan_bwd_kernel",
    ref_attr="selective_scan_bwd_ref",
    domain="model", max_rank=4, budget_bytes=3_700_000,
    make_inputs=lambda device="cpu": _selective_scan_bwd_inputs(
        1, 512, 256, 16, device=device),
    make_small_inputs=lambda device="cpu": _selective_scan_bwd_inputs(
        2, 37, 100, 7, device=device),
    multi_output=True,
    arg_units=("score",) * 10,
    out_units=("score",) * 7,
    tol=2e-4,               # ten times float32's, as the forward's
)
#: No reference SPEC: the reference has no backward kernel. The budget is the
#: call's bytes at the audit shape: its inputs (659,456, o in float32), dq,
#: dk and dv (262,144) and the float32 Delta scratch (4,096), 925,696 in
#: all, held to 931,072; plus the int32 tile table the wrapper copies to the
#: card on a shape's first call, 3 ints for each of 4 key tiles and 8 dQ row
#: tiles, 144 B: 931,216.
FLASH_ATTENTION_BWD_SPEC = KernelSpec(
    name="flash_attention_bwd", module="repro_torch.kernels.flash_attention_bwd",
    kernel_attr="flash_attention_bwd_kernel",
    ref_attr="flash_attention_bwd_ref",
    domain="model", max_rank=5, budget_bytes=931_216,
    make_inputs=lambda device="cpu": _flash_attention_bwd_inputs(
        1, 4, 2, 256, 64, device=device),
    multi_output=True,
    arg_units=("score",) * 6,
    out_units=("score",) * 3,
    tol=2e-2,               # bf16's, as tests/test_kernels.py
)
