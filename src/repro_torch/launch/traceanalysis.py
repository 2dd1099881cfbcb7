"""Per-device work of a traced step (the counterpart of
``repro.launch.hloanalysis``).

The reference reads FLOPs, bytes and collectives from the compiled HLO of
a partitioned module, weighting each computation by its loop trip counts.
Eager PyTorch has no such module: the port reads the stream of operators
one rank runs instead. :class:`TraceCounter` is a ``TorchDispatchMode``
that lets DTensor lower each sharded operator first (it returns
``NotImplemented`` for DTensor arguments), so it sees what one rank
executes: the local shards' operators and the collectives the
redistributions insert. Per device it records

  * ``matmul_flops``: 2 x M x N x K of every ``mm``, ``addmm``, ``bmm``
    and ``baddbmm`` on the local shards (``torch.profiler``'s
    ``with_flops`` formula for the same operators);
  * ``kernel_flops``: the FLOPs of the hand-written kernels, which their
    wrappers report by formula when they take their shape-only route
    (:mod:`repro_torch.kernels.shapeonly`), per kernel in ``kernels``;
  * ``hbm_bytes``: the operand and result bytes of each operator (one
    eager operator is about one kernel: the port's counterpart of the
    reference's fusion granularity), views and allocations excluded, plus
    the kernels' bytes by formula;
  * collectives by kind: result bytes, counts, and wire bytes (result
    bytes x the reference's ``WIRE_FACTOR``), split into NVLink traffic
    (the rank group lies inside one node of ``gpus_per_node`` consecutive
    ranks) and InfiniBand traffic (it spans nodes): the card's counterpart
    of the reference's ICI/DCN split;
  * ``peak_bytes``: the peak of the live storage of this rank (its shards
    of the tracked inputs plus every tensor the step allocates, freed when
    its last reference goes).

Under a ``FakeTensorMode`` nothing is allocated or computed, so a
production cell traces on the CPU; on real tensors the counts are those of
the real step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import shapeonly
from .roofline import GPUS_PER_NODE

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# wire-bytes multiplier on the result size (ring algorithms, n >> 1)
WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default}
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.detach.default,
             _aten._unsafe_view.default, _aten.lift_fresh.default,
             _aten.alias.default}


def _funcol_kinds() -> dict:
    ops = torch.ops._c10d_functional
    kinds = {"all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all"}
    out = {}
    for name, kind in kinds.items():
        packet = getattr(ops, name, None)
        if packet is not None:
            out[packet.default] = kind
    # DTensor's shard-to-shard redistribution (an all-to-all on the group)
    dtensor_ops = getattr(torch.ops, "_dtensor", None)
    packet = getattr(dtensor_ops, "shard_dim_alltoall", None)
    if packet is not None:
        out[packet.default] = "all-to-all"
    return out


_COLLECTIVES = _funcol_kinds()
_WAIT = torch.ops._c10d_functional.wait_tensor.default


def _matmul_flops(func, args) -> float:
    """2 x M x N x K of one product (batched: times the batch)."""
    if func in (_aten.addmm.default, _aten.baddbmm.default):
        args = args[1:]
    a, b = args[0], args[1]
    if a.dim() == 2:
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def spans_nodes(ranks, gpus_per_node: int = GPUS_PER_NODE) -> bool:
    """True when the rank group lies on more than one node of
    ``gpus_per_node`` consecutive ranks (InfiniBand traffic)."""
    return len({int(r) // gpus_per_node for r in ranks}) > 1


@dataclasses.dataclass
class TraceStats:
    matmul_flops: float = 0.0
    kernel_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_result_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVE_KINDS})
    collective_wire_bytes_nvlink: float = 0.0
    collective_wire_bytes_ib: float = 0.0
    #: per kernel: calls, flops and bytes by formula
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    #: operators DTensor could not place, run on replicated inputs
    #: (:class:`ReplicateOnFailure`), by name: calls
    replicated_ops: dict = dataclasses.field(default_factory=dict)


class _InPropagation:
    """Marks DTensor's sharding propagation, which runs each new operator
    once on global-shaped fake tensors to learn its output's metadata:
    those calls are no rank's work and are not counted."""

    depth = 0

    @classmethod
    @contextlib.contextmanager
    def patched(cls):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def wrapped(self, op_schema):
            cls.depth += 1
            try:
                return orig(self, op_schema)
            finally:
                cls.depth -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig


class TraceCounter(TorchDispatchMode):
    """Counts one rank's work (see the module docstring). ``track(tree)``
    adds tensors that exist before the step (parameters, optimizer state,
    the batch) to the live storage; ``stats`` holds the counts."""

    def __init__(self):
        super().__init__()
        self.stats = TraceStats()
        self._live: dict[int, int] = {}
        self._refs: dict[int, weakref.finalize] = {}
        self._live_bytes = 0
        self._groups: dict[str, bool] = {}
        self._stack = contextlib.ExitStack()

    # -- live storage ------------------------------------------------------
    def _drop(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def _add_storage(self, t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self._refs[key] = weakref.finalize(st, self._drop, key)
        if self._live_bytes > self.stats.peak_bytes:
            self.stats.peak_bytes = self._live_bytes

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._add_storage(t)

    # -- collectives -------------------------------------------------------
    def _crosses(self, group_name) -> bool:
        if group_name not in self._groups:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
            self._groups[group_name] = spans_nodes(ranks)
        return self._groups[group_name]

    # -- kernels by formula ------------------------------------------------
    def _kernel(self, name: str, flops: float, bytes_: float) -> None:
        k = self.stats.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += bytes_
        self.stats.kernel_flops += flops
        self.stats.hbm_bytes += bytes_

    def __enter__(self):
        self._stack.enter_context(_InPropagation.patched())
        self._stack.enter_context(shapeonly.collecting(self._kernel))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # let DTensor lower it first
        kwargs = kwargs or {}
        if func is _WAIT and isinstance(args[0], torch._subclasses.FakeTensor):
            # the fake wait returns a fresh tensor where the real one
            # returns its argument
            return args[0]
        out = func(*args, **kwargs)
        if _InPropagation.depth:
            return out
        st = self.stats
        if func in _MATMULS:
            st.matmul_flops += _matmul_flops(func, args)
        kind = _COLLECTIVES.get(func)
        if kind is not None:
            b = sum(_nbytes(t) for t in _tensors(out))
            st.collective_result_bytes[kind] += b
            st.collective_counts[kind] += 1
            wire = b * WIRE_FACTOR[kind]
            group = args[-1] if isinstance(args[-1], str) else kwargs.get(
                "group_name")
            if self._crosses(group):
                st.collective_wire_bytes_ib += wire
            else:
                st.collective_wire_bytes_nvlink += wire
        elif func not in _NO_BYTES and not func.is_view:
            st.hbm_bytes += sum(_nbytes(t) for t in _tensors(args)) + sum(
                _nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._add_storage(t)
        return out


class ReplicateOnFailure(TorchDispatchMode):
    """Runs a DTensor operator whose sharding DTensor cannot propagate
    (no rule for its placements, an uneven unflatten) on inputs
    redistributed to ``Replicate()``: every rank then computes the whole
    operator, and the all-gathers that takes are counted by the
    :class:`TraceCounter` beneath it (enter this mode after the counter).
    It is the counterpart of XLA's "involuntary full rematerialization" in
    the reference. Each such operator is recorded in
    ``stats.replicated_ops``."""

    def __init__(self, stats: TraceStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except Exception:                       # noqa: BLE001
            args = tuple(_map_args(self._whole, a) for a in args)
            kwargs = {k: _map_args(self._whole, v) for k, v in kwargs.items()}
            name = str(func.overloadpacket.__name__)
            self.stats.replicated_ops[name] = \
                self.stats.replicated_ops.get(name, 0) + 1
            return func(*args, **kwargs)

    def _whole(self, t):
        """``t`` replicated on every rank. A fake tensor DTensor cannot
        gather (a strided shard's index arithmetic reads data) becomes a
        fresh replicated fake tensor, its all-gather counted here."""
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        whole = [Replicate()] * mesh.ndim
        try:
            return t.redistribute(mesh, whole)
        except Exception:                       # noqa: BLE001
            if not isinstance(t._local_tensor, torch._subclasses.FakeTensor):
                raise
        st = self.stats
        b = _nbytes(t)
        for dim, p in enumerate(t.placements):
            if p.is_replicate():
                continue
            st.collective_result_bytes["all-gather"] += b
            st.collective_counts["all-gather"] += 1
            ranks = dist.get_process_group_ranks(mesh.get_group(dim))
            if spans_nodes(ranks):
                st.collective_wire_bytes_ib += b
            else:
                st.collective_wire_bytes_nvlink += b
        local = torch.empty(t.shape, dtype=t.dtype,
                            device=t._local_tensor.device)
        return DTensor.from_local(local, mesh, whole, run_check=False)


def _map_args(fn, a):
    if isinstance(a, (list, tuple)):
        return type(a)(_map_args(fn, x) for x in a)
    return fn(a)
