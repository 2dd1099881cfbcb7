"""The selective scan as the Mamba-1 layers call it: the forward alone
(serving) and the differentiable forward and backward (training). On
DTensor inputs (a sharded step) each rank scans its shards
(:mod:`..sharded`): the batch over the data axes, the channels over
``model`` when they divide it."""

from __future__ import annotations

import torch

# the modules, not their functions: the backward's package imports this
# one's, so either may be imported first
from ..selective_scan_bwd import kernel as bwd_kernel
from ..selective_scan_bwd import ref as bwd_ref
from .. import shapeonly, sharded
from .kernel import round_states, selective_scan_kernel
from .ref import selective_scan_ref

#: ``"auto"``: the plain version for CPU tensors, the CUDA kernel for CUDA
#: tensors; ``"cuda"``: the kernel (raises on CPU tensors); ``"plain"``: the
#: plain version on any device (the reference route on the card)
BACKENDS = ("auto", "cuda", "plain")


def _plain(backend: str, x: torch.Tensor) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want one of "
                         f"{BACKENDS})")
    # a fake tensor (the dry run's) takes the kernel's shape-only route
    return backend == "plain" or (backend == "auto" and x.device.type == "cpu"
                                  and not shapeonly.is_fake(x))


def selective_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor, *, backend: str = "auto"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, h_last) of the recurrence (see :func:`.ref.selective_scan_ref`).
    The kernel raises rather than fall back to the plain version."""
    if sharded.is_sharded(x):
        return _on_shards(lambda *a: selective_scan(*a, backend=backend),
                          x, dt, B, C, A, D, h0)
    fn = selective_scan_ref if _plain(backend, x) else selective_scan_kernel
    return fn(x, dt, B, C, A, D, h0)


class SelectiveScanFn(torch.autograd.Function):
    """Differentiable selective scan. The forward keeps its inputs and the
    state at the end of every round (:func:`.kernel.round_states`); the
    backward hands them to ``selective_scan_bwd`` — the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors or
    ``backend="plain"``, both ways — so no autograd graph is built over
    time. h0 gets a gradient when it requires one; ``backend`` none."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, D, h0, backend):
        plain = _plain(backend, x)
        states = round_states(x, h0)
        fn = selective_scan_ref if plain else selective_scan_kernel
        y, h_last = fn(x, dt, B, C, A, D, h0, states)
        ctx.save_for_backward(x, dt, B, C, A, D, h0, states)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, B, C, A, D, h0, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        fn = (bwd_ref.selective_scan_bwd_ref if ctx.plain
              else bwd_kernel.selective_scan_bwd_kernel)
        *grads, dh0 = fn(x, dt, B, C, A, D, h0, states, dy, dh_last)
        return (*grads, dh0 if ctx.needs_input_grad[6] else None, None)


def selective_scan_train(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                         C: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                         h0: torch.Tensor, *, backend: str = "auto"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`selective_scan` under autograd (:class:`SelectiveScanFn`)."""
    if sharded.is_sharded(x):
        return _on_shards(lambda *a: SelectiveScanFn.apply(*a, backend),
                          x, dt, B, C, A, D, h0)
    return SelectiveScanFn.apply(x, dt, B, C, A, D, h0, backend)


def _on_shards(fn, x, dt, B, C, A, D, h0):
    """``fn(x, dt, B, C, A, D, h0) -> (y, h_last)`` on each rank's shards:
    x, dt (Bz, S, Di) and h0 (Bz, Di, N) by batch and channel, B and C
    (Bz, S, N) by batch, A (Di, N) and D (Di,) by channel."""
    m = sharded.model_ranks(x)
    roles = ((0, 2), (0, 2), (0, None), (0, None), (None, 0), (None, 0),
             (0, 1))
    return sharded.call_local(fn, (x, dt, B, C, A, D, h0), roles,
                              ((0, 2), (0, 1)), batch=x.shape[0],
                              split_model=x.shape[2] % m == 0)
