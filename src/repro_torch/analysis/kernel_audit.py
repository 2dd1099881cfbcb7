"""Kernel audit — the port's counterpart of ``repro.analysis.jaxpr_audit``.

Every kernel package the registry finds
(:func:`repro_torch.kernels.registered_kernels`) is audited in two halves.

**On the CPU: the plain version, walked op by op.** The spec's plain
version runs at its audit inputs (``make_inputs("cpu")``) under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` that sees every
aten op it issues:

* **rank** — the largest rank of any op's result. For the simulation
  kernels it must stay within ``spec.max_rank`` (2: no
  ``(sites, files, sites)`` / ``(jobs, files, sites)`` broadcast);
* **bytes** — per op, the bytes of its operands plus its results (each
  tensor once); the largest must stay within ``spec.budget_bytes`` for
  the simulation kernels;
* **dtype** — the port's discipline: a simulation kernel's plain version
  holds no floating tensor but float64, a model kernel's no float64;
* **host round trips** — ops that hand a value to the host
  (``aten._local_scalar_dense``, i.e. ``.item()``; data-dependent shapes
  such as ``nonzero`` or indexing by a mask; copies from the card to the
  CPU): none allowed;
* **units** — the spec's dimension signature is complete and valid
  (:func:`check_unit_signature`).

The model kernels' plain versions materialise the logits plane and the
dense scan by design (``kernels/flash_attention/ref.py``,
``kernels/selective_scan/ref.py``): their rank and bytes are recorded,
not gated, and the report says so.

**On the card: the CUDA route.** A ``TorchDispatchMode`` never sees a
ctypes launch, so the card half measures with the allocator instead:

* **peak bytes** — the input bytes of the call plus
  ``torch.cuda.max_memory_allocated()`` during it less
  ``memory_allocated()`` before it: the one-launch counterpart of the
  reference's per-equation sum. It must stay within ``budget_bytes``;
* **parity** — the outputs equal the plain version's on the same inputs
  on the card, bit for bit for the simulation kernels at
  ``make_small_inputs`` and ``make_inputs``, within ``spec.tol`` for the
  model kernels;
* **the wrapper's own ops** — the aten ops the wrapper issues around the
  launch and any host round trip among them. The two network kernels hand
  their minimum back through a mapped host word by design; the report
  names it (``spec.host_read``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .units import DIMENSIONS

#: aten ops that hand a value to the host (a sync on a card): scalar reads
#: and results whose shape depends on the data
HOST_SYNC_OPS = frozenset(
    {"_local_scalar_dense", "nonzero", "masked_select", "_unique2",
     "unique_consecutive", "unique_dim", "repeat_interleave"})
#: aten ops that copy between devices
COPY_OPS = frozenset({"_to_copy", "copy_"})
#: indexing ops, whose result shape (or whose work) depends on the data
#: when an index is a mask (``x[mask]``, ``x[mask] = v``)
INDEX_OPS = frozenset({"index", "index_put", "index_put_"})
#: why the model kernels' plain versions are not gated on rank and bytes
UNGATED = ("recorded, not gated: the plain version materialises the "
           "logits plane / the dense scan by design")


def check_unit_signature(spec, n_args: int) -> bool:
    """True when the spec's dimension signature is complete and valid:
    one unit per operand, at least one output unit, all in
    :data:`~repro_torch.analysis.units.DIMENSIONS`."""
    arg_units = tuple(getattr(spec, "arg_units", ()))
    out_units = tuple(getattr(spec, "out_units", ()))
    return (len(arg_units) == n_args
            and len(out_units) > 0
            and all(u in DIMENSIONS for u in arg_units + out_units))


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpWalk(TorchDispatchMode):
    """Records every aten op issued inside the ``with`` block: its name,
    its result's rank, its operand-plus-result bytes, the floating dtypes
    it touches and whether it hands a value to the host."""

    def __init__(self) -> None:
        super().__init__()
        self.n_ops = 0
        self.op_counts: dict[str, int] = {}
        self.max_rank = 0
        self.peak_bytes = 0
        self.peak_op = ""
        self.float_dtypes: set[str] = set()
        self.host_syncs: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.n_ops += 1
        self.op_counts[str(func)] = self.op_counts.get(str(func), 0) + 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        seen: dict[int, torch.Tensor] = {}
        for t in ins + outs:
            seen.setdefault(id(t), t)
            if t.is_floating_point():
                self.float_dtypes.add(str(t.dtype).removeprefix("torch."))
        nbytes = sum(_nbytes(t) for t in seen.values())
        if nbytes > self.peak_bytes:
            self.peak_bytes, self.peak_op = nbytes, str(func)
        if outs:
            self.max_rank = max(self.max_rank, max(t.dim() for t in outs))
        if name in HOST_SYNC_OPS or (
                name in COPY_OPS
                and any(t.device.type == "cpu" for t in outs)
                and any(t.device.type != "cpu" for t in ins)) or (
                name in INDEX_OPS
                and any(t.dtype in (torch.bool, torch.uint8)
                        for t in _tensors(args[1:2]))):
            self.host_syncs.append(str(func))
        return out


def call_outputs(spec, case, result) -> tuple:
    """The tensors one call of ``spec``'s kernel or plain version
    produced: ``spec.outputs(case, result)``, else the result (a tuple or
    one tensor)."""
    fn = getattr(spec, "outputs", None)
    if fn is not None:
        return tuple(fn(case, result))
    return tuple(result) if isinstance(result, tuple) else (result,)


def audit_plain(spec) -> dict[str, Any]:
    """The CPU half for one kernel spec (see the module doc); returns a
    JSON-ready report with its ``checks`` and ``ok``."""
    case = spec.make_inputs("cpu")
    ref = spec.load_ref()
    walk = OpWalk()
    with walk:
        ref(*case.args, **case.kwargs)
    sim = spec.domain == "sim"
    floats = sorted(walk.float_dtypes)
    checks = {
        "dtype_ok": (set(floats) <= {"float64"} if sim
                     else "float64" not in floats),
        "no_host_sync": not walk.host_syncs,
        "units_declared": check_unit_signature(spec, len(case.operands)),
    }
    if sim:
        checks["rank_ok"] = walk.max_rank <= spec.max_rank
        checks["budget_ok"] = walk.peak_bytes <= spec.budget_bytes
    report = {
        "domain": spec.domain,
        "audit_shapes": [list(t.shape) for t in case.operands],
        "arg_units": list(spec.arg_units),
        "out_units": list(spec.out_units),
        "n_ops": walk.n_ops,
        "max_rank": walk.max_rank,
        "max_rank_allowed": spec.max_rank,
        "peak_op_bytes": walk.peak_bytes,
        "peak_op": walk.peak_op,
        "budget_bytes": spec.budget_bytes,
        "rank_and_bytes": "gated" if sim else UNGATED,
        "float_dtypes": floats,
        "host_syncs": walk.host_syncs[:5],
        "checks": checks,
    }
    report["ok"] = all(checks.values())
    return report


def _input_bytes(args) -> int:
    """Bytes a call reads: its tensors, and the ``nbytes`` of the
    network kernels' packed call and slot arrays."""
    total = 0
    for a in args:
        if isinstance(a, torch.Tensor):
            total += _nbytes(a)
        elif hasattr(a, "nbytes"):
            total += int(a.nbytes)
    return total


def _compare(spec, got: tuple, want: tuple) -> tuple[bool, float]:
    """(agree, max abs error over the finite entries): equal for a
    simulation kernel, within ``spec.tol`` for a model kernel."""
    if len(got) != len(want):
        return False, float("inf")
    ok, err = True, 0.0
    for a, b in zip(got, want):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, float("inf")
        if a.is_floating_point():
            fa, fb = a.double(), b.double()
            fin = torch.isfinite(fa) & torch.isfinite(fb)
            if fin.any():
                err = max(err, float((fa[fin] - fb[fin]).abs().max()))
            if spec.tol is None:
                ok &= torch.equal(a, b)
            else:
                ok &= torch.allclose(fa, fb, atol=spec.tol, rtol=spec.tol)
        else:
            ok &= torch.equal(a, b)
    return bool(ok), err


def audit_cuda(spec, device: torch.device) -> dict[str, Any]:
    """The card half for one kernel spec (see the module doc); returns a
    JSON-ready report with its ``checks`` and ``ok``."""
    from ..kernels import _cuda

    kernel, ref = spec.load_kernel(), spec.load_ref()
    builders = [("audit", spec.make_inputs)]
    if spec.make_small_inputs is not None:
        builders.insert(0, ("small", spec.make_small_inputs))
    report: dict[str, Any] = {"device": torch.cuda.get_device_name(device),
                              "cases": {}}
    checks: dict[str, bool] = {}
    launched = _cuda.LAUNCHES[spec.name]
    for label, build in builders:
        case, plain_case = build(device), build(device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
        walk = OpWalk()
        t0 = time.perf_counter()
        with walk:
            result = kernel(*case.args, **case.kwargs)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        alloc = torch.cuda.max_memory_allocated(device) - before
        got = call_outputs(spec, case, result)
        want = call_outputs(spec, plain_case,
                        ref(*plain_case.args, **plain_case.kwargs))
        agree, err = _compare(spec, got, want)
        checks[f"{label}_matches_plain"] = agree
        entry = {"shapes": [list(t.shape) for t in case.operands],
                 "max_abs_err": err, "call_wall_s": wall}
        if label == "audit":
            in_bytes = _input_bytes(case.args)
            entry.update(input_bytes=in_bytes, alloc_bytes=alloc,
                         peak_bytes=in_bytes + alloc,
                         wrapper_ops=walk.op_counts,
                         wrapper_host_syncs=walk.host_syncs)
            checks["within_budget"] = in_bytes + alloc <= spec.budget_bytes
            checks["no_wrapper_host_sync"] = not walk.host_syncs
            report.update(peak_bytes=in_bytes + alloc,
                          budget_bytes=spec.budget_bytes)
        report["cases"][label] = entry
    report["launches"] = _cuda.LAUNCHES[spec.name] - launched
    checks["launched"] = report["launches"] == len(builders)
    report["parity"] = ("equal" if spec.tol is None
                        else f"within atol=rtol={spec.tol}")
    report["host_read"] = spec.host_read
    report["checks"] = checks
    report["ok"] = all(checks.values())
    return report


def run_kernel_audit(json_path: Path | str | None = None, *,
                     device: str | torch.device | None = None
                     ) -> tuple[dict[str, Any], list[str]]:
    """Audit every registered kernel: the CPU half always, the card half
    when ``device`` is a CUDA device (``None``: when a card is present).
    Returns ``(report, failures)``, failures a list of failed-check
    strings (empty = all pass); writes the report JSON to ``json_path``
    only when one is given."""
    from ..device import resolve_device
    from ..kernels import _cuda, registered_kernels

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = resolve_device(device)
    kernels: dict[str, Any] = {}
    report: dict[str, Any] = {"kernels": kernels,
                              "card": dev.type == "cuda"}
    failures: list[str] = []
    if dev.type == "cuda":
        report["build_s"] = _cuda.build()
    for name, spec in registered_kernels().items():
        entry = {"plain": audit_plain(spec)}
        if dev.type == "cuda":
            entry["cuda"] = audit_cuda(spec, dev)
        kernels[name] = entry
        for half, rep in entry.items():
            for check, ok in rep["checks"].items():
                if not ok:
                    failures.append(f"{name} ({half}): {check} failed")
    if json_path is not None:
        path = Path(json_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    return report, failures
