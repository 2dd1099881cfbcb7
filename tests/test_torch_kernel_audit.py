"""The port's kernel registry, its SPECs and the kernel audit
(``repro_torch.kernels.registry``, ``repro_torch.kernels.spec``,
``repro_torch.analysis.kernel_audit``).

The registry finds exactly the nine kernel packages; each SPEC of the
seven TPU kernels' counterparts carries the reference SPEC's domain, rank
cap, unit signature and audit shapes (``repro.kernels``, which imports no
JAX), and its budget, doubled for the float64 simulation kernels; its
inputs are the reference's draws in float64, and its plain version at them
gives the reference oracle's result. ``flash_attention_bwd`` has no
reference SPEC (the reference has no backward kernel): its SPEC is the
port's own, its plain version at its audit inputs the exact float64
gradient up to its bf16 rounding convention. ``selective_scan_bwd`` has
none either (the reference differentiates its jnp scan): its SPEC's
small and audit inputs carry the forward's round states, and its plain
version at them is the float64 gradient within its tolerance. The CPU
half of the audit passes for all nine and flags toy
plain versions that broadcast to rank 3, overrun their budget, hold the
wrong float dtype or read a value back to the host. The card half runs
under ``-m gpu`` (this file's imports need no JAX, so it runs on the
card's machine too).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.kernels as ref_kernels
from repro_torch.analysis.kernel_audit import (UNGATED, audit_cuda,
                                               audit_plain, call_outputs,
                                               run_kernel_audit)
from repro_torch.kernels import (KernelSpec, get_kernel_spec,
                                 registered_kernels)
from repro_torch.kernels.spec import InputCase

#: the counterparts of the reference's kernels, each with a reference SPEC
REF_NAMES = ["event_engine", "flash_attention", "net_rerate",
             "selective_scan", "st_cost", "strategy_plan", "value_score"]
NAMES = sorted(REF_NAMES + ["flash_attention_bwd", "selective_scan_bwd"])
SIM = ["event_engine", "net_rerate", "st_cost", "strategy_plan",
       "value_score"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# -- the registry and the SPECs ---------------------------------------------

def test_registry_discovers_all_kernels():
    regs = registered_kernels()
    assert list(regs) == NAMES
    for name, spec in regs.items():
        assert isinstance(spec, KernelSpec)
        assert spec.name == name
        assert spec.module == f"repro_torch.kernels.{name}"
        assert get_kernel_spec(name) is spec
        assert callable(spec.load_kernel()) and callable(spec.load_ref())
    with pytest.raises(KeyError):
        get_kernel_spec("no_such_kernel")


@pytest.mark.parametrize("name", REF_NAMES)
def test_spec_matches_reference_spec(name):
    spec, ref = get_kernel_spec(name), ref_kernels.get_kernel_spec(name)
    for field in ("domain", "max_rank", "arg_units", "out_units",
                  "multi_output"):
        assert getattr(spec, field) == getattr(ref, field), field
    scale = 2 if spec.domain == "sim" else 1
    assert spec.budget_bytes == scale * ref.budget_bytes
    builders = [(spec.make_inputs, ref.make_inputs)]
    if ref.make_small_inputs is not None:
        builders.append((spec.make_small_inputs, ref.make_small_inputs))
    else:
        assert spec.make_small_inputs is None
    for port_build, ref_build in builders:
        ref_args, _ = ref_build()
        case = port_build("cpu")
        assert [tuple(t.shape) for t in case.operands] == \
            [tuple(np.shape(a)) for a in ref_args]


@pytest.mark.parametrize("name", REF_NAMES)
def test_inputs_are_the_reference_draws(name):
    """The port's operands are the reference's draws: rounded to the
    reference's float32 they are its arrays, entry for entry; the
    simulation kernels' floats are float64 and their masks bool."""
    spec, ref = get_kernel_spec(name), ref_kernels.get_kernel_spec(name)
    ref_args, _ = ref.make_inputs()
    case = spec.make_inputs("cpu")
    for port, want in zip(case.operands, ref_args):
        want = np.asarray(want)
        got = port.numpy()
        if spec.domain == "sim" and port.is_floating_point():
            assert port.dtype == torch.float64
        np.testing.assert_array_equal(got.astype(want.dtype), want)
    again = spec.make_inputs("cpu")
    assert all(torch.equal(a, b)
               for a, b in zip(case.operands, again.operands))


def _oracle_outputs(name, spec, case):
    """The reference's float64 oracle at a port case, and the port plain
    version's outputs in the oracle's order."""
    ref = ref_kernels.get_kernel_spec(name).load_ref()
    # copies: the network kernels write their slot tensors in place
    args = [t.numpy().copy() for t in case.operands]
    got = call_outputs(spec, case,
                       spec.load_ref()(*case.args, **case.kwargs))
    if name == "net_rerate":
        want = ref(*args[:4], float(args[4]))
        got = (got[2], got[6])
    elif name == "event_engine":
        want = ref(*args[:6], float(args[6]))
        got = (got[1], got[2], got[3], got[6])
    elif name == "strategy_plan":
        want = ref(*args)
        got = (*got[0], *got[1])
    else:
        want = ref(*args, **case.kwargs)
    want = want if isinstance(want, tuple) else (want,)
    return got, want


@pytest.mark.parametrize("small", [True, False], ids=["small", "audit"])
@pytest.mark.parametrize("name", SIM)
def test_plain_versions_match_reference_oracles(name, small):
    spec = get_kernel_spec(name)
    case = (spec.make_small_inputs if small else spec.make_inputs)("cpu")
    got, want = _oracle_outputs(name, spec, case)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bwd_spec_and_inputs():
    """flash_attention_bwd's own SPEC: a model kernel on bf16 q, k, v and
    dO, and the float32 o (before its rounding) and lse of the plain
    forward; its plain version at the audit inputs is the float64 gradient
    within the bf16 tolerance."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    spec = get_kernel_spec("flash_attention_bwd")
    case = spec.make_inputs("cpu")
    assert spec.domain == "model" and spec.multi_output and spec.tol == 2e-2
    assert [t.dtype for t in case.operands] == [torch.bfloat16] * 3 + [
        torch.float32, torch.float32, torch.bfloat16]
    q, k, v, o, lse, do = case.operands
    assert lse.shape == q.shape[:3]
    in_out = sum(t.numel() * t.element_size() for t in case.operands)
    in_out += sum(t.numel() * t.element_size() for t in (q, k, v))
    assert in_out + lse.numel() * 4 <= spec.budget_bytes
    got = spec.load_ref()(*case.args, **case.kwargs)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    flash_attention_ref(*leaves, causal=True).backward(do.double())
    for g, leaf in zip(got, leaves):
        scale = float(leaf.grad.abs().max())
        np.testing.assert_allclose(g.double().numpy(), leaf.grad.numpy(),
                                   atol=spec.tol * scale, rtol=spec.tol)


@pytest.mark.parametrize("small", [True, False], ids=["small", "audit"])
def test_scan_bwd_spec_and_inputs(small):
    """selective_scan_bwd's own SPEC: float32 inputs with the round states
    of the plain forward, a nonzero h0 and dh_last; the audit call's bytes
    within the budget; its plain version at the inputs is the float64
    gradient (autograd through the plain forward) within the SPEC's
    tolerance."""
    from repro_torch.kernels.selective_scan import selective_scan_ref

    spec = get_kernel_spec("selective_scan_bwd")
    case = (spec.make_small_inputs if small else spec.make_inputs)("cpu")
    assert spec.domain == "model" and spec.multi_output and spec.tol == 2e-4
    assert all(t.dtype == torch.float32 for t in case.operands)
    x, dt, B, C, A, D, h0, states, dy, dh_last = case.operands
    Bz, S, Di = x.shape
    assert states.shape == (Bz, -(-S // 16), Di, B.shape[-1])
    assert bool(h0.abs().max() > 0) and bool(dh_last.abs().max() > 0)
    if not small:
        nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
        outputs = nbytes((x, dt, B, C, A, D, h0))
        partials = 4 * (2 * Bz * S * -(-Di // 64) * B.shape[-1]
                        + Bz * Di * B.shape[-1] + Bz * Di)
        assert nbytes(case.operands) + outputs + partials \
            <= spec.budget_bytes
    got = spec.load_ref()(*case.args, **case.kwargs)
    leaves = [t.double().requires_grad_() for t in (x, dt, B, C, A, D, h0)]
    y, h = selective_scan_ref(*leaves)
    want = torch.autograd.grad((y * dy.double()).sum()
                               + (h * dh_last.double()).sum(), leaves)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.double().numpy(), w.numpy(),
                                   atol=spec.tol * scale, rtol=spec.tol)


# -- the CPU half -------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_plain_audit_passes(name):
    spec = get_kernel_spec(name)
    rep = audit_plain(spec)
    assert rep["ok"], rep["checks"]
    assert rep["host_syncs"] == []
    if spec.domain == "sim":
        assert rep["float_dtypes"] == ["float64"]
        assert rep["max_rank"] <= spec.max_rank
        assert rep["peak_op_bytes"] <= spec.budget_bytes
        assert rep["rank_and_bytes"] == "gated"
    else:
        assert "float64" not in rep["float_dtypes"]
        assert rep["rank_and_bytes"] == UNGATED
        assert "rank_ok" not in rep["checks"]


def test_run_kernel_audit_on_the_cpu(tmp_path):
    path = tmp_path / "kernels.json"
    report, failures = run_kernel_audit(path, device="cpu")
    assert failures == []
    assert sorted(report["kernels"]) == NAMES
    assert not report["card"]
    assert all(set(e) == {"plain"} for e in report["kernels"].values())
    assert path.exists()
    _, _ = run_kernel_audit(device="cpu")    # no path: nothing written


def _toy(fn, *, domain="sim", max_rank=2, budget=10 ** 9,
         dtype=torch.float64):
    """A spec-like object around a plain function of two (8, 8) tensors."""
    def make_inputs(device="cpu"):
        gen = torch.Generator().manual_seed(0)
        args = tuple(torch.rand((8, 8), generator=gen, dtype=dtype)
                     .to(device) for _ in range(2))
        return InputCase(args, {}, args)

    return types.SimpleNamespace(
        name="toy", domain=domain, max_rank=max_rank, budget_bytes=budget,
        make_inputs=make_inputs, make_small_inputs=None,
        load_ref=lambda: fn, arg_units=("score", "score"),
        out_units=("score",), outputs=None, tol=None)


def _dense_blowup(a, b):
    return (a[:, :, None] * b[None, :, :]).sum(-1)


def test_audit_catches_rank_and_budget_violations():
    rep = audit_plain(_toy(_dense_blowup, budget=2048))
    assert rep["max_rank"] == 3
    assert not rep["checks"]["rank_ok"]
    assert not rep["checks"]["budget_ok"]
    assert rep["peak_op_bytes"] > 2048
    assert not rep["ok"]


def test_audit_records_but_does_not_gate_model_rank():
    rep = audit_plain(_toy(_dense_blowup, domain="model", budget=2048,
                           dtype=torch.float32))
    assert rep["max_rank"] == 3 and rep["peak_op_bytes"] > 2048
    assert rep["rank_and_bytes"] == UNGATED
    assert rep["ok"], rep["checks"]


def test_audit_catches_host_round_trips():
    def with_item(a, b):
        return a * float((a + b).sum().item())

    rep = audit_plain(_toy(with_item))
    assert not rep["checks"]["no_host_sync"]
    assert rep["host_syncs"] == ["aten._local_scalar_dense.default"]
    assert not rep["ok"]

    def with_mask(a, b):
        return a[a > b]                      # a data-dependent shape

    assert not audit_plain(_toy(with_mask))["checks"]["no_host_sync"]


def test_audit_catches_dtype_discipline():
    def narrows(a, b):
        return (a.float() + b.float()).double()

    assert not audit_plain(_toy(narrows))["checks"]["dtype_ok"]

    def widens(a, b):
        return (a.double() * b.double()).float()

    rep = audit_plain(_toy(widens, domain="model", dtype=torch.float32))
    assert not rep["checks"]["dtype_ok"]
    assert audit_plain(_toy(torch.add))["ok"]


def test_audit_checks_the_unit_signature():
    spec = get_kernel_spec("value_score")
    bad = dataclasses.replace(spec, arg_units=spec.arg_units[:-1])
    assert not audit_plain(bad)["checks"]["units_declared"]


def test_cuda_half_refuses_cpu_tensors():
    """The card half launches the CUDA route, which raises on CPU
    tensors rather than fall back to the plain version."""
    spec = get_kernel_spec("st_cost")
    case = spec.make_inputs("cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        spec.load_kernel()(*case.args, **case.kwargs)


# -- the card half ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_cuda_audit_passes(name):
    dev = _card()
    spec = get_kernel_spec(name)
    rep = audit_cuda(spec, dev)
    assert rep["ok"], rep["checks"]
    assert rep["peak_bytes"] <= spec.budget_bytes
    assert rep["launches"] == (2 if spec.make_small_inputs else 1)
    assert (rep["host_read"] is not None) == (name in ("event_engine",
                                                       "net_rerate"))


@pytest.mark.gpu
def test_run_kernel_audit_on_the_card():
    _card()
    report, failures = run_kernel_audit(device="cuda")
    assert failures == [] and report["card"]
    assert all(set(e) == {"plain", "cuda"}
               for e in report["kernels"].values())
