"""The port's dataflow framework and unit/dimension checker (SL020-SL025).

The counterparts of ``tests/test_units.py`` at ``repro_torch/...`` paths:
FlowAnalysis propagation (env scoping, class attribute pre-pass, fixpoint
mode), one positive and one negative (or suppressed) case per unit rule,
the SL001 port-parity pin, the unit-broken fixture, the unit scope named
by the port's paths (so each unit rule fires on a port module), the
kernel specs' unit signatures (``repro_torch.kernels``) and the
acceptance pin: the port's dimension-carrying modules unit-check clean
with zero suppressions.
"""

import ast
import dataclasses
import textwrap
from pathlib import Path

import pytest

from repro.analysis.units import UNIT_SCOPE as REF_UNIT_SCOPE
from repro.analysis.units import lint_units as ref_lint_units
from repro_torch.analysis import RULE_FAMILIES, RULES
from repro_torch.analysis.dataflow import FlowAnalysis
from repro_torch.analysis.findings import (inline_suppressions,
                                           is_inline_suppressed)
from repro_torch.analysis.kernel_audit import check_unit_signature
from repro_torch.analysis.simlint import lint_source
from repro_torch.analysis.units import (DIMENSIONS, UNIT_SCOPE, lint_units,
                                        run_units, unit_scoped)

REPO_ROOT = Path(__file__).resolve().parents[1]
FIXTURE = REPO_ROOT / "tests" / "fixtures" / "unit_broken.py"


def unit_rules(source: str, path: str = "repro_torch/core/x.py") -> list[str]:
    return [f.rule for f in lint_units(textwrap.dedent(source), path)]


# -- dataflow framework -----------------------------------------------------

class _TagFlow(FlowAnalysis):
    """Toy client: annotation `int` means label 'tag'; calls to tag()
    produce 'tag'; flags every Name read that evaluates to 'tag'."""

    def ann_label(self, ann):
        return "tag" if isinstance(ann, ast.Name) and ann.id == "int" \
            else None

    def expr_label(self, node):
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            return self.attr_env.get(node.attr)
        if isinstance(node, ast.Call) and self.func_name(node.func) == "tag":
            return "tag"
        return None

    def visit_Expr(self, node):
        if self.expr_label(node.value) == "tag":
            self.flag("TAG", node, "tagged value used")
        self.generic_visit(node)


def tag_lines(source: str, *, fixpoint: bool = False) -> list[int]:
    src = textwrap.dedent(source)
    flow = _TagFlow("x.py", src)
    flow.fixpoint = fixpoint
    return [f.line for f in flow.run(ast.parse(src))]


def test_dataflow_assign_propagation_and_rebinding():
    assert tag_lines("""
        x = tag()
        x
        x = 0
        x
    """) == [3]


def test_dataflow_function_scope_and_annotation_seeding():
    assert tag_lines("""
        def f(a: int, b):
            a
            b
        def g(b):
            b
    """) == [3]


def test_dataflow_closure_sees_enclosing_bindings():
    assert tag_lines("""
        def outer():
            y = tag()
            def inner():
                y
    """) == [5]


def test_dataflow_class_attr_prepass():
    assert tag_lines("""
        class C:
            def use(self):
                self.z
            def set(self):
                self.z = tag()
    """) == [4]


def test_dataflow_fixpoint_reaches_loop_carried_labels():
    src = """
        def f():
            x = 0
            for _ in range(3):
                x
                x = tag()
    """
    assert tag_lines(src) == []
    assert tag_lines(src, fixpoint=True) == [5]


def test_dataflow_fixpoint_reports_each_finding_once():
    assert tag_lines("""
        def f():
            x = tag()
            x
    """, fixpoint=True) == [4]


# -- SL001 port parity ------------------------------------------------------

def test_sl001_still_fires_after_framework_port():
    findings = lint_source(textwrap.dedent("""
        class C:
            def __init__(self):
                self.pending: set[int] = set()
            def drain(self):
                return [x for x in self.pending]
    """), "repro_torch/core/x.py")
    assert [f.rule for f in findings] == ["SL001"]


def test_sl001_order_free_consumers_still_clean_after_port():
    assert lint_source(textwrap.dedent("""
        def f(s: set[int]):
            return sorted(s), any(x > 0 for x in s), len(s)
    """), "repro_torch/core/x.py") == []


def test_simlint_corpus_parity_on_shipped_tree():
    from repro_torch.analysis import run_analysis
    new, baselined, inline = run_analysis()
    assert new == [] and baselined == [] and inline == 0


# -- unit rules: positive / negative / suppression ---------------------------

def test_sl020_cross_dimension_add():
    assert "SL020" in unit_rules("""
        def f(size, now):
            return size + now
    """)


def test_sl020_unknown_operand_is_forgiving():
    assert unit_rules("""
        def f(now):
            return now + 5.0
    """) == []


def test_sl020_augassign_mismatch():
    assert "SL020" in unit_rules("""
        class C:
            def f(self, now):
                self.total_wan_bytes += now
    """)


def test_sl021_cross_dimension_compare():
    assert "SL021" in unit_rules("""
        def f(size, bandwidth):
            return size > bandwidth
    """)


def test_sl021_ratio_compare_is_clean():
    assert unit_rules("""
        def f(size, bandwidth, now, deadline):
            return size / bandwidth > deadline - now
    """) == []


def test_sl022_bytes_divided_by_mbps():
    assert "SL022" in unit_rules("""
        def f(n_bytes, link_mbps):
            return n_bytes / link_mbps
    """)


def test_sl022_kwarg_binding_without_conversion():
    assert "SL022" in unit_rules("""
        def f(make, spec):
            return make(wan_bandwidth=spec.lan_mbps)
    """)


def test_sl022_converted_mbps_is_clean():
    assert unit_rules("""
        from repro_torch.core.quantities import MBPS_TO_BYTES_PER_S
        def f(make, spec):
            return make(wan_bandwidth=spec.lan_mbps * MBPS_TO_BYTES_PER_S)
    """) == []


def test_sl023_sim_wall_mixing():
    rules = unit_rules("""
        def f(now, elapsed_us):
            return now - elapsed_us
    """)
    assert "SL023" in rules and "SL020" not in rules


def test_sl024_raw_conversion_literal():
    assert "SL024" in unit_rules("""
        def f(n_bytes):
            return n_bytes / 1e9
    """)


def test_sl024_exempt_in_quantities_and_named_constant_clean():
    assert unit_rules("""
        from repro_torch.core.quantities import GB
        def f(n_bytes):
            return n_bytes / GB
    """) == []
    assert unit_rules("""
        def f(n_bytes):
            return n_bytes / 1e9
    """, path="src/repro_torch/core/quantities.py") == []


def test_sl025_declared_dimension_contradiction():
    assert "SL025" in unit_rules("""
        class C:
            def f(self, n_bytes):
                self.makespan = n_bytes
    """)


def test_sl025_registry_outranks_buggy_inference():
    rules = unit_rules("""
        class C:
            def f(self, n_bytes):
                self.makespan = n_bytes
                return self.makespan + n_bytes
    """)
    assert "SL025" in rules and "SL020" in rules


def test_unit_rules_inline_suppression():
    src = textwrap.dedent("""
        def f(size, now):
            return size + now  # simlint: disable=SL020
    """)
    findings = lint_units(src, "repro_torch/core/x.py")
    supp = inline_suppressions(src)
    assert findings and all(is_inline_suppressed(f, supp) for f in findings)


def test_unit_algebra_labels_engine_idioms():
    assert unit_rules("""
        class Net:
            def advance(self, now, dt):
                self.rem -= self.rate * dt
                eta = now + self.rem / self.rate
                share = self.link_bw / self.n_active
                return eta, share
    """) == []


# -- fixture, scope and the port's tree ---------------------------------------

def test_unit_broken_fixture_yields_every_rule():
    findings = lint_units(FIXTURE.read_text(), "tests/fixtures/unit_broken.py")
    rules = {f.rule for f in findings}
    assert {"SL020", "SL021", "SL022", "SL023", "SL024", "SL025"} <= rules
    assert [(f.rule, f.line, f.message) for f in findings] == \
        [(f.rule, f.line, f.message) for f in ref_lint_units(
            FIXTURE.read_text(), "tests/fixtures/unit_broken.py")]


def test_shipped_tree_unit_checks_clean():
    findings, n_inline, report = run_units()
    assert findings == [], "\n".join(f.render() for f in findings)
    assert n_inline == 0
    assert len(report["files"]) == len(UNIT_SCOPE)
    assert report["n_findings"] == 0
    assert all(f.startswith("src/repro_torch/") for f in report["files"])


def test_unit_scope_files_exist():
    for scope in UNIT_SCOPE:
        assert (REPO_ROOT / "src" / scope).is_file(), scope
        assert unit_scoped(str(REPO_ROOT / "src" / scope))


def test_unit_scope_is_the_reference_scope_on_port_paths():
    """Each reference scope entry, retargeted: ``repro/core/...`` would
    match no port path, and the pass would check nothing."""
    assert UNIT_SCOPE == tuple(s.replace("repro/", "repro_torch/", 1)
                               for s in REF_UNIT_SCOPE)
    assert not unit_scoped("src/repro/core/network.py")


#: one seeded bug per unit rule, on a line of a scoped port module
SEEDED = [
    ("SL020", "core/network.py",
     "torch.clamp_min(self.rem - self.rate * dt",
     "torch.clamp_min(self.rem - self.rate + dt"),
    ("SL022", "core/scenarios.py", "lan_bandwidth=spec.lan_mbps * mbps",
     "lan_bandwidth=spec.lan_mbps"),
]


@pytest.mark.parametrize("rule,module,old,new", SEEDED)
def test_units_catches_seeded_engine_mutations(rule, module, old, new):
    """End-to-end sensitivity: breaking real port engine lines is
    flagged at the module's port path."""
    path = REPO_ROOT / "src" / "repro_torch" / module
    src = path.read_text()
    broken = src.replace(old, new)
    assert broken != src
    rel = path.relative_to(REPO_ROOT).as_posix()
    assert unit_scoped(rel)
    assert rule in {f.rule for f in lint_units(broken, rel)}
    assert lint_units(src, rel) == []


@pytest.mark.parametrize("rule,snippet", [
    ("SL020", "def f(size, now):\n    return size + now\n"),
    ("SL021", "def f(size, bandwidth):\n    return size > bandwidth\n"),
    ("SL022", "def f(n_bytes, link_mbps):\n    return n_bytes / link_mbps\n"),
    ("SL023", "def f(now, elapsed_us):\n    return now - elapsed_us\n"),
    ("SL024", "def f(n_bytes):\n    return n_bytes / 1e9\n"),
    ("SL025", "class C:\n    def f(self, n_bytes):\n"
              "        self.makespan = n_bytes\n"),
])
def test_unit_rule_fires_in_scoped_port_module(rule, snippet, tmp_path):
    """Each unit rule fires through ``run_units`` on a module at a scoped
    port path (appended to a copy of the port's network.py)."""
    mod = tmp_path / "src" / "repro_torch" / "core" / "network.py"
    mod.parent.mkdir(parents=True)
    mod.write_text((REPO_ROOT / "src/repro_torch/core/network.py")
                   .read_text() + "\n\n" + snippet)
    assert unit_scoped(str(mod))
    findings, _, report = run_units([str(mod)])
    assert rule in {f.rule for f in findings}
    assert report["n_findings"] == len(findings)


def test_unit_rules_registered_in_catalog():
    assert {"SL020", "SL021", "SL022", "SL023", "SL024", "SL025"} \
        <= set(RULES)


def test_list_rules_groups_by_family():
    grouped = [r for _, rules in RULE_FAMILIES for r in rules]
    assert sorted(grouped) == sorted(set(grouped))
    assert set(grouped) == set(RULES)


# -- kernel unit signatures ---------------------------------------------------

def test_all_kernel_specs_declare_unit_signatures():
    from repro_torch.kernels import registered_kernels
    specs = registered_kernels()
    assert len(specs) == 9      # the seven TPU kernels' and two backwards
    for name, spec in specs.items():
        case = spec.make_inputs("cpu")
        assert check_unit_signature(spec, len(case.operands)), name
        assert set(spec.arg_units) <= DIMENSIONS, name
        assert set(spec.out_units) <= DIMENSIONS, name


def test_sim_kernel_signatures_pinned():
    from repro_torch.kernels import get_kernel_spec
    net = get_kernel_spec("net_rerate")
    assert net.arg_units == ("count", "bytes", "bytes_per_s", "count",
                             "sim_seconds")
    assert net.out_units == ("bytes_per_s", "sim_seconds")
    assert get_kernel_spec("st_cost").out_units == ("sim_seconds",)
    assert get_kernel_spec("event_engine").out_units == (
        "bytes", "bytes_per_s", "sim_seconds", "sim_seconds")


def test_check_unit_signature_rejects_incomplete():
    from repro_torch.kernels import get_kernel_spec
    spec = get_kernel_spec("value_score")
    n = len(spec.make_inputs("cpu").operands)
    assert check_unit_signature(spec, n)
    assert not check_unit_signature(
        dataclasses.replace(spec, arg_units=spec.arg_units[:-1]), n)
    assert not check_unit_signature(
        dataclasses.replace(spec, out_units=()), n)
    assert not check_unit_signature(
        dataclasses.replace(spec, out_units=("furlongs",)), n)
