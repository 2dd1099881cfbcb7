"""Unit/dimension inference for the grid engine (rules SL020-SL025), a
copy of ``repro.analysis.units`` with ``UNIT_SCOPE`` retargeted to the
port's modules.

The simulator carries every quantity as a bare ``float``: bytes,
bytes/s, sim-clock seconds, wall-clock probe spans, Mbps-vocabulary
config fields, counts, and dimensionless scores all look identical to
Python. The golden suites pin *values*, so a dropped ``* 1e6 / 8`` or a
``now``-vs-``elapsed_us`` mixup ships as a silently-wrong constant
factor rather than a crash. This checker recovers the dimensions
statically and flags arithmetic that cannot be dimensionally sound.

It rides on :class:`repro_torch.analysis.dataflow.FlowAnalysis` in fixpoint
mode: a **declaration registry** seeds dimensions for core attributes /
dataclass fields (``ATTR_UNITS``), well-known local names
(``NAME_UNITS``), and API return values (``CALL_UNITS``); a small unit
algebra then propagates them through assignments and expressions
(``bytes / bytes_per_s -> sim_seconds`` and so on). The algebra is
deliberately *forgiving*: unknown (``None``) never fires a rule, and a
known dimension absorbs an unknown operand (``now + 5.0`` stays
``sim_seconds``), so sound code produces **zero findings** — the CI gate
(``python -m repro_torch.analysis --units --fail-on-findings``) relies on
that.

Dimensions: ``sim_seconds`` (DES clock), ``wall_seconds`` (host probe),
``bytes``, ``bytes_per_s``, ``mbps`` (config vocabulary), ``count``,
``score``. The named constants of :mod:`repro_torch.core.quantities` get
``conv:*`` pseudo-labels so sanctioned conversions type-check
(``lan_mbps * MBPS_TO_BYTES_PER_S -> bytes_per_s``) while raw literal
conversions outside ``quantities.py`` trip SL024.

Rules:

* **SL020** — adding/subtracting different dimensions.
* **SL021** — comparing different dimensions.
* **SL022** — an ``mbps`` value used where ``bytes_per_s`` is declared
  (bandwidth kwargs, bandwidth-typed assignments, ``bytes / mbps``
  transfer-time math) without the ``MBPS_TO_BYTES_PER_S`` conversion.
* **SL023** — sim-clock and wall-clock time mixed in one expression.
* **SL024** — raw conversion literal (``1e6``, ``1e9``, ``125000.0``...)
  scaling a dimensioned value outside :mod:`repro_torch.core.quantities`.
* **SL025** — assignment/keyword binding contradicting the declared
  dimension of the target (non-mbps mismatches).
"""

from __future__ import annotations

import ast
from typing import Optional

from .dataflow import FlowAnalysis
from .findings import Finding, inline_suppressions, is_inline_suppressed

#: Real dimensions (``conv:*`` pseudo-labels are not in this set).
DIMENSIONS = frozenset(
    {"sim_seconds", "wall_seconds", "bytes", "bytes_per_s", "mbps",
     "count", "score"})

#: repro_torch.core.quantities constants -> conversion pseudo-label.
CONV_CONSTANTS = {
    "KB": "conv:bytes_scale", "MB": "conv:bytes_scale",
    "GB": "conv:bytes_scale", "TB": "conv:bytes_scale",
    "MBPS_TO_BYTES_PER_S": "conv:mbps_to_bytes_per_s",
    "US_PER_S": "conv:us_per_s",
    "BITS_PER_BYTE": "conv:bits_per_byte",
}

#: Attribute / dataclass-field declarations across the scoped modules
#: (GridSimulator, NetworkEngine, GridTopology/Site/Link, AccessHistory,
#: SimResult/JobRecord, GridConfig/ScenarioSpec, obs series).
ATTR_UNITS = {
    # sim-clock seconds
    "now": "sim_seconds", "makespan": "sim_seconds", "last": "sim_seconds",
    "eta": "sim_seconds", "due": "sim_seconds",
    "interarrival": "sim_seconds", "interarrival_s": "sim_seconds",
    "econ_interval": "sim_seconds", "econ_interval_s": "sim_seconds",
    "batch_window": "sim_seconds", "last_now": "sim_seconds",
    "start_time": "sim_seconds", "end_time": "sim_seconds",
    "data_ready_time": "sim_seconds", "mean_downtime_s": "sim_seconds",
    "half_life": "sim_seconds",
    # bytes
    "rem": "bytes", "size": "bytes", "file_size": "bytes",
    "total_file_bytes": "bytes", "used_storage": "bytes",
    "storage_capacity": "bytes", "free_storage": "bytes",
    "total_wan_bytes": "bytes", "total_lan_bytes": "bytes",
    "wan_bytes": "bytes", "lan_bytes": "bytes", "prefetch_bytes": "bytes",
    "budget_bytes": "bytes",
    # bytes per second
    "bandwidth": "bytes_per_s", "lan_bandwidth": "bytes_per_s",
    "wan_bandwidth": "bytes_per_s", "uplink_bandwidths": "bytes_per_s",
    "link_bw": "bytes_per_s", "rate": "bytes_per_s", "share": "bytes_per_s",
    # config (paper) vocabulary
    "lan_mbps": "mbps", "uplink_mbps": "mbps",
    # counters
    "n_jobs": "count", "n_active": "count", "n_links": "count",
    "n_sites": "count", "fetches": "count", "remote_fetches": "count",
    "prefetches": "count", "accesses": "count", "hits": "count",
    "total_inter_comms": "count",
}

#: Bare-name fallbacks for unannotated params/locals (env wins when a
#: name is rebound).
NAME_UNITS = {
    "now": "sim_seconds", "at": "sim_seconds", "dt": "sim_seconds",
    "eta": "sim_seconds", "deadline": "sim_seconds",
    "duration": "sim_seconds", "makespan": "sim_seconds",
    "size": "bytes", "n_bytes": "bytes",
    "bw": "bytes_per_s", "bandwidth": "bytes_per_s", "rate": "bytes_per_s",
    "share": "bytes_per_s",
}

#: Name-suffix heuristics (kept deliberately short).
SUFFIX_UNITS = (("_bytes", "bytes"), ("_mbps", "mbps"),
                ("_us", "wall_seconds"))

#: API return dimensions (matched on the called attribute/function name).
CALL_UNITS = {
    "point_bandwidth": "bytes_per_s", "point_bandwidth_matrix": "bytes_per_s",
    "point_bandwidth_columns": "bytes_per_s",
    "point_bandwidth_column": "bytes_per_s",
    "mbps_to_bytes_per_s": "bytes_per_s",
    "free": "bytes", "rem_now": "bytes", "size": "bytes",
    "rerate": "sim_seconds", "flush": "sim_seconds",
    "us_to_s": "wall_seconds", "elapsed_us": "wall_seconds",
    "bytes_to_gb": None,
}

#: Calls whose result carries the dimension of their (first labelled)
#: argument — reductions, casts, elementwise array builders.
PASSTHROUGH_CALLS = frozenset(
    {"min", "max", "abs", "float", "sum", "round", "minimum", "maximum",
     "array", "asarray", "concatenate", "stack", "sorted"})

#: Keyword-parameter declarations checked at call sites (SL022/SL025).
PARAM_UNITS = {
    "lan_bandwidth": "bytes_per_s", "wan_bandwidth": "bytes_per_s",
    "bandwidth": "bytes_per_s", "uplink_bandwidths": "bytes_per_s",
    "storage_capacity": "bytes", "file_size": "bytes",
    "total_file_bytes": "bytes", "interarrival": "sim_seconds",
}

#: Magic scale factors SL024 hunts for outside quantities.py.
RAW_CONV_LITERALS = frozenset({1e3, 1e6, 1e9, 1e12, 125000.0})

#: Posix path substrings the shipped-tree units pass is scoped to: the
#: modules whose floats carry physical dimensions. quantities.py is in
#: scope (its constants must type-check) but exempt from SL024.
UNIT_SCOPE = (
    "repro_torch/core/network.py", "repro_torch/core/simulator.py",
    "repro_torch/core/economy.py", "repro_torch/core/metrics.py",
    "repro_torch/core/access.py", "repro_torch/core/scenarios.py",
    "repro_torch/core/workload.py", "repro_torch/core/topology.py",
    "repro_torch/core/replica.py", "repro_torch/core/quantities.py",
    "repro_torch/obs/series.py",
)


def _is_real(label: Optional[str]) -> bool:
    return label in DIMENSIONS


def _is_conv(label: Optional[str]) -> bool:
    return label is not None and label.startswith("conv:")


class _UnitChecker(FlowAnalysis):
    """Dimension propagation + SL020-SL025, fixpoint mode."""

    fixpoint = True

    def __init__(self, path: str, source: str):
        super().__init__(path, source)
        self.in_quantities = path.replace("\\", "/").endswith(
            "core/quantities.py")
        self._class_depth = 0

    # -- registry lookups --------------------------------------------------

    def _name_decl(self, name: str) -> Optional[str]:
        label = NAME_UNITS.get(name)
        if label is not None:
            return label
        for suffix, unit in SUFFIX_UNITS:
            if name.endswith(suffix) and name != suffix:
                return unit
        return None

    def _attr_decl(self, attr: str) -> Optional[str]:
        """Registry first: a declared dimension outranks labels inferred
        from (possibly buggy) in-class assignments."""
        label = ATTR_UNITS.get(attr)
        if label is not None:
            return label
        label = self.attr_env.get(attr)
        if label is not None:
            return label
        for suffix, unit in SUFFIX_UNITS:
            if attr.endswith(suffix) and attr != suffix:
                return unit
        return None

    # -- the unit algebra --------------------------------------------------

    def _mul(self, left: Optional[str], right: Optional[str]) -> Optional[str]:
        if _is_conv(right) and not _is_conv(left):
            left, right = right, left       # conv handling is symmetric
        if _is_conv(left):
            if left == "conv:mbps_to_bytes_per_s":
                return "bytes_per_s" if right in (None, "mbps", "count") \
                    else None
            if left == "conv:bytes_scale":
                return "bytes" if right in (None, "count") else None
            if left == "conv:us_per_s":
                return "wall_seconds" if right in (None, "wall_seconds") \
                    else None
            return None
        pair = {left, right}
        if pair == {"bytes_per_s", "sim_seconds"}:
            return "bytes"
        if left == "count":
            return right
        if right == "count":
            return left
        if pair == {"score"}:
            return "score"
        if left is None:
            return right
        if right is None:
            return left
        return None                          # both known, no product rule

    def _div(self, left: Optional[str], right: Optional[str]) -> Optional[str]:
        if _is_conv(right):
            if right == "conv:mbps_to_bytes_per_s":
                return "mbps" if left == "bytes_per_s" else None
            if right == "conv:us_per_s" and left in (None, "wall_seconds"):
                return "wall_seconds"
            return None                      # e.g. report-scale `x / GB`
        if _is_conv(left):
            return None
        if left == "bytes" and right == "bytes_per_s":
            return "sim_seconds"
        if left == "bytes" and right == "sim_seconds":
            return "bytes_per_s"
        if left is not None and left == right:
            return "count"                   # dimensionless ratio
        if right == "count":
            return left
        if right is None:
            return left
        return None

    def _addsub(self, left: Optional[str], right: Optional[str]
                ) -> Optional[str]:
        if _is_conv(left) or _is_conv(right):
            return None
        if left == right:
            return left
        if left is None:
            return right
        if right is None:
            return left
        return None                          # mismatch: flagged at the site

    # -- expression labelling (the FlowAnalysis hook) ----------------------

    def expr_label(self, node: ast.expr | None) -> Optional[str]:
        if node is None:
            return None
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in CONV_CONSTANTS:
                return CONV_CONSTANTS[node.id]
            return self._name_decl(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in CONV_CONSTANTS:
                return CONV_CONSTANTS[node.attr]
            return self._attr_decl(node.attr)
        if isinstance(node, ast.Subscript):
            return self.expr_label(node.value)   # arrays carry one unit
        if isinstance(node, ast.UnaryOp):
            return self.expr_label(node.operand)
        if isinstance(node, ast.IfExp):
            return (self.expr_label(node.body)
                    or self.expr_label(node.orelse))
        if isinstance(node, (ast.List, ast.Tuple)):
            return self.expr_label(node.elts[0]) if node.elts else None
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self.expr_label(node.elt)
        if isinstance(node, ast.BinOp):
            left = self.expr_label(node.left)
            right = self.expr_label(node.right)
            if isinstance(node.op, ast.Mult):
                return self._mul(left, right)
            if isinstance(node.op, (ast.Div, ast.FloorDiv)):
                return self._div(left, right)
            if isinstance(node.op, (ast.Add, ast.Sub)):
                return self._addsub(left, right)
            return None
        if isinstance(node, ast.Call):
            name = self.func_name(node.func)
            if name in CALL_UNITS:
                return CALL_UNITS[name]
            if name in PASSTHROUGH_CALLS:
                for arg in node.args:
                    label = self.expr_label(arg)
                    if label is not None:
                        return label
            return None
        return None

    # -- rule sites --------------------------------------------------------

    def _mismatch_rule(self, left: str, right: str) -> str:
        return ("SL023" if {left, right} == {"sim_seconds", "wall_seconds"}
                else "SL020")

    def visit_BinOp(self, node: ast.BinOp) -> None:
        left = self.expr_label(node.left)
        right = self.expr_label(node.right)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            if _is_real(left) and _is_real(right) and left != right:
                rule = self._mismatch_rule(left, right)
                what = ("sim-clock and wall-clock time"
                        if rule == "SL023" else f"{left} and {right}")
                self.flag(rule, node,
                          f"adding/subtracting {what}: convert one side "
                          "first (see repro.core.quantities)")
        elif isinstance(node.op, (ast.Div, ast.FloorDiv)):
            if _is_real(left) and right == "mbps":
                self.flag("SL022", node,
                          f"dividing {left} by an Mbps-vocabulary value; "
                          "convert with MBPS_TO_BYTES_PER_S first")
            self._check_raw_literal(node, left, right)
        elif isinstance(node.op, ast.Mult):
            self._check_raw_literal(node, left, right)
        self.generic_visit(node)

    def _check_raw_literal(self, node: ast.BinOp, left: Optional[str],
                           right: Optional[str]) -> None:
        if self.in_quantities:
            return
        for lit, other in ((node.left, right), (node.right, left)):
            # the messages are the reference's word for word, so the two
            # passes can be held to each other finding for finding
            if (isinstance(lit, ast.Constant)
                    and isinstance(lit.value, (int, float))
                    and float(lit.value) in RAW_CONV_LITERALS
                    and _is_real(other)):
                self.flag("SL024", node,
                          f"raw conversion literal {lit.value!r} scales a "
                          f"{other} value; use the named constant from "
                          "repro.core.quantities")

    def visit_Compare(self, node: ast.Compare) -> None:
        left_node = node.left
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE,
                               ast.Eq, ast.NotEq)):
                left = self.expr_label(left_node)
                right = self.expr_label(comp)
                if _is_real(left) and _is_real(right) and left != right:
                    rule = self._mismatch_rule(left, right)
                    rule = "SL023" if rule == "SL023" else "SL021"
                    what = ("sim-clock against wall-clock time"
                            if rule == "SL023" else f"{left} against {right}")
                    self.flag(rule, node, f"comparing {what}")
            left_node = comp
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub)):
            target = self.expr_label(node.target)
            value = self.expr_label(node.value)
            if _is_real(target) and _is_real(value) and target != value:
                rule = self._mismatch_rule(target, value)
                self.flag(rule, node,
                          f"accumulating {value} into a {target} target")
        self.generic_visit(node)

    def _declared_target(self, target: ast.expr) -> Optional[str]:
        if isinstance(target, ast.Attribute):
            return self._attr_decl(target.attr)
        if isinstance(target, ast.Subscript):
            return self.expr_label(target.value)
        if isinstance(target, ast.Name) and self._class_depth:
            return self._attr_decl(target.id)    # dataclass field default
        return None                              # plain locals may rebind

    def _check_binding(self, node: ast.AST, declared: Optional[str],
                       value: Optional[str], what: str) -> None:
        if not (_is_real(declared) and _is_real(value)) or declared == value:
            return
        if declared == "bytes_per_s" and value == "mbps":
            self.flag("SL022", node,
                      f"{what} is declared bytes_per_s but gets an Mbps-"
                      "vocabulary value; multiply by MBPS_TO_BYTES_PER_S")
        else:
            self.flag("SL025", node,
                      f"{what} is declared {declared} but gets a "
                      f"{value} value")

    def visit_Assign(self, node: ast.Assign) -> None:
        super().visit_Assign(node)
        value = self.expr_label(node.value)
        for target in node.targets:
            self._check_binding(node, self._declared_target(target), value,
                                ast.unparse(target))

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        super().visit_AnnAssign(node)
        if node.value is not None:
            self._check_binding(node, self._declared_target(node.target),
                                self.expr_label(node.value),
                                ast.unparse(node.target))

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_depth += 1
        try:
            super().visit_ClassDef(node)
        finally:
            self._class_depth -= 1

    def visit_Call(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if kw.arg is None:
                continue
            declared = PARAM_UNITS.get(kw.arg)
            if declared is not None:
                self._check_binding(kw.value, declared,
                                    self.expr_label(kw.value),
                                    f"keyword {kw.arg}=")
        self.generic_visit(node)


def lint_units(source: str, path: str) -> list[Finding]:
    """Run the unit rules over one file's source text."""
    tree = ast.parse(source, filename=path)
    return _UnitChecker(path, source).run(tree)


def unit_scoped(path: str) -> bool:
    """True when ``path`` is one of the dimension-carrying modules."""
    posix = path.replace("\\", "/")
    return any(posix.endswith(scope) for scope in UNIT_SCOPE)


def run_units(paths: list[str] | None = None) -> tuple[list[Finding], int, dict]:
    """Unit-check the scoped tree (or explicit ``paths``).

    Returns ``(findings, n_inline_suppressed, report)`` where ``report``
    is the JSON-ready payload the CLI writes where ``--units-json``
    points.
    """
    from pathlib import Path

    from . import RULES, _rel_path, collect_files

    if paths is None:
        files = [p for p in collect_files() if unit_scoped(str(p))]
    else:
        files = [Path(p) for p in paths]
    findings: list[Finding] = []
    n_inline = 0
    scanned: list[str] = []
    for path in sorted(files):
        source = path.read_text(encoding="utf-8")
        rel = _rel_path(path)
        scanned.append(rel)
        suppressed = inline_suppressions(source)
        for f in lint_units(source, rel):
            if is_inline_suppressed(f, suppressed):
                n_inline += 1
            else:
                findings.append(f)
    report = {
        "rules": {r: RULES[r] for r in sorted(RULES) if r >= "SL020"},
        "files": scanned,
        "n_findings": len(findings),
        "inline_suppressed": n_inline,
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message, "snippet": f.snippet,
             "fingerprint": f.fingerprint()}
            for f in findings],
    }
    return findings, n_inline, report
