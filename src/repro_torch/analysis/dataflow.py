"""Intraprocedural dataflow framework for the AST lints (a copy of
``repro.analysis.dataflow``).

The original simlint linter (PR 6) tracked "which names hold sets" with
ad-hoc env dicts inside one monolithic visitor. Two rule families now
need exactly that machinery — set-origin tracking (SL001/SL003) and
unit-dimension inference (SL020-SL025) — so the propagation core lives
here as a small abstract-interpretation framework over ``ast``:

* **Labels.** Abstract values are opaque strings chosen by the client
  analysis (``'set'``/``'container_of_set'`` for simlint,
  ``'bytes'``/``'sim_seconds'``/... for units). ``None`` means unknown;
  the framework never invents labels of its own.
* **Environments.** Scope-stacked ``name -> label`` dicts: one per
  module / function (closures start from a copy of the enclosing env,
  matching Python's lexical capture of the *binding*), plus a parallel
  ``self.<attr> -> label`` stack per class body, seeded by a pre-pass
  over every ``self.X`` assignment/annotation in the class.
* **Transfer functions.** Clients override :meth:`ann_label` (what a
  type annotation means) and :meth:`expr_label` (what an expression
  evaluates to, given the current env). The framework applies them at
  every binding site — ``Assign``, ``AnnAssign``, annotated function
  parameters, class-body attribute collection — and leaves all *rule*
  checks (what to flag at a use site) to subclass visitors.
* **Per-function fixpoints.** With ``fixpoint = True`` each function
  body is re-visited (findings muted) until its environment stops
  changing or ``max_passes`` is hit, then visited once more with
  findings live — so a label assigned at the bottom of a loop body
  reaches uses at the top. Single-pass mode (``fixpoint = False``)
  reproduces the original simlint visiting order exactly, which is what
  keeps the ported SL001 finding-for-finding identical to the legacy
  implementation (pinned by ``tests/test_torch_units.py``).
"""

from __future__ import annotations

import ast
from typing import Optional

from .findings import Finding


class FlowAnalysis(ast.NodeVisitor):
    """Base visitor owning scopes, propagation, and finding collection.

    Subclasses implement ``ann_label`` / ``expr_label`` and add
    ``visit_*`` methods that call :meth:`flag` at rule sites. They must
    call ``self.generic_visit(node)`` (or the framework's binding
    visitors) to keep propagation running under their own visitors.
    """

    #: Re-visit function bodies to a label fixpoint before reporting.
    fixpoint: bool = False
    #: Safety valve on fixpoint iteration per function.
    max_passes: int = 8

    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.lines = source.splitlines()
        self.findings: list[Finding] = []
        self.module_aliases: dict[str, str] = {}   # name -> module path
        self.from_imports: dict[str, str] = {}     # name -> "module.func"
        self.env_stack: list[dict[str, str]] = [{}]
        self.attr_env_stack: list[dict[str, str]] = [{}]
        self._mute = 0

    # -- client hooks ------------------------------------------------------

    def ann_label(self, ann: ast.expr | None) -> Optional[str]:
        """Label carried by a type annotation (``None`` = unknown)."""
        return None

    def expr_label(self, node: ast.expr | None) -> Optional[str]:
        """Label an expression evaluates to under the current env."""
        return None

    # -- findings ----------------------------------------------------------

    def flag(self, rule: str, node: ast.AST, message: str) -> None:
        if self._mute:
            return
        line = getattr(node, "lineno", 1)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        self.findings.append(
            Finding(rule=rule, path=self.path, line=line, message=message,
                    snippet=snippet))

    # -- environments ------------------------------------------------------

    @property
    def env(self) -> dict[str, str]:
        return self.env_stack[-1]

    @property
    def attr_env(self) -> dict[str, str]:
        return self.attr_env_stack[-1]

    def bind(self, name: str, label: Optional[str]) -> None:
        """Strong update: rebind ``name``, dropping it when unknown."""
        if label is not None:
            self.env[name] = label
        else:
            self.env.pop(name, None)

    # -- imports (shared by _qualified-style rule helpers) ------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.module_aliases[alias.asname or
                                alias.name.split(".")[0]] = alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for alias in node.names:
            if node.module:
                self.from_imports[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"

    def func_name(self, fn: ast.expr) -> str:
        if isinstance(fn, ast.Name):
            return fn.id
        if isinstance(fn, ast.Attribute):
            return fn.attr
        return ""

    def qualified(self, fn: ast.expr) -> str:
        """'mod.attr' when the receiver is an imported module alias."""
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            mod = self.module_aliases.get(fn.value.id)
            if mod is not None:
                return f"{mod}.{fn.attr}"
            src = self.from_imports.get(fn.value.id)
            if src is not None:
                return f"{src.rsplit('.', 1)[-1]}.{fn.attr}"
        if isinstance(fn, ast.Name) and fn.id in self.from_imports:
            return self.from_imports[fn.id]
        return ""

    # -- scope handling ----------------------------------------------------

    def class_attr_labels(self, node: ast.ClassDef) -> dict[str, str]:
        """Pre-pass: labels of every ``self.X`` assigned in the class."""
        attrs: dict[str, str] = {}
        for sub in ast.walk(node):
            target = None
            kind = None
            if isinstance(sub, ast.AnnAssign) and isinstance(
                    sub.target, ast.Attribute):
                target, kind = sub.target, self.ann_label(sub.annotation)
            elif isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Attribute):
                target = sub.targets[0]
            if (target is not None and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                if kind is None and isinstance(sub, ast.Assign):
                    kind = self.expr_label(sub.value)
                if kind is not None:
                    attrs[target.attr] = kind
        return attrs

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.attr_env_stack.append(self.class_attr_labels(node))
        self.generic_visit(node)
        self.attr_env_stack.pop()

    def _function_env(self, node) -> dict[str, str]:
        env = dict(self.env)         # closures see enclosing bindings
        for arg in (node.args.posonlyargs + node.args.args
                    + node.args.kwonlyargs):
            kind = self.ann_label(arg.annotation)
            if kind is not None:
                env[arg.arg] = kind
        return env

    def _visit_function(self, node) -> None:
        base = self._function_env(node)
        if self.fixpoint:
            # warm-up passes (muted) until the post-body env stabilizes
            self._mute += 1
            env = dict(base)
            try:
                for _ in range(self.max_passes):
                    self.env_stack.append(dict(env))
                    self.generic_visit(node)
                    after = self.env_stack.pop()
                    if after == env:
                        break
                    env = after
            finally:
                self._mute -= 1
            self.env_stack.append(env)
        else:
            self.env_stack.append(base)
        self.generic_visit(node)
        self.env_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _visit_loop(self, node) -> None:
        """Fixpoint mode: iterate the loop body (muted) until the env
        stabilizes, so labels bound at the bottom of the body reach
        uses at the top during the final reporting visit."""
        if self.fixpoint:
            self._mute += 1
            try:
                for _ in range(self.max_passes):
                    before = dict(self.env)
                    self.generic_visit(node)
                    if self.env == before:
                        break
            finally:
                self._mute -= 1
        self.generic_visit(node)

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    # -- binding sites -----------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        kind = self.expr_label(node.value)
        for t in node.targets:
            if isinstance(t, ast.Name):
                self.bind(t.id, kind)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        kind = self.ann_label(node.annotation) or self.expr_label(node.value)
        if isinstance(node.target, ast.Name) and kind is not None:
            self.env[node.target.id] = kind

    # -- driver ------------------------------------------------------------

    def run(self, tree: ast.Module) -> list[Finding]:
        """Visit ``tree`` and return findings sorted by (line, rule)."""
        self.visit(tree)
        return sorted(self.findings, key=lambda f: (f.line, f.rule))
