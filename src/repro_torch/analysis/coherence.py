"""Snapshot-coherence rules (the frozen-lfns bug class), a copy of
``repro.analysis.coherence`` with its paths retargeted to ``repro_torch/``.

The engine keeps several derived snapshots of the replica catalog —
incremental presence bitmaps in the jax brokers, decayed access counts
in :class:`repro_torch.core.access.AccessHistory` — maintained by catalog
listeners plus a lazy ``sync()`` that re-bases the file axis when files
were registered after construction. Two invariants make that safe, and
PR 5 shipped a bug (stale ``lfns`` axis read without ``sync()``) that
motivates checking them statically:

* **SL011 — catalog mutations go through the listener-notifying API.**
  Outside ``repro_torch/core/catalog.py`` nobody touches the private
  ``_holders`` replica map: reads go through ``holders()`` /
  ``fetchable_holders()``, writes through ``register_file()`` /
  ``add_replica()`` / ``remove_replica()`` (which fire ``_notify``).
  Inside ``catalog.py``, every method that mutates ``_holders`` must
  call ``_notify`` in the same method body.

* **SL012 — snapshot consumers call sync() before reads.** In any class
  defining a ``sync()`` method, the attributes ``sync()`` reassigns are
  the *synced snapshot state*. Every public method (not ``sync``
  itself, not ``on_*`` listener callbacks, not ``_``-private helpers)
  that reads one of those attributes must be *synced*: it calls
  ``.sync()`` directly, or calls a same-class method that is synced
  (transitively). Listener callbacks are exempt because they are the
  incremental maintainers; private helpers are exempt because their
  public callers carry the obligation.

* **SL013 — storage mutations go through the listener-notifying API.**
  The batched strategy engine (PR 8) mirrors ``StorageState`` into
  :class:`repro_torch.core.replica.StorageTensorView` via storage listeners,
  so the storage maps got the same contract the catalog's ``_holders``
  has under SL011. Outside ``repro_torch/core/replica.py`` nobody touches the
  private ``_contents`` / ``_pins`` / ``_add_seq`` / ``_lru`` maps:
  reads go through ``has()`` / ``site_contents()`` / ``is_pinned()`` /
  ``lru_order()``, writes through ``add()`` / ``touch()`` / ``remove()``
  / ``pin()`` / ``unpin()`` (which fire ``_notify``). Inside
  ``replica.py``, every public method that mutates one of those maps
  must call ``_notify`` in the same body (``_``-private helpers are
  exempt — their public callers carry the obligation, same as SL012).

* **SL014 — obs probe callbacks are observation-only.** The telemetry
  package (PR 9) is handed live engine objects — ``GridSampler.sample``
  receives the running ``GridSimulator`` — and is simultaneously the
  one sim-adjacent package exempt from the SL005 wall-clock ban. The
  bit-identity contract ("any obs mode leaves the goldens untouched")
  therefore rests on obs code never *writing* through those handles.
  Inside ``repro_torch/obs/``, any function body that (a) calls a mutating
  method (``submit_job``, ``add_replica``, ``rerate``, ``append``,
  ``pop``, ...) on a receiver rooted at one of its own parameters, or
  (b) assigns/augments/deletes through an attribute or subscript chain
  rooted at a parameter, is flagged. ``self``/``cls`` are excluded —
  mutating the probe's *own* bookkeeping is the package's job; the rule
  polices the boundary to foreign objects passed in.
"""

from __future__ import annotations

import ast

from .findings import Finding

#: The owners of the private maps, matched as path suffixes: the port's
#: modules (``"repro/core/catalog.py"`` is no suffix of the port's path, so
#: an unretargeted constant would flag every access inside the owner).
CATALOG_OWNER_PATH = "repro_torch/core/catalog.py"
PRIVATE_REPLICA_MAP = "_holders"
STORAGE_OWNER_PATH = "repro_torch/core/replica.py"
PRIVATE_STORAGE_MAPS = frozenset(("_contents", "_pins", "_add_seq", "_lru"))
LISTENER_PREFIX = "on_"
#: SL014 scope: files whose path contains this substring.
OBS_PATH = "repro_torch/obs/"
#: Method names that mutate their receiver. Covers the engine's own
#: mutators (simulator / catalog / storage / network / access-history
#: APIs) plus the builtin container mutators — calling any of these on
#: an object that arrived as a parameter is a state write, which obs
#: code must never perform.
OBS_MUTATOR_CALLS = frozenset((
    # catalog / storage / replica-strategy
    "register_file", "add_replica", "remove_replica", "bootstrap",
    "add", "remove", "touch", "pin", "unpin", "lose", "plan_fetch",
    "plan_batch", "refresh_plan",
    # simulator / scheduler / broker
    "submit_job", "inject_failure", "run", "dispatch", "select",
    "select_batch",
    # network engine
    "alloc", "release", "rerate", "flush", "advance", "step",
    # access history / economy
    "record_access", "record_fetch", "record_prefetch",
    "invalidate_online", "decay",
    # builtin / heapq container mutators
    "heappush", "heappop", "heapreplace", "heapify",
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "update", "setdefault", "clear", "discard", "sort",
    "reverse", "fill", "put", "resize",
))


def _flag(findings: list[Finding], rule: str, path: str, lines: list[str],
          node: ast.AST, message: str) -> None:
    line = getattr(node, "lineno", 1)
    snippet = lines[line - 1].strip() if 0 < line <= len(lines) else ""
    findings.append(Finding(rule=rule, path=path, line=line,
                            message=message, snippet=snippet))


# ---------------------------------------------------------------------------
# SL011
# ---------------------------------------------------------------------------


def _mutates_holders(node: ast.AST) -> bool:
    """Does this statement mutate an element of ``self._holders``?"""
    for sub in ast.walk(node):
        # self._holders[lfn] = ... / del self._holders[lfn]
        if isinstance(sub, (ast.Assign, ast.Delete)):
            targets = sub.targets
            for t in targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Attribute)
                        and t.value.attr == PRIVATE_REPLICA_MAP):
                    return True
        # self._holders[lfn].add(...) / .discard(...) / .pop(...)
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            recv = sub.func.value
            if sub.func.attr in ("add", "discard", "remove", "pop", "clear",
                                 "update", "setdefault"):
                for part in ast.walk(recv):
                    if (isinstance(part, ast.Attribute)
                            and part.attr == PRIVATE_REPLICA_MAP):
                        return True
    return False


def check_catalog_bypass(tree: ast.Module, path: str,
                         source: str) -> list[Finding]:
    """SL011: private replica-map access outside the catalog module, and
    notify-less mutations inside it."""
    findings: list[Finding] = []
    lines = source.splitlines()
    inside_catalog = path.endswith(CATALOG_OWNER_PATH) or \
        path == CATALOG_OWNER_PATH

    if not inside_catalog:
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and node.attr == PRIVATE_REPLICA_MAP):
                _flag(findings, "SL011", path, lines, node,
                      "direct access to ReplicaCatalog._holders bypasses "
                      "the listener-notifying API; use holders()/"
                      "add_replica()/remove_replica()")
        return findings

    # inside catalog.py: mutating methods must notify listeners
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name == "__init__" or not _mutates_holders(node):
            continue
        notifies = any(
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "_notify"
            for sub in ast.walk(node))
        if not notifies:
            _flag(findings, "SL011", path, lines, node,
                  f"catalog method {node.name}() mutates _holders without "
                  "firing _notify — listener snapshots (presence bitmaps, "
                  "access axes) go stale")
    return findings


# ---------------------------------------------------------------------------
# SL013
# ---------------------------------------------------------------------------


def _mutated_storage_maps(node: ast.AST) -> set[str]:
    """Private-storage-map names this statement mutates through ``self``.

    Unlike ``_holders`` (a flat dict), the storage maps are nested
    (``self._contents[site][lfn] = ...``), so the target walk descends
    through arbitrarily many subscripts.
    """
    hit: set[str] = set()

    def _collect(expr: ast.AST) -> None:
        for part in ast.walk(expr):
            if (isinstance(part, ast.Attribute)
                    and part.attr in PRIVATE_STORAGE_MAPS
                    and isinstance(part.value, ast.Name)
                    and part.value.id == "self"):
                hit.add(part.attr)

    for sub in ast.walk(node):
        if isinstance(sub, (ast.Assign, ast.Delete)):
            for t in sub.targets:
                if isinstance(t, ast.Subscript):
                    _collect(t)
        elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(sub.target, ast.Subscript):
                _collect(sub.target)
        elif isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            if sub.func.attr in ("add", "discard", "remove", "pop", "clear",
                                 "update", "setdefault", "insert", "append"):
                _collect(sub.func.value)
    return hit


def check_storage_bypass(tree: ast.Module, path: str,
                         source: str) -> list[Finding]:
    """SL013: private storage-map access outside the replica module, and
    notify-less mutations inside it (see module doc)."""
    findings: list[Finding] = []
    lines = source.splitlines()
    inside_owner = path.endswith(STORAGE_OWNER_PATH) or \
        path == STORAGE_OWNER_PATH

    if not inside_owner:
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and node.attr in PRIVATE_STORAGE_MAPS):
                _flag(findings, "SL013", path, lines, node,
                      f"direct access to StorageState.{node.attr} bypasses "
                      "the listener-notifying API; use site_contents()/"
                      "lru_order()/is_pinned() or add_listener() — stale "
                      "StorageTensorView tensors otherwise")
        return findings

    # inside replica.py: public mutators must notify listeners, directly or
    # via a same-class mutator that does (lose() delegates to remove()).
    for cls in (n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)):
        methods = _class_methods(cls)
        mutators = {name: _mutated_storage_maps(fn)
                    for name, fn in methods.items()}
        compliant = {name for name, fn in methods.items()
                     if any(isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "_notify"
                            for sub in ast.walk(fn))}
        changed = True
        while changed:
            changed = False
            for name, fn in methods.items():
                if name not in compliant and _self_calls(fn) & compliant:
                    compliant.add(name)
                    changed = True
        for name in sorted(methods):
            if name.startswith("_") or name.startswith(LISTENER_PREFIX):
                continue   # helpers: public callers carry the obligation
            if mutators[name] and name not in compliant:
                _flag(findings, "SL013", path, lines, methods[name],
                      f"{cls.name}.{name}() mutates "
                      f"{', '.join(sorted(mutators[name]))} without firing "
                      "_notify — listener mirrors (StorageTensorView) go "
                      "stale")
    return findings


# ---------------------------------------------------------------------------
# SL012
# ---------------------------------------------------------------------------


def _self_attr_stores(fn: ast.AST) -> set[str]:
    """Names X for every ``self.X = ...`` in the function body."""
    out: set[str] = set()
    for sub in ast.walk(fn):
        targets = []
        if isinstance(sub, ast.Assign):
            targets = sub.targets
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
            targets = [sub.target]
        for t in targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                out.add(t.attr)
    return out


def _self_attr_reads(fn: ast.AST) -> dict[str, ast.Attribute]:
    """Names X (with a representative node) for ``self.X`` reads."""
    out: dict[str, ast.Attribute] = {}
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "self"
                and not isinstance(sub.ctx, ast.Store)):
            out.setdefault(sub.attr, sub)
    # AugAssign targets read too (self.x += 1) but are ctx=Store; catch them
    for sub in ast.walk(fn):
        if isinstance(sub, ast.AugAssign) and isinstance(
                sub.target, ast.Attribute) \
                and isinstance(sub.target.value, ast.Name) \
                and sub.target.value.id == "self":
            out.setdefault(sub.target.attr, sub.target)
    return out


def _self_calls(fn: ast.AST) -> set[str]:
    """Names of same-instance method calls (``self.m(...)``)."""
    out: set[str] = set()
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and isinstance(sub.func.value, ast.Name)
                and sub.func.value.id == "self"):
            out.add(sub.func.attr)
    return out


def _calls_any_sync(fn: ast.AST) -> bool:
    """Does the body call a ``sync()`` method on anything?"""
    return any(
        isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
        and sub.func.attr == "sync"
        for sub in ast.walk(fn))


def _class_methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def check_sync_coherence(tree: ast.Module, path: str,
                         source: str) -> list[Finding]:
    """SL012: public snapshot readers must be synced (see module doc)."""
    findings: list[Finding] = []
    lines = source.splitlines()
    classes = {n.name: n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef)}

    for cls in classes.values():
        methods = _class_methods(cls)
        own = set(methods)     # report on methods *defined* here only, so
        #                        subclasses don't re-report inherited ones
        # resolve single-inheritance sync() from same-module bases
        sync_fn = methods.get("sync")
        seen = {cls.name}
        base_cls = cls
        while sync_fn is None:
            base_names = [b.id for b in base_cls.bases
                          if isinstance(b, ast.Name)]
            base_cls = next((classes[b] for b in base_names
                             if b in classes and b not in seen), None)
            if base_cls is None:
                break
            seen.add(base_cls.name)
            methods = {**_class_methods(base_cls), **methods}
            sync_fn = _class_methods(base_cls).get("sync")
        if sync_fn is None:
            continue

        # synced attrs: assigned in sync() or in same-class methods sync()
        # calls (transitively — sync may delegate to _resync helpers)
        synced_attrs: set[str] = set()
        frontier = ["sync"]
        visited: set[str] = set()
        while frontier:
            name = frontier.pop()
            if name in visited or name not in methods:
                continue
            visited.add(name)
            synced_attrs |= _self_attr_stores(methods[name])
            frontier.extend(sorted(_self_calls(methods[name])))

        # methods that are synced: call .sync() directly, or call a synced
        # same-class method (fixed point)
        synced_methods = {name for name, fn in methods.items()
                          if _calls_any_sync(fn)}
        changed = True
        while changed:
            changed = False
            for name, fn in methods.items():
                if name in synced_methods:
                    continue
                if _self_calls(fn) & synced_methods:
                    synced_methods.add(name)
                    changed = True

        for name, fn in sorted(methods.items()):
            if name not in own:
                continue
            if (name == "sync" or name.startswith("_")
                    or name.startswith(LISTENER_PREFIX)):
                continue
            if name in synced_methods:
                continue
            reads = _self_attr_reads(fn)
            stale = sorted(set(reads) & synced_attrs)
            if stale:
                _flag(findings, "SL012", path, lines, reads[stale[0]],
                      f"{cls.name}.{name}() reads synced snapshot state "
                      f"({', '.join(stale)}) without calling sync() — "
                      "stale file axis after late register_file()")
    return findings


# ---------------------------------------------------------------------------
# SL014
# ---------------------------------------------------------------------------


def _root_name(expr: ast.expr) -> str | None:
    """The base ``Name`` of an attribute/subscript chain, or ``None``.

    ``sim.catalog._holders[lfn]`` -> ``"sim"``; chains rooted at calls
    or literals return ``None`` (a call result is a fresh object the
    caller owns).
    """
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _fn_params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    args = fn.args
    names = {a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)}
    if args.vararg is not None:
        names.add(args.vararg.arg)
    if args.kwarg is not None:
        names.add(args.kwarg.arg)
    return names - {"self", "cls"}


def check_obs_observation_only(tree: ast.Module, path: str,
                               source: str) -> list[Finding]:
    """SL014: obs code may not mutate objects handed in as parameters
    (see module doc). Scope: files under ``repro_torch/obs/``."""
    findings: list[Finding] = []
    if OBS_PATH not in path:
        return findings
    lines = source.splitlines()

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = _fn_params(fn)
        if not params:
            continue
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in OBS_MUTATOR_CALLS:
                root = _root_name(sub.func.value)
                if root in params:
                    _flag(findings, "SL014", path, lines, sub,
                          f"{fn.name}() calls mutating "
                          f"{root}...{sub.func.attr}() on a parameter — "
                          "obs probes are observation-only; copy the data "
                          "out instead of writing through the handle")
            elif isinstance(sub, (ast.Assign, ast.Delete)):
                for t in sub.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)) \
                            and _root_name(t) in params:
                        _flag(findings, "SL014", path, lines, sub,
                              f"{fn.name}() writes through parameter "
                              f"{_root_name(t)!r} — obs probes are "
                              "observation-only")
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                t = sub.target
                if isinstance(t, (ast.Attribute, ast.Subscript)) \
                        and _root_name(t) in params:
                    _flag(findings, "SL014", path, lines, sub,
                          f"{fn.name}() writes through parameter "
                          f"{_root_name(t)!r} — obs probes are "
                          "observation-only")
    return findings


def lint_coherence(source: str, path: str) -> list[Finding]:
    """Run all four coherence rules over one file."""
    tree = ast.parse(source, filename=path)
    findings = check_catalog_bypass(tree, path, source)
    findings += check_storage_bypass(tree, path, source)
    findings += check_sync_coherence(tree, path, source)
    findings += check_obs_observation_only(tree, path, source)
    return sorted(findings, key=lambda f: (f.line, f.rule))
