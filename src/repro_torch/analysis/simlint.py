"""simlint — AST determinism linter for the port's simulation tree (a copy
of ``repro.analysis.simlint`` with its paths retargeted to ``repro_torch/``
and SL002 extended to the global torch generator).

Flags constructs that let nondeterminism feed simulation state. The DES
engine's bit-identity contract (``tests/golden_metrics.json``) only
holds if every iteration order that touches state, every PRNG draw, and
every tie-break is reproducible across processes and
``PYTHONHASHSEED`` values. CPython dicts are insertion-ordered (and the
engine relies on that); **sets are hash-ordered**, wall clocks are
nondeterministic by definition, and ``id()`` is address-ordered — those
are what the rules target.

Rules (see docs/ANALYSIS.md for the full catalog with examples):

* **SL001** — iteration over a set/frozenset (``for``, comprehensions,
  ``list``/``tuple``/``min``/``max``/``np.fromiter``/star-unpacking
  consumers). Exempt: ``sorted(...)``-wrapped, order-free boolean
  consumers (``any``/``all``), set-to-set rebuilds, ``len``/``bool``.
* **SL002** — module-level / unseeded PRNG use (``random.random()``,
  ``np.random.rand()``...). Seeded instances (``random.Random(seed)``,
  ``np.random.default_rng(seed)``) are the sanctioned form. The port
  draws from explicit ``torch.Generator`` objects, so the global torch
  generator counts too: ``torch.manual_seed`` / ``torch.seed``, and the
  draws ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` (and
  their kin, :data:`TORCH_RANDOM_FUNCS`) or the in-place ``.normal_()`` /
  ``.uniform_()`` (:data:`TORCH_RANDOM_METHODS`) called without a
  ``generator=`` keyword.
* **SL003** — float reductions (``sum``/``math.fsum``) over unordered
  containers: FP addition is order-sensitive, so even a "complete"
  reduction drifts under hash reordering.
* **SL004** — ``id()``/``hash()`` used as a sort/min/max tie-break key.
* **SL005** — wall-clock reads (``time.time``, ``datetime.now``,
  ``uuid.uuid4``, ``os.urandom``) inside the simulation-state packages
  (``repro_torch/core``, ``repro_torch/grid``, ``repro_torch/obs``).
  Measurement code (the CLIs, the fault injectors) lives outside that
  scope and may read real clocks. ``repro_torch/obs/`` is the
  one sanctioned in-scope exemption: the telemetry probe exists to
  measure host phase time, and the companion rule SL014 (coherence)
  guarantees its callbacks cannot write engine state back.
* **SL010** — every ``heapq.heappush`` onto an event queue must push a
  ``(time, seq, ...)`` tuple: a literal tuple of length >= 2 whose
  second element mentions the sequence counter. This is the static half
  of the tie-race sanitizer: FIFO seq numbers make same-timestamp pops
  deterministic and independent of heap-sift internals.
"""

from __future__ import annotations

import ast
from typing import Optional

from .dataflow import FlowAnalysis

SET_ANNOTATIONS = frozenset(
    {"set", "frozenset", "Set", "FrozenSet", "AbstractSet", "MutableSet"})
SEQ_ANNOTATIONS = frozenset(
    {"list", "List", "tuple", "Tuple", "Sequence", "MutableSequence",
     "Iterable", "Iterator", "Collection"})
MAP_ANNOTATIONS = frozenset(
    {"dict", "Dict", "Mapping", "MutableMapping", "defaultdict",
     "OrderedDict"})
SET_METHODS = frozenset(
    {"union", "intersection", "difference", "symmetric_difference", "copy"})
#: Repo APIs documented to return sets (ReplicaCatalog.holders).
SET_RETURNING_METHODS = frozenset({"holders"})
#: Consumers whose result cannot depend on iteration order.
ORDER_FREE_CONSUMERS = frozenset(
    {"sorted", "any", "all", "set", "frozenset", "len", "bool"})
#: Order-sensitive consumers that realize iteration order.
ORDERED_CONSUMERS = frozenset(
    {"list", "tuple", "iter", "enumerate", "reversed", "next", "fromiter",
     "min", "max", "concatenate", "stack", "array"})
FLOAT_REDUCERS = frozenset({"sum", "fsum"})
RANDOM_MODULE_FUNCS = frozenset(
    {"random", "randint", "randrange", "choice", "choices", "shuffle",
     "sample", "uniform", "gauss", "normalvariate", "expovariate",
     "betavariate", "triangular", "getrandbits", "seed", "vonmisesvariate",
     "paretovariate", "weibullvariate", "lognormvariate"})
NP_RANDOM_OK = frozenset(
    {"default_rng", "Generator", "RandomState", "SeedSequence", "PCG64",
     "Philox", "SFC64", "MT19937", "BitGenerator"})
CLOCK_CALLS = frozenset(
    {"time.time", "time.monotonic", "time.perf_counter",
     "time.process_time", "time.time_ns", "time.monotonic_ns",
     "time.perf_counter_ns", "datetime.now", "datetime.utcnow",
     "datetime.today", "date.today", "uuid.uuid1", "uuid.uuid4",
     "os.urandom"})
#: torch-module draws from the global generator unless given
#: ``generator=`` (``manual_seed`` / ``seed`` reseed it: always flagged).
TORCH_RANDOM_FUNCS = frozenset(
    {"rand", "randn", "randint", "randperm", "rand_like", "randn_like",
     "randint_like", "normal", "bernoulli", "multinomial", "poisson"})
TORCH_GLOBAL_SEEDERS = frozenset({"manual_seed", "seed"})
#: In-place tensor draws from the global generator unless given
#: ``generator=``.
TORCH_RANDOM_METHODS = frozenset(
    {"normal_", "uniform_", "exponential_", "random_", "bernoulli_",
     "cauchy_", "geometric_", "log_normal_"})
#: Paths (posix substrings) where SL005 wall-clock reads are banned.
#: ``"repro/core/"`` is not a substring of ``"repro_torch/core/"``: these
#: name the port's packages, or the rule would skip them without a word.
SIM_STATE_PATHS = ("repro_torch/core/", "repro_torch/grid/",
                   "repro_torch/obs/")
#: SL005 carve-out: the telemetry probe is *the* sanctioned wall-clock
#: reader — phase timers are host-time by definition. Its inability to
#: feed that nondeterminism back into simulation state is checked by
#: SL014 instead (repro_torch.analysis.coherence).
SL005_EXEMPT_PATHS = ("repro_torch/obs/",)


def _ann_kind(ann: ast.expr | None) -> Optional[str]:
    """Classify a type annotation: 'set', 'container_of_set', or None."""
    if ann is None:
        return None
    if isinstance(ann, ast.Name):
        return "set" if ann.id in SET_ANNOTATIONS else None
    if isinstance(ann, ast.Attribute):       # typing.Set / t.AbstractSet
        return "set" if ann.attr in SET_ANNOTATIONS else None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _ann_kind(ann.left) or _ann_kind(ann.right)
    if isinstance(ann, ast.Subscript):
        head = ann.value
        name = (head.id if isinstance(head, ast.Name)
                else head.attr if isinstance(head, ast.Attribute) else None)
        if name in SET_ANNOTATIONS:
            return "set"
        inner = (ann.slice.elts if isinstance(ann.slice, ast.Tuple)
                 else [ann.slice])
        if name in SEQ_ANNOTATIONS | MAP_ANNOTATIONS:
            if any(_ann_kind(a) == "set" for a in inner):
                return "container_of_set"
    return None


class _Linter(FlowAnalysis):
    """Determinism rules riding on the dataflow framework.

    Runs in single-pass mode (``fixpoint = False``) — the visiting order
    and env semantics are exactly the pre-framework linter's, which
    keeps the finding corpus identical (pinned by tests/test_units.py).
    Labels: ``'set'`` / ``'container_of_set'``.
    """

    def __init__(self, path: str, source: str):
        super().__init__(path, source)
        self.in_sim_path = (any(s in path for s in SIM_STATE_PATHS)
                            and not any(s in path
                                        for s in SL005_EXEMPT_PATHS))

    # -- set-expression classification ------------------------------------

    def ann_label(self, ann: ast.expr | None) -> Optional[str]:
        return _ann_kind(ann)

    def expr_label(self, node: ast.expr | None) -> Optional[str]:
        if node is None:
            return None
        if isinstance(node, (ast.Set, ast.SetComp)):
            return "set"
        if isinstance(node, ast.ListComp):
            return ("container_of_set"
                    if self.expr_label(node.elt) == "set" else None)
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Attribute):
            if (isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                return self.attr_env.get(node.attr)
            return None
        if isinstance(node, ast.Subscript):
            if self.expr_label(node.value) == "container_of_set":
                return "set"
            return None
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            left, right = self.expr_label(node.left), \
                self.expr_label(node.right)
            if "set" in (left, right):
                return "set"
            return None
        if isinstance(node, ast.IfExp):
            return self.expr_label(node.body) or self.expr_label(node.orelse)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in ("set", "frozenset"):
                return "set"
            if isinstance(fn, ast.Attribute):
                if fn.attr in SET_RETURNING_METHODS:
                    return "set"
                if (fn.attr in SET_METHODS
                        and self.expr_label(fn.value) == "set"):
                    return "set"
            return None
        return None

    def _is_set(self, node: ast.expr | None) -> bool:
        return self.expr_label(node) == "set"

    # -- SL001 iteration sites ---------------------------------------------

    def visit_For(self, node: ast.For) -> None:
        if self._is_set(node.iter):
            self.flag("SL001", node,
                      "iteration over a set is hash-ordered; wrap in "
                      "sorted(...) or keep an insertion-ordered dict")
        self.generic_visit(node)

    def _check_comprehension(self, node, *, exempt: bool) -> None:
        for gen in node.generators:
            if self._is_set(gen.iter) and not exempt:
                self.flag("SL001", gen.iter,
                          "comprehension over a set is hash-ordered; wrap "
                          "the iterable in sorted(...)")

    def visit_ListComp(self, node: ast.ListComp) -> None:
        self._check_comprehension(node, exempt=False)
        self.generic_visit(node)

    def visit_DictComp(self, node: ast.DictComp) -> None:
        self._check_comprehension(node, exempt=False)
        self.generic_visit(node)

    def visit_SetComp(self, node: ast.SetComp) -> None:
        self._check_comprehension(node, exempt=True)   # set -> set: unordered
        self.generic_visit(node)

    def visit_Starred(self, node: ast.Starred) -> None:
        if self._is_set(node.value):
            self.flag("SL001", node,
                      "star-unpacking a set realizes hash order")
        self.generic_visit(node)

    # -- calls: consumers, PRNG, clocks, heappush, key= --------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = self.func_name(node.func)
        qual = self.qualified(node.func)

        # SL001/SL003: ordered consumers fed a set
        if name in ORDERED_CONSUMERS or name in FLOAT_REDUCERS:
            for arg in node.args:
                target = arg.value if isinstance(arg, ast.Starred) else arg
                if isinstance(target, ast.GeneratorExp):
                    if name in FLOAT_REDUCERS and any(
                            self._is_set(g.iter)
                            for g in target.generators):
                        self.flag("SL003", node,
                                  f"float reduction {name}() over a "
                                  "hash-ordered set drifts under "
                                  "reordering; sort the iterable")
                    continue       # ordered consumers of generators: the
                                   # generator's own source was checked
                if self._is_set(target):
                    rule = ("SL003" if name in FLOAT_REDUCERS else "SL001")
                    self.flag(rule, node,
                              f"{name}() over a set realizes hash order; "
                              "wrap the set in sorted(...)")
        if name in ORDER_FREE_CONSUMERS:
            # visit children but skip generator-over-set checks: consumer
            # is order-free (any/all/sorted/set/len/bool)
            for arg in node.args:
                if isinstance(arg, ast.GeneratorExp):
                    self._check_comprehension(arg, exempt=True)
                    for g in arg.generators:
                        self.visit(g.iter)
                    self.visit(arg.elt)
                else:
                    self.visit(arg)
            for kw in node.keywords:
                self.visit(kw.value)
            self.visit(node.func)
            self._check_key_kwarg(node, name)
            return

        # SL002: module-level / unseeded PRNG
        self._check_prng(node, name, qual)
        # SL005: wall-clock in sim-state paths
        if self.in_sim_path and qual in CLOCK_CALLS:
            self.flag("SL005", node,
                      f"wall-clock read {qual}() inside simulation state; "
                      "sim time must come from the event loop")
        # SL010: heappush tie keys
        if qual == "heapq.heappush" or (name == "heappush"
                                        and qual.endswith(".heappush")):
            self._check_heappush(node)
        # SL004: id()/hash() tie-breaks in sort keys
        self._check_key_kwarg(node, name)
        self.generic_visit(node)

    def _check_prng(self, node: ast.Call, name: str, qual: str) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            mod = self.module_aliases.get(fn.value.id)
            if mod == "random" and fn.attr in RANDOM_MODULE_FUNCS:
                self.flag("SL002", node,
                          f"module-level random.{fn.attr}() shares global "
                          "state; use a seeded random.Random instance")
            if mod == "numpy.random" and fn.attr not in NP_RANDOM_OK:
                self.flag("SL002", node,
                          f"global numpy.random.{fn.attr}() is unseeded; "
                          "use np.random.default_rng(seed)")
        # np.random.<fn>(...) — Attribute(Attribute(Name(np), random), fn)
        if (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Attribute)
                and fn.value.attr == "random"
                and isinstance(fn.value.value, ast.Name)
                and self.module_aliases.get(fn.value.value.id) == "numpy"
                and fn.attr not in NP_RANDOM_OK):
            self.flag("SL002", node,
                      f"global np.random.{fn.attr}() is unseeded; use "
                      "np.random.default_rng(seed)")
        if qual.startswith("random.") and name in RANDOM_MODULE_FUNCS \
                and isinstance(fn, ast.Name):
            self.flag("SL002", node,
                      f"from-imported random.{name}() shares global state; "
                      "use a seeded random.Random instance")
        self._check_torch_prng(node, name, qual)

    def _check_torch_prng(self, node: ast.Call, name: str,
                          qual: str) -> None:
        """SL002 in torch: the global generator, reseeded or drawn from
        without ``generator=``."""
        seeded = any(kw.arg == "generator" for kw in node.keywords)
        if qual.startswith("torch.") and qual.count(".") == 1:
            if name in TORCH_GLOBAL_SEEDERS:
                self.flag("SL002", node,
                          f"torch.{name}() reseeds the global generator; "
                          "seed a torch.Generator and pass generator=")
            elif name in TORCH_RANDOM_FUNCS and not seeded:
                self.flag("SL002", node,
                          f"torch.{name}() without generator= draws from "
                          "the global generator; pass a seeded "
                          "torch.Generator")
        elif (isinstance(node.func, ast.Attribute)
              and name in TORCH_RANDOM_METHODS and not seeded):
            self.flag("SL002", node,
                      f"in-place .{name}() without generator= draws from "
                      "the global generator; pass a seeded torch.Generator")

    def _check_heappush(self, node: ast.Call) -> None:
        if len(node.args) < 2:
            return
        item = node.args[1]
        if not isinstance(item, ast.Tuple) or len(item.elts) < 2:
            self.flag("SL010", node,
                      "heappush item must be a literal (time, seq, ...) "
                      "tuple so same-timestamp pops stay deterministic")
            return
        second = ast.unparse(item.elts[1])
        if "seq" not in second.lower():
            self.flag("SL010", node,
                      "heappush tie-break key (2nd tuple element) must be "
                      f"the monotonic seq counter, got {second!r}")

    def _check_key_kwarg(self, node: ast.Call, name: str) -> None:
        if name not in ("sorted", "min", "max", "sort"):
            return
        for kw in node.keywords:
            if kw.arg != "key":
                continue
            expr = kw.value
            if isinstance(expr, ast.Name) and expr.id in ("id", "hash"):
                self.flag("SL004", node,
                          f"{expr.id}() as a sort key is address/hash-"
                          "ordered; use a stable domain key")
            for sub in ast.walk(expr):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id in ("id", "hash")):
                    self.flag("SL004", sub,
                              f"{sub.func.id}() inside a sort key is "
                              "address/hash-ordered; use a stable "
                              "domain key")


def lint_source(source: str, path: str) -> list[Finding]:
    """Run the simlint rules over one file's source text."""
    tree = ast.parse(source, filename=path)
    return _Linter(path, source).run(tree)
