"""repro_torch.analysis — the analysis passes of ``repro.analysis``, run on
the port.

Static passes over ``src/repro_torch/`` (the rule catalog and suppression
syntax are those of ``docs/ANALYSIS.md``):

* **simlint** (:mod:`~repro_torch.analysis.simlint`) — AST determinism
  linter: hash-ordered iteration in mutation paths, unseeded/global
  randomness (the global torch generator included), wall-clock reads in
  sim-state code, float reductions over unordered containers,
  ``id()``/``hash()`` tie-breaks, heap pushes without the ``(time, seq)``
  tie key.
* **coherence** (:mod:`~repro_torch.analysis.coherence`) — every
  replica-table mutation flows through the listener-notifying catalog
  API, every public read of snapshot state calls ``sync()`` first, and
  telemetry probe callbacks (``repro_torch/obs/``) never mutate the
  engine objects they observe.
* **units** (:mod:`~repro_torch.analysis.units`, ``--units``) —
  unit/dimension inference over the dimension-carrying modules (rules
  SL020-SL025).

The path-scoped rules name the port's packages (``repro_torch/core/``,
``repro_torch/obs/``, ...); otherwise the passes are the reference's, and
give its findings, word for word, on the same source.

Runtime passes, on the CUDA card by default (``device="cpu"`` for the
kernels' plain versions):

* **kernel audit** (:mod:`~repro_torch.analysis.kernel_audit`) — every
  registered kernel (:func:`repro_torch.kernels.registered_kernels`):
  its plain version walked op by op on the CPU (rank, bytes, dtype, host
  round trips) and its CUDA route on the card (peak device bytes against
  the budget, bit-equality or tolerance against the plain version);
* **conserve** (:mod:`~repro_torch.analysis.conserve`, ``--conserve``) —
  the conservation auditor (invariants I1–I7 over a replayed scenario);
* **tierace** (:mod:`~repro_torch.analysis.tierace`, ``--tierace``) — the
  tie-race sanitizer's runners and the static SL010 tie-key pass.

Run as ``python -m repro_torch.analysis`` (see ``--help``); a gate uses
``--fail-on-findings``.
"""

from __future__ import annotations

from pathlib import Path

from . import conserve, tierace
from .coherence import lint_coherence
from .findings import Baseline, Finding, inline_suppressions, is_inline_suppressed
from .simlint import lint_source

__all__ = [
    "Baseline", "Finding", "RULES", "RULE_FAMILIES", "analyze_file",
    "collect_files", "conserve", "default_target", "run_analysis",
    "tierace",
]

#: Rule catalog: id -> one-line description (``--list-rules``).
RULES: dict[str, str] = {
    "SL001": "iteration over a set/frozenset (hash order) outside an "
             "order-free consumer such as sorted()/any()/len()",
    "SL002": "global or unseeded PRNG use (random module, np.random.*, "
             "the global torch generator) instead of a seeded Generator",
    "SL003": "float reduction (sum/math.fsum) over an unordered container "
             "— result depends on hash order",
    "SL004": "id()/hash() used in a sort key — ties break on memory "
             "layout, not data",
    "SL005": "wall-clock read (time.time/perf_counter/...) in sim-state "
             "code (repro_torch/core/, repro_torch/grid/, repro_torch/obs/ "
             "— the telemetry probe itself is the sanctioned exemption)",
    "SL010": "heapq.heappush of an event tuple whose second element is "
             "not the monotonic seq tie-breaker",
    "SL011": "ReplicaCatalog._holders touched outside catalog.py, or "
             "mutated inside it without _notify",
    "SL012": "public method reads sync()-maintained snapshot state "
             "without calling sync() first",
    "SL013": "StorageState private maps touched outside replica.py, or "
             "mutated inside it without _notify",
    "SL014": "obs telemetry code mutates an object received as a "
             "parameter (probe callbacks are observation-only)",
    "SL020": "adding/subtracting values of different dimensions "
             "(bytes + seconds, ...)",
    "SL021": "comparing values of different dimensions",
    "SL022": "Mbps-vocabulary value used where bytes/s is declared, "
             "without the MBPS_TO_BYTES_PER_S conversion",
    "SL023": "sim-clock and wall-clock time mixed in one expression",
    "SL024": "raw conversion literal (1e6, 1e9, 125000.0, ...) scales a "
             "dimensioned value outside repro_torch.core.quantities",
    "SL025": "assignment or keyword binding contradicts the declared "
             "dimension of its target",
}

#: ``--list-rules`` grouping: family name -> rule ids.
RULE_FAMILIES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("determinism (simlint)",
     ("SL001", "SL002", "SL003", "SL004", "SL005", "SL010")),
    ("coherence", ("SL011", "SL012", "SL013")),
    ("obs", ("SL014",)),
    ("units", ("SL020", "SL021", "SL022", "SL023", "SL024", "SL025")),
)

#: Path parts skipped entirely.
_SKIP_PARTS = ("__pycache__",)


def default_target() -> Path:
    """The in-repo ``src/repro_torch`` tree this package ships in."""
    return Path(__file__).resolve().parents[1]


def collect_files(paths: list[Path] | None = None) -> list[Path]:
    """Expand ``paths`` (files or directories; default the repro_torch
    package) into a sorted list of ``.py`` files."""
    roots = paths or [default_target()]
    out: set[Path] = set()
    for root in roots:
        root = Path(root)
        if root.is_file():
            out.add(root.resolve())
        else:
            for p in root.rglob("*.py"):
                if not any(part in _SKIP_PARTS for part in p.parts):
                    out.add(p.resolve())
    return sorted(out)


def _rel_path(path: Path) -> str:
    """Path as reported in findings: relative to the repo root when the
    file lives under it (stable fingerprints), absolute otherwise."""
    repo_root = default_target().parents[1]
    try:
        return path.resolve().relative_to(repo_root).as_posix()
    except ValueError:
        return path.as_posix()


def analyze_file(path: Path) -> tuple[list[Finding], int]:
    """Run both static passes on one file. Returns ``(findings,
    n_inline_suppressed)`` — inline ``# simlint: disable`` comments are
    applied here, baseline filtering is the caller's job."""
    source = path.read_text()
    rel = _rel_path(path)
    raw = lint_source(source, rel) + lint_coherence(source, rel)
    suppressions = inline_suppressions(source)
    findings = [f for f in raw if not is_inline_suppressed(f, suppressions)]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule)), \
        len(raw) - len(findings)


def run_analysis(paths: list[Path] | None = None,
                 baseline: Baseline | None = None,
                 ) -> tuple[list[Finding], list[Finding], int]:
    """Run the static passes over ``paths``. Returns
    ``(new_findings, baselined_findings, n_inline_suppressed)``."""
    new: list[Finding] = []
    old: list[Finding] = []
    inline = 0
    for path in collect_files(paths):
        findings, n_inline = analyze_file(path)
        inline += n_inline
        for f in findings:
            (old if baseline is not None and f in baseline else new).append(f)
    return new, old, inline
