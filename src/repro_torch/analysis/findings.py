"""Finding records, inline suppressions, and the JSON baseline (a copy of
``repro.analysis.findings``).

A :class:`Finding` is one rule violation at one source location. Three
suppression layers exist, checked in this order:

1. **Inline, same line** — ``# simlint: disable=SL001`` (or a bare
   ``# simlint: disable`` for all rules) on the flagged line.
2. **Inline, next line** — ``# simlint: disable-next-line=SL001`` on the
   line above the flagged one.
3. **Baseline file** — a JSON file of finding fingerprints
   (``analysis_baseline.json``), for grandfathering legacy findings
   without touching the code. Fingerprints hash rule + path + the
   normalized source line (not the line *number*), so unrelated edits
   above a baselined finding do not invalidate it.

Inline suppressions should carry a justification comment; the baseline
is for bulk-adopting the linter on code you cannot touch yet. The
port's own ``src/repro_torch`` tree carries **zero** baseline entries —
the acceptance bar is a clean run, not a long baseline.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from pathlib import Path

_SUPPRESS_RE = re.compile(
    r"#\s*simlint:\s*disable(?P<next>-next-line)?"
    r"(?:\s*=\s*(?P<rules>[A-Z0-9, ]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str          # e.g. "SL001"
    path: str          # repo-relative posix path
    line: int          # 1-indexed
    message: str
    snippet: str = ""  # stripped source line, for fingerprints + display

    def fingerprint(self) -> str:
        norm = re.sub(r"\s+", " ", self.snippet.strip())
        digest = hashlib.sha1(
            f"{self.rule}|{self.path}|{norm}".encode()).hexdigest()
        return digest[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def inline_suppressions(source: str) -> dict[int, set[str] | None]:
    """Map line number -> suppressed rule set (``None`` = all rules)."""
    out: dict[int, set[str] | None] = {}

    def merge(lineno: int, rules: set[str] | None) -> None:
        if rules is None or out.get(lineno, set()) is None:
            out[lineno] = None if rules is None else rules
        else:
            out.setdefault(lineno, set()).update(rules)  # type: ignore

    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = m.group("rules")
        ruleset = (None if rules is None else
                   {r.strip() for r in rules.split(",") if r.strip()})
        merge(i + 1 if m.group("next") else i, ruleset)
    return out


def is_inline_suppressed(finding: Finding,
                         suppressions: dict[int, set[str] | None]) -> bool:
    rules = suppressions.get(finding.line, set())
    return rules is None or finding.rule in (rules or set())


class Baseline:
    """Fingerprint set loaded from / written to a JSON baseline file."""

    def __init__(self, fingerprints: set[str] | None = None):
        self.fingerprints = set(fingerprints or ())

    @classmethod
    def load(cls, path: Path | str | None) -> "Baseline":
        if path is None or not Path(path).exists():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(set(data.get("suppressions", [])))

    def write(self, path: Path | str, findings: list[Finding]) -> None:
        payload = {
            "version": 1,
            "suppressions": sorted({f.fingerprint() for f in findings}),
        }
        Path(path).write_text(json.dumps(payload, indent=2) + "\n")

    def __contains__(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.fingerprints
