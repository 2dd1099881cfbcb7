"""CLI for ``python -m repro_torch.analysis``.

Default run: both static passes (simlint + coherence) over
``src/repro_torch`` plus the kernel audit: its CPU half (the plain
versions, walked op by op) always, its card half (the CUDA routes) when a
card is present or ``--device cuda`` names one. ``--units`` adds the
unit/dimension pass, ``--conserve`` the conservation-audit smoke and
``--tierace`` the tie-race sanitizer smoke, both on the card unless
``--device cpu``. JSON reports are written only where ``--kernels-json`` /
``--units-json`` point. ``--fail-on-findings`` makes any unsuppressed
finding (or audit / conservation failure) exit non-zero.

    PYTHONPATH=src python -m repro_torch.analysis --fail-on-findings \\
        --units --no-kernels                      # the CPU, static only
    PYTHONPATH=src python -m repro_torch.analysis --fail-on-findings \\
        --units --conserve --tierace              # on the card
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import RULE_FAMILIES, RULES, Baseline, default_target, run_analysis

DEFAULT_BASELINE = "analysis_baseline.json"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Determinism / kernel-invariant / snapshot-coherence "
                    "analysis of the repro_torch port.")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="files or directories to lint "
                             "(default: the installed repro_torch package)")
    parser.add_argument("--fail-on-findings", action="store_true",
                        help="exit 1 if any unsuppressed finding or audit "
                             "failure remains")
    parser.add_argument("--baseline", type=Path, default=None,
                        help=f"baseline JSON (default: {DEFAULT_BASELINE} "
                             "next to the lint root, if present)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings to the baseline file "
                             "and exit 0")
    kernels = parser.add_mutually_exclusive_group()
    kernels.add_argument("--kernels", dest="kernels", action="store_true",
                         default=True, help="run the kernel audit "
                         "(the default)")
    kernels.add_argument("--no-kernels", dest="kernels",
                         action="store_false", help="skip the kernel audit")
    kernels.add_argument("--kernels-only", action="store_true",
                         help="run only the kernel audit")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the runtime passes run: cuda (an error "
                             "without a card) or cpu; default: the kernel "
                             "audit's card half when a card is present, "
                             "--conserve / --tierace on the card")
    parser.add_argument("--kernels-json", type=Path, default=None,
                        help="write the kernel audit report here")
    parser.add_argument("--tierace", action="store_true",
                        help="also run the tie-race sanitizer smoke "
                             "scenario and print its report")
    parser.add_argument("--units", action="store_true",
                        help="also run the unit/dimension checker over the "
                             "dimension-carrying modules")
    parser.add_argument("--units-json", type=Path, default=None,
                        help="write the units report here")
    parser.add_argument("--conserve", action="store_true",
                        help="also run the runtime conservation-audit "
                             "smoke (ledger-closure invariants)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog (grouped by family) "
                             "and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        listed: set[str] = set()
        for family, rules in RULE_FAMILIES:
            print(f"{family}:")
            for rule in rules:
                print(f"  {rule}  {RULES[rule]}")
                listed.add(rule)
        leftover = sorted(set(RULES) - listed)     # never drop a rule
        if leftover:
            print("other:")
            for rule in leftover:
                print(f"  {rule}  {RULES[rule]}")
        return 0

    if args.device == "cuda" and not torch.cuda.is_available():
        print("analysis: --device cuda names a card, and "
              "torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    failed = False

    # -- static passes -----------------------------------------------------
    if not args.kernels_only:
        baseline_path = args.baseline
        if baseline_path is None:
            candidate = default_target() / DEFAULT_BASELINE
            baseline_path = candidate if candidate.exists() else None
        baseline = Baseline.load(baseline_path)
        new, old, inline = run_analysis(args.paths or None, baseline)

        if args.write_baseline:
            target = args.baseline or default_target() / DEFAULT_BASELINE
            Baseline().write(target, new + old)
            print(f"wrote {len(new) + len(old)} fingerprints to {target}")
            return 0

        for finding in new:
            print(finding.render())
        print(f"simlint: {len(new)} finding(s), {len(old)} baselined, "
              f"{inline} inline-suppressed")
        failed |= bool(new)

    # -- kernel audit ------------------------------------------------------
    if args.kernels_only or args.kernels:
        from .kernel_audit import run_kernel_audit
        report, failures = run_kernel_audit(args.kernels_json,
                                            device=args.device)
        for line in failures:
            print(f"kernel audit: FAIL {line}")
        halves = "plain + cuda" if report["card"] else "plain"
        where = f" -> {args.kernels_json}" if args.kernels_json else ""
        print(f"kernel audit ({halves}): {len(report['kernels'])} "
              f"kernel(s), {len(failures)} failure(s){where}")
        for name, entry in report["kernels"].items():
            if "cuda" in entry:
                cuda = entry["cuda"]
                print(f"  {name}: peak {cuda['peak_bytes']} B of "
                      f"{cuda['budget_bytes']} B on the card, "
                      f"{cuda['parity']}")
        failed |= bool(failures)

    # -- unit/dimension pass -----------------------------------------------
    if args.units:
        from .units import run_units
        findings, inline, report = run_units(
            [str(p) for p in args.paths] if args.paths else None)
        for finding in findings:
            print(finding.render())
        where = ""
        if args.units_json is not None:
            args.units_json.parent.mkdir(parents=True, exist_ok=True)
            args.units_json.write_text(
                json.dumps(report, indent=2, sort_keys=True) + "\n")
            where = f" -> {args.units_json}"
        print(f"units: {len(findings)} finding(s), {inline} "
              f"inline-suppressed, {len(report['files'])} file(s){where}")
        failed |= bool(findings)

    device = args.device or "cuda"
    # -- runtime conservation audit ----------------------------------------
    if args.conserve:
        from .conserve import run_conservation_smoke
        for rep in run_conservation_smoke(device=device):
            bad = [n for n, c in rep["checks"].items() if not c["ok"]]
            status = "ok" if rep["ok"] else f"FAIL ({', '.join(bad)})"
            print(f"conserve: {rep['scenario']} ({rep['n_jobs']} jobs, "
                  f"net={rep['net']}, device={device}): "
                  f"{len(rep['checks'])} invariant(s) {status}")
            for name in bad:
                c = rep["checks"][name]
                print(f"  FAIL {name}: lhs={c['lhs']} rhs={c['rhs']} "
                      f"({c['what']})")
            failed |= not rep["ok"]

    # -- dynamic tie-race smoke --------------------------------------------
    if args.tierace:
        from .tierace import sanitize_smoke
        rep = sanitize_smoke(device=device)
        print(f"tie-race smoke (device={device}): {rep['ties_seen']} tie "
              f"instant(s) replayed, {len(rep['tie_races'])} "
              "order-dependent")
        for race in rep["tie_races"]:
            kinds = ",".join(sorted(set(race["kinds"])))
            print(f"  t={race['time']:.1f} [{kinds}] {race['detail']}")

    return 1 if (failed and args.fail_on_findings) else 0


if __name__ == "__main__":
    sys.exit(main())
