"""The port's static analysis passes (``repro_torch.analysis``).

The counterparts of the static-pass tests of ``tests/test_analysis.py``
(SL001-SL014, inline and baseline suppression, the rule catalog,
``collect_files``, the CLI's clean run) at ``repro_torch/...`` paths; each
path-scoped rule shown to fire on a port path (an unretargeted path
constant would drop it without a word); the SL002 extension to the global
torch generator; parity with the reference passes, finding for finding
(rule, line and message), on every module of ``src/repro`` at its path
mapped to ``repro_torch/``, on ``tests/fixtures/unit_broken.py`` and on a
corpus of rule cases; the port's own tree clean; and the SL010 tie-key
pass against the reference's.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis.coherence import lint_coherence as ref_coherence
from repro.analysis.simlint import lint_source as ref_lint
from repro.analysis.tierace import \
    static_tie_key_findings as ref_static_tie_key_findings
from repro.analysis.units import lint_units as ref_units
from repro_torch.analysis import (RULE_FAMILIES, RULES, Baseline,
                                  analyze_file, collect_files,
                                  default_target, run_analysis)
from repro_torch.analysis.coherence import (CATALOG_OWNER_PATH, OBS_PATH,
                                            STORAGE_OWNER_PATH,
                                            lint_coherence)
from repro_torch.analysis.findings import (Finding, inline_suppressions,
                                           is_inline_suppressed)
from repro_torch.analysis.simlint import (SIM_STATE_PATHS,
                                          SL005_EXEMPT_PATHS, lint_source)
from repro_torch.analysis.tierace import static_tie_key_findings
from repro_torch.analysis.units import lint_units

REPO = Path(__file__).resolve().parents[1]
SRC_ROOT = REPO / "src"
FIXTURE = REPO / "tests" / "fixtures" / "unit_broken.py"


def rules_of(source: str, path: str = "repro_torch/core/x.py") -> list[str]:
    src = textwrap.dedent(source)
    return [f.rule for f in lint_source(src, path) + lint_coherence(src, path)]


def _key(findings) -> list[tuple]:
    return sorted((f.rule, f.line, f.message) for f in findings)


def _port_path(ref_rel: str) -> str:
    return ref_rel.replace("repro/", "repro_torch/", 1)


# -- SL001: set iteration ---------------------------------------------------

def test_sl001_flags_set_iteration():
    assert "SL001" in rules_of("""
        def f(s: set[int]):
            for x in s:
                print(x)
    """)


def test_sl001_flags_self_attr_set():
    assert "SL001" in rules_of("""
        class C:
            def __init__(self):
                self.pending: set[int] = set()
            def drain(self):
                return [x for x in self.pending]
    """)


def test_sl001_flags_set_returning_method():
    assert "SL001" in rules_of("""
        def f(catalog, lfn):
            return [h + 1 for h in catalog.holders(lfn)]
    """)


def test_sl001_sorted_wrap_is_clean():
    assert rules_of("""
        def f(s: set[int]):
            for x in sorted(s):
                print(x)
    """) == []


def test_sl001_order_free_consumers_are_clean():
    assert rules_of("""
        def f(s: set[int]):
            return any(x > 0 for x in s), len(s), set(s), bool(s)
    """) == []


def test_sl001_min_max_over_set_flagged():
    assert "SL001" in rules_of("""
        def f(s: set[int], cost):
            return min(s, key=cost)
    """)


def test_sl001_dict_iteration_is_clean():
    assert rules_of("""
        def f(d: dict[int, str]):
            for k in d:
                print(k)
    """) == []


# -- SL002: global / unseeded PRNG ------------------------------------------

def test_sl002_flags_global_random():
    assert "SL002" in rules_of("""
        import random
        def f():
            return random.random()
    """)


def test_sl002_flags_np_random_module():
    assert "SL002" in rules_of("""
        import numpy as np
        def f():
            return np.random.rand(3)
    """)


def test_sl002_seeded_instances_are_clean():
    assert rules_of("""
        import random as _random
        import numpy as np
        def f(seed):
            rng = _random.Random(seed)
            g = np.random.default_rng(seed)
            return rng.random(), g.random()
    """) == []


TORCH_GLOBAL_DRAWS = [
    "torch.manual_seed(0)",
    "torch.seed()",
    "torch.rand(3)",
    "torch.randn(3, dtype=torch.float64)",
    "torch.randint(0, 5, (3,))",
    "torch.randperm(5)",
    "torch.randn_like(x)",
    "torch.normal(0.0, 1.0, (3,))",
    "x.normal_()",
    "x.uniform_(0.0, 1.0)",
    "torch.nn.init.normal_(x)",
]


@pytest.mark.parametrize("call", TORCH_GLOBAL_DRAWS)
def test_sl002_flags_torch_global_generator(call):
    src = f"""
        import torch
        def f(x):
            return {call}
    """
    findings = [f for f in lint_source(textwrap.dedent(src),
                                       "repro_torch/core/x.py")
                if f.rule == "SL002"]
    assert len(findings) == 1 and findings[0].line == 4, findings


def test_sl002_flags_from_imported_and_aliased_torch():
    assert rules_of("""
        import torch as T
        from torch import randperm
        def f():
            return T.rand(2), randperm(4)
    """).count("SL002") == 2


def test_sl002_torch_generator_draws_are_clean():
    assert rules_of("""
        import torch
        def f(x, seed):
            gen = torch.Generator(device="cpu").manual_seed(seed)
            gen.manual_seed(seed + 1)
            a = torch.randn(3, generator=gen)
            b = torch.randint(0, 5, (3,), generator=gen)
            x.normal_(generator=gen)
            x.uniform_(0.0, 1.0, generator=gen)
            return a, b, torch.randperm(5, generator=gen)
    """) == []


def test_sl002_reference_cases_give_the_reference_findings():
    """The torch extension leaves the reference's own SL002 cases as
    they were: same findings, word for word."""
    for src in ("import random\ndef f():\n    return random.random()\n",
                "import numpy as np\ndef f():\n    return np.random.rand(3)\n",
                "from random import choice\ndef f(x):\n    return choice(x)\n",
                "import numpy.random as npr\ndef f():\n    return npr.rand()\n"):
        assert _key(lint_source(src, "repro_torch/core/x.py")) == \
            _key(ref_lint(src, "repro/core/x.py")) != []


# -- SL003 / SL004 ------------------------------------------------------------

def test_sl003_flags_sum_over_set():
    assert "SL003" in rules_of("""
        def f(s: set[float]):
            return sum(s)
    """)


def test_sl003_sum_over_sorted_is_clean():
    assert rules_of("""
        def f(s: set[float]):
            return sum(sorted(s))
    """) == []


def test_sl004_flags_id_in_sort_key():
    assert "SL004" in rules_of("""
        def f(items):
            return sorted(items, key=lambda j: id(j))
    """)


def test_sl004_domain_key_is_clean():
    assert rules_of("""
        def f(items):
            return sorted(items, key=lambda j: j.job_id)
    """) == []


# -- SL005: wall-clock reads in sim-state code ------------------------------

_CLOCK = """
    import time
    def f():
        return time.perf_counter()
"""


@pytest.mark.parametrize("path", ["src/repro_torch/core/simulator.py",
                                  "repro_torch/grid/datagrid.py",
                                  "repro_torch/core/x.py"])
def test_sl005_flags_wall_clock_in_port_sim_state(path):
    assert "SL005" in rules_of(_CLOCK, path=path)


def test_sl005_scope_excludes_fault_and_launch():
    for path in ("repro_torch/fault/failures.py",
                 "repro_torch/launch/experiments.py"):
        assert "SL005" not in rules_of(_CLOCK, path=path)


def test_sl005_obs_package_is_the_sanctioned_exemption():
    assert "SL005" not in rules_of(_CLOCK, path="repro_torch/obs/probe.py")
    assert "SL005" in rules_of(_CLOCK, path="repro_torch/core/simulator.py")


def test_path_constants_name_the_port():
    """``"repro/core/"`` is no substring of ``"repro_torch/core/"``: every
    path constant must name the port's packages."""
    for const in (*SIM_STATE_PATHS, *SL005_EXEMPT_PATHS, CATALOG_OWNER_PATH,
                  STORAGE_OWNER_PATH, OBS_PATH):
        assert const.startswith("repro_torch/"), const


# -- SL010: heappush tie key ------------------------------------------------

def test_sl010_flags_missing_seq_key():
    assert "SL010" in rules_of("""
        import heapq
        def f(q, t):
            heapq.heappush(q, (t, "payload"))
    """)


def test_sl010_seq_key_is_clean():
    assert rules_of("""
        import heapq
        def f(q, t, kind):
            self_seq = 0
            heapq.heappush(q, (t, self_seq, kind, None))
    """) == []


def test_static_tie_key_findings_match_the_reference(tmp_path):
    """SL010 alone: the port's pass gives the reference's findings on the
    reference's core/, on a module with bad pushes, and the port's own
    core/ pushes the (time, seq) key."""
    bad = tmp_path / "queue.py"
    bad.write_text(textwrap.dedent("""
        import heapq
        from heapq import heappush
        def f(q, t, seq):
            heapq.heappush(q, (t, "payload"))
            heappush(q, t)
            heapq.heappush(q, (t, seq, 1))
    """))
    paths = sorted((SRC_ROOT / "repro" / "core").glob("*.py")) + [bad]
    port, ref = static_tie_key_findings(paths), \
        ref_static_tie_key_findings(paths)
    assert [(f.rule, f.path, f.line, f.message) for f in port] == \
        [(f.rule, f.path, f.line, f.message) for f in ref]
    assert [f.line for f in port] == [5, 6]
    assert static_tie_key_findings() == []
    core = sorted((SRC_ROOT / "repro_torch" / "core").glob("*.py"))
    assert static_tie_key_findings(core) == []
    assert any("heappush" in p.read_text() for p in core)


# -- SL011 / SL013: the catalog's and storage's private maps -----------------

def test_sl011_flags_holders_access_outside_catalog():
    assert "SL011" in rules_of("""
        def f(cat):
            cat._holders["lfn"].add(3)
    """)


def test_sl011_flags_notify_less_mutation_inside_catalog():
    assert "SL011" in rules_of("""
        class ReplicaCatalog:
            def _notify(self, *a): ...
            def silent_add(self, lfn, site):
                self._holders[lfn].add(site)
    """, path="src/repro_torch/core/catalog.py")


def test_sl011_notifying_mutation_is_clean():
    assert rules_of("""
        class ReplicaCatalog:
            def _notify(self, *a): ...
            def add_replica(self, lfn, site):
                self._holders[lfn].add(site)
                self._notify("on_add_replica", lfn, site)
    """, path="src/repro_torch/core/catalog.py") == []


_STORAGE = """
    class StorageState:
        def _notify(self, *a): ...
        def add(self, site, lfn):
            self._contents[site][lfn] = 1
            {notify}
"""


def test_sl013_flags_storage_map_access_outside_replica():
    assert "SL013" in rules_of("""
        def f(storage, site):
            return list(storage._contents[site])
    """, path="repro_torch/core/simulator.py")


def test_sl013_flags_notify_less_mutation_inside_replica():
    src = _STORAGE.format(notify="pass")
    assert "SL013" in rules_of(src, path="src/repro_torch/core/replica.py")


def test_sl013_notifying_mutation_is_clean():
    src = _STORAGE.format(notify='self._notify("on_add", site, lfn)')
    assert rules_of(src, path="src/repro_torch/core/replica.py") == []


# -- SL012: sync coherence --------------------------------------------------

_SYNC_CLASS = """
    class Mirror:
        def __init__(self, catalog):
            self.catalog = catalog
            self._n = 0
        def sync(self):
            self._table = dict(self.catalog.files)
            self._n = len(self._table)
        def {sig}:
            {body}
"""


def test_sl012_flags_unsynced_read():
    src = _SYNC_CLASS.format(sig="lookup(self, k)",
                             body="return self._table[k]")
    assert "SL012" in rules_of(src)


def test_sl012_synced_read_is_clean():
    src = _SYNC_CLASS.format(
        sig="lookup(self, k)",
        body="self.sync()\n            return self._table[k]")
    assert rules_of(src) == []


def test_sl012_private_and_listener_hooks_exempt():
    for sig in ("_peek(self, k)", "on_add_replica(self, k)"):
        src = _SYNC_CLASS.format(sig=sig, body="return self._table[k]")
        assert "SL012" not in rules_of(src), sig


def test_sl012_transitive_sync_counts():
    src = textwrap.dedent("""
        class Mirror:
            def sync(self):
                self._table = {}
            def _fresh(self):
                self.sync()
                return self._table
            def lookup(self, k):
                return self._fresh()[k]
    """)
    assert "SL012" not in rules_of(src)


# -- SL014: obs callbacks are observation-only ------------------------------

def test_sl014_flags_mutating_call_on_parameter():
    assert "SL014" in rules_of("""
        class Sampler:
            def sample(self, sim):
                sim.records.append(1)
    """, path="src/repro_torch/obs/series.py")


def test_sl014_flags_write_through_parameter():
    src = """
        def f(sim):
            sim.now = 0.0
            sim.network.link_act[0] += 1.0
            del sim._cpu_queue[0]
    """
    rules = rules_of(src, path="repro_torch/obs/series.py")
    assert rules.count("SL014") == 3


def test_sl014_reads_and_self_mutation_are_clean():
    assert rules_of("""
        class Sampler:
            def sample(self, sim):
                n = len(sim.records) + sim.network.n_active
                self.ring.append((sim.now, float(n)))
    """, path="repro_torch/obs/series.py") == []


def test_sl014_scoped_to_obs_package():
    src = """
        def f(sim):
            sim.records.append(1)
    """
    assert "SL014" not in rules_of(src, path="repro_torch/core/simulator.py")
    # the reference's obs path is not the port's
    assert "SL014" not in rules_of(src, path="repro/obs/series.py")


# -- suppressions + baseline ------------------------------------------------

def test_inline_same_line_suppression():
    src = textwrap.dedent("""
        def f(s: set[int]):
            for x in s:  # simlint: disable=SL001
                print(x)
    """)
    assert rules_of(src) != []
    supp = inline_suppressions(src)
    assert is_inline_suppressed(Finding("SL001", "p.py", 3, "m", ""), supp)
    assert not is_inline_suppressed(
        Finding("SL003", "p.py", 3, "m", ""), supp)


def test_inline_next_line_and_blanket_suppression():
    supp = inline_suppressions(
        "# simlint: disable-next-line=SL010\nx = 1\n# simlint: disable\ny = 2\n")
    assert is_inline_suppressed(Finding("SL010", "p", 2, "m", ""), supp)
    assert is_inline_suppressed(Finding("SL999", "p", 3, "m", ""), supp)


def test_inline_suppression_applies_in_analyze_file(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("def f(s: set[int]):\n"
                    "    for x in s:  # simlint: disable=SL001\n"
                    "        print(x)\n"
                    "    return [y for y in s]\n")
    findings, n_inline = analyze_file(path)
    assert [(f.rule, f.line) for f in findings] == [("SL001", 4)]
    assert n_inline == 1


def test_baseline_roundtrip_and_line_stability(tmp_path):
    f1 = Finding("SL001", "repro_torch/core/x.py", 10, "m", "for x in s:")
    f2 = Finding("SL001", "repro_torch/core/x.py", 99, "m", "for  x  in s:")
    path = tmp_path / "baseline.json"
    Baseline().write(path, [f1])
    loaded = Baseline.load(path)
    assert f1 in loaded and f2 in loaded
    assert Finding("SL003", "repro_torch/core/x.py", 10, "m",
                   "for x in s:") not in loaded
    assert json.loads(path.read_text())["version"] == 1


def test_baseline_filters_run_analysis(tmp_path):
    path = tmp_path / "m.py"
    path.write_text("def f(s: set[int]):\n    return [y for y in s]\n")
    new, old, _ = run_analysis([path])
    assert [f.rule for f in new] == ["SL001"] and old == []
    base = tmp_path / "baseline.json"
    Baseline().write(base, new)
    new2, old2, _ = run_analysis([path], Baseline.load(base))
    assert new2 == [] and old2 == new


# -- the port's tree --------------------------------------------------------

def test_shipped_tree_lints_clean():
    """``src/repro_torch`` carries zero unsuppressed findings, zero
    baseline entries and zero inline suppressions."""
    new, baselined, inline = run_analysis()
    assert new == [], "\n".join(f.render() for f in new)
    assert baselined == [] and inline == 0
    assert not (default_target() / "analysis_baseline.json").exists()


@pytest.mark.parametrize("module,rule", [("catalog.py", "SL011"),
                                         ("replica.py", "SL013")])
def test_owner_modules_are_clean_at_their_port_paths(module, rule):
    """The owners of the private maps, at their real paths: none of the
    findings an unretargeted owner path gives (SL011 14 times in
    catalog.py, SL013 44 times in replica.py)."""
    path = SRC_ROOT / "repro_torch" / "core" / module
    rel = path.relative_to(REPO).as_posix()
    src = path.read_text()
    assert lint_coherence(src, rel) == []
    # the same source under a path that is not the owner's is flagged
    assert rule in [f.rule for f in lint_coherence(src, "elsewhere.py")]


def test_collect_files_covers_tree():
    files = collect_files()
    assert len(files) > 50
    assert all(f.suffix == ".py" for f in files)
    assert default_target() == SRC_ROOT / "repro_torch"
    assert all(default_target() in f.parents for f in files)


def test_rule_catalog_matches_emitted_rules():
    emitted = {"SL001", "SL002", "SL003", "SL004", "SL005", "SL010",
               "SL011", "SL012", "SL013", "SL014"}
    assert emitted <= set(RULES)
    grouped = [r for _, rules in RULE_FAMILIES for r in rules]
    assert sorted(grouped) == sorted(set(RULES))


# -- the CLI ----------------------------------------------------------------

def _cli(*args, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(SRC_ROOT))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def test_cli_clean_run_exits_zero(tmp_path):
    """The static passes and the units pass exit 0 with no finding, and
    write nothing: the CLI has no default report path (the reference's
    ``results/ANALYSIS_*.json`` stay as they are)."""
    results = {p: p.read_bytes() for p in (REPO / "results").glob("*.json")}
    proc = _cli("--no-kernels", "--units", "--fail-on-findings",
                cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "simlint: 0 finding(s)" in proc.stdout
    assert "units: 0 finding(s), 0 inline-suppressed, 11 file(s)" \
        in proc.stdout
    assert list(tmp_path.iterdir()) == []
    assert {p: p.read_bytes()
            for p in (REPO / "results").glob("*.json")} == results


def test_cli_fails_on_findings_and_writes_where_pointed(tmp_path):
    bad = tmp_path / "m.py"
    bad.write_text("import time\ndef f(s: set[int]):\n"
                   "    return [y for y in s], time.time()\n")
    out = tmp_path / "out" / "units.json"
    proc = _cli(str(bad), "--no-kernels", "--units", "--units-json",
                str(out), "--fail-on-findings")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "SL001" in proc.stdout
    assert json.loads(out.read_text())["files"]
    assert _cli(str(bad), "--no-kernels").returncode == 0


def test_cli_lists_every_rule():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rule in RULES:
        assert rule in proc.stdout


def test_cli_card_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _cli("--kernels-only", "--device", "cuda")
    assert proc.returncode == 2
    assert "torch.cuda.is_available() is False" in proc.stderr


# -- parity with the reference passes ----------------------------------------

REF_FILES = sorted(p.relative_to(REPO).as_posix()
                   for p in (SRC_ROOT / "repro").rglob("*.py")
                   if "__pycache__" not in p.parts)


def _all_passes(lint, coherence, units, src: str, path: str) -> list:
    return _key(lint(src, path) + coherence(src, path) + units(src, path))


@pytest.mark.parametrize("rel", REF_FILES)
def test_parity_with_reference_on_reference_tree(rel):
    """Each module of ``src/repro``: the port's three passes at the path
    mapped to ``repro_torch/`` give the reference's findings at its own
    path, by rule, line and message."""
    src = (REPO / rel).read_text()
    assert _all_passes(lint_source, lint_coherence, lint_units, src,
                       _port_path(rel)) == \
        _all_passes(ref_lint, ref_coherence, ref_units, src, rel)


def test_parity_with_reference_on_unit_broken_fixture():
    src = FIXTURE.read_text()
    rel = "tests/fixtures/unit_broken.py"
    port = _all_passes(lint_source, lint_coherence, lint_units, src, rel)
    assert port == _all_passes(ref_lint, ref_coherence, ref_units, src, rel)
    assert {r for r, _, _ in port} >= {"SL020", "SL021", "SL022", "SL023",
                                       "SL024", "SL025"}


#: rule cases at reference paths; each must give the same findings under
#: both passes (the port at the mapped path)
PARITY_CORPUS = [
    ("repro/core/x.py", "def f(s: set[int]):\n    for x in s:\n        pass\n"
     "    return [y for y in s], min(s), sum(s), sorted(s, key=id)\n"),
    ("repro/core/x.py", "import random, heapq\nimport numpy as np\n"
     "def f(q, t):\n    heapq.heappush(q, (t, 'x'))\n"
     "    return random.random(), np.random.rand(3)\n"),
    ("repro/core/x.py", "import time\ndef f():\n    return time.time()\n"),
    ("repro/obs/probe.py", "import time\ndef f(sim):\n"
     "    sim.records.append(time.perf_counter())\n    sim.now = 0\n"),
    ("repro/core/catalog.py", "class ReplicaCatalog:\n"
     "    def _notify(self, *a): ...\n    def add(self, lfn, s):\n"
     "        self._holders[lfn].add(s)\n"),
    ("repro/core/replica.py", "class StorageState:\n"
     "    def add(self, s, lfn):\n        self._contents[s][lfn] = 1\n"),
    ("repro/core/simulator.py", "def f(st, cat):\n"
     "    return st._lru, cat._holders\n"),
    ("repro/core/x.py", "class M:\n    def sync(self):\n"
     "        self._t = {}\n    def get(self, k):\n"
     "        return self._t[k]\n"),
    ("repro/core/network.py", "def f(size, now, n_bytes, link_mbps,"
     " elapsed_us):\n    a = size + now\n    b = size > now\n"
     "    c = n_bytes / link_mbps\n    d = now - elapsed_us\n"
     "    return a, b, c, d, n_bytes / 1e9\n"),
]


@pytest.mark.parametrize("path,src", PARITY_CORPUS)
def test_parity_with_reference_on_rule_corpus(path, src):
    port = _all_passes(lint_source, lint_coherence, lint_units, src,
                       _port_path(path))
    assert port == _all_passes(ref_lint, ref_coherence, ref_units, src, path)
    assert port != []


def test_parity_with_reference_on_port_tree():
    """The other way round: the reference passes over the port's tree at
    its path mapped to ``repro/`` give what the port passes give at the
    real paths (nothing)."""
    for path in collect_files():
        rel = path.relative_to(REPO).as_posix()
        src = path.read_text()
        assert _all_passes(lint_source, lint_coherence, lint_units, src,
                           rel) == \
            _all_passes(ref_lint, ref_coherence, ref_units, src,
                        rel.replace("repro_torch/", "repro/", 1)) == [], rel
