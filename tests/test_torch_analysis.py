"""The port's graftcheck (``gofr_tpu_torch.analysis``) against the JAX
package's (``gofr_tpu.analysis``).

- Parity: every rule that carries over (and the adapted ones, whose JAX
  checks stay) gives JAX's ``(rule, line, key)`` set and suppression
  count on JAX's own fixture corpus, read in place.
- The torch-aware checks and the three CUDA-graph rules (GT003
  recapture, GT004 capture side effects, GT015 static-output reuse) on
  ``tests/analysis_fixtures_torch/``: each positive flags exactly its
  keys, each negative scans clean. JAX's GT003/GT004 fixtures
  (``jax.jit``) and its GT015 package (``donate_argnums``) have no torch
  hazard; their counterparts are ``gt003_*``, ``gt004_*`` and
  ``gt015_*`` there, and ``graph_premises.py``, which the card runs.
- The engine around the rules: SARIF key trees equal to JAX's, the rule
  catalog, the cache and ``--changed-only``, the CLI's exit codes.
- The whole port tree scans clean with the empty baseline and every
  pragma live (one scan, shared by nothing else).
"""

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from gofr_tpu.analysis import engine as jax_engine
from gofr_tpu.analysis.rules import ALL_RULES as JAX_RULES
from gofr_tpu.analysis.rules import default_rules as jax_rules
from gofr_tpu.analysis.sarif import report_to_sarif as jax_sarif
from gofr_tpu_torch.analysis import __main__ as cli
from gofr_tpu_torch.analysis import engine
from gofr_tpu_torch.analysis.project import ProjectGraph
from gofr_tpu_torch.analysis.rules import ALL_RULES, default_rules
from gofr_tpu_torch.analysis.rules.gt016_pool_lock import PoolLockRule
from gofr_tpu_torch.analysis.sarif import report_to_sarif

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_FIXTURES = REPO / "tests" / "analysis_fixtures"
FIXTURES = REPO / "tests" / "analysis_fixtures_torch"
FIXTURE_DOCS = JAX_FIXTURES / "gt005_docs.md"

# rules whose JAX fixtures hold a hazard the port's rule also checks
PARITY_RULES = ("001", "002", "005", "006", "007", "008", "009", "010",
                "011", "012", "013", "014")


def _options(number):
    if number in ("005", "013"):
        return {"docs_catalog": FIXTURE_DOCS}
    if number in ("011", "012"):
        return {"scope_all": True}
    return {}


PARITY_CASES = [
    (f"gt{n}_{kind}.py", f"GT{n}", _options(n), True)
    for n in PARITY_RULES for kind in ("pos", "neg", "pragma")
    if (JAX_FIXTURES / f"gt{n}_{kind}.py").exists()
] + [(f"project/{name}", rule, {}, True) for name, rule in (
    ("gt001_xmod", "GT001"), ("cycle", "GT001"), ("duck", "GT001"),
    ("gt016_pkg", "GT016"), ("gt017_pkg", "GT017"))] + [
    ("project/gt001_xmod", "GT001", {}, False),   # --local misses it
    ("gt011_pos.py", "GT011", {}, True),          # scoped out by path
    ("gt012_pos.py", "GT012", {}, True),
]


def _facts(report):
    return {(f.rule, f.line, f.key) for f in report.new_findings}


@pytest.mark.parametrize("target,rule,options,interprocedural",
                         PARITY_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'ip' if c[3] else 'local'}"
                              for c in PARITY_CASES])
def test_carried_rules_match_jax_on_its_fixtures(target, rule, options,
                                                 interprocedural):
    path = JAX_FIXTURES / target
    ours = engine.run(paths=[path], rules=default_rules(select=[rule],
                                                         **options),
                      baseline={}, interprocedural=interprocedural)
    theirs = jax_engine.run(paths=[path],
                            rules=jax_rules(select=[rule], **options),
                            baseline={}, interprocedural=interprocedural)
    assert _facts(ours) == _facts(theirs)
    assert ours.suppressed == theirs.suppressed
    assert ours.exit_code == theirs.exit_code


# (fixture, rule, expected keys) of the torch-aware and CUDA-graph checks
TORCH_CASES = [
    ("gt001_pos.py", "GT001", {
        ".item() in scalar", ".cpu() in to_host", ".tolist() in listed",
        ".numpy() in _as_numpy", "torch.cuda.synchronize(...) in drain",
        ".synchronize() in wait_event"}),
    ("gt001_neg.py", "GT001", set()),
    ("gt003_pos.py", "GT003", {
        "fresh-capture in per_call", "fresh-capture in fresh_graph",
        "raw-key self._graphs in tick",
        "unhashable-key self._graphs in tick_listed",
        "raw-shape in static_buffers", "page-width in body"}),
    ("gt003_neg.py", "GT003", set()),
    ("gt004_pos.py", "GT004", {
        "logger.info(...) in _tick_body",
        ".increment_counter(...) in _tick_body", "print(...) in body",
        ".item() in body", "numpy.random.rand(...) in body",
        "random.random(...) in body", "if total in body",
        "torch.cuda.synchronize(...) in graph block in graph_block"}),
    ("gt004_neg.py", "GT004", set()),
    ("gt005_pos.py", "GT005", {
        "charset bad-charset-name", "prefix bad-charset-name",
        "unregistered app_fixture_never_registered_total",
        "undocumented app_fixture_undocumented_total"}),
    ("gt005_neg.py", "GT005", set()),
    ("gt006_pos.py", "GT006", {
        ".cpu() on pool leaves in export_handler",
        ".numpy() on pool leaves in _stage",
        ".tolist() on pool leaves in listed"}),
    ("gt006_neg.py", "GT006", set()),
    ("tpu/cluster.py", "GT006", {
        "torch.cuda.synchronize(...) on the KV path in adopt",
        ".synchronize() on the KV path in adopt",
        ".tolist() on the KV path in adopt"}),
    ("gt007_pos.py", "GT007", {
        "torch.tensor(...) in Executorish._dispatch",
        "torch.zeros(...) on the host in Executorish.dispatch_rows",
        ".pin_memory() in Executorish._prep",
        "torch.empty(...) on the host in Engineish._dispatch_tick"}),
    ("gt007_neg.py", "GT007", set()),
    ("gt015_pos.py", "GT015", {
        "static-output first in held", "static-output first in held_view",
        "loop-held entry.out in collected",
        "input-race entry.inp in raced"}),
    ("gt015_neg.py", "GT015", set()),
]


@pytest.mark.parametrize("fixture,rule,expected", TORCH_CASES,
                         ids=[c[0] for c in TORCH_CASES])
def test_torch_fixture_flags_exactly_its_keys(fixture, rule, expected):
    options = {"docs_catalog": FIXTURE_DOCS} if rule == "GT005" else {}
    report = engine.run(paths=[FIXTURES / fixture],
                        rules=default_rules(select=[rule], **options),
                        baseline={})
    assert {f.key for f in report.new_findings} == expected
    assert all(f.rule == rule for f in report.new_findings)
    assert report.exit_code == (1 if expected else 0)


def test_graph_premises_verdict_is_the_smokes():
    """``chip_smoke.py`` phase 43b holds this verdict against the card:
    the analyzer flags exactly the positives of ``graph_premises.py``."""
    import importlib.util
    path = FIXTURES / "graph_premises.py"
    report = engine.run(paths=[path], baseline={}, rules=default_rules(
        select=["GT003", "GT004", "GT015"]))
    spec = importlib.util.spec_from_file_location("graph_premises", path)
    premises = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(premises)
    assert {(f.rule, f.key) for f in report.new_findings} == \
        premises.EXPECTED


def test_graph_rules_say_cuda_graph_and_keep_jax_ids():
    titles = {cls.rule_id: cls.title for cls in ALL_RULES}
    assert set(titles) == {cls.rule_id for cls in JAX_RULES}
    for rule_id in ("GT003", "GT004", "GT015"):
        assert "CUDA graph" in titles[rule_id]


def test_pool_lock_rule_sees_the_ports_page_pool():
    """GT016 is not vacuous on the port: its ``PagePool`` (whose device
    thread is ``PagePool.executor``) is a lock-disciplined pool."""
    path = REPO / "gofr_tpu_torch" / "tpu" / "page_pool.py"
    project = ProjectGraph([engine.ModuleInfo(path, path.read_text())])
    pools = PoolLockRule()._find_pools(project)
    assert {(ref[1], lock) for ref, lock in pools.items()} == \
        {("PagePool", "lock")}


# -- the engine around the rules ------------------------------------------

def _key_tree(value):
    """A JSON value's shape: dict keys (recursively), list element
    shapes, and the type of every leaf."""
    if isinstance(value, dict):
        return {key: _key_tree(item) for key, item in value.items()}
    if isinstance(value, list):
        shapes = []
        for item in value:
            shape = _key_tree(item)
            if shape not in shapes:
                shapes.append(shape)
        return shapes
    return type(value).__name__


def test_sarif_key_tree_equals_jaxs():
    path = JAX_FIXTURES / "gt002_pos.py"
    ours = report_to_sarif(
        engine.run(paths=[path], rules=default_rules(select=["GT002"]),
                   baseline={}), default_rules(select=["GT002"]))
    theirs = jax_sarif(
        jax_engine.run(paths=[path], rules=jax_rules(select=["GT002"]),
                       baseline={}), jax_rules(select=["GT002"]))
    assert _key_tree(ours) == _key_tree(theirs)
    assert ours["runs"][0]["results"]
    assert ours["runs"][0]["tool"]["driver"]["name"] == "graftcheck-torch"
    assert theirs["runs"][0]["tool"]["driver"]["name"] == "graftcheck"


def _write_module(tmp_path, body, name="seeded.py"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body), encoding="utf-8")
    return path


def test_cli_list_rules_and_seeded_violation(tmp_path):
    """``--list-rules`` prints the catalog (JAX's ids); a seeded torch
    sync on the loop exits 1 with its rule and file:line, and a SARIF
    artifact carrying it."""
    proc = subprocess.run(
        [sys.executable, "-m", "gofr_tpu_torch.analysis", "--list-rules"],
        cwd=REPO, capture_output=True, text=True, check=False)
    assert proc.returncode == 0
    listed = [line.split()[0] for line in proc.stdout.splitlines()]
    assert listed == [cls.rule_id for cls in ALL_RULES]
    seeded = _write_module(tmp_path, """\
        async def handler(logits):
            return logits.argmax().item()
    """)
    out = tmp_path / "out.sarif"
    proc = subprocess.run(
        [sys.executable, "-m", "gofr_tpu_torch.analysis", str(tmp_path),
         "--no-baseline", "--no-cache", "--sarif", str(out)],
        cwd=REPO, capture_output=True, text=True, check=False)
    assert proc.returncode == 1
    assert "GT001" in proc.stderr
    assert f"{seeded}:2:" in proc.stderr
    results = json.loads(out.read_text(encoding="utf-8"))["runs"][0][
        "results"]
    assert [r["ruleId"] for r in results] == ["GT001"]


def test_cache_reuse_and_changed_only(tmp_path, monkeypatch, capsys):
    """A warm run is a JSON load with the cold run's report; an edit
    invalidates it; ``--changed-only`` re-analyzes the changed file and
    reuses the cached findings of the rest."""
    root = tmp_path / "pkg"
    root.mkdir()
    blocking = _write_module(root, """\
        async def handler(logits):
            return logits.cpu()
    """, "blocking.py")
    clean = _write_module(root, "def helper(x):\n    return x\n", "clean.py")
    cache = tmp_path / "cache.json"
    rules = default_rules(select=["GT001", "GT002"])
    cold = engine.run(paths=[root], rules=rules, baseline={},
                      cache_path=cache)
    warm = engine.run(paths=[root], rules=rules, baseline={},
                      cache_path=cache)
    assert not cold.from_cache and warm.from_cache
    assert [f.render() for f in warm.new_findings] == \
        [f.render() for f in cold.new_findings] != []
    clean.write_text("import asyncio\n\n\nasync def spawn(coro):\n"
                     "    asyncio.ensure_future(coro)\n", encoding="utf-8")
    edited = engine.run(paths=[root], rules=rules, baseline={},
                        cache_path=cache)
    assert not edited.from_cache
    assert {f.rule for f in edited.new_findings} == {"GT001", "GT002"}
    # the CLI's --changed-only: only clean.py is live, blocking.py's
    # GT001 comes from the cache written by the run above
    monkeypatch.setattr(cli, "_changed_files", lambda base: {
        engine.relpath_of(clean)})
    rc = cli.main([str(root), "--no-baseline", "--cache", str(cache),
                   "--select", "GT001,GT002", "--changed-only", "HEAD"])
    err = capsys.readouterr().err
    assert rc == 1
    assert f"{engine.relpath_of(blocking)}:2: GT001" in err
    assert f"{engine.relpath_of(clean)}:5: GT002" in err


def test_committed_baseline_is_empty():
    payload = json.loads(engine.DEFAULT_BASELINE.read_text("utf-8"))
    assert payload["counts"] == {}
    assert engine.DEFAULT_BASELINE.name == "graftcheck_torch_baseline.json"
    assert engine.DEFAULT_CACHE.name == ".graftcheck_torch_cache.json"
    assert engine.PACKAGE == REPO / "gofr_tpu_torch"


def test_port_tree_scans_clean(tmp_path):
    """The port's analyzer over ``gofr_tpu_torch/`` with the committed
    (empty) baseline: no finding, no parse error, every pragma live. One
    cold scan (a fresh cache file, so nothing is reused); the CLI then
    answers from that cache, exit 0."""
    cache = tmp_path / "cache.json"
    report = engine.run(paths=[engine.PACKAGE], rules=default_rules(),
                        baseline=engine.load_baseline(
                            engine.DEFAULT_BASELINE),
                        cache_path=cache)
    assert [f.render() for f in report.new_findings] == []
    assert report.parse_errors == [] and report.exit_code == 0
    assert not report.from_cache and report.suppressed > 0
    stale = engine.audit_pragmas(paths=[engine.PACKAGE],
                                 raw_findings=report.raw_findings)
    assert [p.render() for p in stale] == []
    proc = subprocess.run(
        [sys.executable, "-m", "gofr_tpu_torch.analysis", "--cache",
         str(cache)], cwd=REPO, capture_output=True, text=True, check=False)
    assert proc.returncode == 0, proc.stderr
    assert "graftcheck: OK" in proc.stdout
