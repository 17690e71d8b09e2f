"""graftcheck rule engine: repo-aware AST analysis with pragmas + baseline.

The serving stack's latency story rests on invariants nothing at runtime
can enforce cheaply — the asyncio loop must never block on a device sync,
fire-and-forget tasks must not swallow exceptions, a CUDA-graph body must
not carry host work that runs only at capture, a graph's static output
must not be read after the next replay overwrote it. graftcheck
machine-checks them ahead of deploy; the compile ledger can only *count*
recapture storms after one already stalled traffic.

This is the port's own copy of the JAX package's analyzer: the same
engine, the same pragma syntax and fingerprints, over the
``gofr_tpu_torch`` tree, with its own baseline
(``scripts/graftcheck_torch_baseline.json``) and its own cache
(``.graftcheck_torch_cache.json``). It imports neither ``torch`` nor
anything of the JAX package.

Architecture:

- :class:`ModuleInfo` — one parsed source file: AST, source lines,
  ``# graftcheck: ignore[RULE]`` pragma sites, import-alias table, and a
  child→parent node map (``ast`` does not keep parents).
- :class:`Rule` — per-rule ``check_module`` (file-local findings),
  ``finalize`` (cross-file joins, e.g. GT005's registered-vs-observed
  metric join), and ``check_project`` (whole-program findings over the
  :class:`~gofr_tpu_torch.analysis.project.ProjectGraph` — interprocedural
  reachability, value flow, lock discipline).
- :func:`run` — hash every file, hit the incremental cache when nothing
  changed (a warm rerun is a JSON load, no parsing), else parse,
  build the project graph once, apply rules, subtract pragma
  suppressions, then subtract the committed baseline (grandfathered
  findings are *pinned by count per fingerprint*: fixing one and adding
  another at the same site still fails).
- :func:`audit_pragmas` — re-run with suppression disabled and report
  every pragma whose rule no longer fires on its line (stale
  suppressions rot into false documentation).

Fingerprints deliberately exclude line numbers so unrelated edits above a
grandfathered finding don't resurrect it; they include the enclosing
function so two distinct sites never share one baseline slot by accident.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

ROOT = pathlib.Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "gofr_tpu_torch"
DEFAULT_BASELINE = ROOT / "scripts" / "graftcheck_torch_baseline.json"
DEFAULT_CACHE = ROOT / ".graftcheck_torch_cache.json"

_PRAGMA_RE = re.compile(
    r"#\s*graftcheck:\s*ignore\[([A-Za-z0-9_*,\s]+)\]")
_PRAGMA_FILE_RE = re.compile(
    r"#\s*graftcheck:\s*ignore-file\[([A-Za-z0-9_*,\s]+)\]")


def _comment_lines(source: str) -> Set[int]:
    """1-based line numbers holding a real ``#`` comment token.
    Falls back to every line on tokenize errors (never *lose* a
    pragma to an exotic encoding — the AST parse will complain about
    genuinely broken files anyway)."""
    import io
    import tokenize
    lines: Set[int] = set()
    try:
        for tok in tokenize.generate_tokens(
                io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                lines.add(tok.start[0])
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return {i + 1 for i in range(source.count("\n") + 1)}
    return lines


@dataclass
class Finding:
    """One rule violation at a source location."""

    rule: str            # "GT001"
    path: str            # repo-relative posix path
    line: int            # 1-based
    message: str         # human-readable, printed as path:line: RULE msg
    severity: str = "error"
    key: str = ""        # stable fingerprint token (defaults to message)

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.key or self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class PragmaSite:
    """One ``# graftcheck: ignore[...]`` occurrence: where it sits,
    which rules it names, and which source lines it covers."""

    line: int                    # the pragma comment's own line
    tags: Set[str]               # rule ids, possibly "*"
    covered: Set[int]            # statement lines this site suppresses
    file_scope: bool = False     # ignore-file[...] form


def relpath_of(path: pathlib.Path) -> str:
    try:
        return path.resolve().relative_to(ROOT).as_posix()
    except ValueError:
        return path.as_posix()


class ModuleInfo:
    """A parsed module plus the derived tables every rule needs."""

    def __init__(self, path: pathlib.Path, source: str):
        self.path = path
        self.relpath = relpath_of(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.pragma_sites: List[PragmaSite] = []
        self.ignores: Dict[int, Set[str]] = {}
        self.file_ignores: Set[str] = set()
        # pragmas live in real comments only — a docstring that *documents*
        # the syntax (every rule module does) is not a suppression site.
        # Most files carry no pragma at all: a cheap substring probe
        # skips the tokenizer pass entirely for them.
        comment_lines = (_comment_lines(source)
                         if "graftcheck:" in source else set())
        for lineno in sorted(comment_lines):
            text = self.lines[lineno - 1]
            match = _PRAGMA_RE.search(text)
            if match:
                tags = {token.strip()
                        for token in match.group(1).split(",")}
                covered = {lineno}
                # a pragma on a comment-only line covers the statement it
                # precedes: skip past the rest of the comment block
                if text.lstrip().startswith("#"):
                    nxt = lineno
                    while nxt < len(self.lines) and (
                            not self.lines[nxt].strip()
                            or self.lines[nxt].lstrip().startswith("#")):
                        nxt += 1
                    if nxt < len(self.lines):
                        covered.add(nxt + 1)
                self.pragma_sites.append(
                    PragmaSite(line=lineno, tags=tags, covered=covered))
                for cov in covered:
                    self.ignores.setdefault(cov, set()).update(tags)
            match = _PRAGMA_FILE_RE.search(text)
            if match:
                tags = {token.strip()
                        for token in match.group(1).split(",")}
                self.pragma_sites.append(
                    PragmaSite(line=lineno, tags=tags, covered=set(),
                               file_scope=True))
                self.file_ignores.update(tags)
        # import alias tables: "np" -> "numpy", "sleep" -> "time.sleep"
        self.import_aliases: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.import_aliases[alias.asname or
                                        alias.name.split(".")[0]] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.import_aliases[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"

    def suppressed(self, finding: Finding) -> bool:
        if finding.rule in self.file_ignores or "*" in self.file_ignores:
            return True
        # check the finding's own line plus the line above: findings inside
        # a multi-line statement report their continuation line, one past
        # the statement start the pragma covers
        for lineno in (finding.line, finding.line - 1):
            tags = self.ignores.get(lineno, ())
            if finding.rule in tags or "*" in tags:
                return True
        return False

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve ``np.asarray`` → ``numpy.asarray`` through the module's
        import aliases; plain names resolve through from-imports. Returns
        None for expressions rooted at something other than a Name."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.import_aliases.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cursor = self.parents.get(node)
        while cursor is not None:
            if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cursor
            cursor = self.parents.get(cursor)
        return None


class Rule:
    """Base rule. Subclasses set ``rule_id``/``title`` and override
    ``check_module`` (file-local), ``finalize`` (cross-file joins),
    and/or ``check_project`` (whole-program, given a ProjectGraph)."""

    rule_id = "GT000"
    title = ""
    severity = "error"
    # cross-file joins (finalize over the full module set) give false
    # positives on partial sets, so --changed-only skips them entirely
    cross_file = False

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        return ()

    def finalize(self, modules: Sequence[ModuleInfo]) -> Iterable[Finding]:
        return ()

    def check_project(self, project) -> Iterable[Finding]:
        return ()

    def config_fingerprint(self) -> str:
        """Cache-key contribution: rules whose output depends on config
        beyond their own source (GT005's docs catalog) override this."""
        return self.rule_id


@dataclass
class Report:
    """Outcome of one analysis run."""

    new_findings: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    # every live finding BEFORE pragma/baseline filtering — complete only
    # on a cold full run (cache-reused files contribute nothing here);
    # feeds audit_pragmas(raw_findings=...) so a pragma audit can ride a
    # scan the caller already paid for
    raw_findings: List[Finding] = field(default_factory=list)
    stale_baseline: List[str] = field(default_factory=list)
    parse_errors: List[str] = field(default_factory=list)
    files_scanned: int = 0
    from_cache: bool = False
    cached_files: int = 0
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def exit_code(self) -> int:
        return 1 if (self.new_findings or self.parse_errors) else 0


def load_baseline(path: pathlib.Path) -> Dict[str, int]:
    try:
        payload = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return {}
    counts = payload.get("counts", {})
    return {str(k): int(v) for k, v in counts.items()}


def write_baseline(path: pathlib.Path, findings: Sequence[Finding]) -> None:
    counts: Dict[str, int] = {}
    for finding in findings:
        counts[finding.fingerprint] = counts.get(finding.fingerprint, 0) + 1
    payload = {
        "_comment": (
            "graftcheck grandfathered findings, pinned by count per "
            "fingerprint. Regenerate with: "
            "python -m gofr_tpu_torch.analysis --write-baseline. Shrink it when "
            "you fix one; never grow it for new code."),
        "version": 1,
        "counts": {k: counts[k] for k in sorted(counts)},
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def iter_python_files(paths: Sequence[pathlib.Path]) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for path in paths:
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return out


def _apply_baseline(report: Report, kept: List[Finding],
                    baseline: Optional[Dict[str, int]]) -> None:
    budget = dict(baseline or {})
    for finding in sorted(kept, key=lambda f: (f.path, f.line, f.rule)):
        if budget.get(finding.fingerprint, 0) > 0:
            budget[finding.fingerprint] -= 1
            report.baselined.append(finding)
        else:
            report.new_findings.append(finding)
    report.stale_baseline = sorted(
        fp for fp, remaining in budget.items() if remaining > 0)


def _run_rules(rules: Sequence[Rule], modules: List[ModuleInfo],
               interprocedural: bool, timings: Dict[str, float],
               skip_cross_file: bool = False) -> List[Finding]:
    from gofr_tpu_torch.analysis.project import ProjectGraph

    raw: List[Finding] = []
    t0 = time.perf_counter()
    project = ProjectGraph(modules, cross_module=interprocedural)
    timings["project-graph"] = \
        timings.get("project-graph", 0.0) + time.perf_counter() - t0
    for rule in rules:
        if skip_cross_file and rule.cross_file:
            continue
        t0 = time.perf_counter()
        for module in modules:
            raw.extend(rule.check_module(module))
        if not skip_cross_file:
            raw.extend(rule.finalize(modules))
        raw.extend(rule.check_project(project))
        timings[rule.rule_id] = \
            timings.get(rule.rule_id, 0.0) + time.perf_counter() - t0
    return raw


def run(paths: Optional[Sequence[pathlib.Path]] = None,
        rules: Optional[Sequence[Rule]] = None,
        baseline: Optional[Dict[str, int]] = None,
        *,
        interprocedural: bool = True,
        cache_path: Optional[pathlib.Path] = None,
        restrict: Optional[Set[str]] = None) -> Report:
    """Run ``rules`` over every ``*.py`` under ``paths``.

    ``baseline`` maps fingerprints to grandfathered counts; within one
    fingerprint the first N findings are baselined and the rest are new.
    ``interprocedural=False`` forces the v1 module-local call graph
    (regression tests pin what project mode buys). ``cache_path``
    enables the incremental cache; ``restrict`` (a set of repo-relative
    paths) is the ``--changed-only`` fast path — listed files are
    analyzed live, everything else reuses its SHA-matched cache entry.
    """
    from gofr_tpu_torch.analysis import cache as cache_mod

    if rules is None:
        from gofr_tpu_torch.analysis.rules import default_rules
        rules = default_rules()
    if paths is None:
        paths = [PACKAGE]
    report = Report()

    sources: Dict[pathlib.Path, str] = {}
    shas: Dict[str, str] = {}
    rel_to_path: Dict[str, pathlib.Path] = {}
    for path in iter_python_files(paths):
        try:
            text = path.read_text(encoding="utf-8")
        except OSError as exc:
            report.parse_errors.append(f"{path}: unparseable: {exc}")
            continue
        rel = relpath_of(path)
        sources[path] = text
        shas[rel] = cache_mod.sha_text(text)
        rel_to_path[rel] = path

    cache = (cache_mod.AnalysisCache(cache_path)
             if cache_path is not None else None)
    rkey = cache_mod.ruleset_key(rules)
    pkey = cache_mod.project_key(rkey, shas, interprocedural)

    # -- full warm hit: the entire report is a JSON load --------------------
    if cache is not None and restrict is None \
            and not report.parse_errors and cache.matches_project(pkey):
        entries = cache.all_entries()
        if all(rel in entries and entries[rel].get("sha") == shas[rel]
               for rel in shas):
            kept: List[Finding] = []
            for rel in sorted(shas):
                entry = entries[rel]
                kept.extend(cache_mod.decode_findings(
                    entry.get("findings", []), Finding))
                report.suppressed += int(entry.get("suppressed", 0))
            report.files_scanned = len(shas)
            report.cached_files = len(shas)
            report.from_cache = True
            _apply_baseline(report, kept, baseline)
            return report

    # -- choose live vs cache-reused files ----------------------------------
    live_rels = set(shas)
    reused: Dict[str, dict] = {}
    if restrict is not None and cache is not None \
            and cache.matches_ruleset(rkey):
        for rel in shas:
            if rel in restrict:
                continue
            entry = cache.file_entry(rel, shas[rel])
            if entry is not None:
                reused[rel] = entry
                live_rels.discard(rel)

    modules: List[ModuleInfo] = []
    for rel in sorted(live_rels):
        path = rel_to_path[rel]
        try:
            modules.append(ModuleInfo(path, sources[path]))
        except SyntaxError as exc:
            report.parse_errors.append(f"{path}: unparseable: {exc}")
    report.files_scanned = len(modules) + len(reused)
    report.cached_files = len(reused)

    raw = _run_rules(rules, modules, interprocedural, report.timings,
                     skip_cross_file=restrict is not None)
    report.raw_findings = list(raw)

    module_by_rel = {m.relpath: m for m in modules}
    kept = []
    suppressed_by_rel: Dict[str, int] = {}
    for finding in raw:
        module = module_by_rel.get(finding.path)
        if module is not None and module.suppressed(finding):
            report.suppressed += 1
            suppressed_by_rel[finding.path] = \
                suppressed_by_rel.get(finding.path, 0) + 1
        else:
            kept.append(finding)

    for rel, entry in reused.items():
        kept.extend(cache_mod.decode_findings(
            entry.get("findings", []), Finding))
        report.suppressed += int(entry.get("suppressed", 0))

    _apply_baseline(report, kept, baseline)

    # -- persist: only exact full runs write the cache ----------------------
    if cache is not None and restrict is None and not report.parse_errors:
        by_path = cache_mod.group_by_path(
            [f for f in kept if f.path in module_by_rel])
        files = {}
        for rel in shas:
            if rel not in module_by_rel:
                continue
            files[rel] = cache_mod.build_file_entry(
                shas[rel], by_path.get(rel, []),
                suppressed_by_rel.get(rel, 0))
        if len(files) == len(shas):
            cache.save(rkey, pkey, files)
    return report


@dataclass
class StalePragma:
    """A suppression whose rule no longer fires on its line."""

    path: str
    line: int
    tags: Set[str]
    file_scope: bool = False

    def render(self) -> str:
        scope = "ignore-file" if self.file_scope else "ignore"
        tags = ",".join(sorted(self.tags))
        return (f"{self.path}:{self.line}: stale pragma "
                f"{scope}[{tags}] — no {tags} finding is suppressed "
                f"here anymore; delete it")


def audit_pragmas(paths: Optional[Sequence[pathlib.Path]] = None,
                  rules: Optional[Sequence[Rule]] = None,
                  interprocedural: bool = True,
                  raw_findings: Optional[Sequence[Finding]] = None,
                  ) -> List[StalePragma]:
    """Find ``# graftcheck: ignore[...]`` pragmas that suppress nothing:
    run every rule with suppression disabled, then check each pragma
    site against the raw findings it claims to cover. A stale pragma is
    worse than none — it documents a hazard that is not there and hides
    the next real one someone writes on that line.

    ``raw_findings`` skips the rule pass entirely: pass
    ``Report.raw_findings`` from a COLD full run over the same paths
    (a warm-cache report carries none and every pragma would look
    stale). Only pragma-bearing files are parsed in that mode."""
    if rules is None:
        from gofr_tpu_torch.analysis.rules import default_rules
        rules = default_rules()
    if paths is None:
        paths = [PACKAGE]
    modules: List[ModuleInfo] = []
    for path in iter_python_files(paths):
        try:
            source = path.read_text(encoding="utf-8")
            if raw_findings is not None and "graftcheck:" not in source:
                continue
            modules.append(ModuleInfo(path, source))
        except (OSError, SyntaxError):
            continue
    raw = (list(raw_findings) if raw_findings is not None
           else _run_rules(rules, modules, interprocedural, {}))
    by_rel: Dict[str, List[Finding]] = {}
    for finding in raw:
        by_rel.setdefault(finding.path, []).append(finding)

    stale: List[StalePragma] = []
    for module in modules:
        findings = by_rel.get(module.relpath, [])
        for site in module.pragma_sites:
            if site.file_scope:
                fired = any(f.rule in site.tags or "*" in site.tags
                            for f in findings)
            else:
                lines = set(site.covered) | {c + 1 for c in site.covered}
                fired = any(
                    (f.rule in site.tags or "*" in site.tags)
                    and f.line in lines
                    for f in findings)
            if not fired:
                stale.append(StalePragma(
                    path=module.relpath, line=site.line,
                    tags=site.tags, file_scope=site.file_scope))
    return stale
