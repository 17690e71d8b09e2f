"""Incremental analysis cache: per-file SHA-keyed findings.

A full graftcheck run parses every module and walks every rule; a rerun
usually meets a tree that has not changed. The cache makes the
warm rerun a JSON load:

- every scanned file is keyed by the SHA-256 of its source;
- the whole run is keyed by a *project key* — the rule-set fingerprint
  (rule ids plus each rule's config fingerprint, e.g. GT005's docs
  catalog digest) hashed together with every (path, sha) pair and the
  interprocedural mode;
- a cache hit on the project key reconstructs the entire report
  (post-pragma findings + suppression counts per file) with **zero**
  parsing;
- ``--changed-only`` relaxes the project key: files whose sha still
  matches reuse their cached findings even though *other* files
  changed. That is an approximation (a cross-module chain through a
  changed file can stale a cached finding's message) — the fast
  pre-commit path; the full run stays exact.

Findings are cached *after* pragma subtraction and *before* baseline
subtraction, so editing the baseline never invalidates the cache.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Dict, List, Optional, Sequence

VERSION = 2


def sha_text(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def project_key(ruleset_key: str,
                shas: Dict[str, str],
                interprocedural: bool) -> str:
    h = hashlib.sha256()
    h.update(ruleset_key.encode("utf-8"))
    h.update(b"|ip" if interprocedural else b"|local")
    for rel in sorted(shas):
        h.update(f"|{rel}={shas[rel]}".encode("utf-8"))
    return h.hexdigest()


def ruleset_key(rules: Sequence[object]) -> str:
    parts = [f"v{VERSION}"]
    for rule in rules:
        fingerprint = getattr(rule, "config_fingerprint", None)
        parts.append(fingerprint() if callable(fingerprint)
                     else getattr(rule, "rule_id", "?"))
    return hashlib.sha256("|".join(sorted(parts)).encode()).hexdigest()


class AnalysisCache:
    """Per-file finding store under one project key."""

    def __init__(self, path: pathlib.Path):
        self.path = pathlib.Path(path)
        self._data: Optional[dict] = None

    # -- load/save ----------------------------------------------------------
    def _load(self) -> dict:
        if self._data is None:
            try:
                payload = json.loads(self.path.read_text(encoding="utf-8"))
                if payload.get("version") != VERSION:
                    payload = {}
            except (OSError, ValueError):
                payload = {}
            self._data = payload
        return self._data

    def save(self, ruleset: str, project: str,
             files: Dict[str, dict]) -> None:
        payload = {
            "_comment": ("graftcheck incremental cache — per-file "
                         "SHA-keyed findings; safe to delete anytime."),
            "version": VERSION,
            "ruleset_key": ruleset,
            "project_key": project,
            "files": files,
        }
        try:
            self.path.write_text(
                json.dumps(payload, indent=1, sort_keys=True) + "\n",
                encoding="utf-8")
            self._data = payload
        except OSError:
            pass  # a read-only tree degrades to always-cold, never fails

    # -- queries ------------------------------------------------------------
    def matches_project(self, project: str) -> bool:
        return self._load().get("project_key") == project

    def matches_ruleset(self, ruleset: str) -> bool:
        return self._load().get("ruleset_key") == ruleset

    def file_entry(self, rel: str, sha: str) -> Optional[dict]:
        entry = self._load().get("files", {}).get(rel)
        if entry is not None and entry.get("sha") == sha:
            return entry
        return None

    def all_entries(self) -> Dict[str, dict]:
        return self._load().get("files", {})


def encode_findings(findings: Sequence[object]) -> List[dict]:
    return [{
        "rule": f.rule, "path": f.path, "line": f.line,
        "message": f.message, "severity": f.severity, "key": f.key,
    } for f in findings]


def decode_findings(rows: Sequence[dict], finding_cls) -> List[object]:
    return [finding_cls(
        rule=row["rule"], path=row["path"], line=int(row["line"]),
        message=row["message"], severity=row.get("severity", "error"),
        key=row.get("key", "")) for row in rows]


def build_file_entry(sha: str, findings: Sequence[object],
                     suppressed: int) -> dict:
    return {"sha": sha, "suppressed": int(suppressed),
            "findings": encode_findings(findings)}


def group_by_path(findings: Sequence[object]
                  ) -> Dict[str, List[object]]:
    out: Dict[str, List[object]] = {}
    for finding in findings:
        out.setdefault(finding.path, []).append(finding)
    return out
