"""Env-file configuration with APP_ENV overlays (a copy of
``gofr_tpu/config/config.py``): a dependency-free ``.env`` parser, the
process environment winning over file values, and one immutable snapshot
per ``EnvConfig``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional


class Config:
    """Read-only config access: ``get`` and ``get_or_default``.

    (reference: config/config.go:3-6)
    """

    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def get_or_default(self, key: str, default: str) -> str:
        val = self.get(key)
        return val if val not in (None, "") else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self.get(key)
        if val is None or val == "":
            return default
        return val.strip().lower() in ("1", "true", "yes", "on")

    def get_int(self, key: str, default: int) -> int:
        val = self.get(key)
        if val is None or val == "":
            return default
        try:
            return int(val)
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        val = self.get(key)
        if val is None or val == "":
            return default
        try:
            return float(val)
        except ValueError:
            return default


def load_env_file(path: str) -> Dict[str, str]:
    """Parse a ``.env`` file into a dict.

    Supports ``KEY=VALUE`` lines, ``#`` comments, ``export`` prefixes, and
    single/double-quoted values. Malformed lines are skipped silently (the
    reference delegates to godotenv which is similarly lenient).
    """
    out: Dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("export "):
                    line = line[len("export "):].lstrip()
                if "=" not in line:
                    continue
                key, _, value = line.partition("=")
                key = key.strip()
                value = value.strip()
                if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
                    value = value[1:-1]
                else:
                    # strip trailing inline comment on unquoted values
                    hash_pos = value.find(" #")
                    if hash_pos >= 0:
                        value = value[:hash_pos].rstrip()
                if key:
                    out[key] = value
    except OSError:
        pass
    return out


class EnvConfig(Config):
    """Layered env config: ``configs/.env`` base + overlay + process env.

    Layering rules (reference: config/godotenv.go:32-69):
      1. ``<dir>/.env`` is the base layer.
      2. If ``APP_ENV`` is set (in process env or base layer), overlay
         ``<dir>/.<APP_ENV>.env``; otherwise overlay ``<dir>/.local.env`` if
         it exists.
      3. The live process environment always wins.
    """

    def __init__(self, config_dir: str = "./configs", environ: Optional[Dict[str, str]] = None):
        self._environ = environ if environ is not None else os.environ  # type: ignore[assignment]
        base = load_env_file(os.path.join(config_dir, ".env"))
        app_env = self._environ.get("APP_ENV") or base.get("APP_ENV") or ""
        overlay: Dict[str, str] = {}
        if app_env:
            overlay = load_env_file(os.path.join(config_dir, f".{app_env}.env"))
        else:
            overlay = load_env_file(os.path.join(config_dir, ".local.env"))
        self._values: Dict[str, str] = {**base, **overlay}

    def get(self, key: str) -> Optional[str]:
        if key in self._environ:
            return self._environ[key]
        return self._values.get(key)

    def __iter__(self) -> Iterator[str]:
        seen = set(self._values) | set(self._environ.keys())
        return iter(seen)


class MapConfig(Config):
    """In-memory config for tests (the reference generates a mock config;
    a plain dict-backed one is the Pythonic seam)."""

    def __init__(self, values: Optional[Dict[str, str]] = None):
        self.values = dict(values or {})

    def get(self, key: str) -> Optional[str]:
        return self.values.get(key)
