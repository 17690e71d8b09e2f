"""CLI transport: the command registry, request parsing and the stdout
responder (counterpart of ``gofr_tpu/cli/command.py``).

A command is a regex over the positional words; ``-key=value`` and
``--key=value`` are params, a bare ``--flag`` is ``"true"``.
"""

from __future__ import annotations

import json
import re
import sys
from typing import Any, Dict, List, Optional


class CLICommand:
    def __init__(self, pattern: str, handler, description: str = "",
                 help_text: str = ""):
        self.pattern = pattern
        self.regex = re.compile("^" + pattern + "$")
        self.handler = handler
        self.description = description
        self.help_text = help_text


class CLIRequest:
    """The request contract over argv: ``-key=value`` / ``--key=value`` →
    params; a bare ``--flag`` → ``"true"``; positional words are the
    subcommand."""

    def __init__(self, argv: List[str]):
        self.argv = list(argv)
        self._params: Dict[str, str] = {}
        self.words: List[str] = []
        for token in argv:
            if token.startswith("-"):
                stripped = token.lstrip("-")
                key, eq, value = stripped.partition("=")
                if not key:
                    continue
                self._params[key] = value if eq else "true"
            else:
                self.words.append(token)
        self.subcommand = " ".join(self.words)

    def param(self, key: str) -> str:
        return self._params.get(key, "")

    def params(self, key: str) -> List[str]:
        value = self._params.get(key)
        return value.split(",") if value else []

    def path_param(self, key: str) -> str:
        return self.param(key)

    def bind(self, target: Any = None) -> Any:
        return dict(self._params) if target is None else target(
            **self._params)

    def header(self, key: str) -> str:
        return ""

    @property
    def method(self) -> str:
        return "CLI"

    @property
    def path(self) -> str:
        return self.subcommand


class CLIResponder:
    """A result to stdout, an error to stderr; returns the exit code."""

    def __init__(self, stdout=None, stderr=None):
        self.stdout = stdout or sys.stdout
        self.stderr = stderr or sys.stderr

    def respond(self, result: Any, error: Optional[Exception]) -> int:
        if error is not None:
            print(str(error) or repr(error), file=self.stderr)
            return 1
        if result is not None:
            if isinstance(result, (dict, list)):
                print(json.dumps(result, indent=2, default=str),
                      file=self.stdout)
            else:
                print(result, file=self.stdout)
        return 0
