"""The CLI's dispatch loop and help printer (counterpart of
``gofr_tpu/cli/runner.py``)."""

from __future__ import annotations

import asyncio
import sys
from typing import List, Optional

from gofr_tpu_torch.cli.command import CLIRequest, CLIResponder
from gofr_tpu_torch.context import Context


def print_help(commands, stream=None) -> None:
    stream = stream or sys.stdout
    print("Available commands:", file=stream)
    for command in commands:
        line = f"  {command.pattern}"
        if command.description:
            line += f" — {command.description}"
        print(line, file=stream)
        if command.help_text:
            print(f"      {command.help_text}", file=stream)


def run_cli(app, argv: Optional[List[str]] = None,
            stdout=None, stderr=None) -> int:
    """Match ``argv`` against the app's sub-commands and run the first
    that matches; returns the exit code (0 ok, 1 the handler raised, 2 no
    command matched)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    responder = CLIResponder(stdout, stderr)
    request = CLIRequest(argv)

    if not argv or request.param("h") == "true" \
            or request.param("help") == "true":
        print_help(app._cli_commands, responder.stdout)
        return 0

    for command in app._cli_commands:
        if command.regex.match(request.subcommand):
            ctx = Context(request, app.container, responder)
            with app.container.tracer.start_span(
                    f"cli {request.subcommand}"):
                try:
                    result = command.handler(ctx)
                    if asyncio.iscoroutine(result):
                        result = asyncio.run(result)
                    return responder.respond(result, None)
                except Exception as exc:
                    app.logger.error("command %s failed: %r",
                                     request.subcommand, exc)
                    return responder.respond(None, exc)

    print(f"unknown command: {request.subcommand!r}", file=responder.stderr)
    print_help(app._cli_commands, responder.stderr)
    return 2
