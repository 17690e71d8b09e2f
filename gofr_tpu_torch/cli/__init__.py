"""CLI transport (counterpart of ``gofr_tpu/cli``)."""

from gofr_tpu_torch.cli.command import CLICommand, CLIRequest, CLIResponder
from gofr_tpu_torch.cli.runner import print_help, run_cli

__all__ = ["CLICommand", "CLIRequest", "CLIResponder", "print_help",
           "run_cli"]
