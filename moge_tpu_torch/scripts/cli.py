"""Command-line interface of the port: ``python -m moge_tpu_torch.scripts.cli
{infer,serve} ...``. Only the ported commands are offered."""

from __future__ import annotations


def command():
    """The ``cli`` click group (click is imported here, not with the module)."""
    import click

    from .infer import command as infer_command
    from .serve import command as serve_command

    @click.group(help="moge_tpu_torch command line tools (PyTorch/CUDA port)")
    def cli():
        pass

    cli.add_command(infer_command(), name="infer")
    cli.add_command(serve_command(), name="serve")
    return cli


def main():
    command()()


if __name__ == "__main__":
    main()
