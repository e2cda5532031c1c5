"""Command-line interface of the port: ``python -m moge_tpu_torch.scripts.cli
{infer,serve,infer_panorama,eval_baseline,infer_baseline} ...``. Only the
ported commands are offered."""

from __future__ import annotations


def command():
    """The ``cli`` click group (click is imported here, not with the module)."""
    import click

    from .eval_baseline import command as eval_baseline_command
    from .infer import command as infer_command
    from .infer_baseline import command as infer_baseline_command
    from .infer_panorama import command as infer_panorama_command
    from .serve import command as serve_command

    @click.group(help="moge_tpu_torch command line tools (PyTorch/CUDA port)")
    def cli():
        pass

    cli.add_command(infer_command(), name="infer")
    cli.add_command(serve_command(), name="serve")
    cli.add_command(infer_panorama_command(), name="infer_panorama")
    cli.add_command(eval_baseline_command(), name="eval_baseline")
    cli.add_command(infer_baseline_command(), name="infer_baseline")
    return cli


def main():
    command()()


if __name__ == "__main__":
    main()
