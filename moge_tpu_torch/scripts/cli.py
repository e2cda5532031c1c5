"""Command-line interface of the port: ``python -m moge_tpu_torch.scripts.cli
{infer,serve,infer_panorama,eval_baseline,infer_baseline,train,vis_data,export_program}
...``. Only the ported commands are offered."""

from __future__ import annotations


def command():
    """The ``cli`` click group (click is imported here, not with the module)."""
    import click

    from .eval_baseline import command as eval_baseline_command
    from .export_program import command as export_program_command
    from .infer import command as infer_command
    from .infer_baseline import command as infer_baseline_command
    from .infer_panorama import command as infer_panorama_command
    from .serve import command as serve_command
    from .train import command as train_command
    from .vis_data import command as vis_data_command

    @click.group(help="moge_tpu_torch command line tools (PyTorch/CUDA port)")
    def cli():
        pass

    cli.add_command(infer_command(), name="infer")
    cli.add_command(serve_command(), name="serve")
    cli.add_command(infer_panorama_command(), name="infer_panorama")
    cli.add_command(eval_baseline_command(), name="eval_baseline")
    cli.add_command(infer_baseline_command(), name="infer_baseline")
    cli.add_command(train_command(), name="train")
    cli.add_command(vis_data_command(), name="vis_data")
    cli.add_command(export_program_command(), name="export_program")
    return cli


def main():
    command()()


if __name__ == "__main__":
    main()
