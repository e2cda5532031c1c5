"""Export a ``torch.export`` inference artifact (port of
moge_tpu/scripts/export_stablehlo.py; the artifact is a ``torch.export``
program, not StableHLO): one self-contained, fixed-shape program with the
weights embedded, reloaded with ``moge_tpu_torch.models.export.load_program``.
The ``--with_postprocess`` form holds the whole ``infer``, camera recovery
(the focal/shift solve, intrinsics, reprojection) included. The artifact
runs on the device it was exported on; click is imported inside
``command``.

    python -m moge_tpu_torch.scripts.cli export_program --pretrained model.pt -o model.pt2 \\
        --height 518 --width 518 --num_tokens 1800 --with_postprocess
"""

from __future__ import annotations

import torch

__all__ = ["command", "main"]


def command():
    """The ``export_program`` click command (click is imported here, not with the module)."""
    import click

    @click.command(help="Export a torch.export inference artifact (the port's counterpart of export_stablehlo).")
    @click.option("--pretrained", "pretrained_path", type=str, required=True,
                  help="Local reference-format .pt checkpoint ({'model_config', 'model'}).")
    @click.option("--version", "model_version", type=click.Choice(["v1", "v2"]), default="v2", show_default=True)
    @click.option("--output", "-o", "output_path", required=True, type=str)
    @click.option("--height", type=int, default=518, show_default=True)
    @click.option("--width", type=int, default=518, show_default=True)
    @click.option("--batch", type=int, default=1, show_default=True)
    @click.option("--num_tokens", type=int, default=1800, show_default=True,
                  help="Token budget baked into the artifact.")
    @click.option("--with_postprocess", is_flag=True,
                  help="Export the whole infer() program (camera recovery included; v2 only) instead of the raw "
                       "forward().")
    @click.option("--fp16/--fp32", "use_fp16", default=None,
                  help="Compute precision inside the artifact. Default: fp32 for the raw forward, bf16 for "
                       "--with_postprocess.")
    @click.option("--device", "device_name", type=str, default="cuda", show_default=True,
                  help="Torch device the artifact runs on; no fallback to the CPU when it is missing.")
    def export_program_command(pretrained_path, model_version, output_path, height, width, batch, num_tokens,
                               with_postprocess, use_fp16, device_name):
        from ..models import import_model_class_by_version
        from ..models.export import export_program

        device = torch.device(device_name)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise click.UsageError(f"--device {device_name}: no CUDA device (no fallback to the CPU)")
        model = import_model_class_by_version(model_version).from_pretrained(pretrained_path, device=device,
                                                                            dtype=torch.bfloat16)
        blob = export_program(model, height, width, num_tokens, batch=batch, with_postprocess=with_postprocess,
                              use_fp16=use_fp16)
        with open(output_path, "wb") as f:
            f.write(blob)
        kind = "infer (with camera recovery)" if with_postprocess else "raw forward"
        click.echo(f"wrote {output_path} ({kind}, {batch}x{height}x{width}, {num_tokens} tokens, "
                   f"{len(blob) / 1e6:.1f} MB)")

    return export_program_command


def main():
    command()()


if __name__ == "__main__":
    main()
