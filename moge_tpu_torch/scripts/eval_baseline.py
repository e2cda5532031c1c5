"""Benchmark evaluation command (port of moge_tpu/scripts/eval_baseline.py;
reference moge/scripts/eval_baseline.py:23-161): dynamic-import a baseline
adapter, loop benchmarks x samples, per-invariance-class metrics with the
alignment solves on the baseline's device (``MGEBaselineInterface.device``),
incremental JSON checkpointing every 100 samples. cv2 and click are imported
inside ``command``."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["command", "main"]


def command():
    """The ``eval_baseline`` click command (click is imported here)."""
    import click

    @click.command(context_settings={"allow_extra_args": True, "ignore_unknown_options": True},
                   help="Evaluation script.")
    @click.option("--baseline", "baseline_code_path", type=click.Path(), required=True,
                  help="Path to the baseline model python code, e.g. moge_tpu_torch/baselines/moge.py.")
    @click.option("--config", "config_path", type=click.Path(), default="configs/eval/all_benchmarks.json",
                  help="Path to the evaluation configurations.")
    @click.option("--output", "-o", "output_path", type=click.Path(), required=True, help="Path to the output json file.")
    @click.option("--oracle", "oracle_mode", is_flag=True, help="Use GT intrinsics input.")
    @click.option("--dump_pred", is_flag=True, help="Dump prediction results.")
    @click.option("--dump_gt", is_flag=True, help="Dump ground truth.")
    @click.pass_context
    def eval_baseline(ctx, baseline_code_path, config_path, output_path, oracle_mode, dump_pred, dump_gt):
        from ..eval.baseline import MGEBaselineInterface
        from ..eval.dataloader import EvalDataLoaderPipeline
        from ..eval.metrics import compute_metrics
        from ..utils.tools import import_file_as_module, key_average, timeit

        module = import_file_as_module(baseline_code_path, Path(baseline_code_path).stem)
        baseline: MGEBaselineInterface = module.Baseline.load.main(ctx.args, standalone_mode=False)
        device = baseline.device
        if device.type == "cuda" and not torch.cuda.is_available():
            raise click.UsageError(f"the baseline runs on {device}: no CUDA device (no fallback to the CPU)")

        config = json.loads(Path(config_path).read_text())

        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        all_metrics = {}
        for benchmark_name, benchmark_config in config.items():
            metrics_list = []
            with EvalDataLoaderPipeline(**benchmark_config) as eval_data_pipe:
                for i in range(len(eval_data_pipe)):
                    sample = eval_data_pipe.get()
                    image = sample["image"]
                    gt_intrinsics = sample["intrinsics"]

                    # the timer opens and closes with a CUDA sync (the reference's
                    # torch.cuda.synchronize(), eval_baseline.py:65-71); the
                    # predictions come back as numpy inside it
                    with timeit("_inference_timer", verbose=False) as timer:
                        if oracle_mode:
                            pred = baseline.infer_for_evaluation(image, gt_intrinsics)
                        else:
                            pred = baseline.infer_for_evaluation(image)
                        pred = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                                for k, v in pred.items()}

                    metrics, misc = compute_metrics(pred, sample, vis=dump_pred or dump_gt, device=device)
                    metrics["inference_time"] = timer.elapsed
                    metrics_list.append(metrics)

                    dump_path = Path(str(output_path).replace(".json", "_dump"), benchmark_name,
                                     sample["filename"].replace(".zip", ""))
                    if dump_pred:
                        _dump_pred(dump_path / "pred", image, metrics, misc, pred)
                    if dump_gt:
                        _dump_gt(dump_path / "gt", image, sample)

                    if i % 100 == 0 or i == len(eval_data_pipe) - 1:
                        Path(output_path).write_text(json.dumps(
                            {**all_metrics, benchmark_name: key_average(metrics_list)}, indent=4
                        ))
                all_metrics[benchmark_name] = key_average(metrics_list)
            print(f"{benchmark_name}: {json.dumps(all_metrics[benchmark_name])}")

        all_metrics["mean"] = key_average(list(all_metrics.values()))
        Path(output_path).write_text(json.dumps(all_metrics, indent=4))

    return eval_baseline


def _dump_pred(path: Path, image, metrics, misc, pred):
    import cv2

    from ..utils.geometry_numpy import intrinsics_to_fov_numpy
    from ..utils.vis import colorize_depth

    path.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path / "image.jpg"), cv2.cvtColor((image * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    (path / "metrics.json").write_text(json.dumps(metrics, indent=4))
    if "pred_depth" in misc:
        cv2.imwrite(str(path / "depth.png"), cv2.cvtColor(colorize_depth(misc["pred_depth"]), cv2.COLOR_RGB2BGR))
    if "intrinsics" in pred:
        fov_x, fov_y = intrinsics_to_fov_numpy(np.asarray(pred["intrinsics"]))
        (path / "fov.json").write_text(json.dumps({
            "fov_x": float(np.rad2deg(fov_x)),
            "fov_y": float(np.rad2deg(fov_y)),
            "intrinsics": np.asarray(pred["intrinsics"]).tolist(),
        }))


def _dump_gt(path: Path, image, sample):
    import cv2

    from ..utils.vis import colorize_depth

    path.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path / "image.jpg"), cv2.cvtColor((image * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(path / "depth.png"),
                cv2.cvtColor(colorize_depth(sample["depth"], mask=sample["depth_mask"]), cv2.COLOR_RGB2BGR))


def main():
    command()()


if __name__ == "__main__":
    main()
