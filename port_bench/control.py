"""Readings for the limits of ``correct``: the program's sound runs and its
control, on the card, at a cell's own size.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--seconds 2]

Each seed runs the cell as the benchmark does (set-up, a short window at
the cell's load, the sampled answers against the reference) and prints
every number of every sampled answer, its largest over the sample and the
cell's checks, as one JSON line. The control answers in the nearest
precision below the configuration's: for MoGe-2 (bf16) the program's own
W8A8 int8 encoder (``MoGeModel(..., use_int8=True)``) in the same window;
for MoGe-1 (fp32 with TF32 off), which has no such path, the reference
itself with its products' operands rounded to TF32 (``reference/lowp.py``)
in the program's place, on as many of the cell's images as a run samples.
A limit lies between the largest sound reading and the smallest control
reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tf32_control(workload, config, seed: int, device):
    """The reference rounded to TF32 in the program's place, on ``sample`` of the cell's images."""
    from port_bench import compare, weights
    from port_bench.reference import models

    n = workload["sample"]
    images = weights.images(seed, n, workload["height"], workload["width"], device)
    tokens = workload.get("num_tokens") or models.num_tokens_of(config["model_config"], workload["resolution_level"])
    sd = weights.draw(config["version"], config["model_config"], config["weights"], seed, device)
    found = []
    for i in range(n):
        low = compare.reference_outputs(config, sd, images[i], tokens, rounding="tf32")
        answer = {k: v[0].cpu().numpy() for k, v in low.items()}
        found.append(compare.readings(answer, compare.reference_outputs(config, sd, images[i], tokens)))
    return found


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from port_bench import compare, harness

    bench, workload, config = harness.load_cell(harness.ROOT, args.workload)
    device = torch.device("cuda", 0)
    control = "int8" if config["dtype"] == "bfloat16" else "tf32"
    plan = [(int(s), "program") for s in args.seeds.split(",") if s]
    plan += [(int(s), control) for s in args.control_seeds.split(",") if s]
    for seed, side in plan:
        t0 = time.perf_counter()
        if side == "tf32":
            found = tf32_control(workload, config, seed, device)
        else:
            found = []
            compare_readings = compare.readings

            def keep(answer, ref):  # every number of every sampled image, not only the limited ones
                found.append(compare_readings(answer, ref))
                return found[-1]

            compare.readings = keep
            try:
                harness.execute(bench, args.workload, workload, config, seed, args.seconds, False, device, t0,
                                int8=side == "int8")
            finally:
                compare.readings = compare_readings
        worst = {k: max(f.get(k, 0.0) for f in found) for k in found[0]} if found else {}
        print(json.dumps({"cell": args.workload, "seed": seed, "side": side, "s": time.perf_counter() - t0,
                          "worst": worst, "each": found, "judged": compare.judge(found, workload["limits"])}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
