"""Find the serving knee once: the highest offered rate at which the
micro-batcher's backlog does not grow.

    python3 port_bench/sweep.py --workload v2l-serve-518-poisson --rates 60,80,100 [--seconds 10] [--seed 1]

One process, one model and one batcher; each rate offers the cell's
arrival pattern at that rate for ``seconds`` and prints one JSON line: the
latency quartiles and tail, the rate answered, the mean batch, and the
median latency of the window's first and last thirds (a backlog that grows
shows as a last third far slower than the first).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from port_bench import harness

    _, workload, config = harness.load_cell(harness.ROOT, args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    driver = harness.load_module(harness.HERE / "drivers" / "serve.py", "pb_driver_serve")
    ctx = argparse.Namespace(workload=dict(workload, rate_per_s=max(rates)), config=config, seed=args.seed,
                             seconds=args.seconds, device=torch.device("cuda", 0), int8=False, traced=False)
    state = driver.setup(ctx)
    for rate in rates:
        due = driver.arrivals(rate, args.seconds)
        r = driver.offer(state, due, args.seconds)
        lat = r["latency_s"] * 1e3
        third = len(lat) // 3
        ok = np.isfinite(lat)
        print(json.dumps({"rate": rate, "requests": len(lat), "failed": r["failed"],
                          "answered_per_s": float(ok.sum() / r["window_s"]),
                          "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                          "p99_ms": float(np.percentile(lat, 99)),
                          "first_third_p50_ms": float(np.median(lat[:third])),
                          "last_third_p50_ms": float(np.median(lat[-third:])),
                          "batch_mean": r["batched_images"] / max(r["batches"], 1),
                          "late_p95_ms": r["late_p95_ms"]}), flush=True)
    state.batcher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
