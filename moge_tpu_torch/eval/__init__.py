"""Benchmark evaluation of the port (port of ``moge_tpu/eval``): the baseline
interface, the deterministic loader and the metrics, whose alignment solves
run on the card through ``moge_tpu_torch.ops.alignment``."""
