"""Baseline adapters of the port for ``scripts.eval_baseline`` and
``scripts.infer_baseline`` (``--baseline moge_tpu_torch/baselines/moge.py``)."""
