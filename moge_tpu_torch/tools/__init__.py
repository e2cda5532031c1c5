"""Measurement tools of the port, run on a CUDA GPU (``heads_breakdown``:
batched against sequential MoGe-2 heads, wall time and kernel profile)."""
