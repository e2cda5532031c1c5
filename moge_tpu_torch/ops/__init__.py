"""Tensor ops of the port: resampling, geometry, camera solvers and the
three kernel-backed ops (LayerNorm, flash attention, 3x3 replicate conv)."""
