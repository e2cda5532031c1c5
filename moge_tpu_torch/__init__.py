"""PyTorch/CUDA port of moge_tpu for NVIDIA Hopper GPUs.

MoGe-2 single-image inference (``models.v2.MoGeModel.infer``) with
hand-written CUDA kernels for the fp32-statistics LayerNorm, the flash
attention forward and the 3x3 replicate-pad convolution (``csrc/``). Each
kernel keeps a plain PyTorch version beside it, which runs for CPU tensors
and is the oracle the kernel is held against on the card. This package
imports ``torch`` and never ``jax``.
"""
