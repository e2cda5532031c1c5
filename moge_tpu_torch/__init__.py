"""PyTorch/CUDA port of moge_tpu for NVIDIA Hopper GPUs.

MoGe-1 and MoGe-2 inference (``models.{v1,v2}.MoGeModel.infer``), serving,
MoGe-2 training, the panorama pipeline (``panorama``) and the eval harness
(``eval``), with hand-written CUDA kernels for the fp32-statistics
LayerNorm, flash attention and the 3x3 replicate-pad convolution, among
others (``csrc/``). Each
kernel keeps a plain PyTorch version beside it, which runs for CPU tensors
and is the oracle the kernel is held against on the card. This package
imports ``torch`` and never ``jax``.
"""
