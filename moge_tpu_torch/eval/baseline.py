"""Baseline adapter interface (port of moge_tpu/eval/baseline.py; reference
moge/test/baseline.py:7-43).

Wrappers uniformize loading + inference across models for the benchmark
harness. Arrays are numpy at the boundary (HWC image in [0, 1]); adapters
run any backend inside (the port's models run on the card).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["MGEBaselineInterface"]


class MGEBaselineInterface:
    """Abstract model wrapper for the evaluation harness."""

    # where ``scripts.eval_baseline`` runs the metrics' alignment solves
    device = torch.device("cuda")

    @staticmethod
    def load(*args, **kwargs) -> "MGEBaselineInterface":
        """click command (a static constructor taking the CLI's passthrough
        args, reference baseline.py:13-18): ``Baseline.load.main(args)``."""
        raise NotImplementedError

    def infer(self, image: np.ndarray, intrinsics: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """``image``: (H, W, 3) RGB in [0, 1]. Returns a dict of
        `points_{metric|scale_invariant|affine_invariant}` /
        `depth_{metric|scale_invariant|affine_invariant}` /
        `disparity_affine_invariant` / `intrinsics` predictions, numpy."""
        raise NotImplementedError

    def infer_for_evaluation(self, image: np.ndarray, intrinsics: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        return self.infer(image, intrinsics)
