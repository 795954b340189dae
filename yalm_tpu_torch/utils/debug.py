"""Numerical debugging utilities (the port's own copy of
`yalm_tpu/utils/debug.py`).

- BinaryDumper: persist and load raw arrays as .npy files for offline
  diffing.
- Activation capture: `models/transformer.py:decode_step(capture=True)` (the
  oracle) and `models/fast.py:decode_step_fast(capture=True)` (the kernel
  path) return a named map of per-layer intermediates; `diff_captures`
  gives the worst error of each tensor between two maps, so a divergence
  between the kernels and the oracle, or between two devices or weight
  types, is localized to a layer boundary.

Tensors (of any device) and numpy arrays are accepted alike.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


class BinaryDumper:
    """Save and load arrays for fixture capture and offline comparison."""

    @staticmethod
    def save(path: str, arr) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(path, _np(arr), allow_pickle=False)

    @staticmethod
    def load(path: str) -> np.ndarray:
        return np.load(path, allow_pickle=False)


def max_err(a, b, relative: bool = True) -> float:
    """Max elementwise error between two tensors or capture maps (relative:
    over the larger of the two max magnitudes)."""
    if isinstance(a, dict):
        return max((max_err(a[k], b[k], relative) for k in a), default=0.0)
    a = _np(a).astype(np.float64)
    b = _np(b).astype(np.float64)
    diff = np.abs(a - b)
    if relative:
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-30)
        return float(diff.max() / scale)
    return float(diff.max())


def diff_captures(cap_a: dict, cap_b: dict, relative: bool = True) -> dict[str, float]:
    """Per-tensor max errors between two capture maps (worst first)."""
    errs = {k: max_err(cap_a[k], cap_b[k], relative) for k in cap_a if k in cap_b}
    return dict(sorted(errs.items(), key=lambda kv: -kv[1]))
