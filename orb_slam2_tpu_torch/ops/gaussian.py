"""Separable Gaussian blur matching cv::GaussianBlur(7x7, sigma=2).

Port of orb_slam2_tpu/ops/gaussian.py.  Used before descriptor sampling
(ref: src/ORBextractor.cc:1086 blurs each pyramid level with
GaussianBlur(ksize=7, sigma=2, BORDER_REFLECT_101)).  F.pad's "reflect"
mode, like jnp.pad's, is BORDER_REFLECT_101.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Same formula as cv::getGaussianKernel for sigma > 0."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


_K7 = [float(v) for v in gaussian_kernel_1d(7, 2.0)]


def blur7x7(img: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 -> blurred float32, BORDER_REFLECT_101."""
    r = 3
    h, w = img.shape
    p = F.pad(img[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(7):
        out = out + _K7[i] * p[i : i + h, :]
    p2 = F.pad(out[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    out2 = torch.zeros_like(img)
    for i in range(7):
        out2 = out2 + _K7[i] * p2[:, i : i + w]
    return out2
