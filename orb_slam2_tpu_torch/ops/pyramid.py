"""Image pyramid with OpenCV INTER_LINEAR resize semantics.

Port of orb_slam2_tpu/ops/pyramid.py (ref: ORBextractor::ComputePyramid,
src/ORBextractor.cc:1107-1132): each level resized from the previous one
with half-pixel centres (src = (dst + 0.5) * scale - 0.5), clamped at the
edges like cv::resize.

Rounding: XLA on the CPU compiles `(i + 0.5) * s - 0.5` and
`a * (1 - w) + b * w` into fused multiply-adds (one rounding each), so
the JAX package's levels are those single-rounded values.  `_fma` gives
the same here on any device: the product of two float32 values is exact
in float64, and the sum is rounded once more to float32.  With two
separate float32 roundings instead, about a quarter of a level's pixels
differ from JAX in the last bits, and the FAST scores on them with it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def level_sizes(
    height: int, width: int, n_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """Per-level (H, W), matching cvRound(size / scale^l) in the reference."""
    sizes = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        # cvRound: round-half-to-even; numpy's rint matches.
        sizes.append(
            (int(np.rint(height * inv)), int(np.rint(width * inv)))
        )
    return sizes


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding of the product and sum."""
    if not torch.is_tensor(b):
        b = float(np.float32(b))
    else:
        b = b.double()
    return (a.double() * b + c.double()).float()


def _coords(n_out: int, n_in: int, device) -> torch.Tensor:
    scale = n_in / n_out
    i = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    c = _fma(i, scale, torch.full_like(i, -0.5))
    return c.clamp(0.0, n_in - 1.0)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv::resize(..., INTER_LINEAR) equivalent for a single-channel image."""
    in_h, in_w = img.shape
    ys = _coords(out_h, in_h, img.device)
    xs = _coords(out_w, in_w, img.device)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    y0i = y0.long()
    x0i = x0.long()
    y1i = (y0i + 1).clamp(max=in_h - 1)
    x1i = (x0i + 1).clamp(max=in_w - 1)
    f = img.float()
    # separable gather: rows then columns
    rows = _fma(f[y0i, :], 1.0 - wy, f[y1i, :] * wy)       # (out_h, in_w)
    return _fma(rows[:, x0i], 1.0 - wx, rows[:, x1i] * wx)  # (out_h, out_w)


def compute_pyramid(
    img: torch.Tensor, n_levels: int = 8, scale_factor: float = 1.2
) -> Tuple[torch.Tensor, ...]:
    """image (H, W) u8/f32 -> tuple of n_levels float32 images.

    Level l is resized from level l-1 (not from level 0), matching the
    reference's accumulation of interpolation (ref: ORBextractor.cc:1118).
    """
    h, w = img.shape
    sizes = level_sizes(h, w, n_levels, scale_factor)
    levels = [img.float()]
    for l in range(1, n_levels):
        lh, lw = sizes[l]
        levels.append(resize_bilinear(levels[-1], lh, lw))
    return tuple(levels)
