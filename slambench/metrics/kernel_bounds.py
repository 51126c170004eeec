"""The least time the card could take for each of the port's three frontend
kernels, from the work a frame's own pixels and keypoints ask for.

A frozen copy of the arithmetic the repository's chip checks used when
the kernels were written: each input byte read once and each output byte
written once over the memory rate, or the operations over the arithmetic
rate, whichever is larger.  Rates: NVIDIA's H100 SXM data sheet at its
700 W limit (3.35 TB/s of HBM3, 67 TFLOP/s float32 and 34 TFLOP/s
float64 outside the tensor cores).  The work is counted from the inputs,
so the bound reads the same whatever implements the kernel.  Imports
torch, numpy and the frozen reference only.
"""

from __future__ import annotations

import torch

from reference import orb

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# FAST per pixel: the early exit's 4 compass differences, 8 pair min/max,
# 6 to reduce them and 4 to test; the NMS's 6 max and 3 compares, 4
# border compares and 3 selects.  Per pixel past the compass test: 12
# more ring differences, 2 x 64 doubling min/max and 2 x 15 over the
# arcs, and 5 for the negation, max, subtraction and threshold.
FAST_OPS_PER_PX = 4 + 8 + 6 + 4 + 6 + 3 + 4 + 3
FAST_OPS_PER_PASSING_PX = 12 + 2 * 64 + 2 * 15 + 5
# describe per valid keypoint: 749 circle pixels x (2 multiplies + 2
# adds) in float64; 512 taps x (4 multiplies, 2 adds, 2 roundings) and
# 256 compares in float32
DESC_FP64_OPS_PER_KP = 749 * 4
DESC_FP32_OPS_PER_KP = 512 * 8 + 256
# stereo refinement per keypoint: 11 shifts x 121 x (2 subtractions, an
# absolute value, an add); the epilogue's centres (3 conversions, 6
# clamps), 10 compares for the first minimum, and the parabola and
# depth's 26 float operations
SAD_OPS_PER_KP = 11 * 121 * 4
REFINE_OPS_PER_KP = 9 + 10 + 26


def bound_s(n_bytes: float, ops_s: float) -> float:
    """Seconds: the larger of the bytes' time and the operations' time."""
    return max(n_bytes / HBM_BYTES_PER_S, ops_s)


def fast_work(levels, min_th: float) -> dict:
    """FAST over one image's levels: every pixel read once and its score
    written once (4 + 4 bytes); every pixel's early-exit work, and the
    full arc score for the pixels that pass the compass-point exit."""
    n_px = sum(lv.numel() for lv in levels)
    n_pass = 0
    for lv in levels:
        c = orb.ring(lv)[[0, 4, 8, 12]] - lv[None]
        cn = torch.roll(c, -1, 0)
        dark = torch.minimum(c, cn).amax(0)
        bright = -torch.maximum(c, cn).amin(0)
        n_pass += int(((torch.maximum(dark, bright) - 1.0) >= min_th).sum())
    ops = n_px * FAST_OPS_PER_PX + n_pass * FAST_OPS_PER_PASSING_PX
    return {"pixels": n_px, "passing": n_pass, "bytes": 8 * n_px,
            "ops": ops,
            "bound_s": bound_s(8 * n_px, ops / FP32_OPS_PER_S)}


def describe_work(levels, xys, valids, n_rows: int) -> dict:
    """Describe over one image's levels: each distinct level pixel under a
    valid keypoint's moment circle and under its taps read once, the
    keypoints (8 B) and flags (1 B) read once, the angle and descriptor
    rows (4 + 32 B) written once; float64 moments and float32 taps."""
    dev = levels[0].device
    half = orb.HALF_PATCH
    dv, du = [t.to(dev) - half for t in torch.nonzero(
        torch.from_numpy(orb.circular_mask() > 0), as_tuple=True)]
    circle = taps = n_valid = n_kp = 0
    for lv, xy, v in zip(levels, xys, valids):
        h, w = lv.shape
        kp = xy[v].long()
        cx = kp[:, 0].clamp(half, w - 1 - half)[:, None]
        cy = kp[:, 1].clamp(half, h - 1 - half)[:, None]
        circle += torch.unique((cy + dv) * w + cx + du).numel()
        ang = orb.ic_angles(lv, xy, v)[v]
        rows, cols = orb.tap_coords(h, w, xy[v], ang)
        taps += torch.unique(rows * w + cols).numel()
        n_valid += int(v.sum())
        n_kp += xy.shape[0]
    n_bytes = 4 * (circle + taps) + 9 * n_kp + (4 + 32) * n_rows
    ops_s = n_valid * (DESC_FP64_OPS_PER_KP / FP64_OPS_PER_S
                       + DESC_FP32_OPS_PER_KP / FP32_OPS_PER_S)
    return {"circle_px": circle, "tap_px": taps, "valid": n_valid,
            "bytes": n_bytes, "bound_s": bound_s(n_bytes, ops_s)}


def refine_work(w: int, yc, xl, xr) -> dict:
    """The stereo refinement over N keypoints with these SAD centres: each
    distinct pixel of the left 11x11 windows and the right 11x21 strips
    read once; per keypoint 24 B in (xy, best index, best distance, the
    right x) and 12 B out (u_right, depth, SAD); 12 B of constants."""
    dev = yc.device
    rw, rl = orb.SAD_W, orb.SAD_L
    d = torch.arange(-rw, rw + 1, device=dev)
    ds = torch.arange(-rw - rl, rw + rl + 1, device=dev)
    rows = (yc.long()[:, None, None] + d[None, :, None]) * w
    left = torch.unique(rows + xl.long()[:, None, None] + d[None, None, :])
    right = torch.unique(rows + xr.long()[:, None, None] + ds[None, None, :])
    n = yc.numel()
    n_bytes = 4 * (left.numel() + right.numel()) + 36 * n + 12
    ops = n * (SAD_OPS_PER_KP + REFINE_OPS_PER_KP)
    return {"left_px": left.numel(), "right_px": right.numel(),
            "bytes": n_bytes, "ops": ops,
            "bound_s": bound_s(n_bytes, ops / FP32_OPS_PER_S)}
