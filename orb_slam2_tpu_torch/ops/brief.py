"""Rotated BRIEF (rBRIEF) 256-bit descriptors, batched.

Port of orb_slam2_tpu/ops/brief.py (ref: computeOrbDescriptor,
src/ORBextractor.cc:108-147): each bit compares two blurred-image
samples at pattern offsets rotated by the keypoint angle and rounded to
integer pixels; 256 bits are packed little-endian into 8 words.

Descriptors are int32 tensors holding the uint32 words' bits: torch's
uint32 lacks most operators.  `convert.features_to_numpy` views them as
np.uint32 at the numpy boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_tpu_torch.ops import consts
from orb_slam2_tpu_torch.ops.orb_pattern import BIT_PATTERN_31
from orb_slam2_tpu_torch.ops.orientation import RAD

PATTERN_BITS = 256
_CLIP = 13  # keep taps within the 31x31 patch under rotation margin


def generate_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int32 rows [x0, y0, x1, y1], G-II localized Gaussian."""
    rng = np.random.default_rng(seed)
    s = 31.0
    pairs = []
    seen = set()
    while len(pairs) < PATTERN_BITS:
        p = rng.normal(0.0, s / 5.0, 2)
        q = rng.normal(p, s / 10.0, 2)
        p = np.clip(np.rint(p), -_CLIP, _CLIP).astype(np.int32)
        q = np.clip(np.rint(q), -_CLIP, _CLIP).astype(np.int32)
        if (p == q).all():
            continue
        key = (p[0], p[1], q[0], q[1])
        if key in seen:
            continue
        seen.add(key)
        pairs.append([p[0], p[1], q[0], q[1]])
    return np.array(pairs, np.int32)


_PATTERN = BIT_PATTERN_31.astype(np.int32)


def set_pattern(pattern: np.ndarray) -> None:
    """Install a custom (256, 4) [x0, y0, x1, y1] tap pattern."""
    global _PATTERN
    pattern = np.asarray(pattern)
    if pattern.shape != (PATTERN_BITS, 4):
        raise ValueError(f"pattern must be (256, 4), got {pattern.shape}")
    _PATTERN = pattern.astype(np.int32)


def get_pattern() -> np.ndarray:
    return _PATTERN.copy()


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words, bit j of word k = bit 32k+j."""
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(n, 8, 32).long() << shifts).sum(-1)   # [0, 2^32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.int()


def tap_coords(h: int, w: int, xy: torch.Tensor, angles_deg: torch.Tensor):
    """(rows, cols), each (N, 512) int64: the 512 rotated taps of each
    keypoint (the 256 first points, then the 256 second), each clipped
    to the (h, w) level on its own."""
    pat = consts.table(_PATTERN, xy.device, torch.float32)
    px = torch.cat([pat[:, 0], pat[:, 2]])[None]         # (1, 512) x offsets
    py = torch.cat([pat[:, 1], pat[:, 3]])[None]         # (1, 512) y offsets
    rad = angles_deg * RAD
    a = torch.cos(rad)[:, None]                          # (N, 1)
    b = torch.sin(rad)[:, None]
    # reference GET_VALUE rotation: x' = round(x cos - y sin),
    # y' = round(x sin + y cos)   (ref: src/ORBextractor.cc:115-117);
    # torch.round is round-half-to-even like jnp.rint
    rx = torch.round(px * a - py * b).long()             # (N, 512)
    ry = torch.round(px * b + py * a).long()
    rows = (xy[:, 1:2].long() + ry).clamp(0, h - 1)
    cols = (xy[:, 0:1].long() + rx).clamp(0, w - 1)
    return rows, cols


def describe(
    blurred: torch.Tensor,
    xy: torch.Tensor,
    angles_deg: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Compute (N, 8) int32 packed descriptors.

    blurred: (H, W) float32 blurred level image.
    xy: (N, 2) int32 keypoint centers (level coords).
    angles_deg: (N,) orientation in degrees.
    """
    h, w = blurred.shape
    rows, cols = tap_coords(h, w, xy, angles_deg)
    taps = blurred.reshape(-1)[rows * w + cols]          # (N, 512)
    packed = pack_bits(taps[:, :PATTERN_BITS] < taps[:, PATTERN_BITS:])
    return torch.where(valid[:, None], packed, torch.zeros_like(packed))
