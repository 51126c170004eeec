"""ORB feature-extraction frontend.

Port of orb_slam2_tpu/ops/frontend.py, the equivalent of
ORBextractor::operator() (ref: src/ORBextractor.cc:1043-1105): pyramid,
FAST with the per-cell threshold fallback, spatially-uniform per-level
budgets, IC angle, blur, rBRIEF, level-0 coordinates — fixed-shape padded
tensors throughout.  `extract_stereo_pair` adds the stereo row match.

Where the JAX package chose Pallas by platform (`_use_pallas`), each
kernel wrapper here chooses by the device of its input: CUDA tensors
launch the Hopper kernels, CPU tensors take their plain versions.
`plain=True` takes the plain versions on any device, to compare the two
on the card.

Per-level feature budgets follow the reference's geometric split
(factor 1/scale, ref: src/ORBextractor.cc:436-446).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_tpu_torch.ops import (
    fast, fast_cuda, gaussian, orb_cuda, pyramid, stereo,
)

EDGE_THRESHOLD = 19  # ref: src/ORBextractor.cc:74


class Features(NamedTuple):
    """Fixed-shape extraction result; level-0 (unscaled) coordinates."""

    xy: torch.Tensor        # (N, 2) float32, level-0 pixel coords
    response: torch.Tensor  # (N,) float32 FAST score
    octave: torch.Tensor    # (N,) int32 pyramid level
    angle: torch.Tensor     # (N,) float32 degrees
    desc: torch.Tensor      # (N, 8) int32: the uint32 words' bits
    valid: torch.Tensor     # (N,) bool

    @property
    def n(self):
        return self.xy.shape[0]


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> list:
    """Per-level keypoint budgets (ref: src/ORBextractor.cc:436-446)."""
    factor = 1.0 / scale_factor
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    budgets = []
    acc = 0
    for l in range(n_levels - 1):
        b = int(round(n_first * factor ** l))
        budgets.append(b)
        acc += b
    budgets.append(max(n_features - acc, 0))
    return budgets


def padded_total(n_features: int, n_levels: int, scale_factor: float) -> int:
    """Total padded keypoint count, rounded up to a multiple of 128."""
    total = sum(level_budgets(n_features, n_levels, scale_factor))
    return -(-total // 128) * 128


def extract(
    img: torch.Tensor,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    ini_th: int = 20,
    min_th: int = 7,
    cell: int = 24,
    plain: bool = False,
) -> Features:
    """(H, W) uint8/float32 image tensor -> Features with fixed shape.

    On a CUDA image FAST and the describe kernel each run once over all
    levels; the grid top-K and the blur run per level."""
    levels = pyramid.compute_pyramid(img, n_levels, scale_factor)
    budgets = level_budgets(n_features, n_levels, scale_factor)
    n_total = padded_total(n_features, n_levels, scale_factor)
    detect = (fast_cuda.detect_levels_plain if plain
              else fast_cuda.detect_levels)
    describe = (orb_cuda.describe_levels_plain if plain
                else orb_cuda.describe_levels)

    border = EDGE_THRESHOLD - 3  # FAST margin; ref ComputeKeyPointsOctTree
    scores = detect(levels, ini_th, min_th, border)
    picks = [fast.select_topk_grid(s, b, cell)
             for s, b in zip(scores, budgets)]
    blurred = [gaussian.blur7x7(lvl) for lvl in levels]
    xys, resps, valids = zip(*picks)
    ang, desc = describe(levels, blurred, xys, valids, n_total)

    # float32(scale_factor ** l), as jnp.float32 of the Python double
    scales = [float(np.float32(scale_factor ** l)) for l in range(n_levels)]
    cat = {
        "xy": torch.cat([xy.float() * s for xy, s in zip(xys, scales)]),
        "resp": torch.cat(resps),
        "oct": torch.cat([torch.full((b,), l, dtype=torch.int32,
                                     device=img.device)
                          for l, b in enumerate(budgets)]),
        "valid": torch.cat(valids),
    }
    pad = n_total - cat["xy"].shape[0]
    if pad > 0:
        cat = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
               for k, v in cat.items()}
    return Features(cat["xy"], cat["resp"], cat["oct"], ang, desc,
                    cat["valid"])


def extract_stereo_pair(
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    scale_factors: torch.Tensor,
    bf: float,
    max_disp: float,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    ini_th: int = 20,
    min_th: int = 7,
    cell: int = 24,
    plain: bool = False,
):
    """Stereo frame construction: both ORB extractions, the row-search
    stereo match with SAD subpixel refinement, and the median sweep.

    The reference runs left/right extraction on two threads then matches
    (ref: src/Frame.cc:78-81, 466-641).  Returns (left Features,
    StereoMatches).
    """
    fl = extract(img_l, n_features, n_levels, scale_factor, ini_th, min_th,
                 cell, plain)
    fr = extract(img_r, n_features, n_levels, scale_factor, ini_th, min_th,
                 cell, plain)
    m = stereo.match(
        fl.xy, fl.octave, fl.desc, fl.valid,
        fr.xy, fr.octave, fr.desc, fr.valid,
        img_l.float(), img_r.float(),
        scale_factors, bf, 0.0, max_disp, plain=plain,
    )
    return fl, stereo.median_sad_filter(m)
