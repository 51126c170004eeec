"""Stereo feature matching: batched Hamming row-search + SAD subpixel.

Port of orb_slam2_tpu/ops/stereo.py (ref: Frame::ComputeStereoMatches,
src/Frame.cc:466-641): all left-right pairs scored at once as a masked
(N, M) Hamming matrix, subpixel refinement by the 11x11 SAD search over
+/-5 px with a parabola fit, then the median-SAD outlier sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.ops import consts, hamming, stereo_cuda


class StereoMatches(NamedTuple):
    u_right: torch.Tensor   # (N,) float32, -1 where unmatched
    depth: torch.Tensor     # (N,) float32, -1 where unmatched
    sad: torch.Tensor       # (N,) float32 best SAD (for outlier sweep)


def match(
    xy_l: torch.Tensor, octave_l: torch.Tensor, desc_l: torch.Tensor,
    valid_l: torch.Tensor,
    xy_r: torch.Tensor, octave_r: torch.Tensor, desc_r: torch.Tensor,
    valid_r: torch.Tensor,
    level0_l: torch.Tensor, level0_r: torch.Tensor,
    scale_factors: torch.Tensor,
    bf: float, min_disp: float, max_disp: float,
    plain: bool = False,
) -> StereoMatches:
    """Match left keypoints to right keypoints along epipolar rows.

    xy_* are level-0 coords; level0_* the level-0 images for the SAD
    refinement.  bf, min_disp and max_disp are taken as float32, as the
    JAX package's traced scalars are: 0-dim tensors on the device, or
    Python numbers that become such tensors once (no copy after the first
    call).  Step 3 is one kernel launch on a CUDA device; plain=True runs
    its plain version on any device.
    """
    dev = xy_l.device
    bf = consts.scalar(bf, dev)
    min_disp = consts.scalar(min_disp, dev)
    max_disp = consts.scalar(max_disp, dev)
    best_idx, best_dist = row_matches(
        xy_l, octave_l, desc_l, valid_l, xy_r, octave_r, desc_r, valid_r,
        scale_factors, min_disp, max_disp)

    # --- 3. SAD subpixel refinement at level 0 ----------------------------
    refine = stereo_cuda.refine_plain if plain else stereo_cuda.refine
    return StereoMatches(*refine(level0_l, level0_r, xy_l, xy_r, best_idx,
                                 best_dist, bf, min_disp, max_disp))


def row_matches(
    xy_l: torch.Tensor, octave_l: torch.Tensor, desc_l: torch.Tensor,
    valid_l: torch.Tensor,
    xy_r: torch.Tensor, octave_r: torch.Tensor, desc_r: torch.Tensor,
    valid_r: torch.Tensor,
    scale_factors: torch.Tensor,
    min_disp: torch.Tensor, max_disp: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-2 of `match`: each left keypoint's best right keypoint by
    Hamming distance among the candidates in its row band, octave band and
    disparity window.  Returns (best_idx (N,) int64, best_dist (N,)
    int32)."""
    # --- 1. candidate mask: row band, octave band, disparity window ------
    vL = xy_l[:, 1:2]
    vR = xy_r[None, :, 1]
    r_band = 2.0 * scale_factors[octave_r.long()][None, :]   # Frame.cc:487
    row_ok = torch.abs(vL - vR) <= r_band

    oct_ok = (
        (octave_r[None, :] >= octave_l[:, None] - 1)
        & (octave_r[None, :] <= octave_l[:, None] + 1)
    )

    disp = xy_l[:, 0:1] - xy_r[None, :, 0]
    disp_ok = (disp >= min_disp) & (disp <= max_disp)

    mask = row_ok & oct_ok & disp_ok & valid_l[:, None] & valid_r[None, :]

    # --- 2. Hamming best match -------------------------------------------
    dist = hamming.distance_matrix(desc_l, desc_r)
    best_idx, best_dist, _ = hamming.masked_argmin(dist, mask)
    return best_idx, best_dist


def median_sad_filter(m: StereoMatches) -> StereoMatches:
    """Drop matches with SAD > 1.5 * 1.4 * median (ref: Frame.cc:626-639).

    The median of the finite SADs is jnp.nanmedian's: the mean of the two
    middle values for an even count (torch.nanmedian takes the lower
    one), NaN when there are none.  Computed without leaving the device.
    """
    finite = torch.isfinite(m.sad)
    srt = torch.sort(torch.where(finite, m.sad, torch.full_like(m.sad,
                                                                torch.inf)))[0]
    cnt = finite.sum()
    # gathers, not srt[t]: indexing by a 0-dim tensor reads it on the host
    lo = srt.gather(0, ((cnt - 1) // 2).clamp(min=0).reshape(1))[0]
    hi = srt.gather(0, (cnt // 2).clamp(max=srt.shape[0] - 1).reshape(1))[0]
    med = torch.where(cnt > 0, lo * 0.5 + hi * 0.5,
                      torch.full_like(lo, torch.nan))
    keep = finite & (m.sad <= 1.5 * 1.4 * med)
    neg = torch.full_like(m.u_right, -1.0)
    return StereoMatches(
        torch.where(keep, m.u_right, neg),
        torch.where(keep, m.depth, neg),
        torch.where(keep, m.sad, torch.full_like(m.sad, torch.inf)),
    )


def depth_from_rgbd(
    xy: torch.Tensor, valid: torch.Tensor, depth_img: torch.Tensor,
    depth_factor: float, bf: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RGB-D depth association (ref: Frame::ComputeStereoFromRGBD
    src/Frame.cc:643-664): depth lookup at the raw keypoint, synthetic
    right coordinate u - bf/d."""
    h, w = depth_img.shape
    xi = torch.round(xy[:, 0]).long().clamp(0, w - 1)
    yi = torch.round(xy[:, 1]).long().clamp(0, h - 1)
    d = depth_img[yi, xi].float() * depth_factor
    good = valid & (d > 0)
    neg = torch.full_like(d, -1.0)
    depth = torch.where(good, d, neg)
    u_right = torch.where(
        good, xy[:, 0] - consts.scalar(bf, d.device) / d.clamp(min=1e-6),
        neg)
    return u_right, depth
