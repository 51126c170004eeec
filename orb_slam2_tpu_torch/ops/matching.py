"""Batched descriptor matching: the tracking matchers as masked matrices.

Port of orb_slam2_tpu/ops/matching.py: the tracking matchers (ref:
ORBmatcher::SearchByProjection, src/ORBmatcher.cc:45-129 and :1328-1470,
and Frame::isInFrustum, src/Frame.cc:269-325), SearchByBoW, the
triangulation search and Fuse with their batched-over-keyframes forms.
Every mode is a masked (Q, T) packed-Hamming distance matrix with window
/ octave / stereo compatibility masks, a row-wise (best, second)
reduction, the reference's ratio test and rotation-histogram filter, and
a scatter-min that keeps one claiming query per target feature.  Where
the JAX package vmaps over B keyframes, the tensors here carry a leading
B dimension.

The relocalization matcher, the two Sim3 matchers of loop closing and
the monocular initialization matcher are here too.
The fused tracking step (slam/track_step.py) inlines the same logic as
the tracking matchers.

All functions take fixed-shape padded tensors + validity masks and read
nothing back to the host.  Scalars (fx, fy, cx, cy, bf, the log scale
factor) may be 0-dim device tensors or Python numbers; the latter become
such tensors once (ops/consts.py), so every division is a true division
on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_tpu_torch.ops import consts, hamming
from orb_slam2_tpu_torch.utils import to_numpy

TH_LOW = hamming.TH_LOW     # 50,  ref: src/ORBmatcher.cc:38
TH_HIGH = hamming.TH_HIGH   # 100, ref: src/ORBmatcher.cc:37
_BIG = 2147483647


class Matches(NamedTuple):
    """Query-side match result (fixed shape Q)."""

    idx: torch.Tensor    # (Q,) int64 target feature index (valid iff ok)
    dist: torch.Tensor   # (Q,) int32 Hamming distance
    ok: torch.Tensor     # (Q,) bool


def resolve_duplicates(idx: torch.Tensor, dist: torch.Tensor,
                       ok: torch.Tensor, n_targets: int) -> torch.Tensor:
    """Keep, per target feature, only the lowest-distance claiming query.

    Returns the filtered `ok` mask.  Ties break by query index
    (deterministic): the key is dist * Q + query, and `.at[idx].min` is
    scatter_reduce's "amin".  Leading dimensions are separate match sets.
    """
    q = idx.shape[-1]
    idx = idx.long()
    key = dist.int() * q + torch.arange(q, dtype=torch.int32,
                                         device=idx.device)
    key = torch.where(ok, key, _BIG)
    best_key = torch.full((*idx.shape[:-1], n_targets), _BIG,
                          dtype=torch.int32,
                          device=idx.device).scatter_reduce(
        -1, idx, key, reduce="amin", include_self=True)
    return ok & (torch.gather(best_key, -1, idx) == key)


# row-wise (best_idx, best, second_best) over a masked distance matrix;
# ties go to the first column, as in jnp.argmin
_best_two = hamming.masked_argmin


# ---------------------------------------------------------------------------
# Frustum projection of map points into a frame (device part of
# Tracking::SearchLocalPoints / Frame::isInFrustum, ref: src/Frame.cc:269-325)
# ---------------------------------------------------------------------------

class Projection(NamedTuple):
    uv: torch.Tensor          # (M, 2) projected pixel coords
    ur: torch.Tensor          # (M,) right-view u (valid only for stereo)
    depth: torch.Tensor       # (M,) camera-frame z
    dist: torch.Tensor        # (M,) distance to camera center
    view_cos: torch.Tensor    # (M,) cos(angle to mean viewing ray)
    level: torch.Tensor       # (M,) int64 predicted octave
    in_frustum: torch.Tensor  # (M,) bool


def _project(pts_w, Tcw, fx, fy, cx, cy, bf):
    """Camera-frame points, pixel coords and right-view u."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = pts_w @ R.T + t
    z_safe = pc[:, 2].clamp(min=1e-6)
    u = fx * pc[:, 0] / z_safe + cx
    v = fy * pc[:, 1] / z_safe + cy
    return pc, u, v, u - bf / z_safe


def _in_bounds(u, v, bounds):
    return ((u >= bounds[0]) & (u < bounds[1])
            & (v >= bounds[2]) & (v < bounds[3]))


def predict_level(max_dist, dist_safe, log_scale_factor, n_levels: int):
    """MapPoint::PredictScale (ref: src/MapPoint.cc:385-400): ceil of
    log(maxDist / dist) / log(scale), clipped to the pyramid."""
    ratio = max_dist.clamp(min=1e-9) / dist_safe
    level = torch.ceil(torch.log(ratio.clamp(min=1e-9)) / log_scale_factor)
    return level.clamp(0, n_levels - 1).long()


def project_points(
    pts_w: torch.Tensor, normals: torch.Tensor,
    min_dist: torch.Tensor, max_dist: torch.Tensor,
    mask: torch.Tensor,
    Tcw: torch.Tensor,
    fx, fy, cx, cy, bf,
    bounds: torch.Tensor,          # [minX, maxX, minY, maxY]
    log_scale_factor,
    n_levels: int,
    view_cos_limit: float = 0.5,
) -> Projection:
    """Batched Frame::isInFrustum (ref: src/Frame.cc:269-325).

    Checks positive depth, image bounds, the scale-invariance distance
    band [0.8*minDist, 1.2*maxDist], and viewing angle < 60deg; predicts
    the octave as ceil(log(maxDist/dist)/logScaleFactor)
    (ref: MapPoint::PredictScale src/MapPoint.cc:385-400).
    """
    dev = pts_w.device
    fx, fy, cx, cy, bf, log_sf = (consts.scalar(v, dev) for v in
                                  (fx, fy, cx, cy, bf, log_scale_factor))
    pc, u, v, ur = _project(pts_w, Tcw, fx, fy, cx, cy, bf)
    z = pc[:, 2]

    R, t = Tcw[:3, :3], Tcw[:3, 3]
    Ow = -R.T @ t
    po = pts_w - Ow
    dist = torch.sqrt((po * po).sum(1))
    dist_safe = dist.clamp(min=1e-9)
    view_cos = (po * normals).sum(1) / dist_safe
    level = predict_level(max_dist, dist_safe, log_sf, n_levels)

    ok = (
        mask
        & (z > 0)
        & _in_bounds(u, v, bounds)
        & (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
        & (view_cos > view_cos_limit)
    )
    return Projection(torch.stack([u, v], -1), ur, z, dist, view_cos, level,
                      ok)


# ---------------------------------------------------------------------------
# SearchByProjection — track local map (ref: src/ORBmatcher.cc:45-129)
# ---------------------------------------------------------------------------

def search_local_points(
    proj: Projection,
    pt_desc: torch.Tensor,        # (M, 8) representative descriptors
    feat_xy: torch.Tensor,        # (N, 2)
    feat_ur: torch.Tensor,        # (N,) right u, <0 for mono features
    feat_octave: torch.Tensor,    # (N,)
    feat_desc: torch.Tensor,      # (N, 8)
    feat_free: torch.Tensor,      # (N,) bool: not already bound to a point
    scale_factors: torch.Tensor,  # (L,)
    th,
    ratio: float = 0.8,
) -> Matches:
    """Match frustum-visible map points to free frame keypoints.

    Window radius is 2.5 px when viewCos > 0.998 else 4.0, times `th`,
    times the predicted-level scale factor (ref :84-90); candidate octaves
    are [pred-1, pred]; the 0.8 ratio test applies only when best and
    second-best live in the same octave (ref :117-120); accept at
    dist <= TH_HIGH.
    """
    r0 = torch.where(proj.view_cos > 0.998, 2.5, 4.0)
    radius = r0 * th * scale_factors[proj.level]            # (M,)

    du = torch.abs(proj.uv[:, 0:1] - feat_xy[None, :, 0])
    dv = torch.abs(proj.uv[:, 1:2] - feat_xy[None, :, 1])
    window = (du < radius[:, None]) & (dv < radius[:, None])

    oct_ok = (
        (feat_octave[None, :] >= proj.level[:, None] - 1)
        & (feat_octave[None, :] <= proj.level[:, None])
    )
    # stereo right-coordinate gate (ref :91-96)
    has_r = feat_ur[None, :] >= 0
    er = torch.abs(proj.ur[:, None] - feat_ur[None, :])
    r_ok = ~has_r | (er < radius[:, None])

    compat = (
        window & oct_ok & r_ok
        & proj.in_frustum[:, None] & feat_free[None, :]
    )
    dist = hamming.distance_matrix(pt_desc, feat_desc)
    d = torch.where(compat, dist, hamming.MAX_DIST)
    best_idx = torch.argmin(d, 1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], hamming.MAX_DIST)
    second_idx = torch.argmin(d2, 1)
    second = torch.gather(d2, 1, second_idx[:, None])[:, 0]
    same_level = feat_octave[best_idx] == feat_octave[second_idx]
    ratio_ok = ~same_level | (best.float() <= ratio * second.float())

    ok = proj.in_frustum & (best <= TH_HIGH) & ratio_ok
    ok = ok & resolve_duplicates(best_idx, best, ok, feat_xy.shape[0])
    return Matches(best_idx, best, ok)


# ---------------------------------------------------------------------------
# SearchByProjection — motion model (ref: src/ORBmatcher.cc:1328-1470)
# ---------------------------------------------------------------------------

def octave_gate(last_octave, feat_octave, forward, backward):
    """The forward/backward octave gate (ref: src/ORBmatcher.cc:1381-1401):
    forward -> octave >= last octave; backward -> octave <= last; else a
    +/-1 band.  `forward`/`backward` are Python bools or 0-dim bool
    tensors."""
    lo = last_octave[:, None]
    fo = feat_octave[None, :]
    band = (fo >= lo - 1) & (fo <= lo + 1)
    if not torch.is_tensor(forward):
        return fo >= lo if forward else (fo <= lo if backward else band)
    return torch.where(forward, fo >= lo, torch.where(backward, fo <= lo,
                                                      band))


def search_last_frame(
    last_pts_w: torch.Tensor,     # (N, 3) world points bound to last frame
    last_has_pt: torch.Tensor,    # (N,) bool
    last_octave: torch.Tensor,    # (N,)
    last_desc: torch.Tensor,      # (N, 8) point descriptors
    last_angle: torch.Tensor,     # (N,) keypoint angles (deg)
    Tcw: torch.Tensor,
    feat_xy: torch.Tensor, feat_ur: torch.Tensor, feat_octave: torch.Tensor,
    feat_desc: torch.Tensor, feat_angle: torch.Tensor,
    feat_valid: torch.Tensor,
    fx, fy, cx, cy, bf,
    bounds: torch.Tensor,
    scale_factors: torch.Tensor,
    th,
    forward: bool = False,
    backward: bool = False,
    check_rotation: bool = True,
) -> Matches:
    """Project last frame's map points into the current frame and match.

    Octave gating follows the reference's forward/backward motion logic;
    stereo gate |ur - ur_pred| < r.  Accept at TH_HIGH, then the
    rotation-histogram filter.
    """
    dev = last_pts_w.device
    fx, fy, cx, cy, bf = (consts.scalar(v, dev) for v in (fx, fy, cx, cy, bf))
    pc, u, v, ur = _project(last_pts_w, Tcw, fx, fy, cx, cy, bf)
    vis = last_has_pt & (pc[:, 2] > 0) & _in_bounds(u, v, bounds)
    radius = th * scale_factors[last_octave.long()]          # (N,)

    du = torch.abs(u[:, None] - feat_xy[None, :, 0])
    dv = torch.abs(v[:, None] - feat_xy[None, :, 1])
    window = (du < radius[:, None]) & (dv < radius[:, None])
    oct_ok = octave_gate(last_octave, feat_octave, forward, backward)
    has_r = feat_ur[None, :] >= 0
    r_ok = ~has_r | (torch.abs(ur[:, None] - feat_ur[None, :])
                     < radius[:, None])

    compat = window & oct_ok & r_ok & vis[:, None] & feat_valid[None, :]
    dist = hamming.distance_matrix(last_desc, feat_desc)
    best_idx, best, _ = _best_two(dist, compat)
    ok = vis & (best <= TH_HIGH)

    if check_rotation:
        ok = hamming.rotation_histogram_filter(
            last_angle, feat_angle[best_idx], ok
        )
    ok = ok & resolve_duplicates(best_idx, best, ok, feat_xy.shape[0])
    return Matches(best_idx, best, ok)


# ---------------------------------------------------------------------------
# SearchByBoW (ref: src/ORBmatcher.cc:159-288 and :522-655)
# ---------------------------------------------------------------------------

def search_by_nodes(
    desc_q: torch.Tensor, node_q: torch.Tensor, valid_q: torch.Tensor,
    angle_q: torch.Tensor,
    desc_t: torch.Tensor, node_t: torch.Tensor, valid_t: torch.Tensor,
    angle_t: torch.Tensor,
    ratio: float = 0.7,
    check_rotation: bool = True,
) -> Matches:
    """Vocabulary-node-aligned brute force: candidates share the same BoW
    node id (the FeatureVector alignment of the reference); TH_LOW accept,
    mNNratio test, rotation histogram.  With node ids all equal (-1
    without a vocabulary) this is full brute-force matching."""
    compat = (
        (node_q[:, None] == node_t[None, :])
        & valid_q[:, None] & valid_t[None, :]
    )
    dist = hamming.distance_matrix(desc_q, desc_t)
    best_idx, best, second = _best_two(dist, compat)
    ok = (
        valid_q & (best <= TH_LOW)
        & (best.float() < ratio * second.float())
    )
    if check_rotation:
        ok = hamming.rotation_histogram_filter(angle_q, angle_t[best_idx], ok)
    ok = ok & resolve_duplicates(best_idx, best, ok, desc_t.shape[0])
    return Matches(best_idx, best, ok)


# ---------------------------------------------------------------------------
# SearchForInitialization (ref: src/ORBmatcher.cc:405-520)
# ---------------------------------------------------------------------------

def search_for_initialization(
    xy1: torch.Tensor, desc1: torch.Tensor, octave1: torch.Tensor,
    angle1: torch.Tensor, valid1: torch.Tensor,
    xy2: torch.Tensor, desc2: torch.Tensor, octave2: torch.Tensor,
    angle2: torch.Tensor, valid2: torch.Tensor,
    window: float = 100.0,
    ratio: float = 0.9,
    check_rotation: bool = True,
) -> Matches:
    """Windowed level-0 matching for the monocular initializer
    (ref :405-520): both keypoints at octave 0, |dxy| < window, TH_LOW,
    ratio, rotation histogram."""
    du = torch.abs(xy1[:, 0:1] - xy2[None, :, 0])
    dv = torch.abs(xy1[:, 1:2] - xy2[None, :, 1])
    compat = (
        (du < window) & (dv < window)
        & (octave1[:, None] == 0) & (octave2[None, :] == 0)
        & valid1[:, None] & valid2[None, :]
    )
    dist = hamming.distance_matrix(desc1, desc2)
    best_idx, best, second = _best_two(dist, compat)
    ok = (
        valid1 & (best <= TH_LOW)
        & (best.float() < ratio * second.float())
    )
    if check_rotation:
        ok = hamming.rotation_histogram_filter(angle1, angle2[best_idx], ok)
    ok = ok & resolve_duplicates(best_idx, best, ok, xy2.shape[0])
    return Matches(best_idx, best, ok)


# ---------------------------------------------------------------------------
# SearchForTriangulation (ref: src/ORBmatcher.cc:657-823)
# ---------------------------------------------------------------------------

def search_for_triangulation(
    xy1: torch.Tensor, ur1: torch.Tensor, octave1: torch.Tensor,
    desc1: torch.Tensor, node1: torch.Tensor, angle1: torch.Tensor,
    free1: torch.Tensor,
    xy2: torch.Tensor, ur2: torch.Tensor, octave2: torch.Tensor,
    desc2: torch.Tensor, node2: torch.Tensor, angle2: torch.Tensor,
    free2: torch.Tensor,
    F12: torch.Tensor,
    epipole2: torch.Tensor,       # (..., 2) epipole of cam1 center in image 2
    scale_factors: torch.Tensor,
    level_sigma2: torch.Tensor,
    check_rotation: bool = True,
) -> Matches:
    """Epipolar-constrained matching of unbound keypoints between two
    keyframes for triangulation: node-aligned candidates, epipolar
    distance < 3.84 * sigma^2 at kp2's octave (ref CheckDistEpipolarLine
    :140-157), epipole proximity reject for mono kps (ref :743-749),
    TH_LOW, rotation histogram.  Every input may carry the same leading
    batch dimensions (one keyframe pair each)."""
    compat = (
        (node1[..., :, None] == node2[..., None, :])
        & free1[..., :, None] & free2[..., None, :]
    )

    # epipolar line of kp1 in image 2: l = F12^T x1  (a,b,c)
    x1h = torch.cat([xy1, torch.ones_like(xy1[..., :1])], -1)   # (.., N1, 3)
    lines = x1h @ F12                                         # (.., N1, 3)
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    num = a * xy2[..., None, :, 0] + b * xy2[..., None, :, 1] + c
    den = a * a + b * b
    dsq = num * num / den.clamp(min=1e-12)
    epi_ok = dsq < 3.84 * level_sigma2[octave2.long()][..., None, :]

    # mono-mono pairs near the epipole are degenerate (ref :743-749)
    both_mono = (ur1[..., :, None] < 0) & (ur2[..., None, :] < 0)
    de = xy2 - epipole2[..., None, :]
    dist_ex = (de * de).sum(-1)                                # (.., N2)
    epi_far = (dist_ex[..., None, :]
               >= 100.0 * scale_factors[octave2.long()][..., None, :] ** 2)
    near_reject = both_mono & ~epi_far

    compat = compat & epi_ok & ~near_reject
    dist = hamming.distance_matrix(desc1, desc2)
    best_idx, best, _ = _best_two(dist, compat)
    ok = free1 & (best <= TH_LOW)
    if check_rotation:
        ok = hamming.rotation_histogram_filter(
            angle1, torch.gather(angle2, -1, best_idx), ok)
    ok = ok & resolve_duplicates(best_idx, best, ok, xy2.shape[-2])
    return Matches(best_idx, best, ok)


# ---------------------------------------------------------------------------
# Fuse (ref: src/ORBmatcher.cc:825-975)
# ---------------------------------------------------------------------------

class FuseMatches(NamedTuple):
    idx: torch.Tensor    # (M,) best feature index in the target keyframe
    dist: torch.Tensor   # (M,)
    ok: torch.Tensor     # (M,)


def fuse_points(
    pts_w: torch.Tensor, pt_mask: torch.Tensor, pt_desc: torch.Tensor,
    pt_normal: torch.Tensor, pt_min_dist: torch.Tensor,
    pt_max_dist: torch.Tensor,
    Tcw: torch.Tensor,
    feat_xy: torch.Tensor, feat_ur: torch.Tensor, feat_octave: torch.Tensor,
    feat_desc: torch.Tensor, feat_valid: torch.Tensor,
    fx, fy, cx, cy, bf,
    bounds: torch.Tensor,
    scale_factors: torch.Tensor,
    level_sigma2: torch.Tensor,
    log_scale_factor,
    n_levels: int,
    th: float = 3.0,
    use_stereo_residual: bool = True,
    view_cos_limit: float = 0.5,
) -> FuseMatches:
    """Project map points into a keyframe and find the best keypoint within
    a chi2-gated window for fusion (ref Fuse :825-975): frustum + distance
    band + view angle, radius th*sf[pred], octave band [pred-1, pred],
    reprojection chi2 < 5.99 (mono) / 7.8 (stereo) at the feature's octave,
    TH_LOW accept.  The caller decides replace-vs-add-observation.  The
    target keyframe's pose (..., 4, 4) and feature block (..., N, ...) may
    carry leading dims (one target each); the M map points are shared."""
    dev = pts_w.device
    fx, fy, cx, cy, bf, log_sf = (consts.scalar(v, dev) for v in
                                  (fx, fy, cx, cy, bf, log_scale_factor))
    # project_points, with the pose's leading dims (ref Frame::isInFrustum)
    R, t = Tcw[..., :3, :3], Tcw[..., :3, 3]
    pc = pts_w @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    z_safe = z.clamp(min=1e-6)
    u = fx * pc[..., 0] / z_safe + cx
    v = fy * pc[..., 1] / z_safe + cy
    ur = u - bf / z_safe
    Ow = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    po = pts_w - Ow[..., None, :]
    dist3 = torch.sqrt((po * po).sum(-1))
    dist_safe = dist3.clamp(min=1e-9)
    view_cos = (po * pt_normal).sum(-1) / dist_safe
    level = predict_level(pt_max_dist, dist_safe, log_sf, n_levels)
    in_frustum = (
        pt_mask & (z > 0) & _in_bounds(u, v, bounds)
        & (dist3 >= 0.8 * pt_min_dist) & (dist3 <= 1.2 * pt_max_dist)
        & (view_cos > view_cos_limit)
    )

    radius = th * scale_factors[level]
    du = u[..., :, None] - feat_xy[..., None, :, 0]
    dv = v[..., :, None] - feat_xy[..., None, :, 1]
    window = ((torch.abs(du) < radius[..., None])
              & (torch.abs(dv) < radius[..., None]))
    fo = feat_octave.long()[..., None, :]
    oct_ok = (fo >= level[..., :, None] - 1) & (fo <= level[..., :, None])
    inv_s2 = (1.0 / level_sigma2[feat_octave.long()])[..., None, :]
    has_r = feat_ur[..., None, :] >= 0
    if use_stereo_residual:
        der = ur[..., :, None] - feat_ur[..., None, :]
        e2_st = (du * du + dv * dv + der * der) * inv_s2
        e2_mo = (du * du + dv * dv) * inv_s2
        chi_ok = torch.where(has_r, e2_st <= 7.8, e2_mo <= 5.99)
    else:
        chi_ok = (du * du + dv * dv) * inv_s2 <= 5.99

    compat = (window & oct_ok & chi_ok & in_frustum[..., :, None]
              & feat_valid[..., None, :])
    dist = hamming.distance_matrix(pt_desc, feat_desc)
    best_idx, best, _ = _best_two(dist, compat)
    ok = in_frustum & (best <= TH_LOW)
    return FuseMatches(best_idx, best, ok)


# ---------------------------------------------------------------------------
# SearchByProjection — relocalization (ref: src/ORBmatcher.cc:1472-1599)
# and with a Sim3 pose — loop closing (ref: src/ORBmatcher.cc:290-403)
# ---------------------------------------------------------------------------

def _window_compat(pts_w, pc, Ow, pt_mask, pt_min_dist, pt_max_dist, band,
                   feat_xy, feat_octave, fx, fy, cx, cy, bounds,
                   scale_factors, log_sf, n_levels, th):
    """Shared body of the guided searches: project camera-frame points
    `pc`, gate on depth, bounds and the distance band
    [band[0]*minDist, band[1]*maxDist] from the camera centre `Ow`, and
    open a th-scaled window at the predicted octave +/-1.  Returns
    (compat (M, N), vis (M,))."""
    z = pc[:, 2]
    z_safe = z.clamp(min=1e-6)
    u = fx * pc[:, 0] / z_safe + cx
    v = fy * pc[:, 1] / z_safe + cy
    po = pts_w - Ow
    dist3d = torch.sqrt((po * po).sum(1))
    level = predict_level(pt_max_dist, dist3d.clamp(min=1e-9), log_sf,
                          n_levels)
    vis = (
        pt_mask & (z > 0) & _in_bounds(u, v, bounds)
        & (dist3d >= band[0] * pt_min_dist)
        & (dist3d <= band[1] * pt_max_dist)
    )
    radius = th * scale_factors[level]
    du = torch.abs(u[:, None] - feat_xy[None, :, 0])
    dv = torch.abs(v[:, None] - feat_xy[None, :, 1])
    window = (du < radius[:, None]) & (dv < radius[:, None])
    fo = feat_octave.long()[None, :]
    oct_ok = (fo >= level[:, None] - 1) & (fo <= level[:, None] + 1)
    return window & oct_ok & vis[:, None], vis


def search_reloc_points(
    pts_w: torch.Tensor,          # (M, 3) keyframe map points
    pt_mask: torch.Tensor,        # (M,) valid & not already found
    pt_desc: torch.Tensor,
    pt_min_dist: torch.Tensor, pt_max_dist: torch.Tensor,
    kf_angle: torch.Tensor,       # (M,) angle of the point's KF keypoint
    Tcw: torch.Tensor,
    feat_xy: torch.Tensor, feat_octave: torch.Tensor,
    feat_desc: torch.Tensor, feat_angle: torch.Tensor,
    feat_free: torch.Tensor,
    fx, fy, cx, cy,
    bounds: torch.Tensor,
    scale_factors: torch.Tensor,
    log_scale_factor,
    n_levels: int,
    th,
    orb_dist: int = 100,
    check_rotation: bool = True,
) -> Matches:
    """Guided reprojection for relocalization: project the candidate KF's
    points with the hypothesised pose, search a th-scaled window at the
    predicted octave +/-1, accept at `orb_dist` (ref :1472-1599)."""
    dev = pts_w.device
    fx, fy, cx, cy, log_sf = (consts.scalar(v, dev) for v in
                              (fx, fy, cx, cy, log_scale_factor))
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    compat, vis = _window_compat(
        pts_w, pts_w @ R.T + t, -R.T @ t, pt_mask, pt_min_dist,
        pt_max_dist, (0.8, 1.2), feat_xy, feat_octave, fx, fy, cx, cy,
        bounds, scale_factors, log_sf, n_levels, th)
    dist = hamming.distance_matrix(pt_desc, feat_desc)
    best_idx, best, _ = _best_two(dist, compat & feat_free[None, :])
    ok = vis & (best <= orb_dist)
    if check_rotation:
        ok = hamming.rotation_histogram_filter(
            kf_angle, feat_angle[best_idx], ok
        )
    ok = ok & resolve_duplicates(best_idx, best, ok, feat_xy.shape[0])
    return Matches(best_idx, best, ok)


def search_by_sim3_projection(
    pts_w: torch.Tensor, pt_mask: torch.Tensor, pt_desc: torch.Tensor,
    pt_min_dist: torch.Tensor, pt_max_dist: torch.Tensor,
    Scw_R: torch.Tensor, Scw_t: torch.Tensor, Scw_s: torch.Tensor,
    feat_xy: torch.Tensor, feat_octave: torch.Tensor,
    feat_desc: torch.Tensor, feat_free: torch.Tensor,
    fx, fy, cx, cy,
    bounds: torch.Tensor,
    scale_factors: torch.Tensor,
    log_scale_factor,
    n_levels: int,
    th=10.0,
    accept_dist: int = TH_LOW,
) -> Matches:
    """SearchByProjection with a Sim3 camera pose (ref :290-403), used to
    attach loop-map points to the current keyframe.  The scale s divides
    out of the projection; the distance band uses the descaled center."""
    dev = pts_w.device
    fx, fy, cx, cy, log_sf = (consts.scalar(v, dev) for v in
                              (fx, fy, cx, cy, log_scale_factor))
    pc = (pts_w @ Scw_R.T) * Scw_s + Scw_t[None, :]
    Ow = -(Scw_R.T @ Scw_t) / Scw_s.clamp(min=1e-12)
    compat, vis = _window_compat(
        pts_w, pc, Ow, pt_mask, pt_min_dist, pt_max_dist, (1.0, 1.0),
        feat_xy, feat_octave, fx, fy, cx, cy, bounds, scale_factors,
        log_sf, n_levels, th)
    dist = hamming.distance_matrix(pt_desc, feat_desc)
    best_idx, best, _ = _best_two(dist, compat & feat_free[None, :])
    ok = vis & (best <= accept_dist)
    ok = ok & resolve_duplicates(best_idx, best, ok, feat_xy.shape[0])
    return Matches(best_idx, best, ok)


def search_by_sim3_mutual(
    pts1_w: torch.Tensor, mask1: torch.Tensor, desc1: torch.Tensor,
    min1: torch.Tensor, max1: torch.Tensor, octave1: torch.Tensor,
    xy1: torch.Tensor,
    pts2_w: torch.Tensor, mask2: torch.Tensor, desc2: torch.Tensor,
    min2: torch.Tensor, max2: torch.Tensor, octave2: torch.Tensor,
    xy2: torch.Tensor,
    T1w: torch.Tensor, T2w: torch.Tensor,
    S12_R: torch.Tensor, S12_t: torch.Tensor, S12_s: torch.Tensor,
    fx, fy, cx, cy,
    bounds: torch.Tensor,
    scale_factors: torch.Tensor,
    log_scale_factor,
    n_levels: int,
    th=7.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SearchBySim3 (ref :1102-1326): project KF1 points into KF2 via
    S21 and KF2 points into KF1 via S12; keep agreements.  Returns
    (match12 (N1,) int64 index into KF2 or -1, ok (N1,) bool)."""
    dev = pts1_w.device
    fx, fy, cx, cy, log_sf = (consts.scalar(v, dev) for v in
                              (fx, fy, cx, cy, log_scale_factor))
    s21 = 1.0 / S12_s.clamp(min=1e-12)
    R21 = S12_R.T
    t21 = -s21 * (R21 @ S12_t)
    origin = torch.zeros(3, dtype=pts1_w.dtype, device=dev)

    def project_side(pts_w, Tw, Rrel, trel, srel, min_d, max_d,
                     feat_xy, feat_oct, mask):
        pc_own = pts_w @ Tw[:3, :3].T + Tw[:3, 3]
        pc = (pc_own @ Rrel.T) * srel + trel[None, :]
        # the band is measured in the other camera's frame, from its centre
        return _window_compat(
            pc, pc, origin, mask, min_d, max_d, (1.0, 1.0), feat_xy,
            feat_oct, fx, fy, cx, cy, bounds, scale_factors, log_sf,
            n_levels, th)

    compat12, vis1 = project_side(
        pts1_w, T1w, R21, t21, s21, min1, max1, xy2, octave2, mask1
    )
    compat21, vis2 = project_side(
        pts2_w, T2w, S12_R, S12_t, S12_s, min2, max2, xy1, octave1, mask2
    )

    dist = hamming.distance_matrix(desc1, desc2)
    compat12 = compat12 & mask2[None, :]
    compat21 = compat21 & mask1[None, :]
    idx12, best12, _ = _best_two(dist, compat12)
    idx21, best21, _ = _best_two(dist.T, compat21)

    ok12 = vis1 & (best12 <= TH_HIGH)
    ok21 = vis2 & (best21 <= TH_HIGH)
    # mutual agreement (ref :1296-1306)
    agree = ok12 & ok21[idx12] & (
        idx21[idx12] == torch.arange(idx12.shape[0], device=dev))
    return torch.where(agree, idx12, -1), agree


def to_host(m: Matches):
    """Pull a Matches result with ONE device-to-host copy (pack, then
    split): (idx int32, dist int32, ok bool) numpy arrays."""
    packed = torch.cat([m.idx.int(), m.dist.int(), m.ok.int()])
    arr = packed.cpu().numpy()
    q = arr.shape[0] // 3
    return arr[:q], arr[q:2 * q], arr[2 * q:] > 0


# ---------------------------------------------------------------------------
# Batched-over-keyframes variants: local mapping issues one device call
# for ALL covisible neighbors instead of one per neighbor.
# ---------------------------------------------------------------------------

def fuse_points_batch(
    pts_w, pt_mask, pt_desc, pt_normal, pt_min_dist, pt_max_dist,
    Tcw_b,                      # (B, 4, 4) target keyframe poses
    feat_xy_b, feat_ur_b, feat_octave_b, feat_desc_b, feat_valid_b,
    kf_mask_b,                  # (B,) bool valid targets
    fx, fy, cx, cy, bf,
    bounds, scale_factors, level_sigma2,
    log_scale_factor, n_levels,
    th=3.0,
) -> torch.Tensor:
    """fuse_points over B target keyframes in one batched call; returns
    the packed float32 [idx (B*M), ok (B*M)]."""
    fm = fuse_points(
        pts_w, pt_mask & kf_mask_b[:, None], pt_desc, pt_normal,
        pt_min_dist, pt_max_dist, Tcw_b, feat_xy_b, feat_ur_b,
        feat_octave_b, feat_desc_b, feat_valid_b, fx, fy, cx, cy, bf,
        bounds, scale_factors, level_sigma2, log_scale_factor, n_levels, th)
    ok = fm.ok & kf_mask_b[:, None]
    return torch.cat([fm.idx.float().reshape(-1), ok.float().reshape(-1)])


def fuse_points_gather(
    pts_w, pt_mask, pt_desc, pt_normal, pt_min_dist, pt_max_dist,
    Tcw_b,                      # (B, 4, 4) target keyframe poses
    ids_b,                      # (B,) mirror row ids of the targets
    mir_f32, mir_i32, mir_desc, mir_valid,   # slam/kf_mirror fields
    kf_mask_b,                  # (B,) bool valid targets
    fx, fy, cx, cy, bf,
    bounds, scale_factors, level_sigma2,
    log_scale_factor, n_levels,
    th=3.0,
) -> torch.Tensor:
    """fuse_points_batch with the target feature blocks gathered from the
    device-resident keyframe mirror: the host uploads the candidate-point
    blocks, poses and a (B,) index vector."""
    ids_b = ids_b.long()
    f2 = mir_f32[ids_b]
    return fuse_points_batch(
        pts_w, pt_mask, pt_desc, pt_normal, pt_min_dist, pt_max_dist,
        Tcw_b, f2[..., 0:2], f2[..., 2], mir_i32[ids_b][..., 0],
        mir_desc[ids_b], mir_valid[ids_b], kf_mask_b,
        fx, fy, cx, cy, bf, bounds, scale_factors, level_sigma2,
        log_scale_factor, n_levels, th,
    )


def unpack_fuse_batch(packed, B, M):
    """(idx (B, M) int32, ok (B, M) bool) from a packed fuse result (a
    HostCopy, a tensor or an array)."""
    buf = to_numpy(packed)
    idx = buf[: B * M].reshape(B, M).astype(np.int32)
    ok = buf[B * M:].reshape(B, M) > 0.5
    return idx, ok
