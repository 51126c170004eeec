"""Batched descriptor matching: the tracking matchers as masked matrices.

Port of orb_slam2_tpu/ops/matching.py, the part the stereo tracking path
uses (ref: ORBmatcher::SearchByProjection, src/ORBmatcher.cc:45-129 and
:1328-1470, and Frame::isInFrustum, src/Frame.cc:269-325).  Every mode
is a masked (Q, T) packed-Hamming distance matrix with window / octave /
stereo compatibility masks, a row-wise (best, second) reduction, the
reference's ratio test and rotation-histogram filter, and a scatter-min
that keeps one claiming query per target feature.

The relocalization, triangulation, fuse and Sim3 matchers are not ported
yet (ROADMAP items 3 and 6).  The fused tracking step
(slam/track_step.py) inlines the same logic as these functions.

All functions take fixed-shape padded tensors + validity masks and read
nothing back to the host.  Scalars (fx, fy, cx, cy, bf, the log scale
factor) may be 0-dim device tensors or Python numbers; the latter become
such tensors once (ops/consts.py), so every division is a true division
on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.ops import consts, hamming

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
    scatter_reduce's "amin".
    """
    q = idx.shape[0]
    key = dist.int() * q + torch.arange(q, dtype=torch.int32,
                                         device=idx.device)
    key = torch.where(ok, key, _BIG)
    best_key = torch.full((n_targets,), _BIG, dtype=torch.int32,
                          device=idx.device).scatter_reduce(
        0, idx.long(), key, reduce="amin", include_self=True)
    return ok & (best_key[idx] == key)


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


def to_host(m: Matches):
    """Pull a Matches result with ONE device-to-host copy (pack, then
    split): (idx int32, dist int32, ok bool) numpy arrays."""
    packed = torch.cat([m.idx.int(), m.dist.int(), m.ok.int()])
    arr = packed.cpu().numpy()
    q = arr.shape[0] // 3
    return arr[:q], arr[q:2 * q], arr[2 * q:] > 0

