"""Batched DLT triangulation + the reference's new-point validity gates.

Port of orb_slam2_tpu/solvers/triangulation.py: the SVD triangulation of
LocalMapping::CreateNewMapPoints (ref: src/LocalMapping.cc:322-331) and
Initializer::Triangulate (ref: src/Initializer.cc:734-754), vectorized over
all candidate pairs at once.  Where the JAX package vmaps over B neighbour
keyframes, every tensor here carries a leading B dimension.

Divisions by the intrinsics are by 0-dim device tensors (ops/consts.py),
and the batched 3x3 solve is `torch.linalg.solve_ex`, which checks
nothing on the host: no stage waits on the device until its result is
pulled.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_tpu_torch.ops import consts, matching
from orb_slam2_tpu_torch.utils import to_numpy


def triangulate_dlt(
    P1: torch.Tensor, P2: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor
) -> torch.Tensor:
    """DLT triangulation.

    P1, P2: (..., 3, 4) projection matrices.
    xy1, xy2: (..., N, 2) pixel (or normalized) coords in each view.
    Returns (..., N, 3) world points (NaN-free; w==0 gives large values).
    """
    x1, y1 = xy1[..., 0], xy1[..., 1]
    x2, y2 = xy2[..., 0], xy2[..., 1]
    P1b = P1[..., None, :, :]
    P2b = P2[..., None, :, :]
    rows = torch.broadcast_tensors(
        x1[..., None] * P1b[..., 2, :] - P1b[..., 0, :],
        y1[..., None] * P1b[..., 2, :] - P1b[..., 1, :],
        x2[..., None] * P2b[..., 2, :] - P2b[..., 0, :],
        y2[..., None] * P2b[..., 2, :] - P2b[..., 1, :],
    )
    A = torch.stack(rows, -2)                          # (..., N, 4, 4)
    # Inhomogeneous DLT: fix the homogeneous scale w=1 and solve the
    # 4x3 least-squares A[:, :3] X = -A[:, 3] via 3x3 normal equations
    # (equivalent to the reference's SVD null-vector for finite points;
    # points at infinity blow up and fail the gates downstream).
    M = A[..., :, :3]                                  # (..., 4, 3)
    b = -A[..., :, 3]                                  # (..., 4)
    MtM = M.transpose(-1, -2) @ M                      # (..., 3, 3)
    Mtb = (M.transpose(-1, -2) @ b[..., None])[..., 0]
    # tiny diagonal ridge keeps degenerate (parallel-ray) systems finite;
    # their solutions fail the reprojection gates anyway
    tr = torch.diagonal(MtM, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    ridge = 1e-9 * tr.clamp(min=1e-12) * eye
    return torch.linalg.solve_ex(MtM + ridge, Mtb[..., None])[0][..., 0]


class NewPoints(NamedTuple):
    pts_w: torch.Tensor     # (..., N, 3) world points
    good: torch.Tensor      # (..., N) bool — passed all gates


def _intrinsics(device, fx, fy, cx, cy, bf):
    return tuple(consts.scalar(v, device) for v in (fx, fy, cx, cy, bf))


def _K(fx, fy, cx, cy):
    z = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack([torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
                        torch.stack([z, z, one])])


def _mv(A, x):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (A @ x[..., None])[..., 0]


def triangulate_and_gate(
    T1w: torch.Tensor, T2w: torch.Tensor,
    xy1: torch.Tensor, xy2: torch.Tensor,          # (..., N, 2) pairs
    ur1: torch.Tensor, ur2: torch.Tensor,          # (..., N) right-u; <0 mono
    depth1: torch.Tensor, depth2: torch.Tensor,    # (..., N) depth; <0 none
    octave1: torch.Tensor, octave2: torch.Tensor,  # (..., N)
    mask: torch.Tensor,                            # (..., N) candidate valid
    fx, fy, cx, cy, bf,
    scale_factors: torch.Tensor,
    level_sigma2: torch.Tensor,
) -> NewPoints:
    """Triangulate matched keypoint pairs between two keyframes and apply
    the reference's acceptance gates (ref: src/LocalMapping.cc:288-431):
    parallax-based DLT-vs-stereo-unprojection choice, positive depth in
    both views, per-view chi2 reprojection bounds (5.991 mono / 7.8
    stereo), and scale-consistency of the distance ratio.  The poses
    carry the same leading dims as the per-point inputs."""
    fx, fy, cx, cy, bf = _intrinsics(xy1.device, fx, fy, cx, cy, bf)
    R1, t1 = T1w[..., :3, :3], T1w[..., :3, 3]
    R2, t2 = T2w[..., :3, :3], T2w[..., :3, 3]
    O1 = -_mv(R1.transpose(-1, -2), t1)
    O2 = -_mv(R2.transpose(-1, -2), t2)
    baseline = torch.linalg.vector_norm(O2 - O1, dim=-1)[..., None]

    # normalized rays in world frame
    one = torch.ones_like(xy1[..., 0])
    xn1 = torch.stack([(xy1[..., 0] - cx) / fx, (xy1[..., 1] - cy) / fy,
                       one], -1)
    xn2 = torch.stack([(xy2[..., 0] - cx) / fx, (xy2[..., 1] - cy) / fy,
                       one], -1)
    ray1 = xn1 @ R1                      # R1^T @ xn1 rowwise
    ray2 = xn2 @ R2
    cos_rays = (ray1 * ray2).sum(-1) / (
        torch.linalg.vector_norm(ray1, dim=-1)
        * torch.linalg.vector_norm(ray2, dim=-1)).clamp(min=1e-12)

    has_s1 = depth1 > 0
    has_s2 = depth2 > 0
    cos_s1 = torch.where(has_s1, torch.cos(2.0 * torch.atan2(
        baseline / 2.0, depth1.clamp(min=1e-9))), 2.0)
    cos_s2 = torch.where(has_s2, torch.cos(2.0 * torch.atan2(
        baseline / 2.0, depth2.clamp(min=1e-9))), 2.0)
    cos_stereo = torch.minimum(cos_s1, cos_s2)

    use_dlt = (
        (cos_rays < cos_stereo) & (cos_rays > 0)
        & (has_s1 | has_s2 | (cos_rays < 0.9998))
    )
    use_s1 = ~use_dlt & has_s1 & (cos_s1 < cos_s2)
    use_s2 = ~use_dlt & ~use_s1 & has_s2

    # DLT triangulation with projective P = K [R|t]
    K = _K(fx, fy, cx, cy)
    P1 = K @ T1w[..., :3, :]
    P2 = K @ T2w[..., :3, :]
    pts_dlt = triangulate_dlt(P1, P2, xy1, xy2)

    # stereo unprojection fallbacks
    z1 = depth1.clamp(min=1e-9)
    pc1 = torch.stack([(xy1[..., 0] - cx) / fx * z1,
                       (xy1[..., 1] - cy) / fy * z1, z1], -1)
    pw_s1 = (pc1 - t1[..., None, :]) @ R1          # R1^T (pc - t)
    z2 = depth2.clamp(min=1e-9)
    pc2s = torch.stack([(xy2[..., 0] - cx) / fx * z2,
                        (xy2[..., 1] - cy) / fy * z2, z2], -1)
    pw_s2 = (pc2s - t2[..., None, :]) @ R2

    pts = torch.where(use_s1[..., None], pw_s1,
                      torch.where(use_s2[..., None], pw_s2, pts_dlt))

    # gates
    pc1_all = pts @ R1.transpose(-1, -2) + t1[..., None, :]
    pc2_all = pts @ R2.transpose(-1, -2) + t2[..., None, :]
    pos = (pc1_all[..., 2] > 0) & (pc2_all[..., 2] > 0)

    s2_1 = level_sigma2[octave1.long()]
    s2_2 = level_sigma2[octave2.long()]

    def reproj_err(pc, xy, ur, s2):
        zs = pc[..., 2].clamp(min=1e-9)
        u = fx * pc[..., 0] / zs + cx
        v = fy * pc[..., 1] / zs + cy
        e_mono = ((u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2) / s2
        urp = u - bf / zs
        e_st = e_mono + (urp - ur) ** 2 / s2
        return e_mono, e_st

    e1m, e1s = reproj_err(pc1_all, xy1, ur1, s2_1)
    e2m, e2s = reproj_err(pc2_all, xy2, ur2, s2_2)
    chi_ok1 = torch.where(has_s1, e1s <= 7.8, e1m <= 5.991)
    chi_ok2 = torch.where(has_s2, e2s <= 7.8, e2m <= 5.991)

    d1 = torch.linalg.vector_norm(pts - O1[..., None, :], dim=-1)
    d2 = torch.linalg.vector_norm(pts - O2[..., None, :], dim=-1)
    ratio_dist = d2 / d1.clamp(min=1e-12)
    ratio_oct = scale_factors[octave1.long()] / scale_factors[octave2.long()]
    scale_ok = (
        (ratio_dist * 1.5 > ratio_oct) & (ratio_dist < ratio_oct * 1.5)
        & (d1 > 1e-9) & (d2 > 1e-9)
    )

    good = mask & (use_dlt | use_s1 | use_s2) & pos \
        & chi_ok1 & chi_ok2 & scale_ok
    return NewPoints(pts, good)


def _skew(t):
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1)], -2)


def fundamental_from_poses(T1w, T2w, K1, K2):
    """F12 = K1^-T [t12]x R12 K2^-1 (ref: LocalMapping::ComputeF12
    src/LocalMapping.cc:536-554); leading dims broadcast."""
    R1, t1 = T1w[..., :3, :3], T1w[..., :3, 3]
    R2, t2 = T2w[..., :3, :3], T2w[..., :3, 3]
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = -_mv(R12, t2) + t1
    K1i = torch.linalg.inv_ex(K1)[0]
    K2i = torch.linalg.inv_ex(K2)[0]
    return K1i.transpose(-1, -2) @ _skew(t12) @ R12 @ K2i


def _triangulate_core(
    T1w,
    xy1, ur1, depth1, octave1, desc1, node1, angle1, free1,   # (N,...)
    T2w_b,                     # (B,4,4) neighbor poses
    xy2_b, ur2_b, depth2_b, octave2_b, desc2_b, node2_b, angle2_b,
    free2_b,                   # (B,N,...)
    nb_mask,                   # (B,) bool valid neighbors
    fx, fy, cx, cy, bf,
    scale_factors, level_sigma2,
):
    """CreateNewMapPoints over ALL covisible neighbors at once: per
    neighbor, F12 + epipole, the epipolar search, triangulation and the
    gates, as tensors with a leading B.  Returns the packed float32
    buffer [idx (B*N), ok (B*N), pts (B*N*3)]."""
    fx, fy, cx, cy, bf = _intrinsics(xy1.device, fx, fy, cx, cy, bf)
    B = T2w_b.shape[0]
    K = _K(fx, fy, cx, cy)
    R1, t1 = T1w[:3, :3], T1w[:3, 3]
    O1 = -_mv(R1.T, t1)

    def ex(a):   # the current keyframe's block, once per neighbour (a view)
        return a.expand(B, *a.shape)

    F12 = fundamental_from_poses(ex(T1w), T2w_b, K, K)          # (B,3,3)
    pc = _mv(T2w_b[:, :3, :3], ex(O1)) + T2w_b[:, :3, 3]         # (B,3)
    z = pc[:, 2].clamp(min=1e-9)
    epipole = torch.stack([fx * pc[:, 0] / z + cx,
                           fy * pc[:, 1] / z + cy], -1)         # (B,2)
    m = matching.search_for_triangulation(
        ex(xy1), ex(ur1), ex(octave1), ex(desc1), ex(node1), ex(angle1),
        free1[None, :] & nb_mask[:, None],
        xy2_b, ur2_b, octave2_b, desc2_b, node2_b, angle2_b, free2_b,
        F12, epipole, scale_factors, level_sigma2,
    )
    idx = m.idx

    def take(a):     # a (B, N, ...) gathered at the match of each row
        ix = idx.reshape(*idx.shape, *([1] * (a.dim() - 2)))
        return torch.gather(a, 1, ix.expand(*idx.shape, *a.shape[2:]))

    res = triangulate_and_gate(
        ex(T1w), T2w_b, ex(xy1), take(xy2_b), ex(ur1), take(ur2_b),
        ex(depth1), take(depth2_b), ex(octave1), take(octave2_b),
        m.ok, fx, fy, cx, cy, bf, scale_factors, level_sigma2,
    )
    good = res.good & nb_mask[:, None]
    return torch.cat([
        idx.float().reshape(-1),
        good.float().reshape(-1),
        res.pts_w.reshape(-1),
    ])


def triangulate_batch(
    T1w,                       # (4,4) current keyframe pose
    xy1, ur1, depth1, octave1, desc1, node1, angle1, free1,   # (N,...)
    T2w_b,                     # (B,4,4) neighbor poses
    xy2_b, ur2_b, depth2_b, octave2_b, desc2_b, node2_b, angle2_b,
    free2_b,                   # (B,N,...)
    nb_mask,                   # (B,) bool valid neighbors
    fx, fy, cx, cy, bf,
    scale_factors, level_sigma2,
):
    """Stacked-array entry point (the mirror-overflow path)."""
    return _triangulate_core(
        T1w, xy1, ur1, depth1, octave1, desc1, node1, angle1, free1,
        T2w_b, xy2_b, ur2_b, depth2_b, octave2_b, desc2_b, node2_b,
        angle2_b, free2_b, nb_mask, fx, fy, cx, cy, bf,
        scale_factors, level_sigma2,
    )


def triangulate_gather(
    T1w, T2w_b,                # (4,4) current pose, (B,4,4) neighbors
    kf1: int, ids_b,           # mirror row of the current KF + (B,) rows
    node1,                     # (N,) current-KF BoW nodes (passed
                               # explicitly: the mirror row may hold
                               # nodes assigned after its upload)
    mir_f32, mir_i32, mir_desc,   # kf_mirror.KfFeatureMirror fields
    free1, free2_b,            # (N,), (B,N) host masks (obs-dependent)
    nb_mask,                   # (B,)
    fx, fy, cx, cy, bf,
    scale_factors, level_sigma2,
):
    """Mirror entry point: the per-keyframe feature blocks are gathered
    from the device-resident mirror; the host uploads only poses, index
    vectors and the free-slot masks (see slam/kf_mirror.py)."""
    ids_b = ids_b.long()
    f1 = mir_f32[kf1]
    f2 = mir_f32[ids_b]
    i2 = mir_i32[ids_b]
    return _triangulate_core(
        T1w,
        f1[:, 0:2], f1[:, 2], f1[:, 3], mir_i32[kf1][:, 0], mir_desc[kf1],
        node1, f1[:, 4], free1,
        T2w_b,
        f2[..., 0:2], f2[..., 2], f2[..., 3], i2[..., 0], mir_desc[ids_b],
        i2[..., 1], f2[..., 4], free2_b, nb_mask,
        fx, fy, cx, cy, bf, scale_factors, level_sigma2,
    )


def unpack_triangulate_batch(packed, B, N):
    """(idx (B, N) int32, good (B, N) bool, pts (B, N, 3)) from a packed
    result (a HostCopy, a tensor or an array)."""
    buf = to_numpy(packed)
    idx = buf[: B * N].reshape(B, N).astype(np.int32)
    good = buf[B * N: 2 * B * N].reshape(B, N) > 0.5
    pts = buf[2 * B * N:].reshape(B, N, 3)
    return idx, good, pts
