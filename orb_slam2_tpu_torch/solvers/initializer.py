"""Monocular map initialization: batched H/F RANSAC + reconstruction.

Port of orb_slam2_tpu/solvers/initializer.py, the batched replacement for
Initializer (ref: src/Initializer.cc): the reference races a homography
thread against a fundamental thread over 200 pre-sampled 8-point sets;
here both models are estimated for ALL 200 sets at once as one batched
SVD, scored densely over all matches, the model is chosen by
RH = SH/(SH+SF) > 0.40 (ref :112-118), and all 12 candidate motions (8
from Faugeras homography decomposition, 4 from the essential matrix) are
cheirality-checked in one batch.

SVD bases differ between LAPACK builds and cuSOLVER: the 12 hypotheses
form the same set under sign flips of paired singular vectors, possibly
in another order, so the winner is picked by its score and only the
chosen R21, t21, good_mask and points3d are comparable across backends.
Where JAX returns inf / nan (the inverse of a singular sample's H, an SVD
of non-finite input) torch raises; here such a matrix comes out NaN
instead (`_svd`, `_inv`), and its sample or hypothesis loses the score.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_tpu_torch.solvers.triangulation import triangulate_dlt
from orb_slam2_tpu_torch.utils import take_row

SIGMA = 1.0
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # both checks accumulate against 5.991 (ref :305-468)
N_RANSAC = 200    # ref: mMaxIterations = 200 (src/Initializer.cc:41)


class InitResult(NamedTuple):
    success: torch.Tensor     # () bool
    R21: torch.Tensor         # (3, 3)
    t21: torch.Tensor         # (3,)
    points3d: torch.Tensor    # (N, 3) in camera-1 frame
    good_mask: torch.Tensor   # (N,) bool triangulated inliers
    used_homography: torch.Tensor  # () bool


def _finite(A: torch.Tensor) -> torch.Tensor:
    """(...) True where the trailing matrix holds no inf / nan."""
    return torch.isfinite(A).all(-1).all(-1)


def _svd(A: torch.Tensor, full_matrices: bool = False):
    """`torch.linalg.svd` that gives NaN factors for a matrix with a
    non-finite entry instead of raising, as the JAX package's SVD does."""
    ok = _finite(A)
    u, s, vt = torch.linalg.svd(torch.where(ok[..., None, None], A, 0.0),
                                full_matrices=full_matrices)
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(ok[..., None, None], u, nan),
            torch.where(ok[..., None], s, nan),
            torch.where(ok[..., None, None], vt, nan))


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse that is NaN for a singular matrix (JAX's gives inf / nan;
    `torch.linalg.inv` raises on the CPU)."""
    inv, info = torch.linalg.inv_ex(A)
    ok = (info == 0) & _finite(inv)
    return torch.where(ok[..., None, None], inv, float("nan"))


def _normalize(xy: torch.Tensor, mask: torch.Tensor):
    """Mean/abs-dev normalization (ref: Initializer::Normalize :694-731)."""
    m = mask.to(xy.dtype)[:, None]
    n = m.sum().clamp(min=1.0)
    mean = (xy * m).sum(0) / n
    dev = ((xy - mean).abs() * m).sum(0) / n
    s = 1.0 / dev.clamp(min=1e-9)
    xyn = (xy - mean) * s
    z = torch.zeros_like(s[0])
    one = torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, one]),
    ])
    return xyn, T


def _h_rows(p1: torch.Tensor, p2: torch.Tensor):
    """The two DLT rows of each correspondence (ref ComputeH21 :226)."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    return r1, r2


def _f_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """The 8-point row of each correspondence (ref ComputeF21 :268)."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(u1)
    return torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1)


def _rank2(Fpre: torch.Tensor) -> torch.Tensor:
    """Project onto rank 2 by zeroing the smallest singular value."""
    u, s, vt2 = _svd(Fpre)
    s = s * torch.tensor([1.0, 1.0, 0.0], dtype=s.dtype, device=s.device)
    return u @ (s[..., None] * vt2)


def _homography_dlt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(S, 8, 2) x2 -> (S, 3, 3) H mapping p1 -> p2 (ref ComputeH21 :226)."""
    r1, r2 = _h_rows(p1, p2)
    A = torch.cat([r1, r2], -2)                   # (S, 16, 9)
    _, _, vt = _svd(A)
    return vt[..., 8, :].reshape(p1.shape[:-2] + (3, 3))


def _fundamental_8pt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(S, 8, 2) x2 -> (S, 3, 3) F with rank-2 (ref ComputeF21 :268).
    A is (S, 8, 9): full_matrices=True gives the ninth right singular
    vector, the null vector."""
    _, _, vt = _svd(_f_rows(p1, p2), full_matrices=True)
    return _rank2(vt[..., 8, :].reshape(p1.shape[:-2] + (3, 3)))


def _refit_h(xy1n, xy2n, w):
    """Weighted DLT homography over all inliers (refinement the reference
    lacks — the minimal 8-point model is noisy; a full-inlier least-squares
    refit before decomposition measurably improves R, t)."""
    r1, r2 = _h_rows(xy1n, xy2n)
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]], 0)
    _, _, vt = _svd(A)
    return vt[8].reshape(3, 3)


def _refit_f(xy1n, xy2n, w):
    """Weighted 8-point fundamental over all inliers with rank-2 projection."""
    _, _, vt = _svd(_f_rows(xy1n, xy2n) * w[:, None])
    return _rank2(vt[8].reshape(3, 3))


def _homogeneous(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], -1)


def _score_h(H21, H12, xy1, xy2, mask, sigma2):
    """Symmetric transfer score (ref CheckHomography :305-388)."""
    p1 = _homogeneous(xy1)                         # (N, 3)
    p2 = _homogeneous(xy2)

    q2 = torch.einsum("sij,nj->sni", H21, p1)
    q2 = q2[..., :2] / q2[..., 2:3]
    chi2_21 = ((xy2[None] - q2) ** 2).sum(-1) / sigma2

    q1 = torch.einsum("sij,nj->sni", H12, p2)
    q1 = q1[..., :2] / q1[..., 2:3]
    chi2_12 = ((xy1[None] - q1) ** 2).sum(-1) / sigma2

    in1 = chi2_12 < CHI2_H
    in2 = chi2_21 < CHI2_H
    score = (torch.where(in1, SCORE_TH - chi2_12, 0.0)
             + torch.where(in2, SCORE_TH - chi2_21, 0.0))
    score = (score * mask[None]).sum(-1)           # (S,)
    inlier = in1 & in2 & mask[None]
    return score, inlier


def _score_f(F21, xy1, xy2, mask, sigma2):
    """Epipolar-distance score (ref CheckFundamental :390-468)."""
    p1 = _homogeneous(xy1)
    p2 = _homogeneous(xy2)

    l2 = torch.einsum("sij,nj->sni", F21, p1)      # epiline in img2
    num2 = torch.einsum("ni,sni->sn", p2, l2)
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    chi2_1 = num2 * num2 / den2.clamp(min=1e-12) / sigma2

    l1 = torch.einsum("sji,nj->sni", F21, p2)      # F^T p2: line in img1
    num1 = torch.einsum("ni,sni->sn", p1, l1)
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    chi2_2 = num1 * num1 / den1.clamp(min=1e-12) / sigma2

    in1 = chi2_1 < CHI2_F
    in2 = chi2_2 < CHI2_F
    score = (torch.where(in1, SCORE_TH - chi2_1, 0.0)
             + torch.where(in2, SCORE_TH - chi2_2, 0.0))
    score = (score * mask[None]).sum(-1)
    inlier = in1 & in2 & mask[None]
    return score, inlier


def _decompose_E(E: torch.Tensor):
    """E -> 4 (R, t) candidates (ref DecomposeE :909-931)."""
    u, _, vt = _svd(E)
    t = u[:, 2]
    t = t / torch.linalg.norm(t).clamp(min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)

    def fix(R):
        return torch.where(torch.linalg.det(R) < 0, -R, R)

    R1 = fix(u @ W @ vt)
    R2 = fix(u @ W.T @ vt)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    return Rs, ts


def _decompose_H(A: torch.Tensor):
    """Faugeras SVD decomposition of calibrated homography -> 8 (R, t, valid).

    (ref ReconstructH :572-731).  A = K^-1 H K.
    """
    U, d, Vt = _svd(A)
    V = Vt.transpose(-1, -2)
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = d[0], d[1], d[2]
    ok = (d1 / d2 > 1.00001) & (d2 / d3 > 1.00001)

    eps = 1e-12
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3))
                      .clamp(min=0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3))
                      .clamp(min=0.0))
    x1s = (1.0, 1.0, -1.0, -1.0)
    x3s = (1.0, -1.0, 1.0, -1.0)
    signs = (1.0, -1.0, -1.0, 1.0)
    z = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    def unit(t):
        return t / torch.linalg.norm(t).clamp(min=eps)

    Rs_list = []
    ts_list = []

    # case d' = d2
    aux_st = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3))
                        .clamp(min=0.0)) / ((d1 + d3) * d2).clamp(min=eps)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp(min=eps)
    for i in range(4):
        st = signs[i] * aux_st
        Rp = torch.stack([torch.stack([ct, z, -st]),
                          torch.stack([z, one, z]),
                          torch.stack([st, z, ct])])
        R = s * (U @ Rp @ Vt)
        tp = torch.stack([x1s[i] * aux1, z, -(x3s[i] * aux3)]) * (d1 - d3)
        Rs_list.append(R)
        ts_list.append(unit(U @ tp))

    # case d' = -d2
    aux_sp = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3))
                        .clamp(min=0.0)) / ((d1 - d3) * d2).clamp(min=eps)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp(min=eps)
    for i in range(4):
        sp = signs[i] * aux_sp
        Rp = torch.stack([torch.stack([cp, z, sp]),
                          torch.stack([z, -one, z]),
                          torch.stack([sp, z, -cp])])
        R = s * (U @ Rp @ Vt)
        tp = torch.stack([x1s[i] * aux1, z, x3s[i] * aux3]) * (d1 + d3)
        Rs_list.append(R)
        ts_list.append(unit(U @ tp))

    return torch.stack(Rs_list), torch.stack(ts_list), ok


def _check_rt(Rs, ts, xy1, xy2, mask, K, th2):
    """Batched CheckRT (ref :798-907): triangulate under each hypothesis,
    count cheirality+reprojection inliers, measure parallax.

    Rs: (M, 3, 3), ts: (M, 3). Returns (n_good (M,), parallax_deg (M,),
    good (M, N), pts3d (M, N, 3)).
    """
    M = Rs.shape[0]
    P1 = torch.cat([K, torch.zeros_like(K[:, :1])], -1)
    P1 = P1.expand(M, 3, 4)
    Rt = torch.cat([Rs, ts[..., None]], -1)        # (M, 3, 4)
    P2 = K[None] @ Rt

    pts1 = triangulate_dlt(P1, P2, xy1.expand((M,) + xy1.shape),
                           xy2.expand((M,) + xy2.shape))  # (M, N, 3)
    finite = torch.isfinite(pts1).all(-1)

    O2 = -torch.einsum("mij,mi->mj", Rs, ts)        # camera-2 center
    n1 = pts1
    n2 = pts1 - O2[:, None]
    d1 = torch.linalg.norm(n1, dim=-1)
    d2n = torch.linalg.norm(n2, dim=-1)
    cos_par = (n1 * n2).sum(-1) / (d1 * d2n).clamp(min=1e-12)

    z1 = pts1[..., 2]
    pc2 = torch.einsum("mij,mnj->mni", Rs, pts1) + ts[:, None]
    z2 = pc2[..., 2]
    cheir = ((z1 > 0) & (z2 > 0)) | (cos_par >= 0.99998)

    # reprojection errors
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u1 = fx * pts1[..., 0] / z1.clamp(min=1e-9) + cx
    v1 = fy * pts1[..., 1] / z1.clamp(min=1e-9) + cy
    e1 = (u1 - xy1[None, :, 0]) ** 2 + (v1 - xy1[None, :, 1]) ** 2
    u2 = fx * pc2[..., 0] / z2.clamp(min=1e-9) + cx
    v2 = fy * pc2[..., 1] / z2.clamp(min=1e-9) + cy
    e2 = (u2 - xy2[None, :, 0]) ** 2 + (v2 - xy2[None, :, 1]) ** 2

    good = (
        finite & mask[None] & cheir & (z1 > 0) & (z2 > 0)
        & (e1 < th2) & (e2 < th2) & (cos_par < 0.99998)
    )
    n_good = good.sum(-1)

    # parallax: ref takes the 50th-smallest angle among good points
    cp = torch.where(good, cos_par, -1.0)          # good sorted descending
    cp_sorted = torch.sort(cp, -1, descending=True).values
    idx = (n_good - 1).clamp(min=0, max=49)
    cos_at = torch.gather(cp_sorted, -1, idx[:, None])[:, 0]
    parallax = torch.rad2deg(torch.arccos(cos_at.clamp(-1.0, 1.0)))
    parallax = torch.where(n_good > 0, parallax, 0.0)
    return n_good, parallax, good, pts1


def initialize(
    xy1: torch.Tensor,          # (N, 2) undistorted px coords in ref frame
    xy2: torch.Tensor,          # (N, 2) matched coords in current frame
    mask: torch.Tensor,         # (N,) bool valid matches
    K: torch.Tensor,            # (3, 3)
    sample_idx: torch.Tensor,   # (200, 8) int RANSAC minimal sets
    sigma: float = 1.0,
) -> InitResult:
    sigma2 = sigma * sigma
    xy1n, T1 = _normalize(xy1, mask)
    xy2n, T2 = _normalize(xy2, mask)
    T2inv = _inv(T2)
    sample_idx = sample_idx.long()

    p1 = xy1n[sample_idx]                           # (S, 8, 2)
    p2 = xy2n[sample_idx]

    # --- homography model -------------------------------------------------
    Hn = _homography_dlt(p1, p2)                    # (S, 3, 3)
    H21 = T2inv[None] @ Hn @ T1[None]
    H12 = _inv(H21)
    score_h, inlier_h = _score_h(H21, H12, xy1, xy2, mask, sigma2)
    best_h = torch.argmax(score_h)
    SH = take_row(score_h, best_h)
    inliers_h = take_row(inlier_h, best_h)
    Hn_ref = _refit_h(xy1n, xy2n, inliers_h.to(xy1.dtype))
    H_best = T2inv @ Hn_ref @ T1

    # --- fundamental model ------------------------------------------------
    Fn = _fundamental_8pt(p1, p2)
    F21 = T2.T[None] @ Fn @ T1[None]
    score_f, inlier_f = _score_f(F21, xy1, xy2, mask, sigma2)
    best_f = torch.argmax(score_f)
    SF = take_row(score_f, best_f)
    inliers_f = take_row(inlier_f, best_f)
    Fn_ref = _refit_f(xy1n, xy2n, inliers_f.to(xy1.dtype))
    F_best = T2.T @ Fn_ref @ T1

    rh = SH / (SH + SF).clamp(min=1e-9)
    use_h = rh > 0.40                               # ref :118

    # --- motion hypotheses: 8 from H, 4 from E ----------------------------
    Kinv = _inv(K)
    A = Kinv @ H_best @ K
    Rs_h, ts_h, h_ok = _decompose_H(A)
    E = K.T @ F_best @ K
    Rs_f, ts_f = _decompose_E(E)

    Rs = torch.cat([Rs_h, Rs_f])                    # (12, 3, 3)
    ts = torch.cat([ts_h, ts_f])
    th2 = 4.0 * sigma2
    model_inliers = torch.where(use_h, inliers_h, inliers_f)
    n_good, parallax, good, pts = _check_rt(Rs, ts, xy1, xy2,
                                            model_inliers, K, th2)

    is_h = torch.arange(12, device=xy1.device) < 8
    hyp_valid = torch.where(is_h, use_h & h_ok, ~use_h)
    scores = torch.where(hyp_valid, n_good, -1)

    best = torch.argmax(scores)
    n_best = take_row(scores, best)
    # second best among valid hypotheses
    is_best = torch.arange(12, device=xy1.device) == best
    n_second = torch.where(is_best, -1, scores).max()

    # ref ReconstructF: nGood > 0.9*N, unique winner (secondBest < 0.75 best
    # in ReconstructH; ReconstructF requires nsimilar <= 1), parallax > 1 deg
    n_inliers = model_inliers.sum()
    min_good = (0.9 * n_inliers).clamp(min=50.0)
    ok = (
        (n_best >= min_good)
        & (n_second < 0.75 * n_best)
        & (take_row(parallax, best) > 1.0)
    )

    return InitResult(
        success=ok,
        R21=take_row(Rs, best),
        t21=take_row(ts, best),
        points3d=take_row(pts, best),
        good_mask=take_row(good, best),
        used_homography=use_h,
    )


def make_ransac_samples(n_matches: int, rng, n_sets: int = N_RANSAC):
    """Host-side seeded 8-point set sampling (ref uses DUtils::Random with
    SeedRandOnce(0), src/Initializer.cc:78-97).  rng: np.random.Generator.
    The JAX package's function, so one seed gives both packages the same
    sets."""
    sets = np.empty((n_sets, 8), np.int32)
    for s in range(n_sets):
        sets[s] = rng.choice(n_matches, size=8, replace=False)
    return sets
