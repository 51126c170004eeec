"""Sim3 RANSAC for loop closure (Horn closed form, batched hypotheses).

Port of orb_slam2_tpu/solvers/sim3_solver.py, the batched replacement for
Sim3Solver (ref: src/Sim3Solver.cc): instead of iterating 3-point minimal
sets sequentially with early exit, all hypotheses are solved at once with
the batched Horn alignment and inliers are counted by both-direction
reprojection (< 9.210 * sigma^2 per octave, ref :87-88, :340-365).  Scale
is fixed to 1 for stereo/RGB-D (bFixScale, ref ctor).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.geometry import sim3
from orb_slam2_tpu_torch.solvers.horn import horn_align
from orb_slam2_tpu_torch.utils import take_row as _row


class Sim3Result(NamedTuple):
    success: torch.Tensor
    R12: torch.Tensor     # (3,3)
    t12: torch.Tensor     # (3,)
    s12: torch.Tensor     # ()
    inliers: torch.Tensor  # (N,)
    n_inliers: torch.Tensor


def _project(p, fx, fy, cx, cy):
    z = p[..., 2].clamp(min=1e-6)
    return torch.stack(
        [fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1
    )


def solve_sim3_ransac(
    pts1: torch.Tensor,       # (N, 3) camera-1-frame 3D points
    pts2: torch.Tensor,       # (N, 3) matched camera-2-frame 3D points
    uv1: torch.Tensor,        # (N, 2) observed pixels in camera 1
    uv2: torch.Tensor,        # (N, 2) observed pixels in camera 2
    max_err1: torch.Tensor,   # (N,) chi2 thresholds in image 1
    max_err2: torch.Tensor,   # (N,) chi2 thresholds in image 2
    mask: torch.Tensor,       # (N,)
    sample_idx: torch.Tensor,  # (S, 3) int64
    fx, fy, cx, cy,
    min_inliers: int = 20,
    fix_scale: bool = False,
):
    """Estimate S12 mapping camera-2 coords into camera-1 coords."""
    p1s = pts1[sample_idx]                        # (S, 3, 3)
    p2s = pts2[sample_idx]
    w = mask[sample_idx].to(pts1.dtype)

    # T12 transforms pts2 -> pts1 frame
    R, t, s = horn_align(p2s, p1s, w, with_scale=not fix_scale)

    # check both directions (ref CheckInliers :340-365)
    p1_from_2 = s[:, None, None] * (pts2 @ R.transpose(-1, -2)) + t[:, None]
    uv1_hat = _project(p1_from_2, fx, fy, cx, cy)
    err1 = ((uv1_hat - uv1[None]) ** 2).sum(-1)

    s_inv = 1.0 / s.clamp(min=1e-12)
    p2_from_1 = s_inv[:, None, None] * ((pts1[None] - t[:, None]) @ R)
    uv2_hat = _project(p2_from_1, fx, fy, cx, cy)
    err2 = ((uv2_hat - uv2[None]) ** 2).sum(-1)

    inl = (err1 < max_err1[None]) & (err2 < max_err2[None]) & mask[None]
    counts = inl.sum(-1)
    best = torch.argmax(counts)

    # refit on all inliers of the winner for accuracy
    inl_b = _row(inl, best)
    n_b = _row(counts, best)
    R2, t2, s2 = horn_align(pts2, pts1, inl_b.to(pts1.dtype),
                            with_scale=not fix_scale)
    p1h = s2 * (pts2 @ R2.T) + t2
    uv1h = _project(p1h, fx, fy, cx, cy)
    e1 = ((uv1h - uv1) ** 2).sum(-1)
    p2h = (1.0 / s2.clamp(min=1e-12)) * ((pts1 - t2) @ R2)
    uv2h = _project(p2h, fx, fy, cx, cy)
    e2 = ((uv2h - uv2) ** 2).sum(-1)
    inl2 = (e1 < max_err1) & (e2 < max_err2) & mask
    n2 = inl2.sum()

    better = n2 >= n_b
    R_out = torch.where(better, R2, _row(R, best))
    t_out = torch.where(better, t2, _row(t, best))
    s_out = torch.where(better, s2, _row(s, best))
    inliers = torch.where(better, inl2, inl_b)
    n_out = torch.maximum(n2, n_b)

    return Sim3Result(
        n_out >= min_inliers, R_out, t_out, s_out, inliers, n_out
    )


def refine_sim3(
    pts1: torch.Tensor,       # (N, 3) camera-1-frame 3D points
    pts2: torch.Tensor,       # (N, 3) matched camera-2-frame points
    uv1: torch.Tensor,        # (N, 2)
    uv2: torch.Tensor,        # (N, 2)
    inv_sigma2_1: torch.Tensor,  # (N,)
    inv_sigma2_2: torch.Tensor,
    mask: torch.Tensor,       # (N,)
    R12, t12, s12,
    fx, fy, cx, cy,
    fix_scale: bool = False,
    iters: int = 10,
    chi2_th: float = 10.0,
):
    """Gauss-Newton refinement of S12 with both-direction projection
    residuals + Huber (IRLS), the equivalent of Optimizer::OptimizeSim3
    (ref: src/Optimizer.cc:1046-1241: EdgeSim3ProjectXYZ both ways,
    RobustKernelHuber delta=sqrt(th2) on every edge :1148-1171, 5 iters ->
    drop chi2 > th2 outliers -> reoptimize).  The Huber weights are
    essential: the match set coming in includes the SearchBySim3
    extension, which is outlier-rich — unrobust GN lets those matches
    destroy the RANSAC estimate before the chi2 gate can run.

    The (4N, 7) Jacobian is `torch.func.jacfwd` of the residual at xi = 0.
    The Sim3 under it carries a leading dimension of 1: under jvp + vmap a
    0-dim tensor combined with a Python scalar is promoted to float64.

    Returns (R12, t12, s12, inlier_mask, n_inliers)."""
    dtype, device = pts1.dtype, pts1.device
    delta = chi2_th ** 0.5
    sq1 = torch.sqrt(inv_sigma2_1)[:, None]
    sq2 = torch.sqrt(inv_sigma2_2)[:, None]
    # the scale direction is masked out of the tangent when it is fixed
    free = torch.ones(7, dtype=dtype, device=device)
    if fix_scale:
        free = torch.cat([free[:6], torch.zeros(1, dtype=dtype,
                                                device=device)])
    eye7 = 1e-6 * torch.eye(7, dtype=dtype, device=device)

    def residuals(S12, active):
        """S12 with a leading dimension of 1 -> (N, 4)."""
        S21 = sim3.inverse(S12)
        p1 = sim3.apply(S12, pts2)          # cam2 pts -> cam1 frame
        p2 = sim3.apply(S21, pts1)
        e1 = (_project(p1, fx, fy, cx, cy) - uv1) * sq1
        e2 = (_project(p2, fx, fy, cx, cy) - uv2) * sq2
        r = torch.cat([e1, e2], -1)   # (N, 4)
        return torch.where(active[:, None], r, 0.0)

    def huber_w(r):
        """sqrt of the IRLS Huber weight per direction-edge, expanded
        back to the (N, 4) residual layout."""
        n1 = torch.sqrt((r[:, :2] ** 2).sum(-1) + 1e-12)
        n2 = torch.sqrt((r[:, 2:] ** 2).sum(-1) + 1e-12)
        w1 = torch.sqrt((delta / n1).clamp(max=1.0))
        w2 = torch.sqrt((delta / n2).clamp(max=1.0))
        return torch.stack([w1, w1, w2, w2], -1)

    def gn_iter(S0, active):
        # IRLS: Huber weights frozen at the current iterate
        W = huber_w(residuals(S0, active))

        def err_from_xi(xi):                        # xi: (1, 7)
            S = sim3.compose(sim3.exp(xi * free), S0)
            return (residuals(S, active) * W).reshape(-1)

        xi0 = torch.zeros(1, 7, dtype=dtype, device=device)
        J = torch.func.jacfwd(err_from_xi)(xi0)[:, 0, :]    # (4N, 7)
        r = err_from_xi(xi0)
        H = J.T @ J + eye7
        g = J.T @ r
        xi = -torch.linalg.solve_ex(H, g[:, None])[0][:, 0] * free
        S_new = sim3.compose(sim3.exp(xi[None]), S0)
        better = (err_from_xi(xi[None]) ** 2).sum() < (r ** 2).sum() + 1e-12
        return tuple(torch.where(better, n, o) for n, o in zip(S_new, S0))

    def chi_ok(S, active):
        r = residuals(S, active)
        chi1 = (r[:, :2] ** 2).sum(-1)
        chi2_ = (r[:, 2:] ** 2).sum(-1)
        return active & (chi1 <= chi2_th) & (chi2_ <= chi2_th)

    S = (R12[None], t12[None],
         torch.as_tensor(s12, dtype=dtype, device=device).reshape(1))
    for _ in range(iters // 2):
        S = gn_iter(S, mask)
    # outlier rejection at chi2 > 10 per direction (ref :1189-1206)
    active = chi_ok(S, mask)
    for _ in range(iters - iters // 2):
        S = gn_iter(S, active)
    inl = chi_ok(S, active)
    return S[0][0], S[1][0], S[2][0], inl, inl.sum()
