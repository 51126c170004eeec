"""EPnP inside batched RANSAC for relocalization.

Port of orb_slam2_tpu/solvers/epnp.py, the batched replacement for
PnPsolver (ref: src/PnPsolver.cc): the reference runs EPnP (4 control
points, barycentric coordinates, 12x12 M^T M eigendecomposition, beta
cases + Gauss-Newton) on one RANSAC minimal set at a time; here ALL
RANSAC hypotheses are solved simultaneously with batched linear algebra,
inliers are counted densely, and the best hypothesis is refined on its
full inlier set.

All three of the reference's closed-form beta seeds (find_betas_approx_
1/2/3, ref: src/PnPsolver.cc:667-761) feed Gauss-Newton in parallel and
the lowest-reprojection-error case wins, exactly like compute_pose
(ref: :565-661).  Deviation: minimal sets use 6 points rather than 4
for numerical headroom (all hypotheses run at once anyway).

Every small solve is `torch.linalg.solve_ex`, which checks nothing on the
host: a minimal set that repeats a row gives a singular system, its
hypothesis comes out inf/nan, every comparison with it is False and it
scores 0 inliers.  `eigh` fixes eigenvectors only up to sign (and, in a
degenerate null space, up to rotation): compare R, t and the inlier mask
across devices, never the eigenvectors or the betas.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.geometry.se3 import _matvec
from orb_slam2_tpu_torch.solvers.horn import eigh_nan, horn_align
from orb_slam2_tpu_torch.utils import take_row as _row

MIN_SET = 6


class PnPResult(NamedTuple):
    success: torch.Tensor
    Tcw: torch.Tensor         # (4, 4)
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor


def _solve(A, b):
    """A x = b for (..., n, n), (..., n) without a host-side check."""
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _control_points(pw: torch.Tensor, w: torch.Tensor):
    """Centroid + PCA control points (ref choose_control_points :375-409).

    pw: (..., N, 3), w: (..., N) weights.  Returns (..., 4, 3).
    """
    wn = w / w.sum(-1, keepdim=True).clamp(min=1e-12)
    c0 = (pw * wn[..., None]).sum(-2)
    centered = (pw - c0[..., None, :]) * torch.sqrt(wn)[..., None]
    cov = centered.transpose(-1, -2) @ centered
    evals, evecs = torch.linalg.eigh(cov)
    sig = torch.sqrt(evals.clamp(min=1e-12))
    axes = evecs * sig[..., None, :]            # columns scaled
    c1 = c0 + axes[..., :, 2]
    c2 = c0 + axes[..., :, 1]
    c3 = c0 + axes[..., :, 0]
    return torch.stack([c0, c1, c2, c3], -2)


def _barycentric(pw: torch.Tensor, cw: torch.Tensor):
    """alphas such that pw = sum alpha_j cw_j, sum alpha = 1
    (ref compute_barycentric_coordinates :411-434)."""
    Cm = torch.cat([cw, torch.ones_like(cw[..., :1])], -1)    # (..., 4, 4)
    P = torch.cat([pw, torch.ones_like(pw[..., :1])], -1)     # (..., N, 4)
    # solve Cm^T alpha = p for each point: one factorisation per control
    # set, the points as right-hand-side columns
    alphas = torch.linalg.solve_ex(
        Cm.transpose(-1, -2), P.transpose(-1, -2))[0]
    return alphas.transpose(-1, -2)                           # (..., N, 4)


def _build_MtM(alphas, uv, fx, fy, cx, cy, w):
    """M^T M (12x12) from the 2N x 12 EPnP system (ref fill_M :436-460)."""
    u, v = uv[..., 0], uv[..., 1]
    a = alphas                                    # (..., N, 4)

    def rows(coef_x, coef_y, coef_z):
        # for each control j: columns 3j..3j+2
        coef = torch.stack([coef_x, coef_y, coef_z], -1)      # (..., N, 3)
        return (a[..., :, None] * coef[..., None, :]).flatten(-2)

    Mu = rows(fx * torch.ones_like(u), torch.zeros_like(u), cx - u)
    Mv = rows(torch.zeros_like(v), fy * torch.ones_like(v), cy - v)
    ww = w[..., None]
    return ((Mu * ww).transpose(-1, -2) @ Mu
            + (Mv * ww).transpose(-1, -2) @ Mv)


_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _dist2(x):
    """Pairwise squared distances of 4 control points -> (..., 6)."""
    return torch.stack(
        [((x[..., i, :] - x[..., j, :]) ** 2).sum(-1) for i, j in _PAIRS], -1
    )


def _pair_diffs(Vc):
    """(..., ctrl, xyz, basis) -> (..., 6, 3, 4) control-pair differences."""
    return torch.stack(
        [Vc[..., i, :, :] - Vc[..., j, :, :] for i, j in _PAIRS], -3)


def _L6x10(V):
    """The reference's L matrix (ref compute_L_6x10 :760-800): for each
    control-point pair p, quadratic-form coefficients of the 4 betas over
    the basis-vector differences dv_k[p].  Column order
    [B11 B12 B22 B13 B23 B33 B14 B24 B34 B44]."""
    Vc = V.reshape(V.shape[:-2] + (4, 3, 4))       # (..., ctrl, xyz, basis)
    dv = _pair_diffs(Vc)                           # (..., 6, 3, 4)
    d = dv.transpose(-1, -2) @ dv                  # (..., 6, 4, 4)
    cols = [d[..., 0, 0], 2 * d[..., 0, 1], d[..., 1, 1],
            2 * d[..., 0, 2], 2 * d[..., 1, 2], d[..., 2, 2],
            2 * d[..., 0, 3], 2 * d[..., 1, 3], 2 * d[..., 2, 3],
            d[..., 3, 3]]
    return torch.stack(cols, -1)                   # (..., 6, 10)


def _lsq(A, b):
    """Batched small least squares via ridge-stabilized normal equations
    (systems here are 6x3..6x5)."""
    At = A.transpose(-1, -2)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) * 1e-9
    return _solve(At @ A + eye, _matvec(At, b))


def _signed_root(b):
    """sqrt(|b11|) with the sign that makes b11 positive."""
    s = torch.where(b[..., 0] < 0, -1.0, 1.0)
    return s, torch.sqrt((s * b[..., 0]).clamp(min=1e-12))


def _betas_approx_1(L, rho):
    """betas_approx_1 = [B11 B12 B13 B14] (ref :667-688)."""
    b4 = _lsq(L[..., (0, 1, 3, 6)], rho)
    s, b0 = _signed_root(b4)
    rest = s[..., None] * b4[..., 1:] / b0[..., None]
    return torch.cat([b0[..., None], rest], -1)


def _betas_approx_2(L, rho):
    """betas_approx_2 = [B11 B12 B22] (ref :693-719)."""
    b3 = _lsq(L[..., (0, 1, 2)], rho)
    s, b0 = _signed_root(b3)
    # beta2 = sqrt(b22) only when b22 has the same sign as b11
    same = s * b3[..., 2] > 0
    b1 = torch.where(same, torch.sqrt((s * b3[..., 2]).clamp(min=1e-12)), 0.0)
    b0 = torch.where(b3[..., 1] < 0, -b0, b0)
    zero = torch.zeros_like(b0)
    return torch.stack([b0, b1, zero, zero], -1)


def _betas_approx_3(L, rho):
    """betas_approx_3 = [B11 B12 B22 B13 B23] (ref :724-755)."""
    b5 = _lsq(L[..., (0, 1, 2, 3, 4)], rho)
    s, b0 = _signed_root(b5)
    same = s * b5[..., 2] > 0
    b1 = torch.where(same, torch.sqrt((s * b5[..., 2]).clamp(min=1e-12)), 0.0)
    b0 = torch.where(b5[..., 1] < 0, -b0, b0)
    b2 = b5[..., 3] / b0
    zero = torch.zeros_like(b0)
    return torch.stack([b0, b1, b2, zero], -1)


def _betas_gauss_newton(V, rho, beta0, iters: int = 5):
    """Refine betas so sum_k beta_k v_k reproduces control distances
    (ref gauss_newton :840-907).  V: (..., 12, 4) basis (columns =
    eigenvectors for the 4 smallest eigenvalues), rho: (..., 6)."""
    Vc = V.reshape(V.shape[:-2] + (4, 3, 4))       # (..., ctrl, xyz, basis)
    dv = _pair_diffs(Vc)                           # (..., 6, 3, 4)
    eye = torch.eye(4, dtype=V.dtype, device=V.device) * 1e-9
    beta = beta0
    for _ in range(iters):
        diffs = (dv @ beta[..., None, :, None])[..., 0]      # (..., 6, 3)
        f = (diffs * diffs).sum(-1) - rho          # (..., 6)
        J = 2.0 * (diffs[..., None, :] @ dv)[..., 0, :]      # (..., 6, 4)
        Jt = J.transpose(-1, -2)
        beta = beta + _solve(Jt @ J + eye, -_matvec(Jt, f))
    return beta


def _epnp_solve(pw, uv, w, fx, fy, cx, cy):
    """Solve one (possibly batched) EPnP instance with weights w.

    Returns (R, t) world->camera.
    """
    cw = _control_points(pw, w)
    alphas = _barycentric(pw, cw)
    MtM = _build_MtM(alphas, uv, fx, fy, cx, cy, w)
    _, evecs = eigh_nan(MtM)
    V = evecs[..., :, :4]                          # 4 smallest (..., 12, 4)

    rho = _dist2(cw)

    # the reference's three closed-form beta seeds, each refined by
    # Gauss-Newton, lowest reprojection error wins (ref compute_pose
    # :565-661 keeps the best of cases 1/2/3)
    L = _L6x10(V)
    beta0 = torch.stack([_betas_approx_1(L, rho),
                         _betas_approx_2(L, rho),
                         _betas_approx_3(L, rho)], -2)        # (..., 3, 4)
    Vb = V[..., None, :, :].expand(V.shape[:-2] + (3,) + V.shape[-2:])
    rhob = rho[..., None, :].expand(rho.shape[:-1] + (3,) + rho.shape[-1:])
    betas = _betas_gauss_newton(Vb, rhob, beta0)            # (..., 3, 4)

    cc = (betas @ V.transpose(-1, -2)).reshape(
        V.shape[:-2] + (3, 4, 3)
    )                                       # camera-frame ctrl pts per case
    pc = alphas[..., None, :, :] @ cc                       # (..., 3, N, 3)

    # fix sign: average depth must be positive
    wb = w[..., None, :]
    mean_z = ((pc[..., 2] * wb).sum(-1)
              / wb.sum(-1).clamp(min=1e-12))
    flip = torch.where(mean_z < 0, -1.0, 1.0)
    pc = pc * flip[..., None, None]

    pwb = pw[..., None, :, :].expand(pc.shape)
    R, t, _ = horn_align(pwb, pc, wb.expand(pc.shape[:-1]),
                         with_scale=False)                  # (..., 3, 3, 3)

    chi2 = _reproj_chi2(R, t, pwb, uv[..., None, :, :], fx, fy, cx, cy)
    err = ((chi2 * wb).sum(-1)
           / wb.sum(-1).clamp(min=1e-12))                   # (..., 3)
    case = torch.argmin(err, -1)
    R = torch.gather(
        R, -3, case[..., None, None, None].expand(
            case.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(
        t, -2, case[..., None, None].expand(case.shape + (1, 3)))[..., 0, :]
    return R, t


def _reproj_chi2(R, t, pw, uv, fx, fy, cx, cy):
    pc = pw @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2].clamp(min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2


def solve_pnp_ransac(
    pts_w: torch.Tensor,       # (N, 3)
    uv: torch.Tensor,          # (N, 2)
    max_err2: torch.Tensor,    # (N,) per-point chi2 threshold (octave-scaled,
                               #  ref: PnPsolver ctor mvMaxError sigma2*5.991)
    mask: torch.Tensor,        # (N,)
    sample_idx: torch.Tensor,  # (S, MIN_SET) int64
    fx, fy, cx, cy,
    min_inliers: int = 10,
):
    """All-hypotheses-at-once EPnP RANSAC + full-inlier refinement."""
    pw_s = pts_w[sample_idx]                       # (S, 6, 3)
    uv_s = uv[sample_idx]
    w_s = mask[sample_idx].to(pts_w.dtype)

    R, t = _epnp_solve(pw_s, uv_s, w_s, fx, fy, cx, cy)   # (S,3,3),(S,3)

    chi2 = _reproj_chi2(R, t, pts_w[None], uv[None], fx, fy, cx, cy)  # (S,N)
    inl = (chi2 <= max_err2[None]) & mask[None]
    counts = inl.sum(-1)
    best = torch.argmax(counts)

    # refine on the best hypothesis's inliers (ref Refine :260-306)
    inl_b = _row(inl, best)
    n_b = _row(counts, best)
    R2, t2 = _epnp_solve(pts_w, uv, inl_b.to(pts_w.dtype), fx, fy, cx, cy)
    chi2_r = _reproj_chi2(R2, t2, pts_w, uv, fx, fy, cx, cy)
    inl_r = (chi2_r <= max_err2) & mask
    n_r = inl_r.sum()

    use_refined = n_r >= n_b
    R_out = torch.where(use_refined, R2, _row(R, best))
    t_out = torch.where(use_refined, t2, _row(t, best))
    inliers = torch.where(use_refined, inl_r, inl_b)
    n_out = torch.maximum(n_r, n_b)

    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=pts_w.dtype,
                          device=pts_w.device)
    T = torch.cat([torch.cat([R_out, t_out[:, None]], 1), bottom], 0)
    return PnPResult(n_out >= min_inliers, T, inliers, n_out)
