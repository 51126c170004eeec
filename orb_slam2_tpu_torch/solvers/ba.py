"""Bundle adjustment: Schur-complement Levenberg-Marquardt.

Port of orb_slam2_tpu/solvers/ba.py, the replacement for
Optimizer::{BundleAdjustment, LocalBundleAdjustment} (ref:
src/Optimizer.cc:49-237, 453-780), which the reference delegates to g2o's
BlockSolver_6_3 with point marginalization.

The problem is a fixed-shape edge list (camera_idx, point_idx,
observation).  Each LM iteration:
  1. residuals + analytic Jacobians for all edges in one batch,
  2. Hcc (K,6,6), Hpp (P,3,3), Hcp, gradients via segment sums,
  3. marginalize points: batched closed-form 3x3 inverses of Hpp,
  4. the reduced camera system S dc = rhs, solved either
       - densely (6K x 6K) for local-BA-sized windows, or
       - by preconditioned conjugate gradients with edge-wise matvecs,
  5. back-substitute point updates.

Segment sums take one of two routes, as in the JAX package: one-hot
matrices and a matmul when E*P <= 5e7 (dense mode), `index_add_`
otherwise.  On a CUDA device `index_add_` accumulates with atomics, so
its float sums may differ in the last bits from run to run; the one-hot
matmul route is deterministic.  The LM loop runs exactly `iters`
iterations and accepts or rejects each step with `torch.where`: no value
is read back to the host inside `optimize`.  The dense solve is
`torch.linalg.solve_ex`, which checks nothing on the host.

The robust kernel, chi2 thresholds (5.991 mono / 7.815 stereo), and the
two-stage optimize -> drop outliers -> reoptimize flow mirror the
reference's LocalBundleAdjustment (ref :660-707).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.ops import consts

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
ONEHOT_MAX_ENTRIES = 50_000_000   # E * P gate of the one-hot route


class BAProblem(NamedTuple):
    cam_T: torch.Tensor       # (K, 4, 4) Tcw
    cam_fixed: torch.Tensor   # (K,) bool — gauge/fixed cameras
    cam_mask: torch.Tensor    # (K,) bool — padded slots
    pts: torch.Tensor         # (P, 3)
    pt_mask: torch.Tensor     # (P,) bool
    edge_cam: torch.Tensor    # (E,) int64
    edge_pt: torch.Tensor     # (E,) int64
    edge_uv: torch.Tensor     # (E, 3) [u, v, ur] (ur < 0 => mono)
    edge_inv_sigma2: torch.Tensor  # (E,)
    edge_mask: torch.Tensor   # (E,) bool


def _edge_terms(prob: BAProblem, cam_T, pts, fx, fy, cx, cy, bf):
    """Residuals r (E,3), Jc (E,3,6), Jp (E,3,3), row_mask (E,3)."""
    Tc = cam_T[prob.edge_cam]                     # (E, 4, 4)
    pw = pts[prob.edge_pt]                        # (E, 3)
    pc = se3.transform(Tc, pw)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    inv_z = 1.0 / z.clamp(min=1e-6)
    inv_z2 = inv_z * inv_z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z

    uv = prob.edge_uv
    is_stereo = uv[:, 2] >= 0
    r = torch.stack(
        [uv[:, 0] - u, uv[:, 1] - v,
         torch.where(is_stereo, uv[:, 2] - ur, 0.0)], -1)

    E = pc.shape[0]
    zero = torch.zeros_like(x)
    Ju = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], -1)
    Jv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], -1)
    Jur = torch.stack([fx * inv_z, zero, -fx * x * inv_z2 + bf * inv_z2], -1)
    Jproj = torch.stack([Ju, Jv, Jur], 1)         # (E, 3, 3)

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(E, 3, 3)
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], -1)  # (E, 3, 6)
    Jc = -(Jproj @ dpc_dxi)                       # (E, 3, 6)
    R = Tc[:, :3, :3]
    Jp = -(Jproj @ R)                             # (E, 3, 3)

    behind = z <= 1e-3
    ok = (
        prob.edge_mask
        & prob.cam_mask[prob.edge_cam]
        & prob.pt_mask[prob.edge_pt]
        & ~behind
    )
    row_mask = torch.stack(
        [torch.ones_like(ok), torch.ones_like(ok), is_stereo], -1
    ) & ok[:, None]
    # fixed cameras contribute to point estimation but have zero cam
    # Jacobian
    Jc = torch.where(prob.cam_fixed[prob.edge_cam][:, None, None], 0.0, Jc)
    return r, Jc, Jp, row_mask, is_stereo


def _chi2(r, row_mask, inv_sigma2):
    return (r * r * row_mask).sum(-1) * inv_sigma2


def edge_chi2(prob: BAProblem, fx, fy, cx, cy, bf):
    """Per-edge chi2 and stereo flags under current estimates."""
    r, _, _, row_mask, is_st = _edge_terms(
        prob, prob.cam_T, prob.pts, fx, fy, cx, cy, bf
    )
    return _chi2(r, row_mask, prob.edge_inv_sigma2), is_st, row_mask[:, 0]


def _onehots(prob: BAProblem, K: int, P: int):
    """One-hot edge->camera (E,K) and edge->point (E,P) matrices: segment
    reductions over the edge list become matmuls.  Only materialized for
    local-window problems (dense mode), where E*P stays ~10^7."""
    dev = prob.edge_cam.device
    Ck = (prob.edge_cam[:, None] == torch.arange(K, device=dev)).float()
    Pm = (prob.edge_pt[:, None] == torch.arange(P, device=dev)).float()
    return Ck, Pm


def _seg_sum(values, onehot, seg_ids, num_segments):
    """Segment sum as a one-hot matmul when available, `index_add_`
    otherwise.  values: (E, ...)."""
    E = values.shape[0]
    flat = values.reshape(E, -1)
    if onehot is None:
        out = torch.zeros((num_segments, flat.shape[1]), dtype=flat.dtype,
                          device=flat.device).index_add_(0, seg_ids, flat)
    else:
        out = onehot.T @ flat                      # (S, D)
    return out.reshape((num_segments,) + values.shape[1:])


def _huber_weights(chi2, is_stereo, use_kernel):
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    if not use_kernel:
        return torch.ones_like(chi2)
    return torch.where(chi2 > delta2,
                       torch.sqrt(delta2 / chi2.clamp(min=1e-12)), 1.0)


def _huber_rho(chi2, is_stereo):
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = torch.sqrt(delta2)
    return torch.where(
        chi2 > delta2,
        2.0 * delta * torch.sqrt(chi2.clamp(min=1e-12)) - delta2,
        chi2,
    )


def _assemble(prob, cam_T, pts, fx, fy, cx, cy, bf, use_kernel,
              onehots=None):
    """Build all blocks of the normal equations."""
    K = cam_T.shape[0]
    P = pts.shape[0]
    r, Jc, Jp, row_mask, is_st = _edge_terms(
        prob, cam_T, pts, fx, fy, cx, cy, bf
    )
    chi2 = _chi2(r, row_mask, prob.edge_inv_sigma2)
    w = prob.edge_inv_sigma2 * _huber_weights(chi2, is_st, use_kernel)
    wr = w[:, None] * row_mask                            # (E, 3)

    JcW = Jc * wr[:, :, None]                             # (E, 3, 6)
    JpW = Jp * wr[:, :, None]

    Hcc_e = JcW.transpose(1, 2) @ Jc                      # (E, 6, 6)
    Hpp_e = JpW.transpose(1, 2) @ Jp                      # (E, 3, 3)
    Hcp_e = JcW.transpose(1, 2) @ Jp                      # (E, 6, 3)
    gc_e = (JcW.transpose(1, 2) @ r[:, :, None])[..., 0]  # (E, 6)
    gp_e = (JpW.transpose(1, 2) @ r[:, :, None])[..., 0]  # (E, 3)

    Ck, Pm = onehots if onehots is not None else (None, None)
    Hcc = _seg_sum(Hcc_e, Ck, prob.edge_cam, K)
    Hpp = _seg_sum(Hpp_e, Pm, prob.edge_pt, P)
    gc = _seg_sum(gc_e, Ck, prob.edge_cam, K)
    gp = _seg_sum(gp_e, Pm, prob.edge_pt, P)

    rho = _huber_rho(chi2, is_st) if use_kernel else chi2
    err = (rho * row_mask[:, 0]).sum()
    return Hcc, Hpp, Hcp_e, gc, gp, err


def _total_error(prob, cam_T, pts, fx, fy, cx, cy, bf, use_kernel):
    r, _, _, row_mask, is_st = _edge_terms(prob, cam_T, pts, fx, fy, cx,
                                           cy, bf)
    chi2 = _chi2(r, row_mask, prob.edge_inv_sigma2)
    rho = _huber_rho(chi2, is_st) if use_kernel else chi2
    return (rho * row_mask[:, 0]).sum()


def _solve_cameras_dense(Hcc, Hcp_e, Hpp_inv, gc, gp, prob, lam,
                         onehots=None):
    """Dense Schur solve for local-BA-sized problems.

    Materializes W (K, P, 6, 3) = sum of Hcp blocks — use only when
    K * P is small (local window).
    """
    K = Hcc.shape[0]
    P = Hpp_inv.shape[0]
    E = Hcp_e.shape[0]
    if onehots is not None:
        Ck, Pm = onehots
        # W[k,p] = sum_e 1[cam=k] 1[pt=p] Hcp_e: expand the (tiny) cam
        # one-hot into the values, then ONE (P,E)@(E,K*18) matmul
        tmp = (Ck[:, :, None] * Hcp_e.reshape(E, 1, 18)).reshape(E, K * 18)
        W = (Pm.T @ tmp).reshape(P, K, 6, 3).transpose(0, 1)
    else:
        flat_idx = prob.edge_cam * P + prob.edge_pt
        W = torch.zeros((K * P, 18), dtype=Hcp_e.dtype,
                        device=Hcp_e.device).index_add_(
            0, flat_idx, Hcp_e.reshape(E, 18)).reshape(K, P, 6, 3)
    Y = torch.einsum("kpab,pbc->kpac", W, Hpp_inv)
    S = -torch.einsum("kpac,lpbc->klab", Y, W)            # (K, K, 6, 6)
    eyeK = torch.eye(K, dtype=S.dtype, device=S.device)
    S = S + eyeK[:, :, None, None] * Hcc[:, None]
    rhs = gc - torch.einsum("kpab,pb->ka", Y, gp)         # (K, 6)

    Sm = S.transpose(1, 2).reshape(6 * K, 6 * K)
    # damping + fixed/padded camera regularization
    Sm = Sm + lam * torch.eye(6 * K, dtype=Sm.dtype, device=Sm.device)
    dc = torch.linalg.solve_ex(Sm, -rhs.reshape(-1, 1))[0][:, 0]
    return dc.reshape(K, 6)


def _solve_cameras_cg(Hcc, Hcp_e, Hpp_inv, gc, gp, prob, lam,
                      iters: int = 60):
    """Matrix-free PCG on the Schur complement for global BA.

    S x = Hcc x - W Hpp^-1 W^T x with W^T x accumulated edge-wise.
    Preconditioner: block-Jacobi with the damped Hcc diagonal blocks.
    """
    K = Hcc.shape[0]
    P = Hpp_inv.shape[0]
    lamI = lam * torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)

    def seg(values, ids, n):
        return torch.zeros((n, values.shape[1]), dtype=values.dtype,
                           device=values.device).index_add_(0, ids, values)

    def S_matvec(x):                                      # x: (K, 6)
        hx = torch.einsum("kab,kb->ka", Hcc, x) + lam * x
        wtx_e = torch.einsum("eab,ea->eb", Hcp_e, x[prob.edge_cam])
        wtx = seg(wtx_e, prob.edge_pt, P)
        z = torch.einsum("pab,pb->pa", Hpp_inv, wtx)      # (P, 3)
        wz_e = torch.einsum("eab,eb->ea", Hcp_e, z[prob.edge_pt])
        wz = seg(wz_e, prob.edge_cam, K)
        return hx - wz

    rhs_p = torch.einsum("pab,pb->pa", Hpp_inv, gp)
    rhs_c_e = torch.einsum("eab,eb->ea", Hcp_e, rhs_p[prob.edge_pt])
    rhs = -(gc - seg(rhs_c_e, prob.edge_cam, K))

    Minv = torch.linalg.inv_ex(Hcc + lamI[None])[0]

    def precond(r):
        return torch.einsum("kab,kb->ka", Minv, r)

    x = torch.zeros_like(rhs)
    r = rhs - S_matvec(x)
    z = precond(r)
    p = z
    for _ in range(iters):
        Sp = S_matvec(p)
        rz = (r * z).sum()
        alpha = rz / (p * Sp).sum().clamp(min=1e-20)
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        beta = (r * z).sum() / rz.clamp(min=1e-20)
        p = z + beta * p
    return x


def optimize(
    prob: BAProblem,
    fx, fy, cx, cy, bf,
    iters: int = 5,
    use_kernel: bool = True,
    mode: str = "dense",
    cg_iters: int = 60,
):
    """Run `iters` LM iterations; returns updated (cam_T, pts, final_err).

    fx..bf: Python numbers or 0-dim tensors on the problem's device."""
    dev = prob.pts.device
    fx, fy, cx, cy, bf = (consts.scalar(v, dev) for v in (fx, fy, cx, cy, bf))
    E_n = prob.edge_cam.shape[0]
    P_n = prob.pts.shape[0]
    # the one-hot reduction matrices are iteration-invariant: build once
    onehots = (_onehots(prob, prob.cam_T.shape[0], P_n)
               if mode == "dense" and E_n * P_n <= ONEHOT_MAX_ENTRIES
               else None)
    eye3 = torch.eye(3, dtype=prob.pts.dtype, device=dev)
    pad_reg = (~prob.pt_mask)[:, None, None] * eye3
    frozen = (prob.cam_fixed | ~prob.cam_mask)[:, None]

    cam_T, pts = prob.cam_T, prob.pts
    lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
    err = None
    # a fixed-length loop, deliberately with no early exit: LM can accept
    # a near-zero-improvement step early (lambda still adapting) and then
    # make large progress once the trust region grows (the JAX package
    # measured the early-exit variant degrading post-loop GBA)
    for _ in range(iters):
        Hcc, Hpp, Hcp_e, gc, gp, err_old = _assemble(
            prob, cam_T, pts, fx, fy, cx, cy, bf, use_kernel,
            onehots=onehots,
        )
        # regularize padded points so inversion stays sane
        Hpp_inv = se3.inv3x3(Hpp + lam * eye3 + pad_reg)

        if mode == "dense":
            dc = _solve_cameras_dense(Hcc, Hcp_e, Hpp_inv, gc, gp, prob,
                                      lam, onehots=onehots)
        else:
            dc = _solve_cameras_cg(Hcc, Hcp_e, Hpp_inv, gc, gp, prob, lam,
                                   iters=cg_iters)
        dc = torch.where(frozen, 0.0, dc)

        # back-substitute points: dp = -Hpp^-1 (gp + W^T dc)
        wtd_e = torch.einsum("eab,ea->eb", Hcp_e, dc[prob.edge_cam])
        wtd = _seg_sum(wtd_e, onehots[1] if onehots is not None else None,
                       prob.edge_pt, P_n)
        dp = -torch.einsum("pab,pb->pa", Hpp_inv, gp + wtd)
        dp = torch.where(prob.pt_mask[:, None], dp, 0.0)

        cam_T_new = se3.exp(dc) @ cam_T
        pts_new = pts + dp
        err_new = _total_error(prob, cam_T_new, pts_new, fx, fy, cx, cy, bf,
                               use_kernel)
        accept = err_new < err_old
        cam_T = torch.where(accept, cam_T_new, cam_T)
        pts = torch.where(accept, pts_new, pts)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        # report the ACCEPTED state's error, not the proposal's
        err = torch.where(accept, err_new, err_old)
    return cam_T, pts, err


def classify_outliers(prob: BAProblem, fx, fy, cx, cy, bf):
    """Edge outlier mask: chi2 > threshold or positive-depth violation
    (ref: src/Optimizer.cc:672-689, 718-739)."""
    dev = prob.pts.device
    fx, fy, cx, cy, bf = (consts.scalar(v, dev) for v in (fx, fy, cx, cy, bf))
    chi2, is_st, ok = edge_chi2(prob, fx, fy, cx, cy, bf)
    th = torch.where(is_st, CHI2_STEREO, CHI2_MONO)
    return (chi2 > th) | ~ok


def local_ba_chain(
    prob: BAProblem, fx, fy, cx, cy, bf,
    iters1: int = 5, iters2: int = 10, mode: str = "dense",
    second_round: bool = True,
):
    """The whole LocalBundleAdjustment device chain (ref:
    src/Optimizer.cc:453-780): 5 Huber-kernel LM iterations, edge outlier
    classification, re-optimize the inlier set 10 iterations without the
    kernel, final outlier classification, with no host read in between.

    Returns (cam_T, pts, final_bad_mask, post_round1_edge_mask).
    """
    cam_T, pts, _ = optimize(
        prob, fx, fy, cx, cy, bf, iters=iters1, use_kernel=True, mode=mode)
    prob1 = prob._replace(cam_T=cam_T, pts=pts)
    if not second_round:
        bad = classify_outliers(prob1, fx, fy, cx, cy, bf)
        return cam_T, pts, bad, prob.edge_mask
    bad1 = classify_outliers(prob1, fx, fy, cx, cy, bf)
    prob2 = prob1._replace(edge_mask=prob.edge_mask & ~bad1)
    cam_T, pts, _ = optimize(
        prob2, fx, fy, cx, cy, bf, iters=iters2, use_kernel=False, mode=mode)
    # final erase pass re-checks ALL original edges under the converged
    # state (ref: Optimizer.cc:718-760 loops every edge)
    prob3 = prob2._replace(cam_T=cam_T, pts=pts, edge_mask=prob.edge_mask)
    bad = classify_outliers(prob3, fx, fy, cx, cy, bf)
    return cam_T, pts, bad, prob.edge_mask
