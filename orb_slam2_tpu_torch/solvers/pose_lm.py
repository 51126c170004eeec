"""Pose-only Levenberg-Marquardt optimization, fully on the device.

Port of orb_slam2_tpu/solvers/pose_lm.py, the replacement for
Optimizer::PoseOptimization (ref: src/Optimizer.cc:239-451): a single SE3
vertex with unary mono (EdgeSE3ProjectXYZOnlyPose) and stereo edges,
Huber kernel with delta = sqrt(5.991) mono / sqrt(7.815) stereo,
optimized in 4 rounds of 10 iterations with chi^2 inlier/outlier
reclassification between rounds and the robust kernel dropped from round
3 (ref :367-442).  The update is left-multiplicative, T <- exp(xi) * T
with xi = [rho, omega].

`lax.scan` becomes a Python loop, and every accept/reject decision stays
a `torch.where` on the device: nothing here reads a tensor on the host,
so the loop can be captured in a CUDA graph.  The 6x6 damped normal
system is solved by `solve_spd6`, an unrolled Gauss-Jordan elimination
without pivoting (H + lambda*I is symmetric positive definite), the same
on every device: `torch.linalg.solve` checks its result on the host,
which is a sync and cannot be captured.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.ops import consts

CHI2_MONO = 5.991    # ref: src/Optimizer.cc deltaMono^2
CHI2_STEREO = 7.815  # ref: deltaStereo^2
# jnp.sqrt of the float32 constants, as the JAX package computes them
_DELTA_MONO = float(np.sqrt(np.float32(CHI2_MONO)))
_DELTA_STEREO = float(np.sqrt(np.float32(CHI2_STEREO)))


class PoseObs(NamedTuple):
    """Fixed-shape observation set for pose optimization."""

    pts_w: torch.Tensor       # (N, 3) world points
    uv: torch.Tensor          # (N, 3) [u, v, u_right]; u_right<0 = mono
    inv_sigma2: torch.Tensor  # (N,) 1/sigma^2 per observation (octave-based)
    mask: torch.Tensor        # (N,) bool valid


def _residual(Tcw, obs: PoseObs, fx, fy, cx, cy, bf):
    """Residuals (N,3) with the stereo row zeroed for mono observations,
    the row mask (N,3), is_stereo (N,), and the camera-frame points and
    1/z the Jacobian reuses."""
    pc = se3.transform(Tcw, obs.pts_w)                   # (N, 3)
    x, y = pc[:, 0], pc[:, 1]
    z = pc[:, 2].clamp(min=1e-6)
    inv_z = 1.0 / z

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z

    is_stereo = obs.uv[:, 2] >= 0
    r = torch.stack(
        [obs.uv[:, 0] - u, obs.uv[:, 1] - v,
         torch.where(is_stereo, obs.uv[:, 2] - ur, 0.0)], -1)
    behind = pc[:, 2] <= 0.05
    ok = obs.mask & ~behind
    row_mask = torch.stack([ok, ok, is_stereo & ok], -1)
    return r, row_mask, is_stereo, pc, inv_z


def _residual_jacobian(Tcw, obs: PoseObs, fx, fy, cx, cy, bf):
    """Residuals (N,3), Jacobians (N,3,6), stereo row masked for mono."""
    r, row_mask, is_stereo, pc, inv_z = _residual(Tcw, obs, fx, fy, cx, cy,
                                                  bf)
    x, y = pc[:, 0], pc[:, 1]
    inv_z2 = inv_z * inv_z
    N = pc.shape[0]

    # d(pc)/dxi for left-multiplicative exp update: [I | -hat(pc)]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(N, 3, 3)
    dpc = torch.cat([eye, -se3.hat(pc)], -1)             # (N, 3, 6)

    # projection Jacobians wrt pc
    zero = torch.zeros_like(x)
    Ju = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], -1)
    Jv = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], -1)
    Jur = torch.stack([fx * inv_z, zero, -fx * x * inv_z2 + bf * inv_z2], -1)
    Jproj = torch.stack([Ju, Jv, Jur], 1)                # (N, 3, 3)

    J = -(Jproj @ dpc)                                   # (N, 3, 6)
    return r, J, row_mask, is_stereo


def _chi2(r, row_mask, inv_sigma2):
    return (r * r * row_mask).sum(-1) * inv_sigma2


def solve_spd6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for a symmetric positive definite (6, 6) A.

    Gauss-Jordan elimination on the augmented (6, 7) matrix, unrolled:
    step k scales row k by its pivot and clears column k from every other
    row in one rank-1 update, so the whole solve is a fixed chain of ~25
    small ops with no host read.  No pivoting is needed: the pivots of an
    SPD matrix stay positive.
    """
    n = A.shape[0]
    is_row = torch.eye(n, dtype=torch.bool, device=A.device)
    M = torch.cat([A, b[:, None]], 1)
    for k in range(n):
        p = M[k] / M[k, k]
        # row k becomes p exactly (not M[k] - M[k, k] * p + p, which
        # cancels catastrophically in float32); every other row i loses
        # M[i, k] * p
        M = torch.where(is_row[:, k:k + 1], p, M - M[:, k:k + 1] * p)
    return M[:, n]


def _huber(chi2, is_st, use_kernel: bool):
    """(rho, w_huber) of the Huber kernel, or of the plain square when
    `use_kernel` is off (rounds 3-4); the static flag drops the kernel's
    ops from those rounds, with the same values as the JAX `where`."""
    if not use_kernel:
        return chi2, None
    delta = torch.where(is_st, _DELTA_STEREO, _DELTA_MONO)
    robust = chi2 > delta * delta
    sq = torch.sqrt(chi2.clamp(min=1e-12))
    rho = torch.where(robust, 2.0 * delta * sq - delta * delta, chi2)
    w = torch.where(robust, delta / sq, 1.0)
    return rho, w


def optimize_pose(
    Tcw0: torch.Tensor,
    obs: PoseObs,
    fx, fy, cx, cy, bf,
    rounds: int = 4,
    iters: int = 10,
):
    """Returns (Tcw_opt (4,4), inlier_mask (N,), n_inliers ()).

    fx, fy, cx, cy, bf: 0-dim float32 tensors on the device of `obs`, or
    Python numbers, which become such tensors once (ops/consts.py).
    """
    fx, fy, cx, cy, bf = (consts.scalar(v, Tcw0.device)
                          for v in (fx, fy, cx, cy, bf))

    def total_error(rho, row_mask, active):
        return torch.where(active & row_mask[:, 0], rho, 0.0).sum()

    T = Tcw0
    active = obs.mask
    eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
    for rnd in range(rounds):
        use_kernel = rnd < 2   # ref drops kernel after 2 rounds
        lam = torch.full((), 1e-3, dtype=T.dtype, device=T.device)
        for _ in range(iters):
            r, J, row_mask, is_st = _residual_jacobian(T, obs, fx, fy, cx,
                                                       cy, bf)
            chi2 = _chi2(r, row_mask, obs.inv_sigma2)
            rho, w_huber = _huber(chi2, is_st, use_kernel)
            w = obs.inv_sigma2 if w_huber is None else obs.inv_sigma2 * w_huber
            w_row = (w * active)[:, None] * row_mask      # (N, 3)
            Jw = (J * w_row[..., None]).reshape(-1, 6)
            H = Jw.T @ J.reshape(-1, 6)                   # (6, 6)
            g = Jw.T @ r.reshape(-1)                      # J^T W r

            # minimize ||r + J d||^2 -> d = -(J^T W J)^-1 J^T W r
            step = solve_spd6(H + lam * eye6, -g)
            T_new = se3.exp(step) @ T
            # the error at T reuses this iteration's residuals: the JAX
            # package recomputes the same values
            err_old = total_error(rho, row_mask, active)
            r_n, row_n, is_st_n, _, _ = _residual(T_new, obs, fx, fy, cx, cy,
                                                  bf)
            rho_n, _ = _huber(_chi2(r_n, row_n, obs.inv_sigma2), is_st_n,
                              use_kernel)
            err_new = total_error(rho_n, row_n, active)
            accept = err_new < err_old
            T = torch.where(accept, T_new, T)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        # reclassify: a point is an outlier for the next round if chi2 > th
        r, row_mask, is_st, _, _ = _residual(T, obs, fx, fy, cx, cy, bf)
        chi2 = _chi2(r, row_mask, obs.inv_sigma2)
        th = torch.where(is_st, CHI2_STEREO, CHI2_MONO)
        active = obs.mask & (chi2 <= th) & row_mask[:, 0]

    return T, active, active.sum()
