"""A frozen plain pose solve: the camera pose that best explains one
frame's matches.

The cost is the one ORB-SLAM2's pose optimization ends on
(Optimizer::PoseOptimization, src/Optimizer.cc:367-442, its last rounds,
where the robust kernel is dropped): over the frame's inlier matches, the
squared reprojection residual of (u, v) for a monocular match and of
(u, v, u_right) for a stereo or RGB-D one (u_right >= 0), each over its
level's variance.  Levenberg-Marquardt with the left-multiplied update
T <- exp(xi) T, run to convergence in the dtype asked for: float64 for
the reference, bfloat16 for the control.  Imports numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_se3(xi):
    """4x4 transform of xi = [rho, omega] (Rodrigues, with the series
    near zero), in xi's dtype."""
    rho, w = xi[:3], xi[3:]
    th2 = (w * w).sum()
    th = torch.sqrt(th2)
    W = _hat(w)
    small = th2 < 1e-10
    th_s = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th_s) / th_s)
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(th_s)) / (th_s * th_s))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th_s - torch.sin(th_s)) / (th_s * th_s * th_s))
    eye = torch.eye(3, dtype=xi.dtype)
    R = eye + a * W + b * (W @ W)
    V = eye + b * W + c * (W @ W)
    T = torch.eye(4, dtype=xi.dtype)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def _solve(A, b):
    """x with A x = b, A symmetric positive definite: Gauss-Jordan in
    A's dtype."""
    n = A.shape[0]
    M = torch.cat([A, b[:, None]], 1)
    for k in range(n):
        p = M[k] / M[k, k]
        M = M - M[:, k:k + 1] * p
        M[k] = p
    return M[:, n]


class Cam:
    def __init__(self, fx, fy, cx, cy, bf):
        self.fx, self.fy, self.cx, self.cy, self.bf = fx, fy, cx, cy, bf


def residuals(T, pts, uv, cam: Cam):
    """(N, 3) observed minus projected, the u_right row zero where the
    match is monocular, and (N, 3, 6) d(residual)/d(xi)."""
    pc = pts @ T[:3, :3].T + T[:3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    iz = 1.0 / z
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    st = (uv[:, 2] >= 0).to(pc.dtype)
    r = torch.stack([uv[:, 0] - u, uv[:, 1] - v, (uv[:, 2] - ur) * st], -1)
    zero = torch.zeros_like(x)
    iz2 = iz * iz
    Ju = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1)
    Jv = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1)
    Jr = torch.stack([cam.fx * iz, zero, (-cam.fx * x + cam.bf) * iz2], -1)
    Jp = torch.stack([Ju, Jv, Jr * st[:, None]], 1)          # (N, 3, 3)
    eye = torch.eye(3, dtype=pc.dtype).expand(len(pc), 3, 3)
    dpc = torch.cat([eye, -_hat(pc)], -1)                     # (N, 3, 6)
    return r, -(Jp @ dpc)


def cost(T, pts, uv, inv_s2, cam: Cam):
    r, _ = residuals(T, pts, uv, cam)
    return ((r * r).sum(-1) * inv_s2).sum()


def solve(T0, pts, uv, inv_s2, cam: Cam, dtype=torch.float64,
          iters: int = 60) -> np.ndarray:
    """The pose (4x4 float64 array) minimising `cost`, from T0.  pts (N, 3)
    world points, uv (N, 3) [u, v, u_right], inv_s2 (N,) 1 / sigma^2;
    every input is first rounded to `dtype`, and every step is computed
    in it."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dtype)  # noqa: E731
    T, P, O, w = t(T0), t(pts), t(uv), t(inv_s2)
    cam = Cam(*(t(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)))
    lam = torch.tensor(1e-3, dtype=dtype)
    eye6 = torch.eye(6, dtype=dtype)
    err = cost(T, P, O, w, cam)
    for _ in range(iters):
        r, J = residuals(T, P, O, cam)
        Jw = J * w[:, None, None]
        H = torch.einsum("nki,nkj->ij", Jw, J)
        g = torch.einsum("nki,nk->i", Jw, r)
        step = _solve(H + lam * torch.diag(torch.diagonal(H)) + lam * eye6,
                      -g)
        T_new = exp_se3(step) @ T
        err_new = cost(T_new, P, O, w, cam)
        if bool(err_new < err):
            T, err, lam = T_new, err_new, lam * 0.5
            if float(step.abs().max()) < 1e-12:
                break
        else:
            lam = lam * 4.0
            if float(lam) > 1e12:
                break
    return T.to(torch.float64).numpy()


def start_on(T_at: np.ndarray, T_like: np.ndarray) -> np.ndarray:
    """A start at the pose `T_at` with the shape of `T_like`'s rotation
    block: the rigid motion nearest to T_at T_like^-1, times T_like.
    `solve` moves a pose by rigid motions only (T <- exp(xi) T), so it
    then searches the set of poses the program's own solve searched,
    whatever `T_like`'s rotation block has lost of being a rotation."""
    M = T_at @ np.linalg.inv(T_like)
    U, _, Vt = np.linalg.svd(M[:3, :3])
    D = np.eye(4)
    D[:3, :3] = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    D[:3, 3] = M[:3, 3]
    return D @ T_like


def orthonormality(T: np.ndarray) -> float:
    """How far a pose's rotation block is from a rotation: the largest
    entry of R R^T - I."""
    R = np.asarray(T, np.float64)[:3, :3]
    return float(np.abs(R @ R.T - np.eye(3)).max())


def gap(Ta: np.ndarray, Tb: np.ndarray) -> tuple:
    """(camera-centre distance in mm, rotation angle in degrees) between
    two world-to-camera poses (centres and relative rotation through the
    inverse, so that a rotation block off orthonormality reads right)."""
    Ca = np.linalg.inv(Ta)[:3, 3]
    Cb = np.linalg.inv(Tb)[:3, 3]
    R = Ta[:3, :3] @ np.linalg.inv(Tb[:3, :3])
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2.0
    c = (np.trace(R) - 1.0) / 2.0
    return (float(np.linalg.norm(Ca - Cb)) * 1e3,
            float(np.degrees(np.arctan2(s, c))))
