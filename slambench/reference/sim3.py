"""A frozen plain Sim3 refinement: ORB-SLAM2's Optimizer::OptimizeSim3
(src/Optimizer.cc:1046-1241), with the Sim3 group and g2o's
Levenberg-Marquardt that reference/pose_graph.py shares.

S12 = (R, t, s) maps camera-2 coordinates into camera 1: p1 = s R p2 + t.
A loop's matches are points in each keyframe's camera frame (pc1, pc2),
the pixels each keyframe observed (uv1, uv2) and 1 / sigma^2 of their
levels.  Each match gives the two edges of EdgeSim3ProjectXYZ and
EdgeInverseSim3ProjectXYZ: e12 = uv1 - proj(S12 pc2) and
e21 = uv2 - proj(S12^-1 pc1), each with information inv_sigma2 I and a
Huber kernel of delta sqrt(chi2_th).  The schedule is ORB-SLAM2's: 5
iterations; a match whose either edge reads chi2 > chi2_th is dropped;
with fewer than 10 left the solve fails; then 10 more iterations where
any was dropped and 5 where none was; the inliers are the matches left
whose both edges read chi2 <= chi2_th.  The scale is held where
`fix_scale` (stereo and RGB-D: LoopClosing's mbFixScale).

Departures from ORB-SLAM2, none of which moves the optimum:
- Jacobians are exact (forward-mode differentiation) where g2o takes
  central differences;
- the update is exp(delta) S with delta = [omega, upsilon, sigma], the
  exponential and its V matrix by one Taylor series (Horner, 30 terms)
  where g2o's Sim3(update) uses closed forms with branches; a fixed
  scale drops sigma from the system where g2o's oplus zeroes it (its
  numeric Jacobian column is then zero: the same step);
- rotations are kept as matrices, not quaternions; a cost that is not
  finite counts as infinite in the step test.

Every input is first rounded to the dtype asked for and every step is
computed in it: float64 for the reference, bfloat16 for the control.
Imports numpy and torch only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ORDER = 30          # Taylor terms of exp and phi1; |sigma I + Omega| <= ~4


# ---- the Sim3 group

def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _eye(like, n=3):
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        like.shape[:-2] + (n, n))


def exp_and_phi1(G):
    """(e^G, phi1(G) = sum G^n / (n + 1)!) of (..., 3, 3) G, by Horner."""
    eye = _eye(G)
    E, P = eye, eye
    for n in range(ORDER, 0, -1):
        E = eye + (G @ E) / n
        P = eye + (G @ P) / (n + 1)
    return E, P


def _matvec(M, v):
    return (M @ v[..., None])[..., 0]


def _solve3(M, v):
    """M^-1 v for (..., 3, 3) M by its adjugate: any dtype."""
    c0 = torch.cross(M[..., 1, :], M[..., 2, :], dim=-1)
    c1 = torch.cross(M[..., 2, :], M[..., 0, :], dim=-1)
    c2 = torch.cross(M[..., 0, :], M[..., 1, :], dim=-1)
    adj = torch.stack([c0, c1, c2], -1)
    det = (M[..., 0, :] * c0).sum(-1)
    return _matvec(adj, v) / det[..., None]


def exp(xi):
    """(R, t, s) of xi = [omega (3), upsilon (3), sigma]: s = e^sigma,
    R = exp(hat(omega)), t = V upsilon, V = phi1(sigma I + hat(omega))."""
    w, u, sig = xi[..., :3], xi[..., 3:6], xi[..., 6]
    G = hat(w) + sig[..., None, None] * _eye(hat(w))
    E, V = exp_and_phi1(G)
    s = torch.exp(sig)
    return E / s[..., None, None], _matvec(V, u), s


def log(S):
    """The inverse of `exp` near the identity: [omega, upsilon, sigma]."""
    R, t, s = S
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    nv = torch.sqrt((v * v).sum(-1) + 1e-30)
    c = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0
    th = torch.atan2(nv / 2.0, c)
    f = torch.where(nv < 1e-4, 0.5 + nv * nv / 48.0, th / nv)
    w = f[..., None] * v
    sig = torch.log(s)
    G = hat(w) + sig[..., None, None] * _eye(R)
    _, V = exp_and_phi1(G)
    return torch.cat([w, _solve3(V, t), sig[..., None]], -1)


def compose(A, B):
    """A o B: apply B first."""
    Ra, ta, sa = A
    Rb, tb, sb = B
    return Ra @ Rb, sa[..., None] * _matvec(Ra, tb) + ta, sa * sb


def inverse(S):
    R, t, s = S
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t) / s[..., None], 1.0 / s


def apply(S, p):
    R, t, s = S
    return s[..., None] * _matvec(R, p) + t


def perturbed(S, delta, fix_scale: bool):
    """exp(delta) S; with a fixed scale delta has 6 entries."""
    if fix_scale:
        delta = torch.cat([delta, torch.zeros_like(delta[..., :1])], -1)
    return compose(exp(delta), S)


def jacobian(f, n: int, like):
    """(..., m, n): d f(delta) / d delta at delta = 0, one forward-mode
    pass a direction; f maps (..., n) to (..., m) row by row."""
    zero = torch.zeros(like.shape[:-1] + (n,), dtype=like.dtype,
                       device=like.device)
    cols = []
    for k in range(n):
        e = torch.zeros_like(zero)
        e[..., k] = 1.0
        cols.append(torch.func.jvp(f, (zero,), (e,))[1])
    return torch.stack(cols, -1)


# ---- g2o's Levenberg-Marquardt

def solve_spd(A, b):
    """x with A x = b: LU in float64, Gauss-Jordan in A's dtype else."""
    if A.dtype == torch.float64:
        return torch.linalg.solve(A, b)
    n = A.shape[0]
    M = torch.cat([A, b[:, None]], 1)
    for k in range(n):
        p = M[k] / M[k, k]
        M = M - M[:, k:k + 1] * p
        M[k] = p
    return M[:, n]


def levenberg(state, linearize, cost, update, iters: int,
              lam_init=None):
    """g2o's OptimizationAlgorithmLevenberg over `iters` iterations of one
    optimize() call: linearize(state) -> (chi, H, b) with H x = b the
    step, cost(state) -> chi, update(state, x) -> state.  The damping
    starts at lam_init or 1e-5 times H's largest diagonal entry, is
    added to the diagonal, falls by max(1/3, min(2/3, 1 - (2 rho - 1)^3))
    after a good step and grows by 2, 4, 8, ... after a bad one, for at
    most 10 trials an iteration; the run ends where those fail or the
    gain is 0."""
    lam = ni = None
    for it in range(iters):
        chi, H, b = linearize(state)
        chi = float(chi)
        if it == 0:
            lam = (float(lam_init) if lam_init is not None
                   else 1e-5 * float(torch.diagonal(H).max()))
            ni = 2.0
        eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        q, rho = 0, -1.0
        while True:
            x = solve_spd(H + lam * eye, b)
            new = update(state, x)
            chi_new = float(cost(new))
            if not math.isfinite(chi_new):
                chi_new = math.inf
            scale = float((x * (lam * x + b)).sum()) + 1e-3
            rho = (chi - chi_new) / scale
            if rho > 0 and math.isfinite(chi_new):
                alpha = min(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
                lam *= max(1.0 / 3.0, alpha)
                ni = 2.0
                state = new
            else:
                lam *= ni
                ni *= 2.0
            q += 1
            if not (rho < 0 and q < 10):
                break
        if q == 10 or rho == 0:
            break
    return state


# ---- OptimizeSim3

class Sim3Result(NamedTuple):
    R: np.ndarray           # (3, 3) float64
    t: np.ndarray           # (3,)
    s: float
    inliers: np.ndarray     # (N,) bool
    n_inliers: int
    ok: bool                # False: fewer than 10 matches after the drop


def _project(p, cam):
    fx, fy, cx, cy = cam
    return torch.stack([fx * p[..., 0] / p[..., 2] + cx,
                        fy * p[..., 1] / p[..., 2] + cy], -1)


def edges(S12, pc1, pc2, uv1, uv2, cam):
    """(N, 2) e12 and (N, 2) e21: observed minus projected."""
    e12 = uv1 - _project(apply(S12, pc2), cam)
    e21 = uv2 - _project(apply(inverse(S12), pc1), cam)
    return e12, e21


def _chi2(S, P, w1, w2, cam):
    e12, e21 = edges(S, *P, cam)
    return w1 * (e12 * e12).sum(-1), w2 * (e21 * e21).sum(-1)


def _huber(c, delta):
    return torch.where(c <= delta * delta, c,
                       2.0 * delta * torch.sqrt(c) - delta * delta)


def optimize_sim3(pc1, pc2, uv1, uv2, inv_s2_1, inv_s2_2, mask, R12, t12,
                  s12, cam, fix_scale: bool, chi2_th: float = 10.0,
                  dtype=torch.float64, device="cpu") -> Sim3Result:
    """OptimizeSim3 from the start (R12, t12, s12) over the rows in
    `mask`; cam = (fx, fy, cx, cy)."""
    t_ = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float64)).to(device=device, dtype=dtype)
    keep = np.nonzero(np.asarray(mask, bool))[0]
    P = tuple(t_(np.asarray(a)[keep]) for a in (pc1, pc2, uv1, uv2))
    w1, w2 = t_(np.asarray(inv_s2_1)[keep]), t_(np.asarray(inv_s2_2)[keep])
    # no 0-dim tensors: under jvp one meeting a Python number is promoted
    # to float64
    cam = tuple(t_([c]) for c in cam)
    delta = math.sqrt(chi2_th)
    n = 6 if fix_scale else 7
    S = (t_(R12), t_(t12), t_([s12]))

    def run(S, active, iters):
        def cost(S):
            c1, c2 = _chi2(S, P, w1, w2, cam)
            return ((_huber(c1, delta) + _huber(c2, delta)) * active).sum()

        def linearize(S):
            def r(d):
                return torch.cat(edges(perturbed(S, d, fix_scale), *P, cam),
                                 -1)

            e = r(torch.zeros(n, dtype=dtype, device=device))
            J = jacobian(r, n, torch.zeros(n, dtype=dtype, device=device))
            c1, c2 = _chi2(S, P, w1, w2, cam)
            # IRLS weight rho'(chi2) times the information, per edge
            k1 = torch.where(c1 <= delta * delta, 1.0,
                             delta / torch.sqrt(c1)) * w1 * active
            k2 = torch.where(c2 <= delta * delta, 1.0,
                             delta / torch.sqrt(c2)) * w2 * active
            k = torch.stack([k1, k1, k2, k2], -1)                 # (N, 4)
            H = torch.einsum("ri,r,rj->ij", J.reshape(-1, n),
                             k.reshape(-1), J.reshape(-1, n))
            b = -torch.einsum("ri,r->i", J.reshape(-1, n),
                              (k * e).reshape(-1))
            return cost(S), H, b

        return levenberg(S, linearize, cost,
                         lambda S, x: perturbed(S, x, fix_scale), iters)

    ones = torch.ones(len(keep), dtype=dtype, device=device)
    S = run(S, ones, 5)
    c1, c2 = _chi2(S, P, w1, w2, cam)
    active = ((c1 <= chi2_th) & (c2 <= chi2_th)).to(dtype)
    n_bad = len(keep) - int(active.sum())
    ok = len(keep) - n_bad >= 10
    if ok:
        S = run(S, active, 10 if n_bad > 0 else 5)
    c1, c2 = _chi2(S, P, w1, w2, cam)
    inl_k = ((c1 <= chi2_th) & (c2 <= chi2_th) & (active > 0)).cpu().numpy()
    inl = np.zeros(len(np.asarray(mask)), bool)
    inl[keep] = inl_k
    R, t, s = (x.to(torch.float64).cpu().numpy() for x in S)
    return Sim3Result(R, t, float(s[0]), inl, int(inl.sum()), bool(ok))


def centre(R, t, s) -> np.ndarray:
    """The camera centre of a world-to-camera Sim3 (or SE3 with s = 1)."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    return -(np.swapaxes(R, -1, -2) @ t[..., None])[..., 0] / np.asarray(
        s, np.float64)[..., None]


def gap(Ra, ta, sa, Rb, tb, sb) -> tuple:
    """(camera-centre distance in mm, rotation angle in degrees) between
    two world-to-camera Sim3s, element by element over leading axes."""
    d = np.linalg.norm(centre(Ra, ta, sa) - centre(Rb, tb, sb), axis=-1)
    M = np.asarray(Ra, np.float64) @ np.swapaxes(
        np.asarray(Rb, np.float64), -1, -2)
    v = np.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                  M[..., 1, 0] - M[..., 0, 1]], -1)
    c = (np.trace(M, axis1=-2, axis2=-1) - 1.0) / 2.0
    ang = np.degrees(np.arctan2(np.linalg.norm(v, axis=-1) / 2.0, c))
    return d * 1e3, ang
