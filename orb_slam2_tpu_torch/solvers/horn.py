"""Horn 1987 closed-form absolute orientation (batched).

Port of orb_slam2_tpu/solvers/horn.py: the quaternion-eigenvector method
used by Sim3Solver::ComputeSim3 (ref: src/Sim3Solver.cc:226-337) and by
EPnP's final R,t estimation (ref: src/PnPsolver.cc:569-613, which uses the
SVD variant).  Batched over leading dims; weights allow masked/padded
point sets.  The 4x4 `eigh` fixes the quaternion only up to sign; q and -q
give the same rotation.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.geometry import se3


def eigh_nan(A: torch.Tensor):
    """`torch.linalg.eigh` that gives NaN eigenpairs for a matrix with a
    non-finite entry instead of raising (the solver behind it rejects
    such input; a degenerate RANSAC hypothesis must come out NaN and lose
    the inlier count, nothing more)."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    evals, evecs = torch.linalg.eigh(
        torch.where(bad[..., None, None], 0.0, A))
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(bad[..., None], nan, evals),
            torch.where(bad[..., None, None], nan, evecs))


def horn_align(
    p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor, with_scale: bool
):
    """Find (R, t, s) minimizing sum w_i || p2_i - (s R p1_i + t) ||^2.

    p1, p2: (..., N, 3); w: (..., N) nonnegative weights.
    Returns R (...,3,3), t (...,3), s (...).  With with_scale=False s = 1.
    Scale uses the reference's asymmetric formula s = <pr2, R pr1>/|R pr1|^2
    (ref: src/Sim3Solver.cc:292-309).
    """
    wn = w / w.sum(-1, keepdim=True).clamp(min=1e-12)
    c1 = (p1 * wn[..., None]).sum(-2)
    c2 = (p2 * wn[..., None]).sum(-2)
    q1 = (p1 - c1[..., None, :]) * w[..., None]
    q2 = p2 - c2[..., None, :]

    # M = sum w q1 q2^T  (correlation; with the N-matrix below the max-
    # eigenvalue quaternion gives R such that p2 ~ s R p1 + t)
    M = q1.transpose(-1, -2) @ q2

    # N matrix (4x4 symmetric), eigenvector of max eigenvalue = quaternion
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]

    N11 = Sxx + Syy + Szz
    N12 = Syz - Szy
    N13 = Szx - Sxz
    N14 = Sxy - Syx
    N22 = Sxx - Syy - Szz
    N23 = Sxy + Syx
    N24 = Szx + Sxz
    N33 = -Sxx + Syy - Szz
    N34 = Syz + Szy
    N44 = -Sxx - Syy + Szz

    Nm = torch.stack(
        [
            torch.stack([N11, N12, N13, N14], -1),
            torch.stack([N12, N22, N23, N24], -1),
            torch.stack([N13, N23, N33, N34], -1),
            torch.stack([N14, N24, N34, N44], -1),
        ],
        -2,
    )
    _, evecs = eigh_nan(Nm)
    q = evecs[..., :, -1]                      # max eigenvalue eigenvector
    # q = (w, x, y, z) in Horn's convention -> (x, y, z, w)
    quat = torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], -1)
    R = se3.rotation_from_quat(
        quat / torch.linalg.vector_norm(
            quat, dim=-1, keepdim=True).clamp(min=1e-12)
    )

    if with_scale:
        rp1 = (p1 - c1[..., None, :]) @ R.transpose(-1, -2)
        num = (q2 * rp1 * w[..., None]).sum((-1, -2))
        den = (rp1 * rp1 * w[..., None]).sum((-1, -2))
        s = num / den.clamp(min=1e-12)
    else:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)

    t = c2 - s[..., None] * se3._matvec(R, c1)
    return R, t, s
