"""A frozen plain essential-graph solve: ORB-SLAM2's
Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:781-1044), its
optimisation only.

One Sim3 vertex Siw (world to camera) a keyframe, the loop keyframe
fixed; one edge a pair (i, j) with the measurement Sji and information
I, whose error is g2o's EdgeSim3: log(Sji Si Sj^-1).  20 iterations of
g2o's Levenberg-Marquardt with its damping started at 1e-16
(setUserLambdaInit), every vertex updated as exp(delta) S, the scale held
where `fix_scale` (VertexSim3Expmap::_fix_scale = bFixScale: stereo and
RGB-D).  The vertices, the edges and their measurements are taken as
given: which edges the map has, and what they measure, is the loop
closer's to choose and not judged here.

Departures from ORB-SLAM2: those of reference/sim3.py (exact Jacobians,
the Taylor-series exponential, matrices for rotations), and the normal
equations are solved dense (g2o: LinearSolverEigen, a sparse Cholesky),
which gives the same step.  Imports numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import sim3


def optimize(R, t, s, fixed, vmask, edge_i, edge_j, meas_R, meas_t, meas_s,
             emask, fix_scale: bool, iters: int = 20, dtype=torch.float64,
             device="cpu"):
    """(R (K, 3, 3), t (K, 3), s (K,)) float64 arrays: every vertex in
    `vmask` after the solve (a vertex outside it, or fixed, is returned as
    given)."""
    t_ = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float64)).to(device=device, dtype=dtype)
    vmask = np.asarray(vmask, bool)
    emask = np.asarray(emask, bool)
    free = vmask & ~np.asarray(fixed, bool)
    col = np.full(len(vmask), -1, np.int64)
    col[free] = np.arange(int(free.sum()))
    ei = np.asarray(edge_i, np.int64)[emask]
    ej = np.asarray(edge_j, np.int64)[emask]
    d = 6 if fix_scale else 7
    n = d * int(free.sum())
    M = (t_(np.asarray(meas_R)[emask]), t_(np.asarray(meas_t)[emask]),
         t_(np.asarray(meas_s)[emask]))
    S = (t_(R), t_(t), t_(s))
    ci, cj = torch.as_tensor(col[ei], device=device), torch.as_tensor(
        col[ej], device=device)
    ei_t = torch.as_tensor(ei, device=device)
    ej_t = torch.as_tensor(ej, device=device)

    def errors(S, di=None, dj=None):
        Si = tuple(x[ei_t] for x in S)
        Sj = tuple(x[ej_t] for x in S)
        if di is not None:
            Si = sim3.perturbed(Si, di, fix_scale)
            Sj = sim3.perturbed(Sj, dj, fix_scale)
        return sim3.log(sim3.compose(sim3.compose(M, Si), sim3.inverse(Sj)))

    def cost(S):
        e = errors(S)
        return (e * e).sum()

    def linearize(S):
        e = errors(S)
        z = torch.zeros(len(ei), d, dtype=dtype, device=device)
        Ji = sim3.jacobian(lambda x: errors(S, x, z), d, z)   # (E, 7, d)
        Jj = sim3.jacobian(lambda x: errors(S, z, x), d, z)
        H = torch.zeros(n + d, n + d, dtype=dtype, device=device)
        b = torch.zeros(n + d, dtype=dtype, device=device)
        # a fixed vertex's block goes to the spare block at n and is cut
        rows_i = torch.where(ci >= 0, ci, n // d)[:, None] * d + torch.arange(
            d, device=device)
        rows_j = torch.where(cj >= 0, cj, n // d)[:, None] * d + torch.arange(
            d, device=device)
        for ra, Ja in ((rows_i, Ji), (rows_j, Jj)):
            b.index_put_((ra.reshape(-1),), -torch.einsum(
                "ekd,ek->ed", Ja, e).reshape(-1), accumulate=True)
            for rb, Jb in ((rows_i, Ji), (rows_j, Jj)):
                blk = torch.einsum("eka,ekb->eab", Ja, Jb)
                H.index_put_((ra[:, :, None].expand(-1, d, d).reshape(-1),
                              rb[:, None, :].expand(-1, d, d).reshape(-1)),
                             blk.reshape(-1), accumulate=True)
        return (e * e).sum(), H[:n, :n], b[:n]

    free_t = torch.as_tensor(free, device=device)

    def update(S, x):
        delta = torch.zeros(len(vmask), d, dtype=dtype, device=device)
        delta[free_t] = x.reshape(-1, d)
        return sim3.perturbed(S, delta, fix_scale)

    if n:
        S = sim3.levenberg(S, linearize, cost, update, iters, lam_init=1e-16)
    return tuple(x.to(torch.float64).cpu().numpy() for x in S)


def se3_of(R, t, s):
    """ORB-SLAM2's write-back of an optimised Siw: [R, t / s]."""
    return R, t / np.asarray(s)[..., None], np.ones_like(np.asarray(s))
