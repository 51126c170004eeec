"""Sim3 pose-graph (essential graph) optimization.

Port of orb_slam2_tpu/solvers/pose_graph.py, the replacement for
Optimizer::OptimizeEssentialGraph (ref: src/Optimizer.cc:781-1044): one
VertexSim3Expmap per keyframe (loop keyframe fixed), EdgeSim3 over loop
edges, spanning-tree edges, prior loop edges and strong-covisibility edges
(weight >= 100), optimized with LM.

Design: vertices are Sim3 triples (R (K,3,3), t (K,3), s (K,)); edges are
index pairs with Sim3 measurements.  The edge error is
log(S_meas^-1 * S_j * S_i^-1) in sim(3); Jacobians w.r.t. the two local
7-dim perturbations are computed by forward-mode autodiff
(`torch.func.vmap` of `jacfwd`: exact, batched), and the normal system is
assembled dense (7K x 7K) — a 200-keyframe map is a 1400x1400 solve.

Scatter-adds are `index_add_`, which accumulates with atomics on a CUDA
device: two solves there agree to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam2_tpu_torch.geometry import sim3


class PoseGraphProblem(NamedTuple):
    R: torch.Tensor          # (K, 3, 3) Siw rotations
    t: torch.Tensor          # (K, 3)
    s: torch.Tensor          # (K,)
    fixed: torch.Tensor      # (K,) bool
    vmask: torch.Tensor      # (K,) bool
    edge_i: torch.Tensor     # (E,) int64
    edge_j: torch.Tensor     # (E,) int64
    meas_R: torch.Tensor     # (E, 3, 3) measured S_ji = S_j * S_i^-1
    meas_t: torch.Tensor     # (E, 3)
    meas_s: torch.Tensor     # (E,)
    emask: torch.Tensor      # (E,) bool


def _edge_error(xi_i, xi_j, Si, Sj, Sm_inv):
    """Residual for one edge with local perturbations applied."""
    Si_p = sim3.compose(sim3.exp(xi_i), Si)
    Sj_p = sim3.compose(sim3.exp(xi_j), Sj)
    rel = sim3.compose(Sj_p, sim3.inverse(Si_p))
    return sim3.log(sim3.compose(Sm_inv, rel))


def _err_fn(xi_i, xi_j, si_r, si_t, si_s, sj_r, sj_t, sj_s, smr, smt, sms):
    return _edge_error(
        xi_i, xi_j, (si_r, si_t, si_s), (sj_r, sj_t, sj_s),
        (smr, smt, sms),
    )


def _edge_residual_jacobians(prob: PoseGraphProblem, jacobians: bool = True):
    """(r (E,7), Ji (E,7,7), Jj (E,7,7)) at zero perturbation; the
    Jacobians are None when not asked for.

    Under vmap each edge keeps a leading dimension of 1: under jvp + vmap
    a 0-dim tensor combined with a Python scalar is promoted to float64.
    """
    def one(S):
        return tuple(x[:, None] for x in S)

    Si = (prob.R[prob.edge_i], prob.t[prob.edge_i], prob.s[prob.edge_i])
    Sj = (prob.R[prob.edge_j], prob.t[prob.edge_j], prob.s[prob.edge_j])
    Sm_inv = sim3.inverse((prob.meas_R, prob.meas_t, prob.meas_s))
    zeros = torch.zeros((prob.edge_i.shape[0], 7), dtype=prob.t.dtype,
                        device=prob.t.device)
    r = _err_fn(zeros, zeros, *Si, *Sj, *Sm_inv)
    if not jacobians:
        return r, None, None
    args = (zeros[:, None], zeros[:, None], *one(Si), *one(Sj), *one(Sm_inv))
    Ji, Jj = torch.func.vmap(
        torch.func.jacfwd(_err_fn, argnums=(0, 1)))(*args)
    return r, Ji[:, 0, :, 0, :], Jj[:, 0, :, 0, :]


def _scatter(n, idx_a, val_a, idx_b, val_b):
    """zeros((n,) + tail) with val_a added at idx_a and val_b at idx_b."""
    out = torch.zeros((n,) + val_a.shape[1:], dtype=val_a.dtype,
                      device=val_a.device)
    return out.index_add_(0, idx_a, val_a).index_add_(0, idx_b, val_b)


def optimize(prob: PoseGraphProblem, iters: int = 20, mode: str = "dense",
             cg_iters: Optional[int] = None):
    """Returns optimized (R, t, s) per keyframe.

    mode="dense" materializes the 7K x 7K normal matrix (one solve, right
    for the <= a-few-hundred-KF maps); mode="cg" runs block-Jacobi
    preconditioned conjugate gradients with a matrix-free matvec over the
    per-edge 7x7 blocks — O(E) memory, the path for 1000+ keyframe
    essential graphs.  cg_iters defaults to 2K: with a block-Jacobi
    preconditioner a correction propagates ~1 vertex per CG step, so a
    K-ring (the dominant structure of an odometry pose graph) needs
    O(K) iterations — 100 fixed iterations under-converge a 1000-KF loop
    closure.  The CG loop is that many eager iterations."""
    K = prob.R.shape[0]
    if cg_iters is None:
        cg_iters = max(100, 2 * K)
    dtype, device = prob.t.dtype, prob.t.device
    ei, ej = prob.edge_i, prob.edge_j
    ew = prob.emask.to(dtype)
    freeze = prob.fixed | ~prob.vmask
    # frozen vertices contribute constraints but receive no update:
    # zero their Jacobians BEFORE assembly so the solve stays consistent
    wi = (ew * (~freeze[ei]).to(dtype))[:, None, None]
    wj = (ew * (~freeze[ej]).to(dtype))[:, None, None]
    ar = torch.arange(K, device=device)

    def total_error(R, t, s):
        r, _, _ = _edge_residual_jacobians(
            prob._replace(R=R, t=t, s=s), jacobians=False)
        return ((r * r).sum(-1) * ew).sum()

    R, t, s = prob.R, prob.t, prob.s
    lam = torch.tensor(1e-6, dtype=dtype, device=device)
    for _ in range(iters):
        r, Ji, Jj = _edge_residual_jacobians(prob._replace(R=R, t=t, s=s))
        Ji = Ji * wi
        Jj = Jj * wj
        rw = r * ew[:, None]

        # per-edge normal-equation blocks
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
        Hij = JiT @ Jj
        g = _scatter(K, ei, (JiT @ rw[..., None])[..., 0],
                     ej, (JjT @ rw[..., None])[..., 0])

        # block diagonal (shared by the dense path and the preconditioner)
        Hdiag = _scatter(K, ei, JiT @ Ji, ej, JjT @ Jj)
        # Marquardt damping scaled by the diagonal keeps step sizes sane
        # across the mixed rotation/translation/scale parametrization.
        ddiag = torch.diagonal(Hdiag, dim1=1, dim2=2)         # (K, 7)
        damp = lam * ddiag.clamp(min=1e-6) + 1e-8

        if mode == "dense":
            H = _scatter(K * K, ei * K + ej, Hij,
                         ej * K + ei, Hij.transpose(1, 2))
            H = H.reshape(K, K, 7, 7)
            H[ar, ar] += Hdiag
            H = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
            H = H + torch.diag(damp.reshape(-1))
            dx = torch.linalg.solve_ex(
                H, -g.reshape(-1, 1))[0].reshape(K, 7)
        else:
            dx = _solve_pcg(prob, Hdiag, Hij, damp, -g, iters=cg_iters)
        dx = torch.where(freeze[:, None], 0.0, dx)

        R_new, t_new, s_new = sim3.compose(sim3.exp(dx), (R, t, s))
        err_old = ((r * r).sum(-1) * ew).sum()
        accept = total_error(R_new, t_new, s_new) < err_old
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        s = torch.where(accept, s_new, s)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return R, t, s


def _solve_pcg(prob, Hdiag, Hij, damp, b, iters: int = 100):
    """Block-Jacobi PCG on the damped normal equations, matrix-free: the
    matvec scatters per-edge off-diagonal 7x7 blocks with segment sums,
    so memory is O(K + E) instead of O(K^2)."""
    K = b.shape[0]
    ei, ej = prob.edge_i, prob.edge_j
    Hd = Hdiag + torch.diag_embed(damp)
    Minv = torch.linalg.inv_ex(
        Hd + 1e-6 * torch.eye(7, dtype=Hd.dtype, device=Hd.device))[0]
    HijT = Hij.transpose(1, 2)

    def mv(A, x):
        return (A @ x[..., None])[..., 0]

    def matvec(x):                                           # x: (K, 7)
        return mv(Hd, x) + _scatter(K, ei, mv(Hij, x[ej]),
                                    ej, mv(HijT, x[ei]))

    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = mv(Minv, r)
    p = z
    for _ in range(iters):
        Ap = matvec(p)
        rz = (r * z).sum()
        alpha = rz / (p * Ap).sum().clamp(min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = mv(Minv, r)
        beta = (r * z).sum() / rz.clamp(min=1e-20)
        p = z + beta * p
    return x
