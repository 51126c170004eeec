"""Sim(3) operations in PyTorch.

Port of orb_slam2_tpu/geometry/sim3.py: the functional equivalent of
g2o::Sim3 (ref: Thirdparty/g2o/g2o/types/sim3.h) used by loop closing and
essential-graph optimization.  A Sim3 element is a (...,7) vector
[rho(3), omega(3), sigma(1)] in tangent space or an (R, t, s) triple /
4x4-with-scale matrix in the group.  Every function is functional (no
in-place write, no host read), so `torch.func.vmap` and `jacfwd` go
through it.

Group action: p' = s * R @ p + t.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.geometry import se3


def make(R: torch.Tensor, t: torch.Tensor, s):
    """Pack (R, t, s) into a tuple; s may be scalar or (...,)."""
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    return (R, t, s.expand(R.shape[:-2]))


def identity(dtype=torch.float32, batch=(), device="cpu"):
    R = torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3))
    t = torch.zeros(batch + (3,), dtype=dtype, device=device)
    s = torch.ones(batch, dtype=dtype, device=device)
    return (R, t, s)


def from_se3(T: torch.Tensor, s=1.0):
    return make(T[..., :3, :3], T[..., :3, 3], s)


def to_se3(S) -> torch.Tensor:
    """[R, t/s] — the reference's recovery of SE3 from an optimized Sim3
    (ref: src/Optimizer.cc:991-1010 and src/LoopClosing.cc:500)."""
    R, t, s = S
    return se3.make_T(R, t / s[..., None])


def apply(S, p: torch.Tensor) -> torch.Tensor:
    R, t, s = S
    return s[..., None] * se3._matvec(R, p) + t


def compose(A, B):
    """A ∘ B : (s_a R_a (s_b R_b p + t_b) + t_a)."""
    Ra, ta, sa = A
    Rb, tb, sb = B
    R = Ra @ Rb
    t = sa[..., None] * se3._matvec(Ra, tb) + ta
    return (R, t, sa * sb)


def inverse(S):
    R, t, s = S
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * se3._matvec(Rt, t)
    return (Rt, t_inv, s_inv)


def _phi1_V(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """V(w, sigma) = integral_0^1 e^{sigma u} exp(u*hat(w)) du = phi1(G)
    with G = sigma*I + hat(w)  (sigma*I commutes with hat(w)).

    Evaluated branch-free by scaling-and-squaring on the doubling identity
    phi1(2A) = (e^A + I)/2 * phi1(A),  e^{2A} = (e^A)^2, with a short Taylor
    series at the scaled-down argument.  Uniformly accurate in f32 for
    |w| <= pi + |sigma| <= ~8 (the closed-form coefficient formulas suffer
    catastrophic cancellation for small theta/sigma in f32), and exact to
    machine eps under forward/reverse autodiff — required by the pose-graph
    Jacobians (ref semantics: Thirdparty/g2o/g2o/types/sim3.h ctor).
    """
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    G = se3.hat(w) + sigma[..., None, None] * eye
    SQUARINGS = 7  # handles ||G|| up to ~8 with scaled norm <= 1/16
    A = G * (1.0 / (1 << SQUARINGS))
    # phi1(A) = I + A/2! + A^2/3! + ... ; e^A = I + A*phi1(A)
    P = (eye / 5040.0).expand(G.shape)
    for k in (720.0, 120.0, 24.0, 6.0, 2.0, 1.0):
        P = eye / k + A @ P
    E = eye + A @ P
    for _ in range(SQUARINGS):
        P = 0.5 * (E + eye) @ P
        E = E @ E
    return P


def exp(xi: torch.Tensor):
    """sim(3) exp: (...,7) [rho, omega, sigma] -> (R, t, s).

    Same semantics as g2o's Sim3 7-vector ctor (sim3.h); t = V(w,sigma) rho
    with V evaluated by the branch-free phi1 scheme above.
    """
    rho, w, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = se3.exp_so3(w)
    V = _phi1_V(w, sigma)
    return (R, se3._matvec(V, rho), s)


def log(S) -> torch.Tensor:
    """(R, t, s) -> (...,7) [rho, omega, sigma].

    V from `exp` is inverted in closed form (3x3 adjugate) — cheap and
    robust for the magnitudes seen in pose graphs.  (Not `solve_ex`: its
    forward-mode derivative under vmap returns inf/nan rows for some
    batch positions in torch 2.x.)
    """
    R, t, s = S
    w = se3.log_so3(R)
    sigma = torch.log(s)
    V = _phi1_V(w, sigma)
    rho = se3._matvec(se3.inv3x3(V), t)
    return torch.cat([rho, w, sigma[..., None]], -1)


def matrix(S) -> torch.Tensor:
    """(R, t, s) -> (...,4,4) with sR in the rotation block."""
    R, t, s = S
    return se3.make_T(s[..., None, None] * R, t)


def from_matrix(M: torch.Tensor):
    """Inverse of `matrix`: recover s = det(sR)^(1/3)."""
    A = M[..., :3, :3]
    det = torch.linalg.det(A)
    s = torch.sign(det) * det.abs().pow(1.0 / 3.0)
    return (A / s[..., None, None], M[..., :3, 3], s)
