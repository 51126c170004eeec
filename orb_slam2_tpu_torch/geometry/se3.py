"""SE(3) Lie-group operations in PyTorch.

Port of orb_slam2_tpu/geometry/se3.py: the semantics the reference gets
from g2o::SE3Quat (ref: Thirdparty/g2o/g2o/types/se3quat.h) —
exponential and logarithm maps, composition, inversion — as plain
functions on tensors, batched over leading dims.  Poses are (4,4)
row-major world-to-camera matrices Tcw, the reference's convention
throughout (ref: include/Frame.h mTcw).

The small-angle branches keep the JAX package's `where` guards (a safe
denominator substituted BEFORE dividing, so no branch ever divides by
zero) and its `_EPS`.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """einsum("...ij,...j->...i")."""
    return (A @ x[..., None])[..., 0]


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    near = theta2 < _EPS
    theta2_safe = torch.where(near, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W
    a = torch.where(near, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(near, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    return _eye3(w) + a * W + b * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,3) axis-angle.

    theta via atan2 and the double-where pattern on the sin division;
    near theta = pi the axis comes from the diagonal.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    w_skew = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    skew2 = (w_skew * w_skew).sum(-1)
    sin_t = 0.5 * torch.sqrt(skew2 + _EPS * _EPS)
    theta = torch.atan2(sin_t, cos_t)
    small = sin_t < 1e-5
    sin_safe = torch.where(small, 1.0, sin_t)
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * sin_safe),
    )
    w = scale[..., None] * w_skew
    # near theta = pi the skew part vanishes; recover axis from diagonal
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis = torch.sqrt(((diag + 1.0) * 0.5).clamp(0.0, 1.0))
    one = torch.ones_like(theta)
    signs = torch.stack(
        [
            one,
            torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0, one, -one),
            torch.where(R[..., 0, 2] + R[..., 2, 0] >= 0, one, -one),
        ],
        -1,
    )
    w_pi = theta[..., None] * axis * signs
    return torch.where(near_pi[..., None], w_pi, w)


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J(w): (...,3) -> (...,3,3)."""
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    near = theta2 < _EPS
    theta2_safe = torch.where(near, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W
    b = torch.where(near, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(near, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return _eye3(w) + b * W + c * W2


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    near = theta2 < _EPS
    theta2_safe = torch.where(near, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W
    half_t = 0.5 * theta
    cot = torch.cos(half_t) / torch.sin(half_t).clamp(min=_EPS)
    k = torch.where(near, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half_t * cot) / theta2_safe)
    return _eye3(w) - 0.5 * W + k * W2


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (...,6) [rho, w] (translation first) -> (...,4,4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    return make_T(exp_so3(w), _matvec(_left_jacobian(w), rho))


def log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) -> (...,6) [rho, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = log_so3(R)
    return torch.cat([_matvec(_left_jacobian_inv(w), t), w], -1)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (...,4,4) from (...,3,3) and (...,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], -1)
    # [0, 0, 0, 1] from fills (an indexed store of a Python scalar is a
    # host copy, which a CUDA graph cannot capture)
    opts = dict(dtype=R.dtype, device=R.device)
    bottom = torch.cat([torch.zeros(batch + (1, 3), **opts),
                        torch.ones(batch + (1, 1), **opts)], -1)
    return torch.cat([top, bottom], -2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse (no linear solve)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -_matvec(Rt, t))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,3)."""
    return _matvec(T[..., :3, :3], p) + T[..., :3, 3]


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def camera_center(Tcw: torch.Tensor) -> torch.Tensor:
    """Ow = -Rcw^T tcw (ref: KeyFrame::GetCameraCenter semantics)."""
    R, t = Tcw[..., :3, :3], Tcw[..., :3, 3]
    return -_matvec(R.transpose(-1, -2), t)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) via SVD (drift cleanup)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)
    fix = torch.stack([one, one, det], -1)
    return (u * fix[..., None, :]) @ vt


def quat_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> unit quaternion (x,y,z,w), TUM trajectory order.

    Branch-free Shepperd's method: all four constructions, then `where`.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp(min=_EPS))

    # four candidate constructions; pick the numerically largest pivot
    qw0 = safe_sqrt(1.0 + tr) * 0.5
    c0 = torch.stack(
        [(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
         (m10 - m01) / (4 * qw0), qw0], -1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    c1 = torch.stack(
        [qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
         (m21 - m12) / (4 * qx1)], -1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    c2 = torch.stack(
        [(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
         (m02 - m20) / (4 * qy2)], -1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    c3 = torch.stack(
        [(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
         (m10 - m01) / (4 * qz3)], -1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None], c0,
        torch.where(cond1[..., None], c1,
                    torch.where(cond2[..., None], c2, c3)),
    )
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def rotation_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x,y,z,w) -> (...,3,3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                         2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                         2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )
