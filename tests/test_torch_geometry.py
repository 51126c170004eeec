"""The port's geometry/se3.py against orb_slam2_tpu.geometry.se3 on the
same seeded inputs (numpy), both on the CPU.

Tolerances: atol 1e-6 for exp, transform and the other closed forms, 1e-5
for log (atan2 and the sin division near 0 and pi amplify float32
rounding); measured max differences are in each test's docstring.  The
inputs cover theta = 0, theta below sqrt(_EPS) (the Taylor branches) and
theta near pi (log's diagonal branch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orb_slam2_tpu.geometry import se3 as jse3
from orb_slam2_tpu_torch.geometry import se3

torch.set_num_threads(2)


def _axis_angles():
    """(K, 3) float32 rotation vectors: random, zero, below sqrt(_EPS),
    and within 1e-4 of pi."""
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    thetas = np.concatenate([
        rng.uniform(0.01, 3.0, 6),        # generic
        [0.0, 3e-5, 9e-5],                # zero and theta^2 < _EPS
        [np.pi - 1e-4, np.pi - 5e-4, 3.0],
    ])
    return (axes * thetas[:, None]).astype(np.float32)


def _xis():
    rng = np.random.default_rng(1)
    w = _axis_angles()
    rho = rng.normal(0, 0.5, w.shape).astype(np.float32)
    return np.concatenate([rho, w], 1)


def _poses():
    rng = np.random.default_rng(2)
    R = Rotation.from_rotvec(_axis_angles().astype(np.float64)).as_matrix()
    T = np.tile(np.eye(4), (len(R), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(0, 2.0, (len(R), 3))
    return T.astype(np.float32)


def _j(f, *a):
    return np.asarray(f(*[jnp.asarray(x) for x in a]))


def _t(f, *a):
    return f(*[torch.from_numpy(np.ascontiguousarray(x)) for x in a]).numpy()


def test_hat_equal():
    w = _axis_angles()
    np.testing.assert_array_equal(_t(se3.hat, w), _j(jse3.hat, w))


@pytest.mark.parametrize("name", ["exp_so3", "_left_jacobian",
                                  "_left_jacobian_inv"])
def test_so3_closed_forms(name):
    """atol 1e-6 (measured <= 2.4e-7), Taylor branches included."""
    w = _axis_angles()
    a = _t(getattr(se3, name), w)
    b = _j(getattr(jse3, name), w)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_exp_se3():
    """atol 1e-6 (measured 2.4e-7)."""
    xi = _xis()
    np.testing.assert_allclose(_t(se3.exp, xi), _j(jse3.exp, xi), atol=1e-6,
                               rtol=0)


def test_log_so3_and_log_se3():
    """atol 1e-5, theta = 0, tiny theta and near pi included (measured:
    log_so3 equal, log 2.4e-7)."""
    T = _poses()
    np.testing.assert_allclose(_t(se3.log_so3, T[:, :3, :3]),
                               _j(jse3.log_so3, T[:, :3, :3]), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(_t(se3.log, T), _j(jse3.log, T), atol=1e-5,
                               rtol=0)


def test_log_inverts_exp_near_pi():
    """The diagonal branch recovers the angle near pi (within 1e-3 rad of
    the input, as float32 allows there)."""
    w = _axis_angles()[9:11]
    back = _t(se3.log_so3, _t(se3.exp_so3, w))
    np.testing.assert_allclose(np.linalg.norm(back, axis=1),
                               np.linalg.norm(w, axis=1), atol=1e-3)


@pytest.mark.parametrize("name", ["inverse", "camera_center", "rotation",
                                  "translation", "normalize_rotation_of"])
def test_pose_unary(name):
    """atol 1e-6 (measured <= 2.4e-7; the SVD of normalize_rotation
    7.7e-7)."""
    T = _poses()
    if name == "normalize_rotation_of":
        R = T[:, :3, :3] + np.float32(1e-3)
        a, b = _t(se3.normalize_rotation, R), _j(jse3.normalize_rotation, R)
    else:
        a, b = _t(getattr(se3, name), T), _j(getattr(jse3, name), T)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_make_T_broadcasts():
    T = _poses()
    R, t = T[:, :3, :3], T[0, :3, 3]
    np.testing.assert_array_equal(_t(se3.make_T, R, t), _j(jse3.make_T, R, t))


def test_compose_and_transform():
    """atol 1e-6 (measured: compose 2.4e-7, transform 4.8e-7)."""
    T = _poses()
    rng = np.random.default_rng(3)
    p = rng.normal(0, 5.0, (len(T), 3)).astype(np.float32)
    np.testing.assert_allclose(_t(se3.compose, T, T[::-1].copy()),
                               _j(jse3.compose, T, T[::-1]), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(_t(se3.transform, T, p),
                               _j(jse3.transform, T, p), atol=1e-6, rtol=0)


def test_quaternion_pair():
    """atol 1e-6 (measured 6e-8 and equal), every branch of Shepperd's
    pick."""
    T = _poses()
    R = np.concatenate([T[:, :3, :3], np.diag([1, -1, -1])[None],
                        np.diag([-1, 1, -1])[None],
                        np.diag([-1, -1, 1])[None]]).astype(np.float32)
    q = _t(se3.quat_from_rotation, R)
    np.testing.assert_allclose(q, _j(jse3.quat_from_rotation, R), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(_t(se3.rotation_from_quat, q),
                               _j(jse3.rotation_from_quat, q), atol=1e-6,
                               rtol=0)
