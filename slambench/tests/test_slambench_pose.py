"""The frozen pose solve (reference/pose_lm.py): it finds the pose that
explains a frame's matches, and its bfloat16 control does not."""

import numpy as np
import torch

from reference import pose_lm, truth

CAM = pose_lm.Cam(718.856, 718.856, 607.1928, 185.2157, 386.1448)


def _frame(seed, n=1200, stereo_share=0.8, noise_px=0.0):
    """Points 5.5-6.5 m ahead of a pose on the benchmark's orbit, their
    projections at random levels, and that pose."""
    rng = np.random.default_rng(seed)
    T = truth.orbit_poses(3, 3.0, 2.0, 0.3)[2]
    pc = rng.uniform(-1, 1, (n, 3)) * [4, 1.5, 0.5] + [0, 0, 6]
    pw = (np.linalg.inv(T) @ np.c_[pc, np.ones(n)].T).T[:, :3]
    octave = rng.integers(0, 8, n)
    u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx
    v = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy
    uv = np.c_[u, v, u - CAM.bf / pc[:, 2]]
    uv += rng.normal(0, noise_px, (n, 3)) * (1.2 ** octave)[:, None]
    uv[rng.random(n) >= stereo_share, 2] = -1.0
    return T, pw, uv, 1.2 ** (-2.0 * octave)


def _start(T):
    xi = torch.tensor([0.05, -0.03, 0.04, 0.01, -0.02, 0.015],
                      dtype=torch.float64)
    return pose_lm.exp_se3(xi).numpy() @ T


def test_exact_matches_give_the_true_pose():
    for seed, share in ((1, 0.8), (2, 0.0), (3, 1.0)):
        T, pw, uv, w = _frame(seed, stereo_share=share)
        mm, deg = pose_lm.gap(pose_lm.solve(_start(T), pw, uv, w, CAM), T)
        assert mm < 1e-6 and deg < 1e-8, (seed, mm, deg)


def test_the_solve_is_a_minimum_of_its_cost():
    T, pw, uv, w = _frame(4, noise_px=0.5)
    Ts = pose_lm.solve(_start(T), pw, uv, w, CAM)
    again = pose_lm.solve(Ts, pw, uv, w, CAM)
    assert max(pose_lm.gap(Ts, again)) < 1e-6
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    cam = pose_lm.Cam(*(t(x) for x in (CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                                       CAM.bf)))
    best = float(pose_lm.cost(t(Ts), t(pw), t(uv), t(w), cam))
    for k in range(6):
        for s in (-1e-5, 1e-5):
            xi = torch.zeros(6, dtype=torch.float64)
            xi[k] = s
            moved = pose_lm.exp_se3(xi) @ t(Ts)
            assert float(pose_lm.cost(moved, t(pw), t(uv), t(w), cam)) > best


def test_the_jacobian_matches_finite_differences():
    T, pw, uv, _ = _frame(5, n=50)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    cam = pose_lm.Cam(*(t(x) for x in (CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                                       CAM.bf)))
    r, J = pose_lm.residuals(t(T), t(pw), t(uv), cam)
    for k in range(6):
        xi = torch.zeros(6, dtype=torch.float64)
        xi[k] = 1e-7
        r2, _ = pose_lm.residuals(pose_lm.exp_se3(xi) @ t(T), t(pw), t(uv),
                                  cam)
        assert torch.allclose((r2 - r) / 1e-7, J[:, :, k], atol=1e-3)


def test_the_bfloat16_control_lands_far_from_the_reference():
    T, pw, uv, w = _frame(6, noise_px=0.5)
    ref = pose_lm.solve(_start(T), pw, uv, w, CAM)
    low = pose_lm.solve(_start(T), pw, uv, w, CAM, dtype=torch.bfloat16)
    mm, deg = pose_lm.gap(low, ref)
    assert mm > 5.0 and deg > 0.05, (mm, deg)


def test_gap_reads_distance_and_angle():
    T = truth.orbit_poses(1, 3.0, 1.0, 0.0)[0]
    turn = torch.tensor([0.0, 0.0, 0.0, 0.0, np.radians(0.5), 0.0],
                        dtype=torch.float64)
    mm, deg = pose_lm.gap(pose_lm.exp_se3(turn).numpy() @ T, T)
    assert abs(deg - 0.5) < 1e-9 and mm < 1e-9   # about the camera centre
    shift = torch.tensor([0.003, -0.004, 0.0, 0.0, 0.0, 0.0],
                         dtype=torch.float64)
    mm, deg = pose_lm.gap(pose_lm.exp_se3(shift).numpy() @ T, T)
    assert abs(mm - 5.0) < 1e-9 and deg < 1e-9


def test_a_start_on_the_programs_pose_set_reaches_its_pose():
    """A pose whose rotation block has drifted off orthonormality (a
    float32 pose compounded frame after frame) is reached exactly from
    the true pose carried onto its set, and missed from the rigid one."""
    T, pw, _, w = _frame(7)
    bent = T.copy()
    bent[:3, :3] *= 1.0 + 2e-4
    pc = pw @ bent[:3, :3].T + bent[:3, 3]
    uv = np.c_[CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
               CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy,
               CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx - CAM.bf / pc[:, 2]]
    assert abs(pose_lm.orthonormality(bent) - 4e-4) < 1e-6
    on = pose_lm.solve(pose_lm.start_on(_start(T), bent), pw, uv, w, CAM)
    assert max(pose_lm.gap(on, bent)) < 1e-6
    off = pose_lm.solve(_start(T), pw, uv, w, CAM)
    assert pose_lm.gap(off, bent)[0] > 0.03
