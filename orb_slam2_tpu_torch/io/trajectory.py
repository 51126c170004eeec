"""Trajectory writers: TUM and KITTI formats, byte-compatible with the
reference's savers (ref: src/System.cc:326-478).

Port of orb_slam2_tpu/io/trajectory.py; the rotation-to-quaternion step
runs the port's geometry/se3.py on a CPU tensor."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.slam.map_store import MapStore
from orb_slam2_tpu_torch.slam.tracking import TrajectoryEntry


def _resolve_reference(store: MapStore, kf: int) -> np.ndarray:
    """Walk the spanning tree past culled keyframes, accumulating the
    stored child-to-parent transforms (ref: src/System.cc:360-374)."""
    Trw = np.eye(4, dtype=np.float32)
    while kf >= 0 and not store.kf_valid[kf]:
        Trw = Trw @ store.kf_Tcp[kf]
        kf = int(store.kf_parent[kf])
    if kf >= 0:
        Trw = Trw @ store.kf_pose[kf]
    return Trw


def _quat_wxyz_from_R(Rwc: np.ndarray) -> np.ndarray:
    R = torch.from_numpy(np.array(Rwc, np.float32))
    return se3.quat_from_rotation(R).numpy()  # (x, y, z, w)


def save_trajectory_tum(store: MapStore, trajectory: List[TrajectoryEntry],
                        path: str):
    """Per-frame camera-to-world poses in TUM format
    `t tx ty tz qx qy qz qw` (ref: System::SaveTrajectoryTUM
    src/System.cc:326-387).  Lost frames are skipped like the reference."""
    with open(path, "w") as f:
        for e in trajectory:
            if e.lost:
                continue
            Trw = _resolve_reference(store, e.ref_kf)
            Tcw = e.Tcr @ Trw
            Rwc = Tcw[:3, :3].T
            twc = -Rwc @ Tcw[:3, 3]
            q = _quat_wxyz_from_R(Rwc)
            f.write(
                f"{e.timestamp:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_keyframe_trajectory_tum(store: MapStore, path: str):
    """ref: System::SaveKeyFrameTrajectoryTUM (src/System.cc:389-423)."""
    with open(path, "w") as f:
        for kf in store.valid_kf_ids():
            T = store.kf_pose[kf]
            Rwc = T[:3, :3].T
            twc = -Rwc @ T[:3, 3]
            q = _quat_wxyz_from_R(Rwc)
            f.write(
                f"{store.kf_timestamp[kf]:.6f} "
                f"{twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_trajectory_kitti(store: MapStore, trajectory: List[TrajectoryEntry],
                          path: str):
    """12-number Twc rows (ref: System::SaveTrajectoryKITTI
    src/System.cc:425-478)."""
    with open(path, "w") as f:
        for e in trajectory:
            Trw = _resolve_reference(store, e.ref_kf)
            Tcw = e.Tcr @ Trw
            Rwc = Tcw[:3, :3].T
            twc = -Rwc @ Tcw[:3, 3]
            vals = [
                Rwc[0, 0], Rwc[0, 1], Rwc[0, 2], twc[0],
                Rwc[1, 0], Rwc[1, 1], Rwc[1, 2], twc[1],
                Rwc[2, 0], Rwc[2, 1], Rwc[2, 2], twc[2],
            ]
            f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error after Horn alignment (the evaluation the
    reference defers to TUM's external tools, README.md:105-109).

    est, gt: (N, 3) matched positions."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    err = E @ R - G   # unscaled: stereo/RGB-D have true scale
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def rpe_rmse(est_T: np.ndarray, gt_T: np.ndarray,
             delta: int = 1) -> tuple:
    """Relative pose error over a fixed frame delta (TUM benchmark's
    evaluate_rpe.py metric the reference README points users at).

    est_T, gt_T: (N, 4, 4) matched Tcw poses.  Returns
    (trans_rmse, rot_rmse_rad)."""
    n = len(est_T)
    if n <= delta:
        return 0.0, 0.0
    t_errs, r_errs = [], []
    for i in range(n - delta):
        de = est_T[i + delta] @ np.linalg.inv(est_T[i])
        dg = gt_T[i + delta] @ np.linalg.inv(gt_T[i])
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_errs.append(np.arccos(c))
    t_errs = np.array(t_errs)
    r_errs = np.array(r_errs)
    return (float(np.sqrt((t_errs ** 2).mean())),
            float(np.sqrt((r_errs ** 2).mean())))


def ate_rmse_scaled(est: np.ndarray, gt: np.ndarray) -> float:
    """Sim(3)-aligned ATE for monocular (scale ambiguity)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    U, sv, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(sv) @ S) / max((E ** 2).sum(), 1e-12)
    err = s * (E @ R) - G
    return float(np.sqrt((err ** 2).sum(-1).mean()))
