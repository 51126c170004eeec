"""The generator's true poses, and the plain numpy judges of a run's map.

`orbit_poses` is the camera path every cell's frames are rendered from: a
circle of radius r, the camera looking radially outward, starting at
azimuth `phase` and turning `deg_per_frame` a frame.  The judges read
the program's outputs (its keyframe poses, map points, observations and
per-frame trajectory) and compare them with what the generator knows or
with what the reference frontend recomputes.  Imports numpy only.
"""

from __future__ import annotations

import numpy as np


def orbit_poses(n: int, orbit_r: float, deg_per_frame: float,
                phase: float) -> np.ndarray:
    """(n, 4, 4) float64 world-to-camera poses Tcw."""
    phi = phase + np.deg2rad(deg_per_frame) * np.arange(n)
    s, c = np.sin(phi), np.cos(phi)
    z = np.stack([s, np.zeros(n), c], -1)          # optical axis, outward
    x = np.stack([c, np.zeros(n), -s], -1)
    y = np.cross(z, x)
    Rwc = np.stack([x, y, z], -1)                  # columns: camera axes
    Cw = orbit_r * z
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = np.transpose(Rwc, (0, 2, 1))
    T[:, :3, 3] = -np.einsum("nij,nj->ni", T[:, :3, :3], Cw)
    return T


def relative_truth(poses: np.ndarray) -> np.ndarray:
    """The true poses in the map's frame, which is the first camera's."""
    return poses @ np.linalg.inv(poses[0])


def centre(T: np.ndarray) -> np.ndarray:
    return -np.swapaxes(T[..., :3, :3], -1, -2) @ T[..., :3, 3:4]


def resolve_reference(kf: int, kf_valid, kf_Tcp, kf_parent, kf_pose):
    """A keyframe's final pose, walking past culled keyframes along the
    spanning tree with their stored child-to-parent transforms (the
    composition ORB-SLAM2's SaveTrajectory* makes, System.cc:360-374).
    None where the walk meets no valid keyframe (a cycle of culled ones)."""
    Trw = np.eye(4)
    for _ in range(len(kf_valid) + 1):
        if kf < 0 or kf_valid[kf]:
            break
        Trw = Trw @ kf_Tcp[kf]
        kf = int(kf_parent[kf])
    else:
        return None
    if kf >= 0:
        Trw = Trw @ kf_pose[kf]
    return Trw


def frame_errors(entries, store: dict, truth: np.ndarray, fps: float):
    """Camera-centre error (m) of every tracked frame's final pose against
    the truth, in the map's frame (the first camera's), no alignment;
    entries: (Tcr, ref_kf, timestamp, lost).  Returns (frame indices,
    errors, frames whose reference walk found no keyframe)."""
    rel = relative_truth(truth)
    idx, err, unresolved = [], [], 0
    for Tcr, ref_kf, ts, lost in entries:
        i = int(round(ts * fps))
        if lost or i >= len(rel):
            continue
        Trw = resolve_reference(ref_kf, store["kf_valid"], store["kf_Tcp"],
                                store["kf_parent"], store["kf_pose"])
        if Trw is None:
            unresolved += 1
            continue
        T = np.asarray(Tcr, np.float64) @ Trw
        idx.append(i)
        err.append(float(np.linalg.norm(centre(T) - centre(rel[i]))))
    return np.asarray(idx, int), np.asarray(err), unresolved


def keyframe_errors(store: dict, truth: np.ndarray, fps: float):
    """Camera-centre error (m) of every valid keyframe against the truth."""
    rel = relative_truth(truth)
    out = []
    for k in np.nonzero(store["kf_valid"])[0]:
        i = int(round(store["kf_timestamp"][k] * fps))
        if i < len(rel):
            out.append(float(np.linalg.norm(
                centre(store["kf_pose"][k].astype(np.float64))
                - centre(rel[i]))))
    return np.asarray(out)


def residuals(store: dict, kfs, fx, fy, cx, cy) -> dict:
    """Left-image reprojection residuals (px, projected minus stored
    keypoint) of every observation of a valid map point in each keyframe
    of `kfs`, with the keyframe's pose and the point's position as the
    program left them: {keyframe: (n, 2) array}."""
    out = {}
    for k in kfs:
        obs = store["kf_obs"][k]
        slots = np.nonzero(obs >= 0)[0]
        keep = _front_valid(store, k)
        slots, pids = slots[keep], obs[slots][keep]
        T = store["kf_pose"][k].astype(np.float64)
        P = store["pt_pos"][pids].astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([fx * P[:, 0] / P[:, 2] + cx,
                       fy * P[:, 1] / P[:, 2] + cy], -1)
        out[int(k)] = uv - store["kf_xy"][k][slots].astype(np.float64)
    return out


def chi2(store: dict, res: dict, scale_factor: float) -> np.ndarray:
    """Each observation's squared residual over its level's variance
    (sigma = scale_factor ** octave px), the quantity ORB-SLAM2's bundle
    adjustments gate at chi2(0.95, 2 dof) = 5.991 (Optimizer.cc)."""
    out = [np.sum(r ** 2, -1) / scale_factor ** (
        2 * store["kf_octave"][k][store["kf_obs"][k] >= 0][
            _front_valid(store, k)]) for k, r in res.items()]
    return np.concatenate(out) if out else np.zeros(0)


def _front_valid(store: dict, k: int) -> np.ndarray:
    """Which of keyframe k's bound slots `residuals` kept."""
    obs = store["kf_obs"][k]
    pids = obs[obs >= 0]
    ok = store["pt_valid"][pids]
    T = store["kf_pose"][k].astype(np.float64)
    z = store["pt_pos"][pids].astype(np.float64) @ T[2, :3] + T[2, 3]
    return ok & (z > 1e-6)


def to_bfloat16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even) and
    back: the control's lower-precision map."""
    a = np.ascontiguousarray(a, np.float32)
    b = a.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).reshape(a.shape)
