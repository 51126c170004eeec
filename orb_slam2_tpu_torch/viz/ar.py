"""AR demo support: plane detection from map points + virtual cube overlay.

Port of orb_slam2_tpu/viz/ar.py, the equivalent of the reference's AR
example (ref: Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.cc:642
`DetectPlane`, `Plane::Recompute`, and ros_mono_ar.cc:169): the reference
RANSACs a plane from the current frame's tracked map points (50
iterations, 3-point hypotheses, octave-scaled inlier tolerance) and
anchors a virtual cube on it.  `fit_plane` scores every RANSAC hypothesis
at once in one (S, N) masked distance matrix and refits the winner by
least squares, as plain tensor code on the caller's device (in the JAX
package it was one jitted XLA program, no Pallas kernel); the overlay
rendering stays on the host.

As in the JAX package, `ARViewer._tracked_points` gives every point
octave 0, so the tolerance's `scale_factor ** octave` factor is always 1
(a fault of the reference package, copied here for parity).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam2_tpu_torch.solvers.horn import eigh_nan


class PlaneFit(NamedTuple):
    normal: torch.Tensor     # (3,) unit plane normal
    d: torch.Tensor          # () offset: n.x + d = 0
    n_inliers: torch.Tensor  # () int32
    inliers: torch.Tensor    # (N,) bool
    ok: torch.Tensor         # () bool


def fit_plane(points, mask, tol, samples, th: float = 3.0) -> PlaneFit:
    """Batched RANSAC plane fit.

    points: (N, 3) candidate world points (padded); mask: (N,) valid flags;
    tol: (N,) per-point inlier tolerance (the reference scales by the
    observation octave's sigma); samples: (S, 3) integer pre-drawn triples
    (host-seeded like the reference's DUtils random).  All S hypotheses
    are scored in one (S, N) masked distance matrix, then the winner is
    refined by an eigendecomposition least-squares fit on its inliers.
    Reads nothing back to the host.
    """
    samples = samples.long()
    p0 = points[samples[:, 0]]                       # (S, 3)
    p1 = points[samples[:, 1]]
    p2 = points[samples[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)  # (S, 3)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    degenerate = norm[:, 0] < 1e-9
    n = n / norm.clamp(min=1e-9)
    d = -(n * p0).sum(-1)                            # (S,)

    dist = (n @ points.T + d[:, None]).abs()         # (S, N)
    good = (dist < th * tol[None, :]) & mask[None, :]
    votes = torch.where(degenerate, -1, good.sum(-1))  # (S,)
    best = torch.argmax(votes).reshape(1)            # the first maximum

    inl = good.index_select(0, best)[0]              # (N,)
    w = inl.to(points.dtype)[:, None]
    centroid = (points * w).sum(0) / w.sum().clamp(min=1.0)
    centered = (points - centroid) * w
    C = centered.T @ centered                        # (3, 3)
    _, vecs = eigh_nan(C)
    n_ref = vecs[:, 0]                               # smallest eigenvector
    # keep the RANSAC winner's orientation (eigh's sign is arbitrary and
    # differs between solvers)
    n_best = n.index_select(0, best)[0]
    n_ref = torch.where((n_ref * n_best).sum() < 0, -n_ref, n_ref)
    d_ref = -(n_ref * centroid).sum()

    dist_ref = (points @ n_ref + d_ref).abs()
    inl_ref = (dist_ref < th * tol) & mask
    return PlaneFit(
        normal=n_ref, d=d_ref,
        n_inliers=inl_ref.sum().to(torch.int32),
        inliers=inl_ref,
        ok=votes.index_select(0, best)[0] > 0,
    )


def plane_pose(normal: np.ndarray, d: float,
               cam_center: np.ndarray) -> np.ndarray:
    """Tpw: plane frame -> world, z along the normal oriented toward the
    camera, origin at the camera's foot point on the plane (ref:
    ViewerAR.cc Plane::Recompute)."""
    n = np.asarray(normal, np.float64)
    n = n / max(np.linalg.norm(n), 1e-12)
    # orient toward the camera
    if np.dot(n, cam_center) + d < 0:
        n, d = -n, -d
    origin = cam_center - (np.dot(n, cam_center) + d) * n
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(up, n)) > 0.95:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, n)
    x /= max(np.linalg.norm(x), 1e-12)
    y = np.cross(n, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0] = x
    T[:3, 1] = y
    T[:3, 2] = n
    T[:3, 3] = origin
    return T


_CUBE_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),
               (4, 5), (5, 7), (7, 6), (6, 4),
               (0, 4), (1, 5), (2, 6), (3, 7)]


def cube_corners(size: float) -> np.ndarray:
    """8 corners of a cube of side `size` resting on the plane (z in
    [0, size] in the plane frame)."""
    h = size / 2.0
    c = []
    for z in (0.0, size):
        for yy in (-h, h):
            for xx in (-h, h):
                c.append((xx, yy, z))
    return np.array(c, np.float32)


def draw_cube(img: np.ndarray, Tcw: np.ndarray, K: np.ndarray,
              Tpw: np.ndarray, size: float = 0.2,
              color=(0, 255, 255)) -> np.ndarray:
    """Project the virtual cube into the image and draw its wireframe
    (ref: ViewerAR.cc DrawCube)."""
    import cv2

    if img.ndim == 2:
        out = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                           cv2.COLOR_GRAY2BGR)
    else:
        out = img.copy()
    pw = cube_corners(size)
    pw_h = np.concatenate([pw, np.ones((8, 1), np.float32)], 1)
    pc = (Tcw @ Tpw @ pw_h.T).T[:, :3]
    z = pc[:, 2]
    uv = (K @ pc.T).T
    uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)
    for a, b in _CUBE_EDGES:
        if z[a] <= 0.05 or z[b] <= 0.05:
            continue
        cv2.line(out, (int(uv[a, 0]), int(uv[a, 1])),
                 (int(uv[b, 0]), int(uv[b, 1])), color, 2)
    return out


class ARViewer:
    """Headless AR overlay driver (ref: ros_mono_ar.cc + ViewerAR.cc):
    detect a dominant plane from the current frame's tracked map points,
    anchor a cube, and draw it into subsequent frames.  The plane fit runs
    on `system.device`; the RANSAC triples come from a seeded host rng."""

    def __init__(self, system, cube_size: float = 0.2,
                 ransac_iters: int = 50, seed: int = 0):
        self.system = system
        self.cube_size = cube_size
        self.ransac_iters = ransac_iters
        self.rng = np.random.default_rng(seed)
        self.Tpw: Optional[np.ndarray] = None

    def _tracked_points(self):
        tracker = self.system.tracker
        frame = tracker.current
        if frame is None or tracker.state.name != "OK":
            return None, None
        store = self.system.store
        pids = frame.bindings[(frame.bindings >= 0) & frame.feats.valid]
        pids = pids[store.pt_valid[pids]]
        if len(pids) == 0:
            return None, None
        octaves = np.zeros(len(pids), np.int32)
        pts = store.pt_pos[pids]
        return pts, octaves

    def detect_plane(self, min_points: int = 20) -> bool:
        """RANSAC a plane from currently tracked points; anchors the cube
        (ref: ViewerAR::DetectPlane requires >= 20 tracked points)."""
        pts, octaves = self._tracked_points()
        if pts is None or len(pts) < min_points:
            return False
        sf = self.system.settings.scale_factor ** octaves
        med = np.median(np.linalg.norm(
            pts - np.median(pts, 0)[None, :], axis=1))
        tol = (0.02 * max(med, 1e-3) * sf).astype(np.float32)
        N = len(pts)
        samples = self.rng.integers(0, N, (self.ransac_iters, 3)).astype(
            np.int32)
        dev = self.system.device
        fit = fit_plane(
            torch.from_numpy(pts.astype(np.float32)).to(dev),
            torch.ones(N, dtype=torch.bool, device=dev),
            torch.from_numpy(tol).to(dev),
            torch.from_numpy(samples).to(dev))
        if not bool(fit.ok) or int(fit.n_inliers) < min_points // 2:
            return False
        frame = self.system.tracker.current
        Tcw = frame.Tcw
        C = -Tcw[:3, :3].T @ Tcw[:3, 3]
        self.Tpw = plane_pose(fit.normal.cpu().numpy(),
                              float(fit.d), C.astype(np.float64))
        return True

    def draw(self, img: np.ndarray) -> np.ndarray:
        """Overlay the cube on the current frame (detects a plane on
        first use)."""
        frame = self.system.tracker.current
        if frame is None or frame.Tcw is None:
            return img
        if self.Tpw is None and not self.detect_plane():
            return img
        return draw_cube(img, frame.Tcw, self.system.settings.K,
                         self.Tpw, self.cube_size)
