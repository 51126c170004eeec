"""Visualization — FrameDrawer / MapDrawer / Viewer equivalents.

Copy of orb_slam2_tpu/viz/viewer.py (host-side, no framework): every
field it reads is host numpy in this package too (the frame's features
and bindings, the map store's arrays and graphs, the tracker's local
points).

The reference renders with Pangolin + OpenCV HighGUI (ref: src/Viewer.cc:
54-170, src/FrameDrawer.cc:38-165, src/MapDrawer.cc:44-264).  Here the
drawers produce numpy images / matplotlib figures so they work headless
(saved frames, notebooks) — a GUI loop is a thin wrapper around them.
The SLAM/Localization mode toggle stays on the System API
(ref: Viewer.cc:116-125 calling ActivateLocalizationMode).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class FrameDrawer:
    """Current frame + keypoint overlay + status bar
    (ref: src/FrameDrawer.cc:38-165)."""

    def __init__(self, system):
        self.system = system

    def draw(self, img: np.ndarray) -> np.ndarray:
        import cv2

        tracker = self.system.tracker
        out = cv2.cvtColor(
            np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
        frame = tracker.current
        n_map = 0
        n_vo = 0
        if frame is not None and tracker.state.name == "OK":
            store = self.system.store
            for i in np.nonzero(frame.feats.valid)[0]:
                x, y = frame.feats.xy[i]
                pid = int(frame.bindings[i])
                if pid >= 0 and store.pt_valid[pid]:
                    if store.pt_n_obs[pid] >= 1:
                        color = (0, 255, 0)      # map point (green)
                        n_map += 1
                    else:
                        color = (255, 0, 0)      # VO point (blue)
                        n_vo += 1
                    cv2.rectangle(out, (int(x) - 3, int(y) - 3),
                                  (int(x) + 3, int(y) + 3), color, 1)
        state = tracker.state.name
        n_kf = int(self.system.store.kf_valid.sum())
        n_pt = int(self.system.store.pt_valid.sum())
        mode = "LOCALIZATION" if tracker.only_tracking else "SLAM"
        text = (f"{mode} | {state} | KFs: {n_kf}, MPs: {n_pt}, "
                f"Matches: {n_map}" + (f", VO: {n_vo}" if n_vo else ""))
        bar = np.zeros((20, out.shape[1], 3), np.uint8)
        cv2.putText(bar, text, (5, 14), cv2.FONT_HERSHEY_PLAIN, 1.0,
                    (255, 255, 255), 1)
        return np.concatenate([out, bar], 0)


class MapDrawer:
    """Map points, keyframe frusta, covisibility graph, current camera
    (ref: src/MapDrawer.cc:44-264) as a matplotlib 3D figure."""

    def __init__(self, system, keyframe_size: float = 0.1):
        self.system = system
        self.kf_size = keyframe_size

    def figure(self, show_graph: bool = True, show_points: bool = True,
               show_keyframes: bool = True):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        store = self.system.store
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")

        if show_points:
            pids = store.valid_pt_ids()
            if len(pids):
                pts = store.pt_pos[pids]
                local = set(int(p) for p in self.system.tracker.local_pts)
                is_local = np.array([int(p) in local for p in pids])
                ax.scatter(pts[~is_local, 0], pts[~is_local, 2],
                           -pts[~is_local, 1], s=0.5, c="k")
                if is_local.any():
                    ax.scatter(pts[is_local, 0], pts[is_local, 2],
                               -pts[is_local, 1], s=0.5, c="r")

        if show_keyframes:
            for kf in store.valid_kf_ids():
                C = store.camera_center(int(kf))
                ax.scatter([C[0]], [C[2]], [-C[1]], s=6, c="b", marker="s")

        if show_graph:
            drawn = set()
            for kf in store.valid_kf_ids():
                kf = int(kf)
                C1 = store.camera_center(kf)
                for nb, w in store.covis.get(kf, {}).items():
                    if w < 100 or (nb, kf) in drawn:
                        continue
                    drawn.add((kf, nb))
                    if not store.kf_valid[nb]:
                        continue
                    C2 = store.camera_center(nb)
                    ax.plot([C1[0], C2[0]], [C1[2], C2[2]],
                            [-C1[1], -C2[1]], "g-", lw=0.4)
                for le in store.kf_loop_edges.get(kf, ()):
                    if store.kf_valid[le]:
                        C2 = store.camera_center(le)
                        ax.plot([C1[0], C2[0]], [C1[2], C2[2]],
                                [-C1[1], -C2[1]], "r-", lw=1.0)
        ax.set_xlabel("x")
        ax.set_ylabel("z")
        ax.set_zlabel("-y")
        return fig

    def save(self, path: str, **kw):
        fig = self.figure(**kw)
        fig.savefig(path, dpi=110)
        import matplotlib.pyplot as plt

        plt.close(fig)


class Viewer:
    """Headless render loop: periodically writes the frame overlay and
    the map figure to disk (the Pangolin window's offline equivalent,
    ref: src/Viewer.cc:54-170)."""

    def __init__(self, system, out_dir: str = "viewer_out",
                 period: int = 10):
        import os

        self.system = system
        self.frame_drawer = FrameDrawer(system)
        self.map_drawer = MapDrawer(system)
        self.out_dir = out_dir
        self.period = period
        self._count = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, img: Optional[np.ndarray] = None):
        import cv2

        self._count += 1
        if self._count % self.period:
            return
        if img is not None:
            overlay = self.frame_drawer.draw(img)
            cv2.imwrite(f"{self.out_dir}/frame_{self._count:06d}.png",
                        overlay)
        self.map_drawer.save(f"{self.out_dir}/map_{self._count:06d}.png")
