"""System: the public API facade.

Equivalent of ORB_SLAM2::System (ref: src/System.cc:33-678 /
include/System.h:61-136): builds the map, frame builder, tracker and
local mapper, wires them together, exposes the per-frame Track* entries,
the SLAM/localization mode switch, reset/shutdown, and the trajectory and
map savers.

Port of orb_slam2_tpu/system.py for stereo and RGB-D with
`scheduler="sync"`: mapping runs deterministically inline after each
keyframe (the testing mode SURVEY §4.4 calls for).  `device` is where
the frontend, the tracking step and the mapper run: the card unless the
caller asks for "cpu"; "cuda" raises without a card.  Waiting for later ROADMAP items, each raising
NotImplementedError: the async scheduler (item 5), the vocabulary, loop
closing and relocalization (item 6), monocular (item 7), and the viewer
and grid-map savers (item 8).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from orb_slam2_tpu_torch.config import Sensor, Settings
from orb_slam2_tpu_torch.io import trajectory as traj_io
from orb_slam2_tpu_torch.ops.frontend import padded_total
from orb_slam2_tpu_torch.slam.frame import FrameBuilder
from orb_slam2_tpu_torch.slam.local_mapping import LocalMapper
from orb_slam2_tpu_torch.slam.map_store import MapStore
from orb_slam2_tpu_torch.slam.tracking import State, Tracker
from orb_slam2_tpu_torch.utils import torch_device


class System:
    def __init__(
        self,
        settings: Settings,
        sensor: Sensor,
        vocabulary=None,
        scheduler: Optional[str] = None,
        use_viewer: bool = False,
        *,
        device="cuda",
    ):
        if isinstance(settings, str):
            settings = Settings.from_yaml(settings)
        if sensor == Sensor.MONOCULAR:
            raise NotImplementedError(
                "the monocular System waits for ROADMAP item 7")
        if vocabulary is not None:
            raise NotImplementedError(
                "the vocabulary and loop closing wait for ROADMAP item 6")
        if use_viewer:
            raise NotImplementedError("the viewer waits for ROADMAP item 8")
        self.scheduler = scheduler or settings.scheduler
        if self.scheduler != "sync":
            raise NotImplementedError(
                "the async scheduler waits for ROADMAP item 5")
        self.device = torch_device(device)
        self.settings = settings
        self.sensor = sensor
        self.vocabulary = None

        self.builder = FrameBuilder(settings, device=self.device)
        n_pad = padded_total(settings.n_features, settings.n_levels,
                             settings.scale_factor)
        self.store = MapStore(n_pad, device=self.device)
        self.local_mapper = LocalMapper(settings, sensor, self.store,
                                        device=self.device)
        self.tracker = Tracker(
            settings, sensor, self.store, self.builder,
            local_mapper=self.local_mapper, device=self.device,
        )

    # ------------------------------------------------------------------
    # per-frame entries (ref: System::Track* src/System.cc:117-283)
    # ------------------------------------------------------------------
    def track_stereo(self, img_l, img_r, timestamp: float):
        T = self.tracker.grab_stereo(img_l, img_r, timestamp)
        self._pump()
        return T

    def track_rgbd(self, img, depth, timestamp: float):
        T = self.tracker.grab_rgbd(img, depth, timestamp)
        self._pump()
        return T

    def prefetch(self, *imgs) -> None:
        """Start the device uploads of the NEXT frame's images (call
        between frames, e.g. while the driver paces to the camera rate).
        For RGB-D pass (rgb, depth)."""
        if self.sensor == Sensor.RGBD and len(imgs) == 2:
            self.builder.prefetch(imgs[0], depth=imgs[1])
        else:
            self.builder.prefetch(*imgs)

    def _pump(self):
        if self.store is not self.tracker.store:
            # tracker reset swapped in a fresh map
            self.store = self.tracker.store
        self.local_mapper.spin()

    # ------------------------------------------------------------------
    # mode switches / state (ref: src/System.cc:126-158, 286-303, 655-676)
    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        self.tracker.set_localization_mode(True)

    def deactivate_localization_mode(self):
        self.tracker.set_localization_mode(False)

    def map_changed(self) -> bool:
        idx = self.store.big_change_idx
        changed = getattr(self, "_last_big_change", 0) < idx
        self._last_big_change = idx
        return changed

    def reset(self):
        self.tracker.reset()
        self.store = self.tracker.store

    def shutdown(self):
        # stop the mapper's drain loop and interrupt a local BA in flight
        # (ref: LocalMapping::RequestFinish, src/LocalMapping.cc:705-757)
        self.local_mapper.request_finish()

    def tracking_state(self) -> State:
        return self.tracker.state

    def stats(self) -> dict:
        """Counters for observability (SURVEY §5.5): map size, resets,
        relocalizations; the loop and global-BA counters stay 0 without
        a loop closer."""
        return {
            "keyframes": int(self.store.kf_valid.sum()),
            "map_points": int(len(self.store.valid_pt_ids())),
            "frames_tracked": len(self.tracker.trajectory),
            "big_change_idx": self.store.big_change_idx,
            "loops_closed": 0,
            "gba_runs_finished": 0,
            "gba_runs_aborted": 0,
            "resets": self.tracker.resets,
            "relocalizations": self.tracker.relocalizations,
        }

    def get_tracked_map_points(self) -> np.ndarray:
        f = self.tracker.current
        if f is None:
            return np.zeros(0, np.int64)
        return f.bindings[f.bindings >= 0]

    def get_tracked_keypoints_un(self) -> np.ndarray:
        """Undistorted keypoints of the current frame, (N, 2) float32
        (ref: System::GetTrackedKeyPointsUn src/System.cc:672-676)."""
        f = self.tracker.current
        if f is None:
            return np.zeros((0, 2), np.float32)
        return f.feats.xy[f.feats.valid]

    # ------------------------------------------------------------------
    # savers (ref: src/System.cc:326-653)
    # ------------------------------------------------------------------
    def save_trajectory_tum(self, path: str):
        traj_io.save_trajectory_tum(self.store, self.tracker.trajectory, path)

    def save_keyframe_trajectory_tum(self, path: str):
        traj_io.save_keyframe_trajectory_tum(self.store, path)

    def save_trajectory_kitti(self, path: str):
        traj_io.save_trajectory_kitti(self.store, self.tracker.trajectory, path)

    def save_map_points_obj(self, path: str):
        self.store.export_points_obj(path)

    def save_map_with_timestamps(self, path: str):
        self.store.export_points_with_timestamps(path)

    def save_map_with_pose(self, path: str):
        """Fork feature (ref: Map::SaveWithPose src/Map.cc:169-186 — its
        body is identical to SaveWithTimestamps: point position followed
        by observing-keyframe timestamps)."""
        self.store.export_points_with_timestamps(path)

    def save_2d_map_points_tum(self, path: str, x: int = 0, y: int = 2):
        """Fork feature (ref: System::Save2dMapPointsTUM src/System.cc:631):
        (x, y) select which world-coordinate axes land in the two file
        columns; the defaults give the ground-plane (x, z) projection."""
        with open(path, "w") as f:
            for pid in self.store.valid_pt_ids():
                pos = self.store.pt_pos[pid]
                f.write(f" {pos[x]:.7f} {pos[y]:.7f}\n")

    def save_map(self, path: str):
        self.store.save(path)

    @property
    def map(self) -> MapStore:
        return self.store
