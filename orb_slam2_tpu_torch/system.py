"""System: the public API facade.

Equivalent of ORB_SLAM2::System (ref: src/System.cc:33-678 /
include/System.h:61-136): builds the map, frame builder, tracker and
local mapper, wires them together, exposes the per-frame Track* entries,
the SLAM/localization mode switch, reset/shutdown, and the trajectory and
map savers.

Port of orb_slam2_tpu/system.py for stereo and RGB-D.  Scheduling: the
reference spawns LocalMapping/LoopClosing/Viewer threads
(src/System.cc:85-104); here `scheduler="sync"` (default) runs mapping
deterministically inline after each keyframe (the testing mode SURVEY
§4.4 calls for) and `scheduler="async"` moves it to a worker thread with
the same queue semantics.  `settings.pipelined` selects the Tracker's
pipelined path; `poll()` drains its delivered results between frames.
`device` is where the frontend, the tracking step and the mapper run: the
card unless the caller asks for "cpu"; "cuda" raises without a card.
Both threads enqueue on the device's default stream, so the mapper's
kernels and the tracker's replay serialise on the card.  Waiting for
later ROADMAP items, each raising NotImplementedError: the vocabulary,
loop closing (and its thread) and relocalization (item 6), monocular
(item 7), and the viewer and grid-map savers (item 8).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

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
        if self.scheduler not in ("sync", "async"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
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

        self._shutdown = False
        self._workers: list = []
        self._work_event = threading.Event()
        self._worker_error: Optional[BaseException] = None
        if self.scheduler == "async":
            # reference thread topology (src/System.cc:85-104): tracking
            # on the caller's thread, LocalMapping on its own (the
            # LoopClosing thread comes with the loop closer, ROADMAP item
            # 6).  The flag lives on the mapper so it survives
            # Tracker.reset.
            self.local_mapper.async_worker = True
            self._workers.append(threading.Thread(
                target=self._mapping_loop, daemon=True))
            for w in self._workers:
                w.start()

    def precompile(self, stages=None, verbose: bool = False) -> dict:
        """Warm up and capture every shape-bucketed device program before
        the first frame (see precompile.py).  Without this, each step's
        first call pays its warm-up and graph capture wherever it lands
        in the run."""
        from orb_slam2_tpu_torch.precompile import precompile

        return precompile(self, stages=stages, verbose=verbose)

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

    def poll(self) -> int:
        """Non-blocking drain of delivered pipelined results (see
        Tracker.poll).  Safe no-op outside pipelined mode."""
        n = self.tracker.poll()
        if n:
            self._pump()
        return n

    def drain(self) -> None:
        """Apply every pipelined frame still in flight, waiting for the
        device, and hand the keyframes they insert to the mapper: the
        trajectory is complete afterwards.  A no-op outside pipelined
        mode.  (The JAX package's drivers save without it and miss the
        last frames in flight.)"""
        self.tracker._flush_pipeline()
        self._pump()

    def _pump(self):
        if self.store is not self.tracker.store:
            # tracker reset swapped in a fresh map
            self.store = self.tracker.store
        if self.scheduler == "sync":
            self.local_mapper.spin()
        else:
            self._raise_worker_error()
            self._work_event.set()

    def _mapping_loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self._shutdown:
                self._work_event.wait(timeout=0.003)
                self._work_event.clear()
                self.local_mapper.spin()
        except BaseException as e:     # handed to the caller's thread
            self._worker_error = e
            raise

    def _raise_worker_error(self):
        """A mapping thread that died must not pass for an idle one."""
        if self._worker_error is not None:
            raise RuntimeError("the mapping thread failed") \
                from self._worker_error

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
        self._shutdown = True
        # stop the mapping worker's drain loop and interrupt a local BA
        # in flight (ref: LocalMapping::RequestFinish + Optimizer
        # setForceStopFlag, src/LocalMapping.cc:705-757)
        self.local_mapper.request_finish()
        self._work_event.set()
        for w in self._workers:
            w.join(timeout=60.0)
        self._raise_worker_error()

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
