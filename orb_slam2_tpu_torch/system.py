"""System: the public API facade.

Equivalent of ORB_SLAM2::System (ref: src/System.cc:33-678 /
include/System.h:61-136): builds the map, frame builder, tracker,
local mapper and (with a vocabulary) the keyframe database, relocalizer
and loop closer, wires them together, exposes the per-frame Track* entries,
the SLAM/localization mode switch, reset/shutdown, and the trajectory and
map savers including the fork's grid-map output.

Port of orb_slam2_tpu/system.py.  Scheduling: the
reference spawns LocalMapping/LoopClosing/Viewer threads
(src/System.cc:85-104); here `scheduler="sync"` (default) runs mapping
and loop closing deterministically inline after each keyframe (the
testing mode SURVEY §4.4 calls for) and `scheduler="async"` moves each to
a worker thread of its own with the same queue semantics, global BA to a
third spawned by the loop closer.  `settings.pipelined` selects the Tracker's
pipelined path; `poll()` drains its delivered results between frames.
`device` is where the frontend, the tracking step and the mapper run: the
card unless the caller asks for "cpu"; "cuda" raises without a card.
All threads enqueue on the device's default stream, so the workers'
kernels and the tracker's replay serialise on the card; a worker's pass
holds `utils.DEVICE_CAPTURE_LOCK`, so a graph capture never meets another
thread on the device.  `use_viewer=True` starts the live viewer
(viz/live.py; it needs OpenCV) on a thread of its own.  Its menu never
changes the tracker itself: `request_localization_mode` and
`request_reset` leave a request that the next `track_*` call applies
before its frame, on the tracking thread, after draining any pipelined
frames in flight (the reference's mbActivateLocalizationMode / mbReset,
src/System.cc:117-186).
"""

from __future__ import annotations

import copy
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
        viewer_port: Optional[int] = 0,
        *,
        device="cuda",
    ):
        if isinstance(settings, str):
            settings = Settings.from_yaml(settings)
        if sensor == Sensor.MONOCULAR:
            # mono local maps outgrow the stereo-tuned candidate block:
            # the init-boosted 2x feature budget triangulates thousands of
            # live points into a tracking neighbourhood, and a point past
            # the cap can never be bound, fails MapPointCulling's
            # >=3-observation rule, and churns (the reference caps nothing
            # in SearchLocalPoints).  Double the block on a per-System
            # COPY so co-resident stereo / RGB-D systems keep their
            # shapes.  copy.copy, NOT dataclasses.replace: replace()
            # rebuilds from fields only and drops attributes set at run
            # time (a caller's settings.pipelined = True).
            settings = copy.copy(settings)
            settings.bucket_local *= 2
            # Mono re-anchors from host state every frame (the fused fast
            # path) instead of the pipelined velocity chain: without
            # per-frame depth, chain extrapolation between anchors
            # compounds into scale drift that no drift gate can see.  The
            # reference tracks mono synchronously for the same reason
            # (TrackWithMotionModel re-anchors on mLastFrame every frame,
            # src/Tracking.cc:853-899).
            if getattr(settings, "pipelined", False):
                settings.pipelined = False
        self.scheduler = scheduler or settings.scheduler
        if self.scheduler not in ("sync", "async"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        self.device = torch_device(device)
        self.settings = settings
        self.sensor = sensor
        self.vocabulary = vocabulary

        self.builder = FrameBuilder(settings, vocabulary, device=self.device)
        # keyframe rows: mono init frames carry the 2x feature budget
        # (ref: src/Tracking.cc:121-126), so a mono store is that wide
        n_budget = settings.n_features * (
            2 if sensor == Sensor.MONOCULAR else 1)
        n_pad = padded_total(n_budget, settings.n_levels,
                             settings.scale_factor)
        self.store = MapStore(n_pad, device=self.device)

        self.kf_database = None
        self.loop_closer = None
        if vocabulary is not None:
            from orb_slam2_tpu_torch.places.database import KeyFrameDatabase
            from orb_slam2_tpu_torch.slam.loop_closing import LoopCloser

            self.kf_database = KeyFrameDatabase(vocabulary)
            self.store.erase_hooks.append(self.kf_database.erase)
            self.loop_closer = LoopCloser(
                settings, sensor, self.store, self.kf_database,
                device=self.device,
            )
        self.local_mapper = LocalMapper(
            settings, sensor, self.store, loop_closer=self.loop_closer,
            vocabulary=vocabulary, device=self.device,
        )
        if self.loop_closer is not None:
            self.loop_closer.local_mapper = self.local_mapper

        relocalizer = None
        if self.kf_database is not None:
            from orb_slam2_tpu_torch.slam.relocalization import Relocalizer

            relocalizer = Relocalizer(settings, self.store, self.kf_database,
                                      device=self.device)

        self.tracker = Tracker(
            settings, sensor, self.store, self.builder,
            local_mapper=self.local_mapper,
            kf_database=self.kf_database,
            relocalizer=relocalizer,
            device=self.device,
        )

        # requests of the viewer's thread, applied by the next track_*
        self._request_lock = threading.Lock()
        self._mode_request: Optional[bool] = None
        self._reset_request = False

        # live viewer thread (ref: src/System.cc:99-103 spawns Viewer;
        # here it is an HTTP panel + optional local window, viz/live.py)
        self.viewer = None
        if use_viewer:
            from orb_slam2_tpu_torch.viz.live import LiveViewer

            self.viewer = LiveViewer(self, http_port=viewer_port)

        self._shutdown = False
        self._workers: list = []
        self._work_event = threading.Event()
        self._loop_event = threading.Event()
        self._worker_error: Optional[tuple] = None   # (thread, exception)
        if self.scheduler == "async":
            # reference thread topology (src/System.cc:85-104): tracking
            # on the caller's thread, LocalMapping and LoopClosing each
            # on their own, GBA spawned by LoopClosing (background_gba).
            # The flag lives on the mapper so it survives Tracker.reset.
            self.local_mapper.async_worker = True
            self._workers.append(threading.Thread(
                target=self._worker, args=("mapping", self._mapping_loop),
                daemon=True))
            if self.loop_closer is not None:
                self.loop_closer.background_gba = True
                self._workers.append(threading.Thread(
                    target=self._worker,
                    args=("loop-closing", self._loop_closing_loop),
                    daemon=True))
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
    def track_monocular(self, img: np.ndarray, timestamp: float):
        with self._frame_span():
            self._apply_requests()
            T = self.tracker.grab_monocular(img, timestamp)
            if self.viewer is not None:
                self.viewer.push_frame(img)
            self._pump()
        return T

    def track_stereo(self, img_l, img_r, timestamp: float):
        with self._frame_span():
            self._apply_requests()
            T = self.tracker.grab_stereo(img_l, img_r, timestamp)
            if self.viewer is not None:
                self.viewer.push_frame(img_l)
            self._pump()
        return T

    def track_rgbd(self, img, depth, timestamp: float):
        with self._frame_span():
            self._apply_requests()
            T = self.tracker.grab_rgbd(img, depth, timestamp)
            if self.viewer is not None:
                self.viewer.push_frame(img)
            self._pump()
        return T

    def _frame_span(self):
        """The root span of a track_* call, `frame`, with the id of the
        frame it builds; every span of the call on this thread nests in
        it."""
        return self.tracker.timers("frame", id=self.builder._next_id)

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
        with self.tracker.timers("system/pump"):
            self._hand_over()

    def _hand_over(self):
        """The keyframes and loops queued by the frame go to the mapper
        and the loop closer: inline (sync) or by waking their threads."""
        if self.store is not self.tracker.store:
            # tracker reset swapped in a fresh map
            self.store = self.tracker.store
        if self.scheduler == "sync":
            self.local_mapper.spin()
            if self.loop_closer is not None:
                self.loop_closer.spin()
        else:
            self._raise_worker_error()
            self._work_event.set()

    def _worker(self, name, loop):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            loop()
        except BaseException as e:     # handed to the caller's thread
            self._worker_error = (name, e)
            raise

    def _mapping_loop(self):
        while not self._shutdown:
            self._work_event.wait(timeout=0.003)
            self._work_event.clear()
            self.local_mapper.spin()
            if self.loop_closer is not None and self.loop_closer.queue:
                self._loop_event.set()

    def _loop_closing_loop(self):
        while not self._shutdown:
            self._loop_event.wait(timeout=0.003)
            self._loop_event.clear()
            self.loop_closer.spin()

    def _raise_worker_error(self):
        """A worker thread that died must not pass for an idle one."""
        if self._worker_error is not None:
            name, error = self._worker_error
            raise RuntimeError(f"the {name} thread failed") from error

    # ------------------------------------------------------------------
    # mode switches / state (ref: src/System.cc:126-158, 286-303, 655-676)
    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        self.tracker.set_localization_mode(True)

    def deactivate_localization_mode(self):
        self.tracker.set_localization_mode(False)

    def request_localization_mode(self, on: bool):
        """Ask for localization mode on or off from another thread (the
        viewer's menu); the next track_* call applies it."""
        with self._request_lock:
            self._mode_request = bool(on)

    def request_reset(self):
        """Ask for a reset from another thread (the viewer's menu); the
        next track_* call applies it, after the mode request if both are
        pending, as the reference does."""
        with self._request_lock:
            self._reset_request = True

    def _apply_requests(self):
        """On the tracking thread, before its frame: drain the pipelined
        frames in flight, then apply the pending mode and reset requests
        (ref: System::TrackStereo src/System.cc:132-166)."""
        with self._request_lock:
            mode, reset = self._mode_request, self._reset_request
            self._mode_request, self._reset_request = None, False
        if mode is None and not reset:
            return
        self.drain()
        if mode is not None:
            self.tracker.set_localization_mode(mode)
        if reset:
            self.reset()

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
        if self.viewer is not None:
            # ref: src/System.cc:305-317 waits for the viewer to finish
            self.viewer.close()
        # stop the mapping worker's drain loop and interrupt a local BA
        # in flight (ref: LocalMapping::RequestFinish + Optimizer
        # setForceStopFlag, src/LocalMapping.cc:705-757)
        self.local_mapper.request_finish()
        lc = self.loop_closer
        if lc is not None and lc.gba is not None and lc.gba.running:
            lc.gba.request_stop()
            lc.gba.wait()
        self._work_event.set()
        self._loop_event.set()
        for w in self._workers:
            w.join(timeout=60.0)
        self._raise_worker_error()

    def tracking_state(self) -> State:
        return self.tracker.state

    def stats(self) -> dict:
        """Counters for observability (SURVEY §5.5): map size, loop and
        GBA lifecycle, resets, relocalizations, and the counters the
        tracker and the mapper keep beside their spans (`_counters`)."""
        lc = self.loop_closer
        gba = lc.gba if lc is not None else None
        return {
            "keyframes": int(self.store.kf_valid.sum()),
            "map_points": int(len(self.store.valid_pt_ids())),
            "frames_tracked": len(self.tracker.trajectory),
            "big_change_idx": self.store.big_change_idx,
            "loops_closed": lc.loops_closed if lc is not None else 0,
            "gba_runs_finished": gba.runs_finished if gba is not None else 0,
            "gba_runs_aborted": gba.runs_aborted if gba is not None else 0,
            "resets": self.tracker.resets,
            "relocalizations": self.tracker.relocalizations,
            **self._counters(),
        }

    def _counters(self) -> dict:
        """keyframes_inserted: into the mapper's queue;
        keyframes_refused_busy: wanted while the mapper was busy and
        refused after its local BA was interrupted (its queue full, or
        monocular); keyframes_denied_c2: wanted by the frame counts but
        denied by the inlier test c2 (ref: Tracking.cc:1044-1046);
        fast_path_fallbacks: replayed frames re-tracked on the modular
        path; local_ba_interrupted: local BAs that dropped their second
        round for a keyframe inserted since their pass began;
        mapper_queue_max: the mapper's longest queue; graph_captures: the
        CUDA graphs captured by the tracker's fast and chained steps (a
        fast step is shared by every System of the same settings in the
        process)."""
        tc = self.tracker.timers.counters
        mc = self.local_mapper.timers.counters
        t = self.tracker
        captures = (getattr(t._fast_step, "captures", 0)
                    + getattr(t._chain_step, "captures", 0))
        return {
            "keyframes_inserted": mc.get("keyframes_inserted", 0),
            "keyframes_refused_busy": tc.get("keyframes_refused_busy", 0),
            "keyframes_denied_c2": tc.get("keyframes_denied_c2", 0),
            "fast_path_fallbacks": tc.get("fast_path_fallbacks", 0),
            "local_ba_interrupted": mc.get("local_ba_interrupted", 0),
            "mapper_queue_max": mc.get("mapper_queue_max", 0),
            "graph_captures": captures,
        }

    def trace_snapshot(self) -> dict:
        """The spans still in the tracker's, the mapper's and the loop
        closer's rings (dicts of `utils.SPAN_FIELDS`, oldest first) and
        the counters of `stats()`, as plain data.  It copies every ring:
        read it once, when a run ends."""
        lc = self.loop_closer
        return {
            "spans": {
                "tracker": self.tracker.timers.spans(),
                "mapper": self.local_mapper.timers.spans(),
                "loop": lc.timers.spans() if lc is not None else [],
            },
            "counters": self._counters(),
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

    def change_calibration(self, path: str):
        """Hot-swap camera intrinsics/distortion/baseline from a settings
        file (ref: Tracking::ChangeCalibration src/Tracking.cc:1553-1584;
        the reference re-triggers Frame::mbInitialComputations — here the
        camera-dependent steps and undistortion state are rebuilt)."""
        from orb_slam2_tpu_torch.config import _parse_opencv_yaml

        with open(path, "r") as f:
            d = _parse_opencv_yaml(f.read())
        s = self.settings

        def g(key, cur):
            return float(d.get(key, cur))

        s.fx = g("Camera.fx", s.fx)
        s.fy = g("Camera.fy", s.fy)
        s.cx = g("Camera.cx", s.cx)
        s.cy = g("Camera.cy", s.cy)
        s.k1 = g("Camera.k1", 0.0)
        s.k2 = g("Camera.k2", 0.0)
        s.p1 = g("Camera.p1", 0.0)
        s.p2 = g("Camera.p2", 0.0)
        s.k3 = g("Camera.k3", 0.0)
        s.bf = g("Camera.bf", s.bf)
        self.tracker.refresh_calibration()

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

    def save_grid_map_tum(self, path: str):
        """Fork feature — exact port of System::SaveGridMapTUM
        (ref: src/System.cc:481-629): fixed 450x300 grid, cell-for-cell
        comparable output. For the configurable Monosub-style grid use
        `mapping2d.gridmap.save_grid_map_pgm`."""
        from orb_slam2_tpu_torch.mapping2d.gridmap import save_grid_map_tum

        save_grid_map_tum(self.store, path)

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
