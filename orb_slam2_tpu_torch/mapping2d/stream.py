"""Keyframe/point streaming — the fork's Monopub data contract without ROS.

Copy of orb_slam2_tpu/mapping2d/stream.py (host-side numpy, no framework),
its import pointed at the port's gridmap.

The fork publishes, per new keyframe, a PoseArray of [keyframe camera
center, its map points] on `pts_and_pose`, and the ENTIRE map on
`all_kf_and_pts` on loop closure or every `all_pts_gap` keyframes
(ref: Examples/ROS/ORB_SLAM2/src/ros_mono_pub.cc:95-96, 166-236).
SURVEY §5.8 maps this to in-process callbacks: subscribers get the same
payloads as plain numpy arrays; the GridMapper subscribes to build the
live occupancy grid exactly like Monosub."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


class MapStream:
    """Publish-subscribe bridge between the SLAM pipeline and consumers
    (grid mapper, recorders, visualizers)."""

    def __init__(self, system, all_pts_gap: int = 20):
        self.system = system
        self.all_pts_gap = all_pts_gap
        self.kf_subscribers: List[Callable] = []
        self.map_subscribers: List[Callable] = []
        self._kf_count = 0
        system.local_mapper.on_keyframe.append(self._on_keyframe)
        if system.loop_closer is not None:
            system.loop_closer.on_loop.append(self._on_loop)

    # ------------------------------------------------------------------
    def _payload(self, kf: int):
        store = self.system.store
        row = store.kf_obs[kf]
        pids = row[row >= 0]
        pids = pids[store.pt_valid[pids]]
        return kf, store.camera_center(kf), store.pt_pos[pids].copy()

    def _on_keyframe(self, kf: int):
        """pts_and_pose equivalent (ref: ros_mono_pub.cc publish())."""
        payload = self._payload(kf)
        for cb in self.kf_subscribers:
            cb(*payload)
        self._kf_count += 1
        if self.all_pts_gap and self._kf_count % self.all_pts_gap == 0:
            self._publish_all()

    def _on_loop(self, kf: int):
        """all_kf_and_pts full-map republish on loop closure
        (ref: ros_mono_pub.cc:166-236 + loop_detected flag)."""
        self._publish_all()

    def _publish_all(self):
        store = self.system.store
        payloads = [self._payload(int(k)) for k in store.valid_kf_ids()]
        for cb in self.map_subscribers:
            cb(payloads)


def attach_grid_mapper(system, params=None, all_pts_gap: int = 20):
    """Wire a live GridMapper to the stream (the Monopub -> Monosub
    pipeline as one in-process call graph)."""
    from orb_slam2_tpu_torch.mapping2d.gridmap import GridMapper

    stream = MapStream(system, all_pts_gap=all_pts_gap)
    mapper = GridMapper(system.store, params)

    def on_kf(kf, center, points):
        mapper.update_keyframe(kf)

    def on_full_map(payloads):
        mapper.rebuild()

    stream.kf_subscribers.append(on_kf)
    stream.map_subscribers.append(on_full_map)
    return mapper, stream
