"""Struct-of-arrays SLAM map: keyframes, map points, observations, graphs.

Replaces the reference's pointer-graph data model — KeyFrame
(include/KeyFrame.h:43), MapPoint (include/MapPoint.h:39), Map
(include/Map.h:38) and their per-object mutex + SetBadFlag pointer
surgery — with growable numpy arrays indexed by integer ids and validity
masks.  Device kernels slice these arrays directly; host bookkeeping
(covisibility, spanning tree, observation maps) lives in small dicts.

Conventions:
  - keyframe id `kf` and point id `pid` are stable array indices;
    erased entries only flip validity bits (ids are never reused).
  - `kf_obs[kf, feat] == pid` is the observation structure seen from the
    keyframe side; `pt_obs[pid] == {kf: feat}` is the point side
    (the reference's MapPoint::mObservations, src/MapPoint.cc:98-149).
  - poses are (4,4) float32 world-to-camera Tcw like the reference.

Port of orb_slam2_tpu/slam/map_store.py.  The host arrays stay numpy with
the same dtypes (descriptors np.uint32), so `save`/`load` write and read
the JAX package's pickle layout byte for byte and a map saved by either
package loads in the other.  The store's `device` holds the per-keyframe
cache of feature tensors (`kf_device`); descriptors there are int32
tensors holding the uint32 words' bits.
"""

from __future__ import annotations

import pickle
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from orb_slam2_tpu_torch import native
from orb_slam2_tpu_torch.native.obs_engine import distinctive_index, make_engine
from orb_slam2_tpu_torch.utils import torch_device

_POPCNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Packed-descriptor Hamming distance on host ((...,8)u32 pairs)."""
    x = np.bitwise_xor(a, b).view(np.uint8)
    return _POPCNT[x].reshape(*x.shape[:-1], -1).sum(-1).astype(np.int32)


@dataclass
class FrameFeatures:
    """Per-frame fixed-shape feature block (device extraction output,
    pulled to host once per frame).

    `dev`, when present, holds device-resident copies of the hot fields
    (xy, ur, octave, angle, desc, valid, ...) so matcher calls reuse them
    instead of uploading again; `torch_device` is where `device()` puts
    the fields it uploads."""

    xy: np.ndarray        # (N, 2) f32 undistorted level-0 coords
    xy_raw: np.ndarray    # (N, 2) f32 raw (distorted) coords
    ur: np.ndarray        # (N,) f32 right-view u; -1 mono/unmatched
    depth: np.ndarray     # (N,) f32; -1 unknown
    octave: np.ndarray    # (N,) i32
    angle: np.ndarray     # (N,) f32 degrees
    desc: np.ndarray      # (N, 8) u32 packed rBRIEF
    valid: np.ndarray     # (N,) bool
    node: np.ndarray      # (N,) i32 BoW node id (-1 before assignment)
    word: np.ndarray      # (N,) i32 BoW word (leaf) id (-1 before)
    dev: Optional[dict] = None
    torch_device: str = "cpu"

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    def device(self, key: str) -> torch.Tensor:
        """Device tensor for a field, uploading and caching on first use.
        Descriptors go up as int32 holding the uint32 bits."""
        if self.dev is None:
            self.dev = {}
        if key not in self.dev:
            a = getattr(self, key)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            self.dev[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
                self.torch_device)
        return self.dev[key]


def _resize_features(f: FrameFeatures, n: int) -> FrameFeatures:
    def rs(a, fill):
        if a.shape[0] >= n:
            return a[:n]
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    return FrameFeatures(
        xy=rs(f.xy, 0), xy_raw=rs(f.xy_raw, 0), ur=rs(f.ur, -1.0),
        depth=rs(f.depth, -1.0), octave=rs(f.octave, 0),
        angle=rs(f.angle, 0), desc=rs(f.desc, 0),
        valid=rs(f.valid, False), node=rs(f.node, -1), word=rs(f.word, -1),
    )


class MapStore:
    """The global SLAM map (ref: src/Map.cc + KeyFrame/MapPoint state)."""

    def __init__(self, n_feat: int, kf_cap: int = 256, pt_cap: int = 1 << 15,
                 *, device):
        self.n_feat = n_feat
        # where the keyframe feature cache lives ("cuda" raises without a
        # card)
        self.device = torch_device(device)
        # --- keyframes -------------------------------------------------
        self.kf_cap = kf_cap
        self.n_kf = 0
        self.kf_valid = np.zeros(kf_cap, bool)
        self.kf_pose = np.zeros((kf_cap, 4, 4), np.float32)       # Tcw
        self.kf_timestamp = np.zeros(kf_cap, np.float64)
        self.kf_frame_id = np.zeros(kf_cap, np.int64)
        self.kf_xy = np.zeros((kf_cap, n_feat, 2), np.float32)
        self.kf_ur = np.full((kf_cap, n_feat), -1.0, np.float32)
        self.kf_depth = np.full((kf_cap, n_feat), -1.0, np.float32)
        self.kf_octave = np.zeros((kf_cap, n_feat), np.int32)
        self.kf_angle = np.zeros((kf_cap, n_feat), np.float32)
        self.kf_desc = np.zeros((kf_cap, n_feat, 8), np.uint32)
        self.kf_feat_valid = np.zeros((kf_cap, n_feat), bool)
        self.kf_node = np.full((kf_cap, n_feat), -1, np.int32)
        self.kf_word = np.full((kf_cap, n_feat), -1, np.int32)
        self.kf_obs = np.full((kf_cap, n_feat), -1, np.int64)
        # spanning tree + loop edges (ref: include/KeyFrame.h:194-199)
        self.kf_parent = np.full(kf_cap, -1, np.int64)
        self.kf_children: Dict[int, Set[int]] = {}
        self.kf_loop_edges: Dict[int, Set[int]] = {}
        self.kf_not_erase = np.zeros(kf_cap, bool)
        self.kf_to_be_erased = np.zeros(kf_cap, bool)
        self.kf_first_connection = np.ones(kf_cap, bool)
        # pose relative to parent at cull time (ref: KeyFrame::mTcp)
        self.kf_Tcp = np.zeros((kf_cap, 4, 4), np.float32)
        # covisibility: ordered (kf ids, weights) per keyframe
        self.covis: Dict[int, Dict[int, int]] = {}

        # --- map points ------------------------------------------------
        self.pt_cap = pt_cap
        self.n_pt = 0
        self.pt_valid = np.zeros(pt_cap, bool)
        self.pt_pos = np.zeros((pt_cap, 3), np.float32)
        self.pt_normal = np.zeros((pt_cap, 3), np.float32)
        self.pt_min_dist = np.zeros(pt_cap, np.float32)
        self.pt_max_dist = np.zeros(pt_cap, np.float32)
        self.pt_desc = np.zeros((pt_cap, 8), np.uint32)
        self.pt_n_obs = np.zeros(pt_cap, np.int32)
        self.pt_visible = np.ones(pt_cap, np.int32)
        self.pt_found = np.ones(pt_cap, np.int32)
        self.pt_first_kf = np.full(pt_cap, -1, np.int64)
        self.pt_ref_kf = np.full(pt_cap, -1, np.int64)
        self.pt_replaced_by = np.full(pt_cap, -1, np.int64)
        # observation engine: point -> [(kf, feat)] (C++ mapcore when
        # available; see native/mapcore.cpp)
        self.obs = make_engine()

        # big-change counter (ref: Map::InformNewBigChange src/Map.cc:70)
        self.big_change_idx = 0
        self.origin_kf = 0
        self.map_epoch = 0
        # bumped on every replace_point; lets the tracker skip the
        # per-feature replacement sweep when nothing changed
        self.replace_epoch = 0
        # bumped ONLY when EXISTING geometry moves (local-BA writeback,
        # GBA apply, loop correction, point replacement) — NOT on point
        # births.  The pipelined tracker snapshots this at dispatch: a
        # frame solved against points that moved while it was in flight
        # legitimately shows a large solve-vs-prediction innovation, and
        # the drift gate must not read that as divergence.
        self.geo_epoch = 0

        # coarse map lock for the async scheduler (the reference's
        # Map::mMutexMapUpdate, include/Map.h:73); a no-op under the
        # synchronous deterministic scheduler
        self.lock = threading.RLock()
        # device-side cache of immutable per-KF feature blocks
        self.kf_dev: Dict[int, dict] = {}
        # callbacks invoked when a keyframe is erased (e.g. the BoW
        # database's inverted-file removal, ref: KeyFrame::SetBadFlag
        # calling mpKeyFrameDB->erase)
        self.erase_hooks: list = []
        # dirty-point sinks for device mirrors (slam/device_map.py)
        self.dirty_sinks: list = []
        # callbacks invoked when a keyframe's BoW is assigned after
        # insertion (ref: KeyFrame::ComputeBoW runs on the mapping
        # thread, src/LocalMapping.cc:128-137 — keyframes can exist
        # briefly without BoW); keyframe-feature mirrors re-upload
        self.bow_hooks: list = []

    def mark_dirty(self, pids):
        # monotone point-data epoch: device-side caches of point blocks
        # (tracking's local-candidate cache) revalidate against this
        self.map_epoch += 1
        if not self.dirty_sinks:
            return
        if np.isscalar(pids) or isinstance(pids, (int, np.integer)):
            for s in self.dirty_sinks:
                s.add(int(pids))
        else:
            for s in self.dirty_sinks:
                s.update(int(p) for p in pids)

    def kf_device(self, kf: int, key: str):
        """Tensor on the store's device for a keyframe feature field,
        cached (features are immutable after insertion, so the upload
        happens at most once).  Descriptors as int32 holding the bits."""
        cache = self.kf_dev.setdefault(kf, {})
        if key not in cache:
            attr = "kf_feat_valid" if key == "valid" else "kf_" + key
            a = getattr(self, attr)[kf]
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            cache[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device)
        return cache[key]

    # ------------------------------------------------------------------
    # capacity management
    # ------------------------------------------------------------------
    def _grow_kf(self):
        old = self.kf_cap
        new = old * 2
        def g(a, fill=0):
            out = np.full((new,) + a.shape[1:], fill, a.dtype)
            out[:old] = a
            return out
        self.kf_valid = g(self.kf_valid, False)
        self.kf_pose = g(self.kf_pose)
        self.kf_timestamp = g(self.kf_timestamp)
        self.kf_frame_id = g(self.kf_frame_id)
        self.kf_xy = g(self.kf_xy)
        self.kf_ur = g(self.kf_ur, -1.0)
        self.kf_depth = g(self.kf_depth, -1.0)
        self.kf_octave = g(self.kf_octave)
        self.kf_angle = g(self.kf_angle)
        self.kf_desc = g(self.kf_desc)
        self.kf_feat_valid = g(self.kf_feat_valid, False)
        self.kf_node = g(self.kf_node, -1)
        self.kf_word = g(self.kf_word, -1)
        self.kf_obs = g(self.kf_obs, -1)
        self.kf_parent = g(self.kf_parent, -1)
        self.kf_not_erase = g(self.kf_not_erase, False)
        self.kf_to_be_erased = g(self.kf_to_be_erased, False)
        self.kf_first_connection = g(self.kf_first_connection, True)
        self.kf_Tcp = g(self.kf_Tcp)
        self.kf_cap = new

    def _grow_pt(self):
        old = self.pt_cap
        new = old * 2
        def g(a, fill=0):
            out = np.full((new,) + a.shape[1:], fill, a.dtype)
            out[:old] = a
            return out
        self.pt_valid = g(self.pt_valid, False)
        self.pt_pos = g(self.pt_pos)
        self.pt_normal = g(self.pt_normal)
        self.pt_min_dist = g(self.pt_min_dist)
        self.pt_max_dist = g(self.pt_max_dist)
        self.pt_desc = g(self.pt_desc)
        self.pt_n_obs = g(self.pt_n_obs)
        self.pt_visible = g(self.pt_visible, 1)
        self.pt_found = g(self.pt_found, 1)
        self.pt_first_kf = g(self.pt_first_kf, -1)
        self.pt_ref_kf = g(self.pt_ref_kf, -1)
        self.pt_replaced_by = g(self.pt_replaced_by, -1)
        self.pt_cap = new

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def add_keyframe(
        self, feats: FrameFeatures, Tcw: np.ndarray, timestamp: float,
        frame_id: int, bindings: Optional[np.ndarray] = None,
    ) -> int:
        """Insert a keyframe from frame features; `bindings` is the frame's
        per-feature map-point id array (-1 = unbound).  Observations for
        bound points are registered (ref: Tracking::CreateNewKeyFrame +
        LocalMapping::ProcessNewKeyFrame)."""
        if self.n_kf == self.kf_cap:
            self._grow_kf()
        if feats.n != self.n_feat:
            # monocular init frames carry a 2x feature budget
            # (ref: src/Tracking.cc:126); pad/trim to the store width
            feats = _resize_features(feats, self.n_feat)
            if bindings is not None:
                b = np.full(self.n_feat, -1, np.int64)
                b[: min(len(bindings), self.n_feat)] = \
                    bindings[: self.n_feat]
                bindings = b
        kf = self.n_kf
        self.n_kf += 1
        self.kf_valid[kf] = True
        self.kf_pose[kf] = Tcw
        self.kf_timestamp[kf] = timestamp
        self.kf_frame_id[kf] = frame_id
        self.kf_xy[kf] = feats.xy
        self.kf_ur[kf] = feats.ur
        self.kf_depth[kf] = feats.depth
        self.kf_octave[kf] = feats.octave
        self.kf_angle[kf] = feats.angle
        self.kf_desc[kf] = feats.desc
        self.kf_feat_valid[kf] = feats.valid
        self.kf_node[kf] = feats.node
        self.kf_word[kf] = feats.word
        self.covis[kf] = {}
        self.kf_children[kf] = set()
        self.kf_loop_edges[kf] = set()
        if (feats.dev and feats.n == self.n_feat
                and torch_device(feats.torch_device) == self.device):
            # adopt the frame's device-resident feature block: zero-copy
            self.kf_dev[kf] = dict(feats.dev)
        if bindings is not None:
            feats = np.nonzero(bindings >= 0)[0]
            pids = self.resolve_replaced_batch(bindings[feats])
            ok = (pids >= 0) & self.pt_valid[np.maximum(pids, 0)]
            self.add_observations_batch(pids[ok], kf, feats[ok])
        return kf

    def camera_center(self, kf: int) -> np.ndarray:
        T = self.kf_pose[kf]
        return -T[:3, :3].T @ T[:3, 3]

    def kf_bow_assigned(self, kf: int) -> bool:
        return bool((self.kf_node[kf] >= 0).any())

    def set_kf_bow(self, kf: int, node: np.ndarray, word: np.ndarray):
        """Assign BoW nodes/words to a keyframe inserted without them
        (ref: KeyFrame::ComputeBoW, called by the mapping thread in
        LocalMapping::ProcessNewKeyFrame).  Invalidates device caches of
        the node field."""
        self.kf_node[kf] = node
        self.kf_word[kf] = word
        cache = self.kf_dev.get(kf)
        if cache is not None:
            cache.pop("node", None)
        for hook in self.bow_hooks:
            hook(kf)

    # ------------------------------------------------------------------
    # points
    # ------------------------------------------------------------------
    def add_point(self, pos: np.ndarray, ref_kf: int, desc: np.ndarray) -> int:
        if self.n_pt == self.pt_cap:
            self._grow_pt()
        pid = self.n_pt
        self.n_pt += 1
        self.pt_valid[pid] = True
        self.pt_pos[pid] = pos
        self.pt_desc[pid] = desc
        self.pt_first_kf[pid] = ref_kf
        self.pt_ref_kf[pid] = ref_kf
        self.pt_visible[pid] = 1
        self.pt_found[pid] = 1
        self.mark_dirty(pid)
        return pid

    def add_points_batch(self, pos: np.ndarray, ref_kf: int,
                         descs: np.ndarray) -> np.ndarray:
        """Vectorized add_point over a block of new points (keyframe
        insertion births up to hundreds at once, ref: Tracking::
        CreateNewKeyFrame src/Tracking.cc:1078-1133)."""
        B = len(pos)
        if B == 0:
            return np.zeros(0, np.int64)
        while self.n_pt + B > self.pt_cap:
            self._grow_pt()
        pids = np.arange(self.n_pt, self.n_pt + B, dtype=np.int64)
        self.n_pt += B
        self.pt_valid[pids] = True
        self.pt_pos[pids] = pos
        self.pt_desc[pids] = descs
        self.pt_first_kf[pids] = ref_kf
        self.pt_ref_kf[pids] = ref_kf
        self.pt_visible[pids] = 1
        self.pt_found[pids] = 1
        self.mark_dirty(pids)
        return pids

    def add_observations_batch(self, pids: np.ndarray, kf: int,
                               feats: np.ndarray) -> np.ndarray:
        """Same-keyframe batched AddObservation: one native engine call
        instead of a Python round-trip per feature.  Returns the mask of
        rows the engine actually added (dup rows are skipped)."""
        pids = np.asarray(pids, np.int64)
        feats = np.asarray(feats, np.int64)
        if len(pids) == 0:
            return np.zeros(0, bool)
        prev = self.kf_obs[kf, feats]
        for i in np.nonzero((prev >= 0) & (prev != pids))[0]:
            self._unbind(int(prev[i]), kf, int(feats[i]))
        w = np.where(self.kf_ur[kf, feats] >= 0, 2, 1).astype(np.int32)
        added = self.obs.add_batch(pids, kf, feats.astype(np.int32), w)
        self.kf_obs[kf, feats[added]] = pids[added]
        np.add.at(self.pt_n_obs, pids[added], w[added])
        return added

    def resolve_replaced(self, pid: int) -> int:
        """Follow Replace() chains (ref: MapPoint::GetReplaced)."""
        seen = 0
        while pid >= 0 and self.pt_replaced_by[pid] >= 0 and seen < 64:
            pid = int(self.pt_replaced_by[pid])
            seen += 1
        return pid

    def resolve_replaced_batch(self, pids: np.ndarray) -> np.ndarray:
        """Vectorized Replace()-chain resolution (chains are short; 8
        fancy-indexed passes cover any realistic depth)."""
        resolved = np.asarray(pids, np.int64).copy()
        for _ in range(8):
            rep = self.pt_replaced_by[np.maximum(resolved, 0)]
            step = (resolved >= 0) & (rep >= 0)
            if not step.any():
                break
            resolved = np.where(step, rep, resolved)
        return resolved

    def add_observation(self, pid: int, kf: int, feat: int):
        """ref: MapPoint::AddObservation (src/MapPoint.cc:98-109);
        stereo features count twice toward nObs."""
        prev = self.kf_obs[kf, feat]
        if prev >= 0 and prev != pid:
            self._unbind(int(prev), kf, feat)
        w = 2 if self.kf_ur[kf, feat] >= 0 else 1
        if self.obs.add(pid, kf, feat, w):
            self.kf_obs[kf, feat] = pid
            self.pt_n_obs[pid] += w

    def _unbind(self, pid: int, kf: int, feat: int):
        if self.obs.find(pid, kf) == feat:
            self.obs.erase(pid, kf)
            self.pt_n_obs[pid] -= 2 if self.kf_ur[kf, feat] >= 0 else 1

    def erase_observation(self, pid: int, kf: int):
        """ref: MapPoint::EraseObservation (src/MapPoint.cc:111-149)."""
        feat = self.obs.erase(pid, kf)
        if feat < 0:
            return
        if self.kf_obs[kf, feat] == pid:
            self.kf_obs[kf, feat] = -1
        self.pt_n_obs[pid] -= 2 if self.kf_ur[kf, feat] >= 0 else 1
        if self.pt_ref_kf[pid] == kf:
            rest = self.obs.items(pid)
            if rest:
                self.pt_ref_kf[pid] = rest[0][0]
        if self.pt_n_obs[pid] <= 2:
            self.set_point_bad(pid)

    def set_point_bad(self, pid: int):
        """ref: MapPoint::SetBadFlag (src/MapPoint.cc:151-175)."""
        if not self.pt_valid[pid]:
            return
        self.pt_valid[pid] = False
        for kf, feat in self.obs.items(pid):
            if self.kf_obs[kf, feat] == pid:
                self.kf_obs[kf, feat] = -1
        self.obs.clear_point(pid)
        self.pt_n_obs[pid] = 0
        self.mark_dirty(pid)

    def replace_point(self, old: int, new: int):
        """ref: MapPoint::Replace (src/MapPoint.cc:177-240): re-point all
        observations of `old` at `new`, merge visible/found counters."""
        if old == new or not self.pt_valid[old]:
            return
        obs_old = self.obs.items(old)
        self.pt_valid[old] = False
        self.pt_replaced_by[old] = new
        self.replace_epoch += 1
        for kf, feat in obs_old:
            if self.kf_obs[kf, feat] == old:
                self.kf_obs[kf, feat] = -1
            if self.obs.find(new, kf) < 0:
                self.add_observation(new, kf, feat)
            # else: keyframe already sees `new`; drop the duplicate slot
        self.obs.clear_point(old)
        self.pt_n_obs[old] = 0
        self.pt_visible[new] += self.pt_visible[old]
        self.pt_found[new] += self.pt_found[old]
        self.compute_distinctive_descriptor(new)
        self.geo_epoch += 1
        self.mark_dirty(old)
        self.mark_dirty(new)

    def found_ratio(self, pid: int) -> float:
        return float(self.pt_found[pid]) / max(float(self.pt_visible[pid]), 1.0)

    def compute_distinctive_descriptor(self, pid: int):
        """Min-median-Hamming representative descriptor
        (ref: MapPoint::ComputeDistinctiveDescriptors src/MapPoint.cc:242)."""
        obs = self.obs.items(pid)
        if not obs:
            return
        descs = np.stack([self.kf_desc[kf, ft] for kf, ft in obs])
        self.pt_desc[pid] = descs[distinctive_index(descs)]
        self.mark_dirty(pid)

    def compute_distinctive_batch(self, pids: np.ndarray):
        """Vectorized compute_distinctive_descriptor over a pid list:
        one obs dump, one gather, one native segmented min-median-Hamming
        call (mapcore_distinctive_batch)."""
        pids = np.asarray(pids, np.int64)
        pids = pids[self.pt_valid[pids]]
        if len(pids) == 0:
            return
        idx, kfs, feats = self.obs.dump(pids)
        if len(idx) == 0:
            return
        n = len(pids)
        descs = np.ascontiguousarray(self.kf_desc[kfs, feats])  # (M, 8)
        seg_len = np.bincount(idx, minlength=n).astype(np.int32)
        seg_start = np.zeros(n, np.int32)
        np.cumsum(seg_len[:-1], out=seg_start[1:])
        has = seg_len > 0
        lib = native.load()
        if lib is not None:
            import ctypes as _c
            out = np.empty(n, np.int32)
            lib.mapcore_distinctive_batch(
                descs.ctypes.data_as(_c.POINTER(_c.c_uint32)),
                seg_start.ctypes.data_as(_c.POINTER(_c.c_int32)),
                seg_len.ctypes.data_as(_c.POINTER(_c.c_int32)),
                n, out.ctypes.data_as(_c.POINTER(_c.c_int32)),
            )
            best = seg_start + out
        else:
            best = np.empty(n, np.int64)
            for i in range(n):
                if not has[i]:
                    continue
                seg = descs[seg_start[i]:seg_start[i] + seg_len[i]]
                best[i] = seg_start[i] + distinctive_index(seg)
        self.pt_desc[pids[has]] = descs[best[has]]
        self.mark_dirty(pids[has])

    def update_normal_and_depth(self, pid: int):
        """ref: MapPoint::UpdateNormalAndDepth (src/MapPoint.cc:330-371)."""
        obs = [kf for kf, _ in self.obs.items(pid)]
        if not obs or self.pt_ref_kf[pid] < 0:
            return
        pos = self.pt_pos[pid]
        normals = []
        for kf in obs:
            ray = pos - self.camera_center(kf)
            n = np.linalg.norm(ray)
            if n > 1e-9:
                normals.append(ray / n)
        if not normals:
            return
        normal = np.mean(normals, axis=0)
        nn = np.linalg.norm(normal)
        self.pt_normal[pid] = normal / max(nn, 1e-9)
        self.mark_dirty(pid)

    def update_scale_band(self, pid: int, scale_factors: np.ndarray):
        """Distance band from the reference keyframe's octave
        (ref: src/MapPoint.cc:360-368)."""
        ref = int(self.pt_ref_kf[pid])
        feat = self.obs.find(pid, ref)
        if feat < 0:
            obs = self.obs.items(pid)
            if not obs:
                return
            ref, feat = obs[0]
        dist = np.linalg.norm(self.pt_pos[pid] - self.camera_center(ref))
        level = int(self.kf_octave[ref, feat])
        n_levels = len(scale_factors)
        self.pt_max_dist[pid] = dist * scale_factors[level]
        self.pt_min_dist[pid] = self.pt_max_dist[pid] / scale_factors[n_levels - 1]
        self.mark_dirty(pid)

    def update_points_batch(self, pids: np.ndarray,
                            scale_factors: np.ndarray):
        """Vectorized update_normal_and_depth + update_scale_band over a
        pid list (the post-BA writeback hot path).  Same semantics as the
        scalar versions (ref: src/MapPoint.cc:330-371) but one obs-engine
        dump and pure-numpy segment reductions instead of a Python loop
        per point."""
        pids = np.asarray(pids, np.int64)
        if len(pids) == 0:
            return
        keep = self.pt_valid[pids]
        pids = pids[keep]
        if len(pids) == 0:
            return
        idx, kfs, feats = self.obs.dump(pids)
        if len(idx) == 0:
            return
        n = len(pids)
        # camera centers for every referenced keyframe, vectorized
        T = self.kf_pose[kfs]                                # (M, 4, 4)
        centers = -np.einsum("mij,mi->mj", T[:, :3, :3], T[:, :3, 3])
        rays = self.pt_pos[pids][idx] - centers              # (M, 3)
        norms = np.linalg.norm(rays, axis=1)
        ok = norms > 1e-9
        unit = np.where(ok[:, None], rays / np.maximum(norms, 1e-9)[:, None],
                        0.0)
        acc = np.zeros((n, 3), np.float64)
        np.add.at(acc, idx, unit)
        cnt = np.zeros(n, np.int64)
        np.add.at(cnt, idx, ok.astype(np.int64))
        has_ref = self.pt_ref_kf[pids] >= 0
        upd_n = (cnt > 0) & has_ref
        mean = acc / np.maximum(cnt, 1)[:, None]
        nn = np.linalg.norm(mean, axis=1)
        normal = mean / np.maximum(nn, 1e-9)[:, None]
        self.pt_normal[pids[upd_n]] = normal[upd_n].astype(np.float32)

        # scale band: the ref-kf observation row, else the first row
        ref = self.pt_ref_kf[pids]
        is_ref_row = kfs == ref[idx]
        # first row per point (dump emits rows grouped by pid order)
        first = np.full(n, np.iinfo(np.int64).max, np.int64)
        rows = np.arange(len(idx))
        np.minimum.at(first, idx, rows)
        first[first == np.iinfo(np.int64).max] = -1
        chosen = first.copy()
        ref_rows = rows[is_ref_row]
        chosen[idx[is_ref_row]] = ref_rows
        has_obs = first >= 0
        ci = np.maximum(chosen, 0)
        ref_used = kfs[ci]
        feat_used = feats[ci]
        dist = np.linalg.norm(self.pt_pos[pids] - centers[ci], axis=1)
        level = self.kf_octave[ref_used, feat_used].astype(np.int64)
        max_d = (dist * scale_factors[level]).astype(np.float32)
        min_d = (max_d / scale_factors[len(scale_factors) - 1]).astype(
            np.float32)
        self.pt_max_dist[pids[has_obs]] = max_d[has_obs]
        self.pt_min_dist[pids[has_obs]] = min_d[has_obs]
        self.mark_dirty(pids)

    # ------------------------------------------------------------------
    # covisibility graph + spanning tree
    # ------------------------------------------------------------------
    def update_connections(self, kf: int, min_weight: int = 15):
        """Recompute covisibility for `kf` (ref: KeyFrame::UpdateConnections
        src/KeyFrame.cc:289-380): count keyframes sharing map points, keep
        edges with weight >= 15 (or the single best), mirror edges, and set
        the spanning-tree parent on first connection."""
        row = self.kf_obs[kf]
        kfs, counts = self.obs.observers_of(row[row >= 0], exclude_kf=kf)
        if len(kfs) == 0:
            return
        best_kf = int(kfs[0])
        keep = {int(k): int(w) for k, w in zip(kfs, counts)
                if w >= min_weight}
        if not keep:
            keep = {best_kf: int(counts[0])}
        # drop stale mirrored edges
        for other in set(self.covis.get(kf, {})) - set(keep):
            self.covis.get(other, {}).pop(kf, None)
        self.covis[kf] = dict(keep)
        for other, w in keep.items():
            self.covis.setdefault(other, {})[kf] = w
        if self.kf_first_connection[kf] and kf != self.origin_kf:
            self.set_parent(kf, best_kf)
            self.kf_first_connection[kf] = False

    def set_parent(self, kf: int, parent: int):
        old = self.kf_parent[kf]
        if old >= 0:
            self.kf_children.get(int(old), set()).discard(kf)
        self.kf_parent[kf] = parent
        if parent >= 0:
            self.kf_children.setdefault(parent, set()).add(kf)

    def ordered_covisibles(self, kf: int) -> List[int]:
        c = self.covis.get(kf, {})
        return sorted((k for k in c if self.kf_valid[k]),
                      key=lambda k: -c[k])

    def best_covisibles(self, kf: int, n: int) -> List[int]:
        return self.ordered_covisibles(kf)[:n]

    def covisibles_by_weight(self, kf: int, w: int) -> List[int]:
        c = self.covis.get(kf, {})
        return sorted((k for k in c if c[k] >= w and self.kf_valid[k]),
                      key=lambda k: -c[k])

    def add_loop_edge(self, a: int, b: int):
        self.kf_loop_edges.setdefault(a, set()).add(b)
        self.kf_loop_edges.setdefault(b, set()).add(a)
        self.kf_not_erase[a] = True
        self.kf_not_erase[b] = True

    # ------------------------------------------------------------------
    # keyframe culling (ref: KeyFrame::SetBadFlag src/KeyFrame.cc:453-541)
    # ------------------------------------------------------------------
    def erase_keyframe(self, kf: int):
        if kf == self.origin_kf:
            return
        if self.kf_not_erase[kf]:
            self.kf_to_be_erased[kf] = True
            return
        # erase covisibility edges both ways
        for other in list(self.covis.get(kf, {})):
            self.covis.get(other, {}).pop(kf, None)
        self.covis[kf] = {}
        # erase observations
        row = self.kf_obs[kf]
        for feat in np.nonzero(row >= 0)[0]:
            self.erase_observation(int(row[feat]), kf)
        # greedy spanning-tree reparenting of children by max covis weight
        # among candidate parents (ref: src/KeyFrame.cc:485-535)
        children = set(self.kf_children.get(kf, set()))
        candidates: Set[int] = set()
        parent = int(self.kf_parent[kf])
        if parent >= 0:
            candidates.add(parent)
        while children:
            best_w, best_child, best_parent = -1, None, None
            for child in children:
                for cand in self.covis.get(child, {}):
                    if cand in candidates and self.kf_valid[cand]:
                        w = self.covis[child][cand]
                        if w > best_w:
                            best_w, best_child, best_parent = w, child, cand
            if best_child is None:
                break
            self.set_parent(best_child, best_parent)
            candidates.add(best_child)
            children.discard(best_child)
        for child in children:      # fallback: original parent
            self.set_parent(child, parent)
        self.kf_Tcp[kf] = self.kf_pose[kf] @ np.linalg.inv(
            self.kf_pose[parent]) if parent >= 0 else np.eye(4, dtype=np.float32)
        if parent >= 0:
            self.kf_children.get(parent, set()).discard(kf)
        self.kf_children[kf] = set()
        self.kf_valid[kf] = False
        self.kf_dev.pop(kf, None)
        for hook in self.erase_hooks:
            hook(kf)

    def set_not_erase(self, kf: int, flag: bool):
        """ref: KeyFrame::SetNotErase/SetErase deferred deletion."""
        if flag:
            self.kf_not_erase[kf] = True
        else:
            if not self.kf_loop_edges.get(kf):
                self.kf_not_erase[kf] = False
            if self.kf_to_be_erased[kf]:
                self.kf_to_be_erased[kf] = False
                self.kf_not_erase[kf] = False
                self.erase_keyframe(kf)

    # ------------------------------------------------------------------
    # queries used by the pipeline
    # ------------------------------------------------------------------
    def valid_kf_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_valid[: self.n_kf])[0]

    def valid_pt_ids(self) -> np.ndarray:
        return np.nonzero(self.pt_valid[: self.n_pt])[0]

    def points_in_kfs(self, kfs) -> np.ndarray:
        """Unique valid map-point ids observed by the given keyframes."""
        if len(kfs) == 0:
            return np.zeros(0, np.int64)
        pids = np.unique(self.kf_obs[np.asarray(kfs)])
        pids = pids[pids >= 0]
        return pids[self.pt_valid[pids]]

    def tracked_points_in_kf(self, kf: int, min_obs: int) -> int:
        """ref: KeyFrame::TrackedMapPoints."""
        row = self.kf_obs[kf]
        pids = row[row >= 0]
        pids = pids[self.pt_valid[pids]]
        if min_obs <= 1:
            return len(pids)
        return int(np.sum(self.pt_n_obs[pids] >= min_obs))

    def scene_median_depth(self, kf: int, q: int = 2) -> float:
        """ref: KeyFrame::ComputeSceneMedianDepth (src/KeyFrame.cc:633)."""
        row = self.kf_obs[kf]
        pids = row[row >= 0]
        pids = pids[self.pt_valid[pids]]
        if len(pids) == 0:
            return -1.0
        T = self.kf_pose[kf]
        z = self.pt_pos[pids] @ T[2, :3] + T[2, 3]
        z = np.sort(z)
        return float(z[(len(z) - 1) // q])

    # ------------------------------------------------------------------
    # save / load (SURVEY §5.4: the fork is export-only; we add full
    # checkpoint/resume, cheap with array state)
    # ------------------------------------------------------------------
    def state(self) -> tuple:
        """(arrays, meta): every numpy array of the store and the rest of
        its state as plain dicts and sets — the pickle layout of `save`,
        which is the JAX package's."""
        arrays = {
            k: v for k, v in self.__dict__.items()
            if isinstance(v, np.ndarray)
        }
        meta = {
            "n_feat": self.n_feat, "n_kf": self.n_kf, "n_pt": self.n_pt,
            "kf_cap": self.kf_cap, "pt_cap": self.pt_cap,
            "big_change_idx": self.big_change_idx,
            "origin_kf": self.origin_kf,
            "covis": self.covis,
            "pt_obs": {
                int(pid): self.obs.items(int(pid))
                for pid in np.nonzero(self.pt_valid[: self.n_pt])[0]
            },
            "kf_children": {k: set(v) for k, v in self.kf_children.items()},
            "kf_loop_edges": {k: set(v) for k, v in self.kf_loop_edges.items()},
        }
        return arrays, meta

    def save(self, path: str):
        arrays, meta = self.state()
        with open(path, "wb") as f:
            pickle.dump({"arrays": arrays, "meta": meta}, f, protocol=4)

    @classmethod
    def load(cls, path: str, *, device) -> "MapStore":
        with open(path, "rb") as f:
            blob = pickle.load(f)
        return cls.from_state(blob["arrays"], blob["meta"], device=device)

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, *, device) -> "MapStore":
        """A store from `state()`'s (arrays, meta), e.g. a saved map's."""
        m = cls(meta["n_feat"], kf_cap=meta["kf_cap"], pt_cap=meta["pt_cap"],
                device=device)
        for k, v in arrays.items():
            setattr(m, k, v)
        m.n_kf = meta["n_kf"]
        m.n_pt = meta["n_pt"]
        m.big_change_idx = meta["big_change_idx"]
        m.origin_kf = meta["origin_kf"]
        m.covis = meta["covis"]
        for pid, items in meta["pt_obs"].items():
            for kf, feat in items:
                w = 2 if m.kf_ur[kf, feat] >= 0 else 1
                m.obs.add(int(pid), int(kf), int(feat), w)
        m.kf_children = meta["kf_children"]
        m.kf_loop_edges = meta["kf_loop_edges"]
        return m

    # map-point export (fork: Map::Save/SaveWithTimestamps src/Map.cc:133-186)
    def export_points_obj(self, path: str):
        with open(path, "w") as f:
            for pid in self.valid_pt_ids():
                x, y, z = self.pt_pos[pid]
                f.write(f"v {x} {y} {z}\n")

    def export_points_with_timestamps(self, path: str):
        with open(path, "w") as f:
            for pid in self.valid_pt_ids():
                x, y, z = self.pt_pos[pid]
                ts = " ".join(
                    f"{self.kf_timestamp[kf]:.6f}"
                    for kf in sorted(k for k, _ in self.obs.items(int(pid)))
                )
                f.write(f"{x} {y} {z} {ts}\n")
