"""Device-resident keyframe feature mirror for the mapping pipeline.

Port of orb_slam2_tpu/slam/kf_mirror.py.  The mapper's batched device
calls (epipolar triangulation over ~10 covisible neighbors, two-way
fusion over ~30 covisible targets) need the feature blocks of MANY
keyframes per call.  Keyframe features are IMMUTABLE after insertion
(ref: KeyFrame.h — the keypoint/descriptor members are const; only pose
and connections change), so they live in one fixed-capacity set of
tensors on the mapper's device, uploaded once per keyframe.  Batched
calls then receive the whole mirror plus a small (B,) index vector and
gather rows on the device.

Fields are packed to minimize copies per insertion:
  f32  (cap, N, 5)  — xy(2), ur, depth, angle
  i32  (cap, N, 2)  — octave, node
  desc (cap, N, 8)  — rBRIEF words as int32 holding the uint32 bits
  valid(cap, N)     — bool feature-slot validity

Capacity is FIXED at construction (settings.mirror_kf_cap).  Keyframes
with ids beyond it report absent and callers fall back to the stacking
path (correctness is never capacity-bound).  Rows are written in place
with `index_copy_` (the JAX package's donated scatter).
"""

from __future__ import annotations

import numpy as np
import torch


class KfFeatureMirror:
    def __init__(self, n_feat: int, cap: int, device):
        self.n_feat = int(n_feat)
        self.cap = int(cap)
        self.device = torch.device(device)
        self._present = np.zeros(self.cap, bool)
        # per-row generation counter, bumped by node_dirty: ensure() only
        # marks a row present if its generation is unchanged across the
        # host-array snapshot -> device upload window, so a BoW
        # assignment landing mid-upload cannot have its invalidation
        # overwritten
        self._gen = np.zeros(self.cap, np.int64)
        z = dict(device=self.device)
        self.f32 = torch.zeros((self.cap, self.n_feat, 5), dtype=torch.float32,
                               **z)
        self.i32 = torch.zeros((self.cap, self.n_feat, 2), dtype=torch.int32,
                               **z)
        self.desc = torch.zeros((self.cap, self.n_feat, 8), dtype=torch.int32,
                                **z)
        self.valid = torch.zeros((self.cap, self.n_feat), dtype=torch.bool,
                                 **z)

    def clear(self):
        """Map reset: keyframe ids restart from 0 in a fresh store."""
        self._present[:] = False
        self._gen += 1

    def node_dirty(self, kf: int):
        """Invalidate a row whose BoW nodes were assigned after insertion
        (the i32 field holds node ids); the next ensure() re-uploads."""
        if 0 <= kf < self.cap:
            self._present[kf] = False
            self._gen[kf] += 1

    def ensure(self, store, kfs) -> bool:
        """Upload any missing keyframe rows from the store's host arrays.

        Returns False when any requested id is beyond capacity — the
        caller must use the stacking path for this call."""
        kfs = np.asarray(kfs, np.int64)
        if len(kfs) == 0:
            return True
        if kfs.max() >= self.cap:
            return False
        missing = kfs[~self._present[kfs]]
        if len(missing) == 0:
            return True
        missing = np.unique(missing)
        gen_before = self._gen[missing].copy()
        f32_r = np.zeros((len(missing), self.n_feat, 5), np.float32)
        f32_r[:, :, 0:2] = store.kf_xy[missing]
        f32_r[:, :, 2] = store.kf_ur[missing]
        f32_r[:, :, 3] = store.kf_depth[missing]
        f32_r[:, :, 4] = store.kf_angle[missing]
        i32_r = np.stack([store.kf_octave[missing], store.kf_node[missing]],
                         -1).astype(np.int32)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        rows = up(missing)
        self.f32.index_copy_(0, rows, up(f32_r))
        self.i32.index_copy_(0, rows, up(i32_r))
        self.desc.index_copy_(0, rows, up(store.kf_desc[missing].view(
            np.int32)))
        self.valid.index_copy_(0, rows, up(store.kf_feat_valid[missing]))
        unchanged = self._gen[missing] == gen_before
        self._present[missing[unchanged]] = True
        return True
