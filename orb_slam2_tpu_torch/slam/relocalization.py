"""Relocalization: recover a lost camera from the BoW database.

Port of orb_slam2_tpu/slam/relocalization.py, the equivalent of
Tracking::Relocalization (ref: src/Tracking.cc:1342-1503): BoW candidate
retrieval, node-aligned matching (>=15), EPnP RANSAC, pose optimization
(>=10 inliers), and up to two guided-reprojection rounds until >=50
inliers.  It runs on the tracking thread while the tracker is LOST, never
inside a graph capture.  The RANSAC samples come from a numpy generator
on the host, as in the JAX package, so both draw the same minimal sets.
"""

from __future__ import annotations

import os as _os

import numpy as np
import torch

from orb_slam2_tpu_torch.config import Settings
from orb_slam2_tpu_torch.ops import matching
from orb_slam2_tpu_torch.slam.map_store import MapStore
from orb_slam2_tpu_torch.solvers import epnp
from orb_slam2_tpu_torch.utils import (
    bucket_size, pad_rows, torch_device, upload,
)

_DEBUG_TRACK = _os.environ.get("ORB_DEBUG_TRACK", "0") == "1"


class Relocalizer:
    def __init__(self, settings: Settings, store: MapStore, kf_database,
                 *, device):
        self.device = torch_device(device)
        self.s = settings
        self.store = store
        self.db = kf_database
        self.level_sigma2 = settings.level_sigma2().astype(np.float32)
        self.scale_factors = settings.scale_factors().astype(np.float32)
        self.log_scale = float(np.log(settings.scale_factor))
        w, h = settings.width, settings.height
        self.bounds = np.array([0.0, w, 0.0, h], np.float32)
        self._bounds_dev = self._up(self.bounds)
        self._sf_dev = self._up(self.scale_factors)
        self.rng = np.random.default_rng(0)

    def _up(self, a) -> torch.Tensor:
        return upload(a, self.device)

    def relocalize(self, frame, tracker) -> bool:
        store = self.store
        s = self.s
        tracker._assign_frame_bow(frame)
        if not (frame.feats.word >= 0).any():
            return False
        candidates = self.db.detect_reloc_candidates(
            frame.feats.word, store)
        if _DEBUG_TRACK:
            print(f"[dbg]   reloc f{frame.frame_id} candidates="
                  f"{candidates[:8]}", flush=True)
        if not candidates:
            return False

        for kf in candidates[:8]:
            if not store.kf_valid[kf]:
                continue
            kf_bind = store.kf_obs[kf]
            kf_has = (kf_bind >= 0)
            kf_pids = np.where(kf_has, kf_bind, 0)
            kf_has = kf_has & store.pt_valid[kf_pids]
            m = matching.search_by_nodes(
                store.kf_device(kf, "desc"), store.kf_device(kf, "node"),
                self._up(kf_has), store.kf_device(kf, "angle"),
                frame.feats.device("desc"), frame.feats.device("node"),
                frame.feats.device("valid"), frame.feats.device("angle"),
                ratio=0.75,
            )
            idx, dist, ok = matching.to_host(m)
            ok = ok & kf_has
            if _DEBUG_TRACK:
                print(f"[dbg]   reloc kf={kf} bow={int(ok.sum())}",
                      flush=True)
            if int(ok.sum()) < 15:
                continue

            # EPnP RANSAC on the 3D-2D matches (ref: PnPsolver)
            rows = np.nonzero(ok)[0]
            # hard-cap at the top of the warmed bucket ladder
            # (2x bucket_reloc, precompile.py), keeping the best-scoring
            # matches, so the solver only ever sees the warmed shapes
            cap = 2 * s.bucket_reloc
            if len(rows) > cap:
                rows = rows[np.argsort(dist[rows], kind="stable")[:cap]]
            pts_w = store.pt_pos[kf_pids[rows]]
            uv = frame.feats.xy[idx[rows]]
            oct_f = frame.feats.octave[idx[rows]]
            max_err2 = (5.991 * self.level_sigma2[oct_f]).astype(np.float32)
            n = len(rows)
            # pinned bucket (Settings.bucket_reloc): most reloc attempts
            # carry well under 256 BoW matches, so the PnP RANSAC meets
            # one shape — warmed by System.precompile()
            n_pad = bucket_size(n, s.bucket_reloc)
            mask = pad_rows(np.ones(n, bool), n_pad, False)
            sample = self.rng.integers(0, n, (128, 6)).astype(np.int64)
            res = epnp.solve_pnp_ransac(
                self._up(pad_rows(pts_w.astype(np.float32), n_pad, 0.0)),
                self._up(pad_rows(uv.astype(np.float32), n_pad, 0.0)),
                self._up(pad_rows(max_err2, n_pad, 0.0)),
                self._up(mask),
                self._up(sample),
                s.fx, s.fy, s.cx, s.cy,
            )
            # one device-to-host copy of the whole result
            packed = torch.cat([
                res.Tcw.reshape(-1), res.inliers.float(),
                res.success.float().reshape(1)]).cpu().numpy()
            if not packed[-1] > 0.5:
                if _DEBUG_TRACK:
                    print(f"[dbg]   reloc kf={kf} ransac FAILED", flush=True)
                continue
            frame.Tcw = packed[:16].reshape(4, 4).astype(np.float32)
            frame.bindings[:] = -1
            inl = packed[16:16 + n] > 0.5
            frame.bindings[idx[rows[inl]]] = kf_pids[rows[inl]]

            n_good = tracker._optimize_pose(frame)
            if n_good < 10:
                continue
            tracker._discard_outliers(frame)

            # guided reprojection rounds (ref :1434-1483)
            for round_th, round_dist in ((10.0, 100), (3.0, 64)):
                if n_good >= 50:
                    break
                already = set(
                    int(p) for p in frame.bindings[frame.bindings >= 0])
                cand_rows = np.nonzero(kf_has)[0]
                cand_rows = np.array(
                    [r for r in cand_rows
                     if int(kf_pids[r]) not in already], np.int64)
                if len(cand_rows) == 0:
                    break
                pid_c = kf_pids[cand_rows]
                free = frame.feats.valid & (frame.bindings < 0)
                # pad to the keyframe feature capacity: cand_rows is
                # bounded by it, so this is ONE shape, warmed beforehand
                C = store.n_feat
                cmask = pad_rows(np.ones(len(cand_rows), bool), C, False)
                m2 = matching.search_reloc_points(
                    self._up(pad_rows(
                        store.pt_pos[pid_c].astype(np.float32), C)),
                    self._up(cmask),
                    self._up(pad_rows(store.pt_desc[pid_c], C)),
                    self._up(pad_rows(store.pt_min_dist[pid_c], C)),
                    self._up(pad_rows(store.pt_max_dist[pid_c], C)),
                    self._up(pad_rows(store.kf_angle[kf][cand_rows], C)),
                    self._up(frame.Tcw),
                    frame.feats.device("xy"), frame.feats.device("octave"),
                    frame.feats.device("desc"), frame.feats.device("angle"),
                    self._up(free),
                    s.fx, s.fy, s.cx, s.cy,
                    self._bounds_dev, self._sf_dev,
                    self.log_scale, s.n_levels,
                    round_th, orb_dist=round_dist,
                )
                idx2, _, ok2 = matching.to_host(m2)
                for r in np.nonzero(ok2[: len(cand_rows)])[0]:
                    frame.bindings[idx2[r]] = pid_c[r]
                n_good = tracker._optimize_pose(frame)
                tracker._discard_outliers(frame)

            if _DEBUG_TRACK:
                print(f"[dbg]   reloc kf={kf} n_good={n_good}", flush=True)
            if n_good >= 50:
                return True
        return False
