"""Loop closing: detection, Sim3 estimation, correction, global optimization.

Port of orb_slam2_tpu/slam/loop_closing.py, the equivalent of
LoopClosing (ref: src/LoopClosing.cc, 778 LoC): BoW candidate detection with 3-consecutive covisibility-consistency voting
(:103-229), Sim3 RANSAC + refinement + guided projection acceptance
(:231-400), and loop correction — Sim3 propagation over the covisible
window, loop-point fusion, essential-graph optimization, and global BA
(:402-757).  The fork's `loop_detected` flag (consumed by the grid-map
publisher, ref src/LoopClosing.cc:750) is kept.

Host numpy over the MapStore; the device calls are the node-aligned BoW
match, the two Sim3 searches, the Sim3 solver and the pose graph, all at
the pinned bucket shapes of Settings.  A pass holds
`utils.DEVICE_CAPTURE_LOCK` first and `store.lock` inside it, the same
order as the mapping thread's pass, so the tracking thread never captures
a CUDA graph while this thread is on the device.  The RANSAC samples come
from a numpy generator on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from orb_slam2_tpu_torch import logs
from orb_slam2_tpu_torch.config import Sensor, Settings
from orb_slam2_tpu_torch.ops import matching
from orb_slam2_tpu_torch.slam.map_store import MapStore
from orb_slam2_tpu_torch.solvers import pose_graph
from orb_slam2_tpu_torch.solvers import sim3_solver
from orb_slam2_tpu_torch.utils import (
    DEVICE_CAPTURE_LOCK, StageTimers, bucket_size, pad_rows, torch_device,
    upload,
)

COVISIBILITY_CONSISTENCY_TH = 3   # ref: LoopClosing ctor


class LoopCloser:
    def __init__(self, settings: Settings, sensor: Sensor, store: MapStore,
                 kf_database, local_mapper=None, *, device):
        self.device = torch_device(device)
        self.s = settings
        self.sensor = sensor
        self.store = store
        self.db = kf_database
        self.local_mapper = local_mapper
        self.queue: List[int] = []
        self.last_loop_kf = -1000
        self.loop_detected = False        # fork flag (Monopub contract)
        self.loops_closed = 0
        self._consistent_groups: List[Tuple[Set[int], int]] = []
        self.level_sigma2 = settings.level_sigma2().astype(np.float32)
        self.scale_factors = settings.scale_factors().astype(np.float32)
        self.log_scale = float(np.log(settings.scale_factor))
        w, h = settings.width, settings.height
        self.bounds = np.array([0.0, w, 0.0, h], np.float32)
        self._bounds_dev = self._up(self.bounds)
        self._sf_dev = self._up(self.scale_factors)
        self.rng = np.random.default_rng(0)
        self.timers = StageTimers()
        # stream callbacks (fork Monopub contract, see mapping2d.stream)
        self.on_loop: List = []
        # global BA runner (ref: mbRunningGBA/mbStopGBA protocol); in
        # async scheduling the System flips background_gba so GBA runs
        # on its own thread like the reference's RunGlobalBundleAdjustment
        self.gba = None
        self.background_gba = False
        # True while a keyframe is mid-detect/correct (popped but not
        # done) — quiescence signal, see LocalMapper.idle
        self.processing = False
        self.log = logs.get("loop")

    def _up(self, a) -> torch.Tensor:
        return upload(a, self.device)

    # ------------------------------------------------------------------
    def insert_keyframe(self, kf: int):
        self.queue.append(kf)

    def reset(self, store: MapStore):
        if self.gba is not None:
            self.gba.request_stop()   # join-free, see LocalMapper.reset
        self.store = store
        self.queue.clear()
        self._consistent_groups.clear()
        self.last_loop_kf = -1000
        if self.db is not None:
            self.db.clear()

    def spin(self):
        while self.queue:
            self.process_one()

    def idle(self) -> bool:
        """Quiescent: queue drained, nothing mid-flight, no background
        GBA running."""
        return (not self.queue and not self.processing
                and (self.gba is None or not self.gba.running))

    def process_one(self):
        if not self.queue:
            return
        self.processing = True
        try:
            # capture lock first, store.lock inside (the mapper's order)
            with DEVICE_CAPTURE_LOCK:
                self._process_one_inner()
        finally:
            self.processing = False

    def _process_one_inner(self):
        try:
            kf = self.queue.pop(0)
        except IndexError:    # a reset emptied the queue while process_one
            return            # waited for the lock
        # coarse map lock for the whole detect/correct pass: loop closing
        # runs on its own thread in async mode, and the reference likewise
        # serializes CorrectLoop against tracking/mapping via
        # mMutexMapUpdate + LocalMapping::RequestStop (src/LoopClosing.cc:
        # 402-435).  The long GBA that follows does NOT hold the lock —
        # it runs chunked on the GBA thread (see global_ba.GlobalBA).
        with self.store.lock:
            if not self.store.kf_valid[kf]:
                return
            self.store.kf_not_erase[kf] = True
            try:
                with self.timers("loop/detect"):
                    candidate = self._detect_loop(kf)
                if candidate is None:
                    return
                ok = self._compute_sim3_and_correct(kf, candidate)
                if ok:
                    self.loop_detected = True
                    self.loops_closed += 1
                    self.last_loop_kf = kf
                    self.store.big_change_idx += 1
                    self.log.info(
                        "loop closed: kf %d <-> candidate %d "
                        "(total loops %d)", kf, candidate,
                        self.loops_closed)
                    for cb in self.on_loop:
                        cb(kf)
                else:
                    self.log.info(
                        "loop candidate %d for kf %d rejected by Sim3",
                        candidate, kf)
            finally:
                self.store.set_not_erase(kf, False)

    # ------------------------------------------------------------------
    def _detect_loop(self, kf: int) -> Optional[int]:
        """ref: LoopClosing::DetectLoop (src/LoopClosing.cc:103-229)."""
        store = self.store
        if kf - self.last_loop_kf < 10 or store.n_kf < 10:
            self.db.add(kf, store.kf_word[kf])
            return None

        # min score against covisible neighbors (ref :121-138)
        neighbors = store.ordered_covisibles(kf)
        ids_kf, w_kf = self.db.voc.bow_vector(store.kf_word[kf])
        min_score = 1.0
        for nb in neighbors:
            if nb in self.db.bow:
                min_score = min(
                    min_score, self.db.score_against(ids_kf, w_kf, nb))

        candidates = self.db.detect_loop_candidates(
            kf, min_score, store, ids=ids_kf, weights=w_kf)
        if not candidates:
            self.db.add(kf, store.kf_word[kf])
            self._consistent_groups.clear()
            return None

        # 3-consecutive covisibility-consistency vote (ref :152-211)
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for cand in candidates:
            group = set(store.best_covisibles(cand, 30)) | {cand}
            consistent = False
            for prev_group, count in self._consistent_groups:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    consistent = True
                    if count + 1 >= COVISIBILITY_CONSISTENCY_TH:
                        enough.append(cand)
                    break
            if not consistent:
                new_groups.append((group, 0))
        self._consistent_groups = new_groups
        self.db.add(kf, store.kf_word[kf])
        if not enough:
            self.log.debug(
                "kf %d: %d BoW candidates, none consistency-confirmed",
                kf, len(candidates))
            return None
        self.log.info(
            "kf %d: loop candidate %d passed 3-consistency vote "
            "(%d candidates)", kf, enough[0], len(candidates))
        return enough[0]

    # ------------------------------------------------------------------
    def _match_by_bow(self, kf1: int, kf2: int):
        """Node-aligned matching of the two keyframes' bound features."""
        store = self.store
        b1 = store.kf_obs[kf1]
        has1 = (b1 >= 0) & store.pt_valid[np.where(b1 >= 0, b1, 0)]
        b2 = store.kf_obs[kf2]
        has2 = (b2 >= 0) & store.pt_valid[np.where(b2 >= 0, b2, 0)]
        m = matching.search_by_nodes(
            store.kf_device(kf1, "desc"), store.kf_device(kf1, "node"),
            self._up(has1), store.kf_device(kf1, "angle"),
            store.kf_device(kf2, "desc"), store.kf_device(kf2, "node"),
            self._up(has2), store.kf_device(kf2, "angle"),
            ratio=0.75,
        )
        idx, _, ok = matching.to_host(m)
        ok = ok & has1 & has2[np.clip(idx, 0, len(has2) - 1)]
        return idx, ok

    def _gather_pairs(self, kf: int, cand: int, rows, idx):
        """Correspondence arrays (camera-frame points, pixels, octaves)
        for match rows `rows` of kf matched to features `idx[rows]` of
        cand."""
        store = self.store
        pid1 = store.kf_obs[kf][rows]
        pid2 = store.kf_obs[cand][idx[rows]]
        T1 = store.kf_pose[kf]
        T2 = store.kf_pose[cand]
        pc1 = store.pt_pos[pid1] @ T1[:3, :3].T + T1[:3, 3]
        pc2 = store.pt_pos[pid2] @ T2[:3, :3].T + T2[:3, 3]
        uv1 = store.kf_xy[kf][rows]
        uv2 = store.kf_xy[cand][idx[rows]]
        oct1 = store.kf_octave[kf][rows]
        oct2 = store.kf_octave[cand][idx[rows]]
        return pc1, pc2, uv1, uv2, oct1, oct2

    def _sim3_extend_matches(self, kf: int, cand: int, R12, t12, s12,
                             match12: np.ndarray) -> np.ndarray:
        """SearchBySim3 (ref: src/LoopClosing.cc:313-317,
        src/ORBmatcher.cc:1102-1326): grow the BoW match set by mutual
        Sim3-guided projection of each side's unmatched map points into
        the other keyframe.  Returns the extended match12."""
        store = self.store
        b1 = store.kf_obs[kf]
        b2 = store.kf_obs[cand]
        has1 = (b1 >= 0) & store.pt_valid[np.where(b1 >= 0, b1, 0)]
        has2 = (b2 >= 0) & store.pt_valid[np.where(b2 >= 0, b2, 0)]
        used2 = np.zeros(len(has2), bool)
        used2[match12[match12 >= 0]] = True
        mask1 = has1 & (match12 < 0)
        mask2 = has2 & ~used2
        if not mask1.any() or not mask2.any():
            return match12
        p1 = np.where(b1 >= 0, b1, 0)
        p2 = np.where(b2 >= 0, b2, 0)
        idx12, agree = matching.search_by_sim3_mutual(
            self._up(store.pt_pos[p1]), self._up(mask1),
            self._up(store.pt_desc[p1]),
            self._up(store.pt_min_dist[p1]),
            self._up(store.pt_max_dist[p1]),
            store.kf_device(kf, "octave"), store.kf_device(kf, "xy"),
            self._up(store.pt_pos[p2]), self._up(mask2),
            self._up(store.pt_desc[p2]),
            self._up(store.pt_min_dist[p2]),
            self._up(store.pt_max_dist[p2]),
            store.kf_device(cand, "octave"), store.kf_device(cand, "xy"),
            self._up(store.kf_pose[kf]), self._up(store.kf_pose[cand]),
            self._up(R12.astype(np.float32)),
            self._up(t12.astype(np.float32)), self._up(np.float32(s12)),
            self.s.fx, self.s.fy,
            self.s.cx, self.s.cy,
            self._bounds_dev, self._sf_dev,
            self.log_scale, self.s.n_levels,
            th=7.5,
        )
        packed = torch.stack([idx12, agree.long()]).cpu().numpy()
        idx12 = packed[0].astype(np.int32)
        agree = packed[1] > 0
        out = match12.copy()
        new = agree & mask1
        out[new] = idx12[new]
        return out

    def _compute_sim3_and_correct(self, kf: int, cand: int) -> bool:
        """ref: LoopClosing::ComputeSim3 (:231-400) + CorrectLoop (:402)."""
        store = self.store
        s = self.s
        with self.timers("loop/bow_match"):
            idx, ok = self._match_by_bow(kf, cand)
        rows = np.nonzero(ok)[0]
        if len(rows) < 20:
            self.log.debug("sim3 %d<->%d: bow matches %d < 20",
                           kf, cand, len(rows))
            return False
        # hard-cap at the top of the warmed bucket ladder (4x bucket_sim3,
        # precompile.py): rows is otherwise bounded only by the keyframe
        # feature capacity, and the solver should only see warmed shapes
        # while the loop thread holds store.lock
        cap = 4 * s.bucket_sim3
        rows = rows[:cap]

        pc1, pc2, uv1, uv2, oct1, oct2 = self._gather_pairs(
            kf, cand, rows, idx)
        max_err1 = 9.210 * self.level_sigma2[oct1]   # ref Sim3Solver :87
        max_err2 = 9.210 * self.level_sigma2[oct2]

        n = len(rows)
        n_pad = bucket_size(n, s.bucket_sim3)

        def up(a, fill=0.0):
            return self._up(pad_rows(a.astype(np.float32), n_pad, fill))

        mask = self._up(pad_rows(np.ones(n, bool), n_pad, False))
        sample = self.rng.integers(0, n, (128, 3)).astype(np.int64)
        fix_scale = self.sensor != Sensor.MONOCULAR
        with self.timers("loop/sim3_ransac"):
            res = sim3_solver.solve_sim3_ransac(
                up(pc1), up(pc2), up(uv1), up(uv2), up(max_err1),
                up(max_err2), mask, self._up(sample),
                s.fx, s.fy, s.cx, s.cy,
                fix_scale=fix_scale,
            )
            # one device-to-host copy: R (9), t (3), s, success
            packed = torch.cat([
                res.R12.reshape(-1), res.t12, res.s12.reshape(1),
                res.success.float().reshape(1)]).cpu().numpy()
        if not packed[13] > 0.5:
            if self.log.isEnabledFor(10):      # DEBUG diagnostics only
                # how many pairs agree with the POSE-derived relative
                # transform (s=1)?  High count => the solver is under-
                # sampling; low count => the BoW matches are bad.
                T1 = store.kf_pose[kf]
                T2 = store.kf_pose[cand]
                R12d = T1[:3, :3] @ T2[:3, :3].T
                t12d = T1[:3, 3] - R12d @ T2[:3, 3]
                pred = pc2 @ R12d.T + t12d
                err = np.linalg.norm(pc1 - pred, axis=1)
                self.log.debug(
                    "sim3 %d<->%d: RANSAC failed over %d pairs "
                    "(pose-consistent within 0.25m: %d, median 3D err "
                    "%.2fm)", kf, cand, n, int((err < 0.25).sum()),
                    float(np.median(err)))
            else:
                self.log.debug("sim3 %d<->%d: RANSAC failed over %d "
                               "pairs", kf, cand, n)
            return False

        # grow the match set with Sim3-guided mutual projection before
        # refinement (ref :313-317 SearchBySim3 then OptimizeSim3 over
        # the extended set)
        match12 = np.full(store.n_feat, -1, np.int32)
        match12[rows] = idx[rows]
        with self.timers("loop/sim3_extend"):
            match12 = self._sim3_extend_matches(
                kf, cand, packed[:9].reshape(3, 3), packed[9:12],
                float(packed[12]), match12)
        rows = np.nonzero(match12 >= 0)[0]
        rows = rows[:cap]          # same ladder cap as the RANSAC block
        idx = match12
        pc1, pc2, uv1, uv2, oct1, oct2 = self._gather_pairs(
            kf, cand, rows, idx)
        n = len(rows)
        n_pad = bucket_size(n, s.bucket_sim3)
        inv_s2_1 = 1.0 / self.level_sigma2[oct1]
        inv_s2_2 = 1.0 / self.level_sigma2[oct2]
        mask = self._up(pad_rows(np.ones(n, bool), n_pad, False))
        with self.timers("loop/sim3_refine"):
            R12, t12, s12, inl, n_inl = sim3_solver.refine_sim3(
                up(pc1), up(pc2), up(uv1), up(uv2), up(inv_s2_1),
                up(inv_s2_2), mask,
                res.R12, res.t12, res.s12,
                s.fx, s.fy, s.cx, s.cy,
                fix_scale=fix_scale,
            )
            packed = torch.cat([
                R12.reshape(-1), t12, s12.reshape(1),
                n_inl.float().reshape(1)]).cpu().numpy()
        n_inl = int(packed[13])
        if n_inl < 20:                             # ref :326-329
            self.log.debug("sim3 %d<->%d: refine inliers %d < 20 "
                           "(extended matches %d)", kf, cand, n_inl, n)
            return False
        R12 = packed[:9].reshape(3, 3).copy()
        t12 = packed[9:12].copy()
        s12 = float(packed[12])

        # Scw: world -> current camera through the loop estimate
        # (ref :340-345 gScm * gSmw)
        T2 = store.kf_pose[cand]
        Scw_R, Scw_t, Scw_s = _sim3_compose_np(
            (R12, t12, np.float32(s12)),
            (T2[:3, :3], T2[:3, 3], np.float32(1.0)))
        Scw_s = float(Scw_s)

        # gather loop map points from cand + neighbors (ref :357-372)
        loop_kfs = [cand] + store.best_covisibles(cand, 20)
        loop_pts = store.points_in_kfs(loop_kfs)
        # acceptance counts the union of already-matched features and new
        # guided projections (ref :369-385: mvpCurrentMatchedPoints starts
        # as the BoW+Sim3 matches, SearchByProjection only fills empty
        # slots and skips already-found loop points)
        matched_feats = rows
        matched_pids = store.kf_obs[cand][idx[rows]]
        with self.timers("loop/sim3_accept"):
            n_total = len(matched_feats) + self._count_sim3_matches(
                kf, loop_pts, Scw_R, Scw_t, Scw_s,
                exclude_feats=matched_feats, exclude_pids=matched_pids)
        if n_total < 40:                           # ref :374-385
            self.log.debug("sim3 %d<->%d: acceptance count %d < 40 "
                           "(matched %d)", kf, cand, n_total,
                           len(matched_feats))
            return False

        with self.timers("loop/correct"):
            self._correct_loop(kf, cand, R12, t12, s12, Scw_R, Scw_t,
                               Scw_s, loop_pts)
        return True

    def _count_sim3_matches(self, kf, loop_pts, R, t, s,
                            exclude_feats=None, exclude_pids=None) -> int:
        """New guided-projection matches of loop points into kf, skipping
        already-matched features and already-found loop points (ref:
        ORBmatcher::SearchByProjection src/ORBmatcher.cc:1327-1431)."""
        store = self.store
        if len(loop_pts) == 0:
            return 0
        # FIXED chunk width: loop-point sets grow with map density, and
        # the search should meet one warmed shape while this thread
        # holds store.lock (tracking blocked the whole time)
        M = self.s.bucket_loop_pts
        free = store.kf_feat_valid[kf].copy()
        if exclude_feats is not None:
            free[exclude_feats] = False
        pt_mask = np.ones(len(loop_pts), bool)
        if exclude_pids is not None:
            pt_mask &= ~np.isin(loop_pts, exclude_pids)
        free_dev = self._up(free)
        matched_feats: list = []
        for c0 in range(0, len(loop_pts), M):
            pts_c = loop_pts[c0:c0 + M]
            m = matching.search_by_sim3_projection(
                self._up(pad_rows(store.pt_pos[pts_c], M)),
                self._up(pad_rows(pt_mask[c0:c0 + M], M, False)),
                self._up(pad_rows(store.pt_desc[pts_c], M)),
                self._up(pad_rows(store.pt_min_dist[pts_c], M)),
                self._up(pad_rows(store.pt_max_dist[pts_c], M)),
                self._up(R.astype(np.float32)),
                self._up(t.astype(np.float32)), self._up(np.float32(s)),
                store.kf_device(kf, "xy"), store.kf_device(kf, "octave"),
                store.kf_device(kf, "desc"), free_dev,
                self.s.fx, self.s.fy,
                self.s.cx, self.s.cy,
                self._bounds_dev, self._sf_dev,
                self.log_scale, self.s.n_levels,
                10.0,
            )
            idx, _, ok = matching.to_host(m)
            matched_feats.append(idx[ok])
        # a feature matched from two chunks counts once (the in-chunk
        # duplicate resolution cannot see across chunks)
        return len(np.unique(np.concatenate(matched_feats))) \
            if matched_feats else 0

    # ------------------------------------------------------------------
    def _correct_loop(self, kf, cand, R12, t12, s12, Scw_R, Scw_t, Scw_s,
                      loop_pts):
        """ref: LoopClosing::CorrectLoop (src/LoopClosing.cc:402-643)."""
        store = self.store
        if self.local_mapper is not None:
            self.local_mapper.interrupt_ba()
        # a GBA from a previous loop still running is stale now: kill it
        # and discard its result (ref: CorrectLoop :409-430 mbStopGBA).
        # No join — we hold store.lock, and the dying run re-checks the
        # stop flag under that lock before it would apply anything.
        if self.gba is not None and self.gba.running:
            self.gba.request_stop()

        # snapshot pre-correction poses for relative measurements — one
        # array copy instead of an O(K) per-KF dict (reference-scale maps
        # run 1300+ KFs through here)
        pre_pose = store.kf_pose.copy()

        # corrected Sim3 for current KF + covisible window (ref :436-460)
        window = [kf] + store.best_covisibles(kf, 1000)
        T_kf = pre_pose[kf]
        corrected: Dict[int, tuple] = {}
        Scw_np = (Scw_R, Scw_t, Scw_s)
        for ki in window:
            Ti = pre_pose[ki]
            # S_i_kf = T_i_w * T_w_kf  (scale 1)
            T_i_kf = Ti @ np.linalg.inv(T_kf)
            S_i_kf = (T_i_kf[:3, :3], T_i_kf[:3, 3], 1.0)
            corrected[ki] = _sim3_compose_np(S_i_kf, Scw_np)

        # correct map points of the window (ref :462-498), vectorized:
        # each point is claimed by its FIRST observing keyframe in window
        # order (the reference's mnCorrectedByKF guard) and moved by the
        # composed map M_i = Sc_i^-1 o S_old_i in one batched einsum
        window_arr = np.asarray(window, np.int64)
        W = len(window)
        rows = store.kf_obs[window_arr]               # (W, F) pids
        flat = rows.ravel()
        present = flat >= 0
        pids_flat = flat[present]
        flat_order = np.nonzero(present)[0]
        uniq, first_idx = np.unique(pids_flat, return_index=True)
        claim = flat_order[first_idx] // rows.shape[1]   # window index
        live = store.pt_valid[uniq]
        pids_u = uniq[live]
        g = claim[live]
        if len(pids_u):
            Rc = np.stack([corrected[ki][0] for ki in window])
            tc = np.stack([corrected[ki][1] for ki in window])
            sc = np.asarray([corrected[ki][2] for ki in window],
                            np.float64)
            Ro = pre_pose[window_arr][:, :3, :3]
            to = pre_pose[window_arr][:, :3, 3]
            # M_i = Sc_i^-1 o S_old_i (S_old has scale 1):
            #   R_m = Rc^T Ro ; t_m = Rc^T (to - tc) / sc ; s_m = 1/sc
            R_m = np.einsum("wji,wjk->wik", Rc, Ro)
            t_m = np.einsum("wji,wj->wi", Rc, to - tc) / sc[:, None]
            s_m = 1.0 / sc
            p = store.pt_pos[pids_u]
            p_new = (s_m[g, None]
                     * np.einsum("pij,pj->pi", R_m[g], p) + t_m[g])
            store.pt_pos[pids_u] = p_new.astype(np.float32)
            store.geo_epoch += 1
            store.mark_dirty(pids_u)
        for ki in window:
            # corrected pose: SE3 with scale divided out (ref :500-507)
            R, t, s = corrected[ki]
            Tn = np.eye(4, dtype=np.float32)
            Tn[:3, :3] = R
            Tn[:3, 3] = t / s
            store.kf_pose[ki] = Tn
            store.update_connections(ki)

        # fuse loop points into the current KF (ref :519-536 + SearchAndFuse)
        old_connections = {ki: set(store.covis.get(ki, {}))
                          for ki in window}
        with self.timers("loop/search_and_fuse"):
            self._search_and_fuse(window, loop_pts, corrected)

        # new covisibility links from fusion (ref :546-565)
        loop_connections: Dict[int, Set[int]] = {}
        for ki in window:
            store.update_connections(ki)
            new_links = set(store.covis.get(ki, {})) \
                - old_connections.get(ki, set()) - set(window)
            if new_links:
                loop_connections[ki] = new_links

        store.add_loop_edge(kf, cand)

        # essential-graph optimization (ref :568-578)
        self._optimize_essential_graph(
            kf, cand, corrected, pre_pose, loop_connections)

        # global bundle adjustment (ref :580 RunGlobalBundleAdjustment) —
        # on its own thread in async mode, abortable by the next loop
        if self.local_mapper is not None:
            if self.gba is None:
                from orb_slam2_tpu_torch.slam.global_ba import GlobalBA
                self.gba = GlobalBA(self.local_mapper)
            with self.timers("loop/gba_launch"):
                self.local_mapper.global_bundle_adjustment(
                    iters=10, fixed_kf=store.origin_kf, loop_kf=kf,
                    background=self.background_gba, gba=self.gba)

    def _search_and_fuse(self, window, loop_pts, corrected):
        """Project loop points into each corrected keyframe and replace
        conflicting bindings (ref: SearchAndFuse src/LoopClosing.cc:588)."""
        store = self.store
        if len(loop_pts) == 0:
            return
        # FIXED chunk width (see _count_sim3_matches): big loop-point
        # sets go through the same shape in chunks
        M = self.s.bucket_loop_pts
        chunks = []
        for c0 in range(0, len(loop_pts), M):
            pts_c = loop_pts[c0:c0 + M]
            chunks.append((
                pts_c,
                self._up(pad_rows(store.pt_pos[pts_c], M)),
                self._up(pad_rows(np.ones(len(pts_c), bool), M, False)),
                self._up(pad_rows(store.pt_desc[pts_c], M)),
                self._up(pad_rows(store.pt_min_dist[pts_c], M)),
                self._up(pad_rows(store.pt_max_dist[pts_c], M)),
            ))
        # dispatch every (window keyframe x chunk) projection before
        # pulling any result: the device queue runs ahead of the host
        # instead of one serialized round-trip per keyframe
        dispatched = []
        # the window's corrected Sim3s in ONE upload: [R (9), t (3), s]
        sims = self._up(np.stack([
            np.concatenate([np.asarray(corrected[ki][0]).reshape(-1),
                            corrected[ki][1], [corrected[ki][2]]])
            for ki in window]).astype(np.float32))
        for w, ki in enumerate(window):
            for pts_c, pts_dev, valid_dev, desc_dev, mind_dev, maxd_dev \
                    in chunks:
                m = matching.search_by_sim3_projection(
                    pts_dev, valid_dev, desc_dev, mind_dev, maxd_dev,
                    sims[w, :9].reshape(3, 3), sims[w, 9:12], sims[w, 12],
                    store.kf_device(ki, "xy"),
                    store.kf_device(ki, "octave"),
                    store.kf_device(ki, "desc"),
                    store.kf_device(ki, "valid"),
                    self.s.fx, self.s.fy,
                    self.s.cx, self.s.cy,
                    self._bounds_dev, self._sf_dev,
                    self.log_scale, self.s.n_levels,
                    4.0,
                )
                dispatched.append((ki, pts_c, m))
        touched = []
        for ki, pts_c, m in dispatched:
            idx, _, ok = matching.to_host(m)
            for row in np.nonzero(ok[: len(pts_c)])[0]:
                pid_new = int(pts_c[row])
                feat = int(idx[row])
                if not store.pt_valid[pid_new]:
                    continue
                existing = int(store.kf_obs[ki, feat])
                if existing >= 0 and store.pt_valid[existing]:
                    store.replace_point(existing, pid_new)
                else:
                    store.add_observation(pid_new, ki, feat)
                    touched.append(pid_new)
        if touched:
            store.compute_distinctive_batch(np.unique(touched))

    def _optimize_essential_graph(self, kf, cand, corrected, pre_pose,
                                  loop_connections):
        """ref: Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:781):
        Sim3 pose graph over spanning tree + loop edges + strong
        covisibility, loop keyframe fixed."""
        store = self.store
        kfs = [int(k) for k in store.valid_kf_ids()]
        index = {k: i for i, k in enumerate(kfs)}
        K = len(kfs)

        kfs_arr = np.asarray(kfs, np.int64)
        poses_now = store.kf_pose[kfs_arr]
        R = poses_now[:, :3, :3].astype(np.float32).copy()
        t = poses_now[:, :3, 3].astype(np.float32).copy()
        s = np.ones(K, np.float32)
        fixed = np.zeros(K, bool)
        for k, (Rc, tc, sc) in corrected.items():
            if k in index:
                i = index[k]
                R[i], t[i], s[i] = Rc, tc, sc
        fixed[index[cand]] = True                  # ref :830

        def rel_measure(ki, kj):
            """S_j_i measured from pre-correction poses (the drift-consistent
            odometry; ref uses NonCorrectedSim3 for these edges)."""
            Ti = pre_pose[ki]
            Tj = pre_pose[kj]
            Tji = Tj @ np.linalg.inv(Ti)
            return Tji[:3, :3], Tji[:3, 3], 1.0

        def corrected_sim3(ki):
            """vScw of the reference: corrected Sim3 where available, else
            the current store pose (ref: src/Optimizer.cc:808-828)."""
            if ki in corrected:
                return corrected[ki]
            T = store.kf_pose[ki]
            return (T[:3, :3], T[:3, 3], 1.0)

        def corrected_measure(ki, kj):
            return _sim3_compose_np(
                corrected_sim3(kj), _sim3_inverse_np(corrected_sim3(ki)))

        e_i, e_j, mR, mt, ms = [], [], [], [], []
        added = set()

        def add_edge(ki, kj, meas=None):
            key = (min(ki, kj), max(ki, kj))
            if key in added or ki == kj:
                return
            if ki not in index or kj not in index:
                return
            added.add(key)
            if meas is None:
                meas = rel_measure(ki, kj)
            e_i.append(index[ki])
            e_j.append(index[kj])
            mR.append(meas[0])
            mt.append(meas[1])
            ms.append(meas[2])

        # the new loop edge, measured from CORRECTED relative pose
        Sk = corrected[kf]
        Tc = pre_pose[cand]
        S_cand = (Tc[:3, :3], Tc[:3, 3], 1.0)
        S_loop = _sim3_compose_np(Sk, _sim3_inverse_np(S_cand))
        add_edge(cand, kf, meas=S_loop)

        # new cross-loop covisibility links measured from CORRECTED poses —
        # these bridge the drifted window to the old loop area, so a
        # pre-correction measurement would re-anchor the drift (ref
        # :834-860 measures LoopConnections from vScw).  Added FIRST so the
        # generic covisibility sweep below can't claim them with a drifted
        # measurement.
        for ki, links in loop_connections.items():
            for kj in links:
                add_edge(ki, kj, meas=corrected_measure(ki, kj))

        # bulk edges — spanning tree, prior loop edges, covisibility
        # >= 100 (ref :806,:869-906) — assembled as arrays and measured
        # with ONE batched relative-pose computation.  The per-edge
        # Python add_edge path above is reserved for the handful of
        # special-measurement edges; at reference scale (1300+ KFs,
        # thousands of strong-covis edges) the bulk sweep must not run
        # Python per edge.
        bi, bj = [], []
        parents = store.kf_parent[kfs_arr]
        pa_ok = (parents >= 0) & store.kf_valid[np.maximum(parents, 0)]
        bi.append(parents[pa_ok])
        bj.append(kfs_arr[pa_ok])
        for k in kfs:
            les = store.kf_loop_edges.get(k, ())
            for le in les:
                if store.kf_valid[le]:
                    bi.append(np.array([le]))
                    bj.append(np.array([k]))
            c = store.covis.get(k, {})
            if c:
                nbs = np.fromiter(c.keys(), np.int64, len(c))
                ws = np.fromiter(c.values(), np.int64, len(c))
                strong = nbs[(ws >= 100) & store.kf_valid[nbs]]
                if len(strong):
                    bi.append(strong)
                    bj.append(np.full(len(strong), k))
        bi = np.concatenate(bi) if bi else np.zeros(0, np.int64)
        bj = np.concatenate(bj) if bj else np.zeros(0, np.int64)
        # canonical undirected key; dedup against self + special edges
        lo = np.minimum(bi, bj)
        hi = np.maximum(bi, bj)
        keep = lo != hi
        key = lo * store.kf_cap + hi
        _, first = np.unique(key, return_index=True)
        sel = np.zeros(len(bi), bool)
        sel[first] = True
        sel &= keep
        if added:
            spec = np.asarray(
                [a * store.kf_cap + b for a, b in added], np.int64)
            sel &= ~np.isin(key, spec)
        bi, bj = bi[sel], bj[sel]
        if len(bi):
            # batched rel_measure: S_j_i = T_j * T_i^-1 from pre poses
            Ti = pre_pose[bi]
            Tj = pre_pose[bj]
            Ri_T = np.swapaxes(Ti[:, :3, :3], 1, 2)
            Rji = np.einsum("eij,ejk->eik", Tj[:, :3, :3], Ri_T)
            tji = (Tj[:, :3, 3] - np.einsum(
                "eij,ej->ei", Rji, Ti[:, :3, 3]))
            idx_of_kf = np.full(store.kf_cap, -1, np.int64)
            idx_of_kf[kfs_arr] = np.arange(K)
            e_i.extend(idx_of_kf[bi].tolist())
            e_j.extend(idx_of_kf[bj].tolist())
            mR.extend(Rji.astype(np.float32))
            mt.extend(tji.astype(np.float32))
            ms.extend([1.0] * len(bi))

        # bucketed padding (Settings.bucket_pg_*): the pose graph runs
        # under store.lock at pinned shapes, which System.precompile()
        # warms beforehand.
        # Padded vertices are masked out and frozen (identity); padded
        # edges are masked out (edge 0-0).
        E = len(e_i)
        Kp = bucket_size(K, self.s.bucket_pg_cams)
        Ep = bucket_size(max(E, 1), self.s.bucket_pg_edges)
        R_p = pad_rows(R, Kp)
        R_p[K:] = np.eye(3, dtype=np.float32)
        s_p = pad_rows(s, Kp, 1.0)
        mR_a = (np.stack(mR).astype(np.float32) if E
                else np.zeros((0, 3, 3), np.float32))
        mt_a = (np.stack(mt).astype(np.float32) if E
                else np.zeros((0, 3), np.float32))
        mR_p = pad_rows(mR_a, Ep)
        mR_p[E:] = np.eye(3, dtype=np.float32)
        prob = pose_graph.PoseGraphProblem(
            self._up(R_p), self._up(pad_rows(t, Kp)),
            self._up(s_p),
            self._up(pad_rows(fixed, Kp, True)),
            self._up(pad_rows(np.ones(K, bool), Kp, False)),
            self._up(pad_rows(np.array(e_i, np.int64), Ep)),
            self._up(pad_rows(np.array(e_j, np.int64), Ep)),
            self._up(mR_p), self._up(pad_rows(mt_a, Ep)),
            self._up(pad_rows(np.array(ms, np.float32), Ep, 1.0)),
            self._up(pad_rows(np.ones(E, bool), Ep, False)),
        )
        # dense 7Kx7K solve up to a few hundred KFs; matrix-free PCG
        # above (mode decided by the BUCKET so shape+mode pairs are
        # stable and precompilable)
        mode = "dense" if Kp <= 256 else "cg"
        with self.timers("loop/essential_graph"):
            R_o, t_o, s_o = pose_graph.optimize(prob, iters=20, mode=mode)
            packed = torch.cat(
                [R_o.reshape(Kp, 9), t_o, s_o[:, None]], 1).cpu().numpy()
        R_o = packed[:, :9].reshape(Kp, 3, 3)
        t_o = packed[:, 9:12]
        s_o = packed[:, 12]

        # write back SE3 poses [R, t/s] and remap points via their
        # reference keyframe's correction (ref :991-1043), vectorized:
        # p_new = S_new^-1 (S_old p) with S indexed by each point's
        # reference keyframe (fallback: first observer).
        pids = store.valid_pt_ids()
        if len(pids) > 0:
            idx_of = np.full(store.kf_cap, -1, np.int64)
            for k, i in index.items():
                idx_of[k] = i
            refs = store.pt_ref_kf[pids].copy()
            bad_ref = (refs < 0) | (idx_of[np.maximum(refs, 0)] < 0)
            if bad_ref.any():
                ridx, rkfs, _ = store.obs.dump(pids[bad_ref])
                first = np.full(int(bad_ref.sum()), -1, np.int64)
                # dump rows are grouped by pid: first row per pid index
                first_rows = np.unique(ridx, return_index=True)[1]
                first[ridx[first_rows]] = rkfs[first_rows]
                refs[bad_ref] = first
            ok = (refs >= 0) & (idx_of[np.maximum(refs, 0)] >= 0)
            pids_ok = pids[ok]
            i_pt = idx_of[refs[ok]]
            # old poses of the reference KFs, stacked by vertex index
            Ro = np.stack([store.kf_pose[k][:3, :3] for k in kfs])
            to = np.stack([store.kf_pose[k][:3, 3] for k in kfs])
            p = store.pt_pos[pids_ok]
            p1 = np.einsum("pij,pj->pi", Ro[i_pt], p) + to[i_pt]
            Rn, tn, sn = R_o[i_pt], t_o[i_pt], s_o[i_pt]
            store.pt_pos[pids_ok] = (np.einsum(
                "pji,pj->pi", Rn, p1 - tn) / sn[:, None]).astype(np.float32)
            store.geo_epoch += 1
            store.mark_dirty(pids_ok)
        for k, i in index.items():
            Tn = np.eye(4, dtype=np.float32)
            Tn[:3, :3] = R_o[i]
            Tn[:3, 3] = t_o[i] / max(float(s_o[i]), 1e-12)
            store.kf_pose[k] = Tn


# ---------------------------------------------------------------------------
# small numpy Sim3 helpers (host-side loop correction)
# ---------------------------------------------------------------------------

def _sim3_compose_np(A, B):
    """A o B: apply B first."""
    Ra, ta, sa = A
    Rb, tb, sb = B
    return (Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb)


def _sim3_inverse_np(S):
    R, t, s = S
    Rt = R.T
    return (Rt, -(Rt @ t) / s, 1.0 / s)
