"""Global bundle adjustment with the reference's background semantics.

Equivalent of LoopClosing::RunGlobalBundleAdjustment + the mTcwGBA /
mPosGBA protocol (ref: src/LoopClosing.cc:646-757, src/Optimizer.cc:
41-237): GBA optimizes a SNAPSHOT of the map taken at launch, runs
abortably (a new loop arriving kills it between LM chunks, ref
mbStopGBA), and on completion corrects keyframes and points created
while it ran by propagating along the spanning tree — so tracking and
local mapping never have to pause for the (potentially seconds-long)
global solve.

Port of orb_slam2_tpu/slam/global_ba.py.  The snapshot is the same
fixed-shape BAProblem the local-BA path uses, and abortability comes from
chunking the LM iterations into separate `ba.optimize` calls with a flag
check between chunks (the reference's g2o forceStopFlag checked per
iteration).  In async scheduling the run happens on a daemon thread; all
map reads/writes stay under store.lock.  Each chunk, and the copy of the
result to the host, holds `utils.DEVICE_CAPTURE_LOCK` and releases it
again, so the tracking thread can capture a CUDA graph between chunks;
the capture lock is never taken while store.lock is held by this thread
and never held while it waits for store.lock.  The one exception is the
monocular init's inline run: the tracker's modular frame already holds
both locks, in that order, so the run takes them again (both reentrant).

Includes the outlier-gated refinement from round 1: full Huber GBA,
chi2 classification at convergence, re-optimize the inlier set (wrong
cross-seam fusions are only separable from large-residual good edges at
convergence).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Optional

import numpy as np

from orb_slam2_tpu_torch import logs
from orb_slam2_tpu_torch.solvers import ba
from orb_slam2_tpu_torch.utils import DEVICE_CAPTURE_LOCK, StickyBuckets


class _Run:
    """State of one GBA run.  `stop` is the per-run mbStopGBA: checked
    between LM chunks and — crucially — INSIDE store.lock at apply time,
    so a loop correction that holds the lock can kill a run with a plain
    flag write and never needs to join the GBA thread (joining while
    holding store.lock would deadlock against _apply's lock acquire)."""
    __slots__ = ("stop", "alive")

    def __init__(self):
        self.stop = False
        self.alive = True


class GlobalBA:
    def __init__(self, local_mapper):
        self.mapper = local_mapper
        self._run_state: Optional[_Run] = None
        self._thread: Optional[threading.Thread] = None
        self.runs_finished = 0
        self.runs_aborted = 0
        self.log = logs.get("loop.gba")
        # OWN sticky buckets: GBA packs the whole map, and growing the
        # mapper's shared buckets would pad every later local BA to
        # global size (a 2048-camera pad on a 16-camera window at
        # reference scale)
        s = local_mapper.s
        self._buckets = StickyBuckets(
            K=2 * s.bucket_ba_cams, P=s.bucket_ba_pts,
            E=s.bucket_ba_edges, fuse=s.bucket_fuse, nb=s.bucket_nb)

    @property
    def store(self):
        return self.mapper.store

    @property
    def running(self) -> bool:       # ref: mbRunningGBA
        r = self._run_state
        return r is not None and r.alive

    # -- control surface (ref: LoopClosing.h:49-56) --------------------
    def request_stop(self):
        """Kill the current GBA; its results are discarded (ref:
        CorrectLoop :409-430 stops the previous GBA when a new loop
        arrives).  Safe to call while holding store.lock — the dying run
        rechecks the flag under the lock before applying."""
        r = self._run_state
        if r is not None:
            r.stop = True

    def wait(self):
        t = self._thread
        if t is not None and t.is_alive():
            t.join()

    # ------------------------------------------------------------------
    def launch(self, loop_kf: int, iters: int = 10,
               fixed_kf: Optional[int] = None,
               background: bool = False) -> bool:
        """Snapshot the map and run GBA (ref :580 spawns the thread).

        background=False runs inline (sync scheduler / tests);
        background=True returns immediately and applies on completion.
        A still-live previous run must have been stop-requested; it
        exits at its next chunk boundary without applying."""
        snap = self._snapshot(loop_kf, iters, fixed_kf)
        if snap is None:
            return False
        self.log.info(
            "global BA launched (loop kf %d, %d kfs, background=%s)",
            loop_kf, len(snap["cam_index"]), background)
        r = _Run()
        self._run_state = r
        if background:
            self._thread = threading.Thread(
                target=self._run, args=(snap, r), daemon=True)
            self._thread.start()
        else:
            self._run(snap, r)
        return True

    def _snapshot(self, loop_kf, iters, fixed_kf):
        """Fixed-shape BAProblem over the CURRENT keyframes/points,
        taken under the store lock (the g2o graph build of ref
        Optimizer.cc:52-140)."""
        store = self.store
        with store.lock:
            cams = [int(c) for c in store.valid_kf_ids()]
            if len(cams) < 2:
                return None
            pids = store.points_in_kfs(cams)
            if len(pids) == 0:
                return None
            prob, cam_index, pids, _e_feat = self.mapper._gather_ba_problem(
                cams, [], pids, buckets=self._buckets)
        # cameras past the live ones are the padding: fixed, like the gauge
        fix0 = fixed_kf if fixed_kf is not None else store.origin_kf
        cam_fixed = np.zeros(prob.cam_fixed.shape[0], bool)
        cam_fixed[len(cam_index):] = True
        if fix0 in cam_index:
            cam_fixed[cam_index[fix0]] = True
        prob = prob._replace(cam_fixed=self.mapper._up(cam_fixed))
        return dict(prob=prob, cam_index=cam_index, pids=np.asarray(pids),
                    loop_kf=loop_kf, iters=iters,
                    mode="dense" if len(cams) <= 64 else "cg")

    # ------------------------------------------------------------------
    def _chunked_optimize(self, prob, iters, mode, r: _Run, chunk=5):
        """LM in chunks with an abort check between dispatches."""
        fx, fy, cx, cy, bf = self.mapper._intrinsics()
        done = 0
        while done < iters:
            if r.stop:
                return prob, False
            it = min(chunk, iters - done)
            with DEVICE_CAPTURE_LOCK:
                cam_T, pts, _ = ba.optimize(
                    prob, fx, fy, cx, cy, bf, iters=it,
                    use_kernel=True, mode=mode)
            prob = prob._replace(cam_T=cam_T, pts=pts)
            done += it
        return prob, True

    def _run(self, snap, r: _Run):
        try:
            fx, fy, cx, cy, bf = self.mapper._intrinsics()
            prob, ok = self._chunked_optimize(
                snap["prob"], snap["iters"], snap["mode"], r)
            if ok:
                # outlier-gated second pass at convergence
                with DEVICE_CAPTURE_LOCK:
                    bad = ba.classify_outliers(prob, fx, fy, cx, cy, bf)
                prob = prob._replace(edge_mask=prob.edge_mask & ~bad)
                prob, ok = self._chunked_optimize(
                    prob, snap["iters"], snap["mode"], r)
            if ok and self._apply(snap, prob, r):
                self.runs_finished += 1
                self.log.info("global BA finished and applied "
                              "(%d done, %d aborted)",
                              self.runs_finished, self.runs_aborted)
            else:
                self.runs_aborted += 1
                self.log.info("global BA aborted/discarded "
                              "(%d done, %d aborted)",
                              self.runs_finished, self.runs_aborted)
        finally:
            r.alive = False

    # ------------------------------------------------------------------
    def _apply(self, snap, prob, r: _Run) -> bool:
        """Write back GBA results and correct everything born mid-run
        (ref: RunGlobalBundleAdjustment :679-754)."""
        store = self.store
        with DEVICE_CAPTURE_LOCK:
            cam_T_np = prob.cam_T.cpu().numpy()
            pts_np = prob.pts.cpu().numpy()
        with store.lock:
            if r.stop:
                return False
            cam_index = snap["cam_index"]
            new_pose = {}                       # mTcwGBA
            for c, i in cam_index.items():
                if store.kf_valid[c]:
                    new_pose[c] = cam_T_np[i]
            if not new_pose:
                return False
            # spanning-tree propagation: keyframes created during GBA
            # get T_child_parent (current poses) * parent's corrected
            # pose (ref :700-721)
            children = defaultdict(list)
            for k in store.valid_kf_ids():
                k = int(k)
                p = int(store.kf_parent[k])
                if p >= 0:
                    children[p].append(k)
            queue = [int(store.origin_kf)]
            seen = set(queue)
            while queue:
                k = queue.pop(0)
                for ch in children[k]:
                    if ch in seen:
                        continue
                    seen.add(ch)
                    if ch not in new_pose and k in new_pose:
                        T_ch_p = store.kf_pose[ch] @ np.linalg.inv(
                            store.kf_pose[k])
                        new_pose[ch] = (T_ch_p @ new_pose[k]).astype(
                            np.float32)
                    queue.append(ch)
            # record pre-correction poses (mTcwBefGBA), then write
            bef = {k: store.kf_pose[k].copy() for k in new_pose}
            for k, T in new_pose.items():
                store.kf_pose[k] = T

            # points in the snapshot take their optimized positions
            pids = snap["pids"]
            live = store.pt_valid[pids]
            store.pt_pos[pids[live]] = pts_np[: len(pids)][live]
            # points born during GBA move with their reference keyframe
            # (ref :724-754: X_new = Twc_after * Tcw_before * X)
            all_p = store.valid_pt_ids()
            born = all_p[~np.isin(all_p, pids)]
            if len(born):
                refs = store.pt_ref_kf[born]
                has_bef = np.zeros(store.kf_cap, bool)
                has_bef[np.fromiter(bef, np.int64, len(bef))] = True
                ok = (refs >= 0) & has_bef[np.maximum(refs, 0)]
                born = born[ok]
                refs = refs[ok]
            if len(born):
                # one batched transform for all born points: group-gather
                # the per-ref before/after poses, then two einsums
                ref_ids = np.unique(refs)
                Tb_arr = np.stack([bef[int(r)] for r in ref_ids])
                Ta_arr = np.stack([new_pose[int(r)] for r in ref_ids])
                gi = np.searchsorted(ref_ids, refs)
                Tb = Tb_arr[gi]
                Ta = Ta_arr[gi]
                Xc = np.einsum("pij,pj->pi", Tb[:, :3, :3],
                               store.pt_pos[born]) + Tb[:, :3, 3]
                store.pt_pos[born] = np.einsum(
                    "pji,pj->pi", Ta[:, :3, :3],
                    Xc - Ta[:, :3, 3]).astype(np.float32)
                all_touched = np.concatenate([pids[live], born])
            else:
                all_touched = pids[live]
            store.update_points_batch(
                all_touched, self.mapper.scale_factors)
            store.geo_epoch += 1
            store.mark_dirty(all_touched)
            store.big_change_idx += 1
        return True
