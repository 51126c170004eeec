"""Decides `correct`: what the timed window produced against the reference.

Run after the window has closed, the peak memory has been read and the
System is shut down, from a host snapshot of its map and trajectory and
from what `FrameCatcher` copied during the window:

  frontend_rows_differ  keyframes drawn from the seed among those the
                        window made, and the caught frames: every feature
                        row (keypoint, level, angle, descriptor, u_right,
                        depth, valid flag) against the frozen reference
                        frontend run on that frame's own images.  Covers
                        the FAST, describe and stereo kernels at the
                        timed size.
  track_pose_gap_mm,    the caught frames: the largest camera-centre
  track_pose_gap_deg    distance and rotation angle between the pose the
                        track step solved and the frozen reference pose
                        solve (reference/pose_lm.py) in float64 on the
                        same matches, with the reference frontend's
                        keypoints, started from the generator's truth
                        and moved, as the program's solve moves a pose,
                        by rigid motions only.  The matches are the
                        frame's inliers as it reports them; its last
                        round solved over the round before's, as
                        ORB-SLAM2's PoseOptimization does, so a match
                        at the chi2 gate that the two classify apart
                        moves the optimum (about 1 mm on a weakly held
                        frame, PERF.md).
  track_pose_gap_mm_median,
  track_pose_gap_deg_median
                        the same two over the caught frames' median:
                        steady from seed to seed where the widest gap
                        carries that one frame's tail.
  reproj_chi2_p50       the median, over every keyframe's observations,
                        of the squared left-image reprojection residual
                        over its level's variance, with the poses and
                        points the mapper left.
  loops_closed          loops the loop closer closed: none where the mix
                        never revisits a place.
  frames_unresolved     tracked frames whose final pose cannot be
                        composed: the walk from the frame's reference
                        keyframe along the spanning tree meets no valid
                        keyframe (a cycle of culled ones), so that
                        ORB-SLAM2's SaveTrajectory* could not write it.

Each is compared with its limit in `limits/<workload>.json`, whose keys
may also name numbers of files in `checks/` (run.py).  The trajectory's
error against the generator's truth (`traj_ate_m`) is reported beside
them; a cell compares it through `checks/traj_ate_m.py`.
The control (`readings(controls=True)`) reads the same numbers with the
reference in the program's place in bfloat16: the frontend's levels, the
pose solve, and the map's poses and points.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from reference import orb, pose_lm, truth

READINGS = ("frontend_rows_differ", "track_pose_gap_mm", "track_pose_gap_deg",
            "track_pose_gap_mm_median", "track_pose_gap_deg_median",
            "reproj_chi2_p50", "loops_closed", "frames_unresolved")
STORE_KEYS = ("kf_valid", "kf_pose", "kf_Tcp", "kf_parent", "kf_timestamp",
              "kf_xy", "kf_ur", "kf_depth", "kf_octave", "kf_angle",
              "kf_desc", "kf_feat_valid", "kf_obs", "pt_valid", "pt_pos")


def snapshot(system) -> dict:
    """A host copy of what the judges read, taken before the System goes."""
    st = system.map
    snap = {k: np.array(getattr(st, k)) for k in STORE_KEYS}
    snap["trajectory"] = [(np.array(e.Tcr), int(e.ref_kf), float(e.timestamp),
                           bool(e.lost)) for e in system.tracker.trajectory]
    lc = system.loop_closer
    snap["loops_closed"] = int(lc.loops_closed) if lc is not None else 0
    return snap


def frontend_settings(cfg: dict) -> dict:
    st = cfg["settings"]
    return {"n_features": int(st["ORBextractor.nFeatures"]),
            "n_levels": int(st["ORBextractor.nLevels"]),
            "scale": float(st["ORBextractor.scaleFactor"]),
            "ini_th": int(st["ORBextractor.iniThFAST"]),
            "min_th": int(st["ORBextractor.minThFAST"]),
            "bf": float(st["Camera.bf"]), "fx": float(st["Camera.fx"]),
            "depth_map_factor": float(st.get("DepthMapFactor", 1.0))}


def reference_frame(frame: tuple, cfg: dict, device, lowp: bool = False):
    """The reference frontend on one offered frame's host images."""
    s = frontend_settings(cfg)
    a = torch.from_numpy(frame[0]).to(device)
    b = torch.from_numpy(frame[1].astype(np.float32) if cfg["sensor"] ==
                         "rgbd" else frame[1]).to(device)
    if cfg["sensor"] == "stereo":
        return orb.stereo_frame(a, b, s, lowp)
    return orb.rgbd_frame(a, b, s, lowp)


def _rows(ref: dict) -> dict:
    r = {k: ref[k].cpu().numpy() for k in ("xy", "octave", "angle", "desc",
                                          "valid", "ur", "depth")}
    r["desc"] = r["desc"].view(np.uint32)
    return r


def rows_differ(a: dict, b: dict) -> int:
    """Feature rows in which two extractions differ, bit for bit."""
    bad = a["valid"] != b["valid"]
    for k in ("xy", "angle", "ur", "depth"):
        x, y = a[k], b[k]
        same = (x.view(np.uint32) == y.view(np.uint32))
        bad |= ~(same.all(-1) if same.ndim > 1 else same)
    bad |= a["octave"] != b["octave"]
    bad |= ~(a["desc"] == b["desc"]).all(-1)
    return int(bad.sum())


def stored_rows(snap: dict, k: int) -> dict:
    return {"xy": snap["kf_xy"][k], "octave": snap["kf_octave"][k],
            "angle": snap["kf_angle"][k], "desc": snap["kf_desc"][k],
            "valid": snap["kf_feat_valid"][k], "ur": snap["kf_ur"][k],
            "depth": snap["kf_depth"][k]}


def sample_keyframes(snap: dict, n_frames: int, fps: float, seed: int,
                     k: int) -> list:
    """Up to k keyframes of the window, drawn from the seed, the last
    one always among them: (keyframe id, frame index)."""
    kfs = [(int(i), int(round(snap["kf_timestamp"][i] * fps)))
           for i in np.nonzero(snap["kf_valid"])[0]]
    kfs = [x for x in kfs if x[1] < n_frames]
    if len(kfs) <= k:
        return kfs
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0xC4EC])
    pick = set(rng.choice(len(kfs) - 1, size=k - 1, replace=False).tolist())
    return [kfs[i] for i in sorted(pick)] + [kfs[-1]]


class FrameCatcher:
    """Copies what the track step produced for a sample of the window's
    frames, as each one lands: its solved pose, its feature rows, which
    map point each feature was matched to as an inlier, and those points'
    positions.  One moment is drawn from the seed in each of `k` equal
    spans of the window; the first frame that lands OK after it is
    caught, unless the map's geometry moved (the store's `geo_epoch`)
    over the last `quiet_notes` landings or before the copy holds the
    store's lock, when the solve may have read other positions than the
    copy does: then the next one is.  The epoch is read again under the
    lock that the copy takes, since the mapper writes a bundle
    adjustment back under that lock and bumps the epoch only at its end:
    a landing noted while it writes would otherwise copy moved points.
    `passed_over` counts the frames refused at that second reading.
    Called by the harness after each landing (harness/drive.py)."""

    def __init__(self, system, seconds: float, fps: float, seed: int,
                 k: int, quiet_notes: int):
        rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x9A5E])
        edges = np.linspace(min(1.0, seconds / 4), seconds, k + 1)
        self.at = np.sort(rng.uniform(edges[:-1], edges[1:])).tolist()
        self.system, self.fps = system, fps
        self.epochs = collections.deque(maxlen=quiet_notes)
        self.seen = None
        self.caught = []
        self.passed_over = 0

    def __call__(self, window) -> None:
        store, tr = self.system.map, self.system.tracker
        self.epochs.append(store.geo_epoch)
        f = tr.last_frame
        if len(self.caught) >= len(self.at) or f is None or f is self.seen:
            return
        self.seen = f
        if time.perf_counter() - window.t0 < self.at[len(self.caught)]:
            return
        if (len(self.epochs) < self.epochs.maxlen or len(set(self.epochs)) > 1
                or f.Tcw is None or getattr(tr.state, "name", "") != "OK"):
            return
        b = np.array(f.bindings)
        slots = np.nonzero(b >= 0)[0]
        with store.lock:
            moved = store.geo_epoch != self.epochs[-1]
            pts = np.array(store.pt_pos[b[slots]], np.float64)
        if moved:
            self.passed_over += 1
            return
        ff = f.feats
        self.caught.append({
            "index": int(round(f.timestamp * self.fps)),
            "Tcw": np.array(f.Tcw, np.float64), "slots": slots, "pts": pts,
            "rows": {"xy": np.array(ff.xy), "octave": np.array(ff.octave),
                     "angle": np.array(ff.angle), "desc": np.array(ff.desc),
                     "valid": np.array(ff.valid), "ur": np.array(ff.ur),
                     "depth": np.array(ff.depth)}})


def intrinsics(cfg: dict) -> tuple:
    st = cfg["settings"]
    return (float(st["Camera.fx"]), float(st["Camera.fy"]),
            float(st["Camera.cx"]), float(st["Camera.cy"]))


def pose_gaps(caught: list, refs: list, truth_poses: np.ndarray,
              cfg: dict, dtype=torch.float64, against=None) -> list:
    """(mm, deg) for each caught frame: its pose against the reference
    solve, or (with `against`) the solve in `dtype` against `against`.
    The solve starts at the generator's true pose, carried onto the set
    of poses the program's own solve could reach (pose_lm.start_on)."""
    st = cfg["settings"]
    cam = pose_lm.Cam(*intrinsics(cfg), float(st["Camera.bf"]))
    sf = float(st["ORBextractor.scaleFactor"])
    rel = truth.relative_truth(truth_poses)
    out = []
    for j, (c, r) in enumerate(zip(caught, refs)):
        keep = r["valid"][c["slots"]]
        s = c["slots"][keep]
        uv = np.concatenate([r["xy"][s], r["ur"][s, None]], 1)
        T = pose_lm.solve(pose_lm.start_on(rel[c["index"]], c["Tcw"]),
                          c["pts"][keep], uv, sf ** (-2.0 * r["octave"][s]),
                          cam, dtype)
        out.append((T, pose_lm.gap(c["Tcw"] if against is None
                                   else against[j], T)))
    return out


def readings(snap: dict, frames: list, truth_poses: np.ndarray, cfg: dict,
             n_window: int, seed: int, device, caught=(),
             controls: bool = False):
    """The compared numbers of a run and, with `controls`, the control's
    readings of the same numbers."""
    fps = float(cfg["settings"]["Camera.fps"])
    picked = sample_keyframes(snap, n_window, fps, seed,
                              int(cfg["check"]["keyframes"]))
    differ = ctrl_differ = 0
    judged = [(stored_rows(snap, k), i) for k, i in picked] + \
        [(c["rows"], c["index"]) for c in caught]
    refs = []
    for rows, i in judged:
        ref = _rows(reference_frame(frames[i], cfg, device))
        differ += rows_differ(rows, ref)
        refs.append(ref)
        if controls:
            low = _rows(reference_frame(frames[i], cfg, device, lowp=True))
            ctrl_differ += rows_differ(low, ref)
    refs = refs[len(picked):]
    solved = pose_gaps(caught, refs, truth_poses, cfg)
    enough = len(caught) * 2 >= int(cfg["check"]["frames"])
    gap_mm = max((g[0] for _, g in solved), default=0.0) if enough \
        else float("inf")
    gap_deg = max((g[1] for _, g in solved), default=0.0) if enough \
        else float("inf")
    med_mm, med_deg = (np.median([g for _, g in solved], 0).tolist()
                       if enough and solved else [float("inf")] * 2)
    kfs = np.nonzero(snap["kf_valid"])[0]
    res = truth.residuals(snap, kfs, *intrinsics(cfg))
    err = (np.hypot(*np.concatenate(list(res.values())).T) if res
           else np.zeros(0))
    sf = float(cfg["settings"]["ORBextractor.scaleFactor"])
    c2 = truth.chi2(snap, res, sf)
    ate, ferr, unresolved = _ate(snap, truth_poses, fps)
    kerr = truth.keyframe_errors(snap, truth_poses, fps)
    out = {"frontend_rows_differ": differ,
           "track_pose_gap_mm": gap_mm, "track_pose_gap_deg": gap_deg,
           "track_pose_gap_mm_median": med_mm,
           "track_pose_gap_deg_median": med_deg,
           "reproj_chi2_p50": float(np.median(c2)) if len(c2) else float(
               "inf"),
           "loops_closed": snap["loops_closed"],
           "frames_unresolved": unresolved}
    info = {"traj_ate_m": ate,
            "keyframes_compared": len(picked), "frames_caught":
            [c["index"] for c in caught],
            "pose_gaps_mm_deg": [g for _, g in solved],
            "pose_orthonormality": [pose_lm.orthonormality(c["Tcw"])
                                    for c in caught],
            "inliers_caught": [len(c["slots"]) for c in caught],
            "observations": len(err),
            "frames_in_ate": len(ferr),
            "frame_err_m_p50_p90_max": ([float(np.percentile(ferr, q))
                                         for q in (50, 90, 100)]
                                        if len(ferr) else None),
            "kf_ate_m": float(np.sqrt(np.mean(kerr ** 2))) if len(kerr)
            else None,
            "reproj_px_p50_p90": ([float(np.percentile(err, q))
                                   for q in (50, 90)] if len(err) else None),
            "reproj_chi2_p90": float(np.percentile(c2, 90)) if len(c2)
            else None}
    if not controls:
        return out, info
    low_gaps = [g for _, g in pose_gaps(
        caught, refs, truth_poses, cfg, torch.bfloat16,
        against=[T for T, _ in solved])]
    low = dict(snap)
    low["kf_pose"] = truth.to_bfloat16(snap["kf_pose"])
    low["pt_pos"] = truth.to_bfloat16(snap["pt_pos"])
    low["trajectory"] = [(truth.to_bfloat16(T), k, ts, lost)
                         for T, k, ts, lost in snap["trajectory"]]
    lc2 = truth.chi2(low, truth.residuals(low, kfs, *intrinsics(cfg)), sf)
    ctrl = {"frontend_rows_differ": ctrl_differ,
            "track_pose_gap_mm": max((g[0] for g in low_gaps),
                                     default=float("inf")),
            "track_pose_gap_deg": max((g[1] for g in low_gaps),
                                      default=float("inf")),
            "track_pose_gap_mm_median": (float(np.median([g[0] for g in
                                                          low_gaps]))
                                         if low_gaps else float("inf")),
            "track_pose_gap_deg_median": (float(np.median([g[1] for g in
                                                           low_gaps]))
                                          if low_gaps else float("inf")),
            "reproj_chi2_p50": float(np.median(lc2)) if len(lc2)
            else float("inf"),
            "loops_closed": snap["loops_closed"],
            "frames_unresolved": unresolved,
            "traj_ate_m": _ate(low, truth_poses, fps)[0]}
    return out, info, ctrl


def _ate(snap: dict, truth_poses: np.ndarray, fps: float) -> tuple:
    """(RMS camera-centre error of every tracked frame's final pose, the
    errors, frames whose pose cannot be composed); infinite when one
    cannot be."""
    _, ferr, unresolved = truth.frame_errors(snap["trajectory"], snap,
                                              truth_poses, fps)
    ate = (float(np.sqrt(np.mean(ferr ** 2))) if len(ferr) and not unresolved
           else float("inf"))
    return ate, ferr, unresolved


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit, sense)]): each number against its
    limit; sense "<=" (at most) or ">=" (at least)."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = values[name]
        if "at_most" in lim:
            good, bound, sense = v <= lim["at_most"], lim["at_most"], "<="
        else:
            good, bound, sense = v >= lim["at_least"], lim["at_least"], ">="
        ok &= bool(good)
        rows.append((name, v, bound, sense))
    return ok, rows
