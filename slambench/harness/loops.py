"""The judge of a closed loop: what the loop closer solved, caught as it
solves it, held against the frozen float64 references.

`LoopCatcher` is attached to the System before the window (by the check
files `checks/loop_*.py`, through run.py) and detached after shutdown.
It wraps, on the System's own LoopCloser, `_compute_sim3_and_correct`
(one loop candidate), `_correct_loop` and `_optimize_essential_graph`,
and, for the calls made inside a candidate's pass on the loop closer's
thread, the port's `sim3_solver.refine_sim3` and `pose_graph.optimize`.
For every loop that closes it keeps host copies of:

  sim3    refine_sim3's inputs (pc1, pc2, uv1, uv2, the inverse sigmas,
          the mask, the RANSAC start, fix_scale, iters, chi2_th) and its
          outputs (R12, t12, s12, the inliers, their count);
  scw     the Scw that `_correct_loop` was handed, and the candidate's
          pose it was composed with;
  graph   the PoseGraphProblem's arrays, iters, and the outputs R, t, s;
          the keyframe of each vertex and its timestamp.

`readings(j)` then judges every caught loop, once a run (the check files
share it): the current keyframe's Scw from the program's refined S12
against the one from reference/sim3.py's OptimizeSim3 on the same matches
from the same start, the matches the two classify apart as inliers and
outliers, and every keyframe's pose from the program's essential graph
against reference/pose_graph.py's on the same problem.
The control is each reference in bfloat16 against itself in float64.
"""

from __future__ import annotations

import inspect
import threading

import numpy as np
import torch

from reference import pose_graph as ref_graph
from reference import sim3 as ref_sim3
from reference import truth

PER_LOOP = ("loop_sim3_gap_mm", "loop_sim3_gap_deg", "loop_graph_gap_mm",
            "loop_graph_gap_deg", "loop_sim3_inliers_differ")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


class LoopCatcher:
    """Keeps each closed loop's two solves (module docstring): `loops`,
    one dict a loop that closed with both solves caught; `closed`, the
    loops that closed while attached."""

    def __init__(self, system):
        from orb_slam2_tpu_torch.solvers import pose_graph, sim3_solver

        self.lc = lc = system.loop_closer
        self.loops, self.closed = [], 0
        self._cur, self._tid = None, None
        self._undo = []
        if lc is None:
            return
        for name in ("_compute_sim3_and_correct", "_correct_loop",
                     "_optimize_essential_graph"):
            self._wrap(lc, name, getattr(self, name))
        self._wrap(sim3_solver, "refine_sim3", self._refine)
        self._wrap(pose_graph, "optimize", self._graph)

    def _wrap(self, owner, name, hook) -> None:
        """owner.name(...) becomes hook(the original, ...); `detach`
        puts back what owner held itself (a module's function), or
        removes the instance's own attribute (a method)."""
        inner = getattr(owner, name)
        own = vars(owner).get(name)

        def call(*a, **k):
            return hook(inner, *a, **k)

        setattr(owner, name, call)
        self._undo.append((owner, name, own))

    def detach(self) -> None:
        """Unwrap everything, and let go of the System."""
        for owner, name, own in reversed(self._undo):
            if own is None:
                delattr(owner, name)
            else:
                setattr(owner, name, own)
        self._undo, self.lc = [], None

    def _mine(self) -> bool:
        return self._cur is not None and threading.get_ident() == self._tid

    # ---- the loop closer's steps
    def _compute_sim3_and_correct(self, inner, kf, cand, *a, **k):
        store = self.lc.store
        self._cur = {"kf": int(kf), "cand": int(cand),
                     "kf_ts": float(store.kf_timestamp[kf]),
                     "cand_ts": float(store.kf_timestamp[cand]),
                     "sim3": None, "scw": None, "graph": None}
        self._tid = threading.get_ident()
        try:
            ok = inner(kf, cand, *a, **k)
            if ok:
                self.closed += 1
                c = self._cur
                if c["sim3"] is not None and c["scw"] is not None \
                        and c["graph"] is not None:
                    self.loops.append(c)
            return ok
        finally:
            self._cur = self._tid = None

    def _correct_loop(self, inner, kf, cand, R12, t12, s12, Scw_R, Scw_t,
                      Scw_s, *a, **k):
        if self._mine():
            self._cur["scw"] = {
                "R": _host(Scw_R), "t": _host(Scw_t), "s": float(Scw_s),
                "T_cand": self.lc.store.kf_pose[cand].copy()}
        return inner(kf, cand, R12, t12, s12, Scw_R, Scw_t, Scw_s, *a, **k)

    def _optimize_essential_graph(self, inner, *a, **k):
        if not self._mine():
            return inner(*a, **k)
        store = self.lc.store
        kfs = np.asarray(store.valid_kf_ids(), np.int64)
        v = {"kf": kfs, "ts": store.kf_timestamp[kfs].copy()}
        out = inner(*a, **k)
        v["written"] = store.kf_pose[kfs].copy()
        self._cur["vertices"] = v
        return out

    # ---- the two solves
    def _refine(self, inner, *a, **k):
        if not self._mine():
            return inner(*a, **k)
        args = inspect.signature(inner).bind(*a, **k)
        args.apply_defaults()
        rec = {n: _host(v) for n, v in args.arguments.items()}
        out = inner(*a, **k)
        rec["out"] = tuple(_host(x) for x in out)
        self._cur["sim3"] = rec
        return out

    def _graph(self, inner, prob, *a, **k):
        if not self._mine():
            return inner(prob, *a, **k)
        args = inspect.signature(inner).bind(prob, *a, **k)
        args.apply_defaults()
        rec = {n: _host(v) for n, v in args.arguments.items()
               if n != "prob"}
        rec["prob"] = {f: _host(getattr(prob, f)) for f in prob._fields}
        out = inner(prob, *a, **k)
        rec["out"] = tuple(_host(x) for x in out)
        self._cur["graph"] = rec
        return out


# ---- the judge

def _sim3_ref(rec: dict, cfg: dict, dtype, device):
    st = cfg["settings"]
    cam = (float(st["Camera.fx"]), float(st["Camera.fy"]),
           float(st["Camera.cx"]), float(st["Camera.cy"]))
    return ref_sim3.optimize_sim3(
        rec["pts1"], rec["pts2"], rec["uv1"], rec["uv2"],
        rec["inv_sigma2_1"], rec["inv_sigma2_2"], rec["mask"], rec["R12"],
        rec["t12"], float(np.asarray(rec["s12"])), cam,
        bool(rec["fix_scale"]), float(rec["chi2_th"]), dtype=dtype,
        device=device)


def _scw(R12, t12, s12, T_cand) -> tuple:
    """S12 o T_cand (scale 1): the current keyframe's Scw."""
    R, t, s = (np.asarray(R12, np.float64), np.asarray(t12, np.float64),
               float(s12))
    Tc = np.asarray(T_cand, np.float64)
    return R @ Tc[:3, :3], s * (R @ Tc[:3, 3]) + t, s


def _graph_ref(rec: dict, fix_scale: bool, dtype, device):
    p = rec["prob"]
    return ref_graph.optimize(
        p["R"], p["t"], p["s"], p["fixed"], p["vmask"], p["edge_i"],
        p["edge_j"], p["meas_R"], p["meas_t"], p["meas_s"], p["emask"],
        fix_scale, iters=int(rec["iters"]), dtype=dtype, device=device)


def _pose_gap(a, b, vmask) -> tuple:
    """Widest (mm, deg) over the vertices in vmask between two sets of
    essential-graph vertices, each written back as ORB-SLAM2 does."""
    mm, deg = ref_sim3.gap(*ref_graph.se3_of(*(x[vmask] for x in a)),
                           *ref_graph.se3_of(*(x[vmask] for x in b)))
    return _widest(mm), _widest(deg)


def _se3_4x4(S, k: int) -> np.ndarray:
    """The first k vertices of S written back as 4x4 [R, t / s]."""
    R, t, _ = ref_graph.se3_of(*(np.asarray(x, np.float64)[:k] for x in S))
    T = np.tile(np.eye(4), (k, 1, 1))
    T[:, :3, :3], T[:, :3, 3] = R, t
    return T


def _widest(x) -> float:
    x = np.asarray(x, np.float64)
    if not len(x):
        return 0.0
    return float("inf") if not np.isfinite(x).all() else float(x.max())


def _truth_error_m(S, vmask, ts, truth_poses, fps) -> float:
    """RMS camera-centre distance (m) of the written-back vertices from
    the generator's truth, after the rigid motion that best aligns the
    two sets of centres (the graph holds the loop keyframe, not the
    first one, where the map's frame lies)."""
    rel = truth.relative_truth(truth_poses)
    idx = np.rint(np.asarray(ts)[vmask] * fps).astype(int)
    ok = idx < len(rel)
    R, t, s = ref_graph.se3_of(*(x[vmask][ok] for x in S))
    a = ref_sim3.centre(R, t, s)
    b = truth.centre(rel[idx[ok]])[..., 0]
    if len(a) < 3:
        return float("nan")
    ac, bc = a - a.mean(0), b - b.mean(0)
    U, _, Vt = np.linalg.svd(bc.T @ ac)
    D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    d = np.linalg.norm(ac @ (U @ D @ Vt).T - bc, axis=-1)
    return float(np.sqrt(np.mean(d ** 2)))


def _edges_off_truth(prob: dict, ts, truth_poses, fps, kfs) -> dict:
    """Each edge's measurement held against the generator's truth: the
    rotation angle (deg) and the translation (m) of Sji Ti Tj^-1 with the
    true poses Ti, Tj (a relative measurement, so the map's frame does
    not enter).  The median, and the five farthest as [keyframe i,
    keyframe j, deg, m]."""
    rel = truth.relative_truth(truth_poses)
    em = np.asarray(prob["emask"], bool)
    ei, ej = (np.asarray(prob[k], np.int64)[em] for k in ("edge_i",
                                                          "edge_j"))
    T = rel[np.minimum(np.rint(np.asarray(ts) * fps).astype(int),
                       len(rel) - 1)]
    M = np.tile(np.eye(4), (len(ei), 1, 1))
    M[:, :3, :3] = np.asarray(prob["meas_R"], np.float64)[em]
    M[:, :3, 3] = np.asarray(prob["meas_t"], np.float64)[em]
    E = M @ T[ei] @ np.linalg.inv(T[ej])
    deg = ref_sim3.gap(E[:, :3, :3], np.zeros((len(E), 3)), np.ones(len(E)),
                       np.tile(np.eye(3), (len(E), 1, 1)), np.zeros(
                           (len(E), 3)), np.ones(len(E)))[1]
    m = np.linalg.norm(E[:, :3, 3], axis=-1)
    far = np.argsort(-m)[:5]
    return {"median_deg_m": [float(np.median(deg)), float(np.median(m))]
            if len(m) else None,
            "farthest": [[int(kfs[ei[e]]), int(kfs[ej[e]]), float(deg[e]),
                          float(m[e])] for e in far]}


def _judge_one(loop: dict, j, control: bool) -> tuple:
    """One loop's PER_LOOP numbers, the control's (the references in
    bfloat16 in the program's place; None without `control`) and what the
    detail reports of it."""
    dev = j.device
    rec, scw = loop["sim3"], loop["scw"]
    ref = _sim3_ref(rec, j.cfg, torch.float64, dev)
    S_ref = _scw(ref.R, ref.t, ref.s, scw["T_cand"])
    g = loop["graph"]
    fix = bool(rec["fix_scale"])
    vmask = np.asarray(g["prob"]["vmask"], bool)
    G_ref = _graph_ref(g, fix, torch.float64, dev)
    G_prog = tuple(np.asarray(x, np.float64) for x in g["out"])
    mask = np.asarray(rec["mask"], bool)

    def gaps(S, G, inliers):
        mm, deg = ref_sim3.gap(*S, *S_ref)
        apart = int((np.asarray(inliers, bool) != ref.inliers)[mask].sum())
        return dict(zip(PER_LOOP, (_widest([mm]), _widest([deg]))
                        + _pose_gap(G, G_ref, vmask) + (apart,)))

    out = gaps((scw["R"], scw["t"], scw["s"]), G_prog, rec["out"][3])
    low = None
    if control:
        s_low = _sim3_ref(rec, j.cfg, torch.bfloat16, dev)
        low = gaps(_scw(s_low.R, s_low.t, s_low.s, scw["T_cand"]),
                   _graph_ref(g, fix, torch.bfloat16, dev), s_low.inliers)
    fps = float(j.cfg["settings"]["Camera.fps"])
    rel = truth.relative_truth(j.truth_poses)
    i1, i2 = (int(round(loop[k] * fps)) for k in ("kf_ts", "cand_ts"))
    T12 = rel[i1] @ np.linalg.inv(rel[i2])
    R12, t12, s12 = (rec["out"][0], rec["out"][1],
                     float(np.asarray(rec["out"][2])))
    G_free = _graph_ref(g, False, torch.float64, dev)
    ts = np.zeros(len(vmask))
    ts[:len(loop["vertices"]["ts"])] = loop["vertices"]["ts"]
    start = tuple(np.asarray(g["prob"][f], np.float64) for f in "Rts")
    detail = dict(out, **{
        "kf": loop["kf"], "cand": loop["cand"], "frames": [i1, i2],
        "matches": int(mask.sum()),
        "inliers_program_reference": [int(np.asarray(rec["out"][4])),
                                      ref.n_inliers],
        "s12_program_reference": [s12, ref.s],
        "s12_from_truth_mm_deg": [
            [float(x) for x in ref_sim3.gap(R12, t12, s12, T12[:3, :3],
                                            T12[:3, 3], 1.0)],
            [float(x) for x in ref_sim3.gap(ref.R, ref.t, ref.s,
                                            T12[:3, :3], T12[:3, 3], 1.0)]],
        "vertices_edges": [int(vmask.sum()),
                           int(np.asarray(g["prob"]["emask"]).sum())],
        "graph_written_vs_output": float(np.abs(
            loop["vertices"]["written"] - _se3_4x4(g["out"], len(
                loop["vertices"]["kf"]))).max()),
        "graph_scale_min_max": [float(g["out"][2][vmask].min()),
                                float(g["out"][2][vmask].max())],
        "graph_gap_to_free_scale_mm_deg": list(_pose_gap(G_prog, G_free,
                                                         vmask)),
        "edges_off_truth": _edges_off_truth(
            g["prob"], ts, j.truth_poses, fps,
            np.concatenate([loop["vertices"]["kf"], np.full(
                len(vmask) - len(loop["vertices"]["kf"]), -1)])),
        "graph_truth_rms_m": {
            name: _truth_error_m(S, vmask, ts, j.truth_poses, fps)
            for name, S in (("start", start), ("program", G_prog),
                            ("reference", G_ref),
                            ("reference_free_scale", G_free))}})
    return out, low, detail


def readings(j) -> dict:
    """The PER_LOOP numbers, each the widest
    over the caught loops, and `loops_judged`;
    with j.controls (control.py) the same of the control, under
    "control".  Every one of them reads +inf where the loop closer closed
    more loops than were caught and judged.  Computed once a run and kept on
    j; the judged loops go to the detail as j.info["loops"]."""
    if "loops" in j.cache:
        return j.cache["loops"]
    catch = j.catch
    control = j.controls is not None
    judged = [_judge_one(lp, j, control) for lp in catch.loops]
    short = max(int(j.values["loops_closed"]), catch.closed) > len(judged)

    def widest(rows, k):
        return float("inf") if short else max((r[k] for r in rows),
                                              default=0.0)

    out = {k: widest([r[0] for r in judged], k) for k in PER_LOOP}
    out["loops_judged"] = len(judged)
    j.info["loops"] = [r[2] for r in judged]
    if control:
        out["control"] = {k: widest([r[1] for r in judged], k)
                          for k in PER_LOOP}
        out["control"]["loops_judged"] = len(judged)
    j.cache["loops"] = out
    return out
