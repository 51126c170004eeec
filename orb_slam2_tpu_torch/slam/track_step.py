"""The fused per-frame tracking step, replayed as one CUDA graph a frame.

Port of orb_slam2_tpu/slam/track_step.py.  The whole steady-state
tracking step of a frame is one function of fixed-shape tensors:

    images -> ORB extract (+stereo match) -> motion-model matching
    against the last frame's points -> pose LM (4x10, Huber, chi2) ->
    frustum projection + window matching of the local-map candidates ->
    pose LM again -> packed outputs

The JAX package jits it into one XLA program.  Here the step runs eagerly
on the CPU, and on a CUDA device `build_track_step` wraps it in
`GraphStep`, which captures it once per input shape with
`torch.cuda.graph` and replays the graph each frame: a few thousand
kernel launches become one `cudaGraphLaunch`.  The host keeps only
decisions (keyframe policy, fallbacks) and map bookkeeping.

The local-map candidate set is prepared by the host from the PREVIOUS
frame's local map (one frame stale), as in the JAX package.  The chained
(pipelined) variant of that module is not ported yet (ROADMAP item 5).

Scalars the step closes over (fx, fy, cx, cy, bf, the log scale factor,
the per-level scale factors and sigma^2, the image bounds) are device
tensors built once by `build_track_step`: a Python scalar in a CUDA
division is a reciprocal multiply, and a tensor made from a host value
inside the step would be a copy that a graph cannot capture.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam2_tpu_torch.ops import frontend, hamming, matching, stereo
from orb_slam2_tpu_torch.solvers import pose_lm


class TrackOut(NamedTuple):
    """Outputs of one fused tracking step: everything float-packable in
    one float32 tensor (one device-to-host copy, the int32 descriptor
    words' bits at its tail) plus the descriptors as a device tensor."""

    f32_pack: torch.Tensor    # see unpack_track_out for layout
    desc: torch.Tensor        # (N,8) int32 holding the uint32 words' bits


class TrackResult(NamedTuple):
    """Host-side unpacked result."""

    Tcw: np.ndarray
    xy: np.ndarray
    angle: np.ndarray
    octave: np.ndarray
    valid: np.ndarray
    ur: np.ndarray
    depth: np.ndarray
    response: np.ndarray
    assign: np.ndarray        # (N,) i32: -1 | [0,L) last slot | [L,L+M) local
    inlier: np.ndarray        # (N,) bool
    vis_local: np.ndarray     # (M,) bool
    n_matches_mm: int
    n_inliers: int


# the forward/backward octave gate, here on device flags (ref:
# src/ORBmatcher.cc:1381)
_octave_compat = matching.octave_gate


def _sensor_mode(sensor_stereo) -> str:
    """Accept the legacy bool (True=stereo) or a mode string."""
    if isinstance(sensor_stereo, str):
        return sensor_stereo
    return "stereo" if sensor_stereo else "mono"


def _step_cache_key(s, mode: str):
    """Every settings field the step closes over."""
    return (float(s.fx), float(s.fy), float(s.cx), float(s.cy),
            float(s.bf), int(s.n_features), int(s.n_levels),
            float(s.scale_factor), int(s.ini_th_fast), int(s.min_th_fast),
            int(s.width), int(s.height), str(mode),
            float(getattr(s, "depth_map_factor", 1.0)))


_STEP_CACHE = {}


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def build_track_step(settings, sensor_stereo, device="cuda",
                     plain: bool = False):
    """The tracking step for these settings on `device`, memoized on the
    settings values, the device and `plain`.

    `sensor_stereo`: "stereo" | "mono" | "rgbd" (bool accepted: True=
    stereo).  For rgbd the step's img_r input is the FLOAT depth image.
    On a CPU device this returns the eager step; on a CUDA device a
    `GraphStep` around it (its `.eager` is the eager step).  plain=True
    runs the kernels' plain PyTorch versions, to compare the two on the
    card."""
    mode = _sensor_mode(sensor_stereo)
    device = _canonical(device)
    key = (("fast",) + _step_cache_key(settings, mode)
           + (str(device), bool(plain)))
    if key not in _STEP_CACHE:
        step = _build_track_step(settings, mode, device, plain)
        if device.type == "cuda":
            step = GraphStep(step, device)
        _STEP_CACHE[key] = step
    return _STEP_CACHE[key]


def _build_track_step(settings, mode: str, device: torch.device,
                      plain: bool):
    """Returns the eager step(img_l, img_r, scal, last block, local block,
    loc_excl) -> TrackOut for fixed shapes on `device`."""
    s = settings
    sensor_stereo = mode == "stereo"

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    fx, fy, cx, cy, bf = (f32(v) for v in (s.fx, s.fy, s.cx, s.cy, s.bf))
    sf = f32(s.scale_factors())
    ls2 = f32(s.level_sigma2())
    bounds = f32([0.0, s.width, 0.0, s.height])
    log_sf = f32(np.log(s.scale_factor))
    n_levels = s.n_levels
    th_mm = 7.0 if sensor_stereo else 15.0   # ref: Tracking.cc:880
    # RGB-D depth scaling (ref: Frame RGB-D ctor src/Frame.cc:119-171)
    dfac = float(getattr(s, "depth_map_factor", 1.0))
    if abs(dfac - 1.0) > 1e-9 and dfac != 0:
        dfac = 1.0 / dfac
    extract_kw = dict(n_features=s.n_features, n_levels=n_levels,
                      scale_factor=s.scale_factor, ini_th=s.ini_th_fast,
                      min_th=s.min_th_fast, plain=plain)

    def step(
        img_l, img_r,
        scal,                         # (20,) f32 packed host scalars
        last_f32,                     # (L, 4) [pts xyz, has]
        last_desc,                    # (L, 8) int32 point descriptors
        last_oct, last_angle,         # (L,) last frame's feature fields
        loc_f32,                      # (M, 8) [pts xyz, normal xyz, min, max]
        loc_desc,                     # (M, 8) int32
        loc_excl=None,                # (M,) u8: 1 = skip this candidate
    ) -> TrackOut:
        # unpack the scalar block (packed on host into ONE upload)
        T_pred = scal[:16].reshape(4, 4)
        fwd = scal[16] > 0.5
        bwd = scal[17] > 0.5
        th_local = scal[18]
        n_cand = scal[19].int()
        last_pts = last_f32[:, :3]
        last_has = last_f32[:, 3] > 0.5
        loc_pts = loc_f32[:, :3]
        loc_normal = loc_f32[:, 3:6]
        loc_min = loc_f32[:, 6]
        loc_max = loc_f32[:, 7]
        L = last_pts.shape[0]
        M = loc_pts.shape[0]
        loc_mask = torch.arange(M, device=device) < n_cand
        if loc_excl is not None:
            loc_mask = loc_mask & (loc_excl == 0)

        # ---- 1. frontend ------------------------------------------------
        if mode == "stereo":
            feats, sm = frontend.extract_stereo_pair(
                img_l, img_r, sf, bf, fx, **extract_kw)
            ur, depth = sm.u_right, sm.depth
        elif mode == "rgbd":
            feats = frontend.extract(img_l, **extract_kw)
            # img_r carries the float depth image; depth lookup at raw
            # keypoints + synthetic right coord (ref: Frame.cc:643-664)
            ur, depth = stereo.depth_from_rgbd(
                feats.xy, feats.valid, img_r, dfac, bf)
        else:
            feats = frontend.extract(img_l, **extract_kw)
            ur = torch.full((feats.n,), -1.0, device=device)
            depth = torch.full((feats.n,), -1.0, device=device)

        N = feats.n
        f_xy = feats.xy
        f_oct = feats.octave
        f_desc = feats.desc
        f_ang = feats.angle
        f_val = feats.valid
        rows_L = torch.arange(L, dtype=torch.int32, device=device)
        rows_M = torch.arange(M, dtype=torch.int32, device=device)

        # ---- 2. motion-model matching (ref SearchByProjection last) -----
        pc, u, v, urp = matching._project(last_pts, T_pred, fx, fy, cx, cy,
                                          bf)
        vis = (last_has & (pc[:, 2] > 0)
               & matching._in_bounds(u, v, bounds))
        oct_ok = _octave_compat(last_oct, f_oct, fwd, bwd)
        has_r = ur[None, :] >= 0
        dmat = hamming.distance_matrix(last_desc, f_desc)
        radius1 = sf[last_oct.long()]

        def mm_match(th):
            radius = th * radius1
            du = torch.abs(u[:, None] - f_xy[None, :, 0])
            dv = torch.abs(v[:, None] - f_xy[None, :, 1])
            window = (du < radius[:, None]) & (dv < radius[:, None])
            r_ok = ~has_r | (torch.abs(urp[:, None] - ur[None, :])
                             < radius[:, None])
            compat = window & oct_ok & r_ok & vis[:, None] & f_val[None, :]
            d = torch.where(compat, dmat, hamming.MAX_DIST)
            idx = torch.argmin(d, 1)
            best = torch.gather(d, 1, idx[:, None])[:, 0]
            ok = vis & (best <= hamming.TH_HIGH)
            ok = hamming.rotation_histogram_filter(last_angle, f_ang[idx], ok)
            return idx, matching.resolve_duplicates(idx, best, ok, N)

        idx1, ok1 = mm_match(th_mm)
        idx2, ok2 = mm_match(2.0 * th_mm)
        use2 = ok1.sum() < 20
        mm_idx = torch.where(use2, idx2, idx1)
        mm_ok = torch.where(use2, ok2, ok1)
        n_mm = mm_ok.sum()

        # per-feature binding after motion match: slot in [0, L).  The
        # JAX package scatters with mode="drop" at the out-of-range index
        # N; here into an N+1 buffer whose last row is dropped.
        assign = torch.full((N + 1,), -1, dtype=torch.int32, device=device)
        assign = assign.scatter(0, torch.where(mm_ok, mm_idx, N), rows_L)[:N]

        # ---- 3. pose optimization 1 -------------------------------------
        uv = torch.stack([f_xy[:, 0], f_xy[:, 1], ur], -1)
        inv_s2 = 1.0 / ls2[f_oct.long()]

        def pose_obs(assign_slots, src_pts):
            bound = assign_slots >= 0
            pts = src_pts[assign_slots.clamp(min=0).long()]
            return pose_lm.PoseObs(pts, uv, inv_s2, bound & f_val)

        T1, inl1, _ = pose_lm.optimize_pose(
            T_pred, pose_obs(assign, last_pts), fx, fy, cx, cy, bf, 4, 10)
        # drop outlier bindings (ref: Tracking.cc:905-918)
        assign = torch.where(inl1 | (assign < 0), assign, -1)

        # ---- 4. local-map candidates: frustum + window match ------------
        pcl, ul, vl, url = matching._project(loc_pts, T1, fx, fy, cx, cy, bf)
        Rl, tl = T1[:3, :3], T1[:3, 3]
        Ow = -Rl.T @ tl
        po = loc_pts - Ow
        dist = torch.sqrt((po * po).sum(1))
        dist_s = dist.clamp(min=1e-9)
        view_cos = (po * loc_normal).sum(1) / dist_s
        level = matching.predict_level(loc_max, dist_s, log_sf, n_levels)
        vis_l = (
            loc_mask & (pcl[:, 2] > 0)
            & matching._in_bounds(ul, vl, bounds)
            & (dist >= 0.8 * loc_min) & (dist <= 1.2 * loc_max)
            & (view_cos > 0.5)
        )
        r0 = torch.where(view_cos > 0.998, 2.5, 4.0)
        radius = r0 * th_local * sf[level]
        du = torch.abs(ul[:, None] - f_xy[None, :, 0])
        dv = torch.abs(vl[:, None] - f_xy[None, :, 1])
        window = (du < radius[:, None]) & (dv < radius[:, None])
        oct_ok_l = (
            (f_oct[None, :] >= level[:, None] - 1)
            & (f_oct[None, :] <= level[:, None])
        )
        r_ok2 = ~has_r | (torch.abs(url[:, None] - ur[None, :])
                          < radius[:, None])
        free = f_val & (assign < 0)
        compat = window & oct_ok_l & r_ok2 & vis_l[:, None] & free[None, :]
        dmat_l = hamming.distance_matrix(loc_desc, f_desc)
        d = torch.where(compat, dmat_l, hamming.MAX_DIST)
        lidx = torch.argmin(d, 1)
        lbest = torch.gather(d, 1, lidx[:, None])[:, 0]
        d2 = d.scatter(1, lidx[:, None], hamming.MAX_DIST)
        lsecond = d2.amin(1)
        same_lvl = f_oct[lidx] == f_oct[torch.argmin(d2, 1)]
        ratio_ok = ~same_lvl | (lbest.float() <= 0.8 * lsecond.float())
        lok = vis_l & (lbest <= hamming.TH_HIGH) & ratio_ok
        lok = matching.resolve_duplicates(lidx, lbest, lok, N)

        assign = torch.cat([assign, assign.new_full((1,), -1)]).scatter(
            0, torch.where(lok, lidx, N), L + rows_M)[:N]

        # ---- 5. pose optimization 2 -------------------------------------
        all_pts = torch.cat([last_pts, loc_pts], 0)   # (L+M, 3)
        T2, inl2, n_in = pose_lm.optimize_pose(
            T1, pose_obs(assign, all_pts), fx, fy, cx, cy, bf, 4, 10)

        # ---- 6. pack outputs (ONE float32 tensor = one device-to-host
        # copy; the descriptor words ride along as their bits) ------------
        floats = torch.cat([
            T2.reshape(-1),                              # 16
            torch.stack([n_mm.float(), n_in.float()]),   # 2
            f_xy.reshape(-1),                            # 2N
            f_ang,                                       # N
            f_oct.float(),                               # N
            f_val.float(),                               # N
            ur, depth,                                   # 2N
            feats.response,                              # N
            assign.float(),                              # N
            (inl2 & (assign >= 0)).float(),              # N
            vis_l.float(),                               # M
        ])
        f32_pack = torch.cat([floats.view(torch.int32),
                              f_desc.reshape(-1)]).view(torch.float32)
        return TrackOut(f32_pack, f_desc)

    return step


class GraphStep:
    """The eager step captured as one CUDA graph per input shape and
    replayed each frame: this package's counterpart of `@jax.jit`.

    A call copies its inputs into the graph's static device buffers
    (numpy arrays through pinned host staging, all non-blocking), replays
    the graph, copies `f32_pack` into pinned host memory without
    blocking, and synchronises once.  It returns a TrackOut whose
    `f32_pack` is a host tensor and whose `desc` is a device tensor of
    its own (copies, so the next replay does not overwrite them).

    The first call for a new shape warms the step up eagerly on a side
    stream (that first run builds the kernels' library and uploads the
    describe kernel's tables), then captures it.  Graphs are keyed on
    the inputs' shapes and dtypes: (L, M), the image shapes and whether
    there is a loc_excl.  There is no fallback: a capture that fails
    raises, and the step never runs eagerly in its place.
    """

    # eager runs before a capture: the first builds the kernels' library
    # and uploads their tables, the second runs on a settled allocator
    WARMUP = 2

    def __init__(self, step, device: torch.device):
        self.eager = step
        self.device = device
        self._graphs = {}

    @staticmethod
    def _key(args):
        return tuple(None if a is None
                     else (tuple(a.shape), torch.as_tensor(a).dtype)
                     for a in args)

    def _capture(self, args):
        dev = self.device
        static = []
        staging = []
        for a in args:
            if a is None:
                static.append(None)
                staging.append(None)
                continue
            t = torch.as_tensor(a)
            static.append(torch.empty(t.shape, dtype=t.dtype, device=dev))
            staging.append(torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True))
        graph = _Graph(static, staging)
        graph.load(args)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                self.eager(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph.graph):
            graph.out = self.eager(*static)
        graph.host = torch.empty(graph.out.f32_pack.shape,
                                 dtype=torch.float32, pin_memory=True)
        return graph

    def __call__(self, img_l, img_r, scal, last_f32, last_desc, last_oct,
                 last_angle, loc_f32, loc_desc, loc_excl=None) -> TrackOut:
        args = tuple(_as_input(a) for a in (
            img_l, img_r, scal, last_f32, last_desc, last_oct, last_angle,
            loc_f32, loc_desc, loc_excl))
        key = self._key(args)
        graph = self._graphs.get(key)
        with torch.cuda.device(self.device):
            if graph is None:   # the capture leaves these inputs loaded
                graph = self._graphs[key] = self._capture(args)
            else:
                graph.load(args)
            graph.graph.replay()
            graph.host.copy_(graph.out.f32_pack, non_blocking=True)
            desc = graph.out.desc.clone()
            torch.cuda.current_stream(self.device).synchronize()
        return TrackOut(graph.host.clone(), desc)


def _as_input(a):
    """numpy uint32 descriptor blocks as their int32 bits (the step's
    descriptor dtype); anything else as it is."""
    if isinstance(a, np.ndarray) and a.dtype == np.uint32:
        return a.view(np.int32)
    return a


class _Graph:
    """One captured step: its static inputs, their pinned host staging,
    the graph, its outputs and the pinned buffer of f32_pack."""

    def __init__(self, static, staging):
        self.static = static
        self.staging = staging
        self.graph = None
        self.out: Optional[TrackOut] = None
        self.host = None

    def load(self, args) -> None:
        """Copy a frame's inputs into the static buffers, non-blocking:
        numpy arrays through the pinned staging, tensors directly."""
        for a, dst, stage in zip(args, self.static, self.staging):
            if a is None:
                continue
            if isinstance(a, np.ndarray):
                stage.numpy()[...] = a
                a = stage
            dst.copy_(a, non_blocking=True)


# number of trailing diagnostic floats in the CHAINED step's pack (the
# JAX package's pipelined variant, ROADMAP item 5); kept for its callers
N_DIAG = 6


def unpack_track_out(out: TrackOut, n: int, m: int,
                     buf: Optional[np.ndarray] = None) -> TrackResult:
    """One pull of the packed buffer (none if it is on the host), then
    split on the host.

    Returns (TrackResult, desc) with `desc` as np.uint32 recovered from
    the bitcast tail — the separate TrackOut.desc tensor is never pulled.
    Pass a pre-pulled `buf` to avoid a second host copy."""
    if buf is None:
        buf = out.f32_pack.detach().cpu().numpy()
    Tcw = buf[:16].reshape(4, 4).astype(np.float32)
    n_mm = int(buf[16])
    n_in = int(buf[17])
    o = 18
    xy = buf[o:o + 2 * n].reshape(n, 2); o += 2 * n
    angle = buf[o:o + n]; o += n
    octave = buf[o:o + n].astype(np.int32); o += n
    valid = buf[o:o + n] > 0.5; o += n
    ur = buf[o:o + n]; o += n
    depth = buf[o:o + n]; o += n
    response = buf[o:o + n]; o += n
    assign = buf[o:o + n].astype(np.int32); o += n
    inlier = buf[o:o + n] > 0.5; o += n
    vis_local = buf[o:o + m] > 0.5; o += m
    desc = buf[o:o + 8 * n].view(np.uint32).reshape(n, 8)
    return TrackResult(
        Tcw, xy.astype(np.float32), angle.astype(np.float32), octave,
        valid, ur.astype(np.float32), depth.astype(np.float32),
        response.astype(np.float32), assign, inlier, vis_local,
        n_mm, n_in,
    ), desc
