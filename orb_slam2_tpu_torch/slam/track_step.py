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
frame's local map (one frame stale), as in the JAX package.

The chained (pipelined) variant, `build_track_step_chained`, takes the
previous step's outputs as a device-resident `ChainState` and gathers
point data by id from the device map mirror (slam/device_map.py), so a
frame can be dispatched before the frame ahead of it has been read.
`ChainRunner` drives it: on a CUDA device one graph replay and one
non-blocking copy of the pack into pinned memory a frame, with an event
behind the copy; nothing waits for the device until the result is asked
for.

Scalars the step closes over (fx, fy, cx, cy, bf, the log scale factor,
the per-level scale factors and sigma^2, the image bounds) are device
tensors built once by `build_track_step`: a Python scalar in a CUDA
division is a reciprocal multiply, and a tensor made from a host value
inside the step would be a copy that a graph cannot capture.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from orb_slam2_tpu_torch.geometry import se3
from orb_slam2_tpu_torch.ops import (
    cuda_build, frontend, hamming, matching, stereo,
)
from orb_slam2_tpu_torch.solvers import pose_lm
from orb_slam2_tpu_torch.utils import DEVICE_CAPTURE_LOCK


class TrackOut(NamedTuple):
    """Outputs of one fused tracking step: everything float-packable in
    one float32 tensor (one device-to-host copy, the int32 descriptor
    words' bits at its tail) plus the descriptors as a device tensor,
    and the step's stage stamps (see STAGES)."""

    f32_pack: torch.Tensor    # see unpack_track_out for layout
    desc: torch.Tensor        # (N,8) int32 holding the uint32 words' bits
    stamps: Optional[torch.Tensor] = None   # (N_STAMPS,) int64 ns; a list
                                            # of ints from GraphStep


# The step's device stages, in order.  The step writes a stamp at its
# start and after each stage (`_stamp`): on a card the device's
# %globaltimer from a one-thread kernel captured into the graph
# (csrc/stamp.cu), on the CPU, where the eager step is synchronous, the
# host's perf_counter_ns.  Stage i runs from stamp i to stamp i + 1.
STAGES = ("step/frontend", "step/match_last", "step/pose_lm1",
          "step/match_local", "step/pose_lm2", "step/pack")
N_STAMPS = 8            # 64 bytes; slots past len(STAGES) + 1 stay 0
stamp_launches = 0      # csrc/stamp.cu launches since the last reset


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
_WARMUP_STREAMS = {}


def _warmup_stream(device: torch.device):
    """The one side stream a device on which every step is warmed up
    before its capture.  cuBLAS keeps a workspace for each stream it runs
    on (32 MiB on an H100), so a new stream a capture left 32 MiB more
    allocated after every System's precompile."""
    if device not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[device]


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


def _step_consts(settings, mode: str, device: torch.device,
                 plain: bool) -> SimpleNamespace:
    """Everything a step closes over, as device tensors built once."""
    s = settings

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    # RGB-D depth scaling (ref: Frame RGB-D ctor src/Frame.cc:119-171)
    dfac = float(getattr(s, "depth_map_factor", 1.0))
    if abs(dfac - 1.0) > 1e-9 and dfac != 0:
        dfac = 1.0 / dfac
    return SimpleNamespace(
        device=device, mode=mode,
        fx=f32(s.fx), fy=f32(s.fy), cx=f32(s.cx), cy=f32(s.cy),
        bf=f32(s.bf), baseline=f32(s.baseline),
        sf=f32(s.scale_factors()), ls2=f32(s.level_sigma2()),
        bounds=f32([0.0, s.width, 0.0, s.height]),
        log_sf=f32(np.log(s.scale_factor)), n_levels=s.n_levels,
        th_mm=7.0 if mode == "stereo" else 15.0,   # ref: Tracking.cc:880
        is_stereo=torch.as_tensor(mode == "stereo", device=device),
        dfac=dfac,
        extract_kw=dict(n_features=s.n_features, n_levels=s.n_levels,
                        scale_factor=s.scale_factor, ini_th=s.ini_th_fast,
                        min_th=s.min_th_fast, plain=plain),
        stamps=torch.zeros(N_STAMPS, dtype=torch.int64, device=device),
    )


def _stamp(c, slot: int) -> None:
    """Stamp the time the step reaches `slot` into c.stamps[slot]: on a
    card one launch of csrc/stamp.cu on the current stream (inside a
    capture it becomes a node of the graph), on the CPU the host clock."""
    global stamp_launches
    buf = c.stamps
    if buf.is_cuda:
        stamp_launches += 1
        cuda_build.check_error(cuda_build.library().orb_stamp(
            buf.data_ptr(), slot, cuda_build.stream_ptr(buf.device)),
            "orb_stamp")
    else:
        buf[slot] = time.perf_counter_ns()


def _frontend(c, img_l, img_r):
    """ORB extraction of the frame in the step's mode: (features, u_right,
    depth).  For rgbd `img_r` is the float depth image."""
    if c.mode == "stereo":
        feats, sm = frontend.extract_stereo_pair(
            img_l, img_r, c.sf, c.bf, c.fx, **c.extract_kw)
        return feats, sm.u_right, sm.depth
    feats = frontend.extract(img_l, **c.extract_kw)
    if c.mode == "rgbd":
        # depth lookup at raw keypoints + synthetic right coord (ref:
        # Frame.cc:643-664)
        ur, depth = stereo.depth_from_rgbd(
            feats.xy, feats.valid, img_r, c.dfac, c.bf)
        return feats, ur, depth
    ur = torch.full((feats.n,), -1.0, device=c.device)
    return feats, ur, torch.full((feats.n,), -1.0, device=c.device)


def _match_and_solve(c, feats, ur, T_pred, fwd, bwd, th_local,
                     last_pts, last_has, last_oct, last_angle, last_desc,
                     loc_pts, loc_normal, loc_min, loc_max, loc_desc,
                     loc_mask, relative_widen: bool) -> SimpleNamespace:
    """Steps 2-5 of a tracking step, shared by the fast and the chained
    step: motion-model matching against the last block, pose LM,
    frustum + window matching of the local block, pose LM again.

    relative_widen: the chained step's rule for the doubled motion-model
    window (see there); the fast step widens below 20 matches only."""
    device = c.device
    fx, fy, cx, cy, bf = c.fx, c.fy, c.cx, c.cy, c.bf
    sf, bounds = c.sf, c.bounds
    N = feats.n
    f_xy = feats.xy
    f_oct = feats.octave
    f_desc = feats.desc
    f_ang = feats.angle
    f_val = feats.valid
    L = last_pts.shape[0]
    M = loc_pts.shape[0]
    rows_L = torch.arange(L, dtype=torch.int32, device=device)
    rows_M = torch.arange(M, dtype=torch.int32, device=device)

    # ---- 2. motion-model matching (ref SearchByProjection last) ---------
    pc, u, v, urp = matching._project(last_pts, T_pred, fx, fy, cx, cy, bf)
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

    idx1, ok1 = mm_match(c.th_mm)
    idx2, ok2 = mm_match(2.0 * c.th_mm)
    n1 = ok1.sum()
    use2 = n1 < 20
    if relative_widen:
        use2 = (2 * n1 < vis.sum()) | use2
    mm_idx = torch.where(use2, idx2, idx1)
    mm_ok = torch.where(use2, ok2, ok1)
    n_mm = mm_ok.sum()

    # per-feature binding after motion match: slot in [0, L).  The
    # JAX package scatters with mode="drop" at the out-of-range index
    # N; here into an N+1 buffer whose last row is dropped.
    assign = torch.full((N + 1,), -1, dtype=torch.int32, device=device)
    assign = assign.scatter(0, torch.where(mm_ok, mm_idx, N), rows_L)[:N]

    # ---- 3. pose optimization 1 -----------------------------------------
    uv = torch.stack([f_xy[:, 0], f_xy[:, 1], ur], -1)
    inv_s2 = 1.0 / c.ls2[f_oct.long()]

    def pose_obs(assign_slots, src_pts):
        bound = assign_slots >= 0
        pts = src_pts[assign_slots.clamp(min=0).long()]
        return pose_lm.PoseObs(pts, uv, inv_s2, bound & f_val)

    obs1 = pose_obs(assign, last_pts)
    _stamp(c, 2)
    T1, inl1, _ = pose_lm.optimize_pose(T_pred, obs1, fx, fy, cx, cy, bf,
                                        4, 10)
    _stamp(c, 3)
    # drop outlier bindings (ref: Tracking.cc:905-918)
    assign = torch.where(inl1 | (assign < 0), assign, -1)

    # ---- 4. local-map candidates: frustum + window match ----------------
    pcl, ul, vl, url = matching._project(loc_pts, T1, fx, fy, cx, cy, bf)
    Rl, tl = T1[:3, :3], T1[:3, 3]
    Ow = -Rl.T @ tl
    po = loc_pts - Ow
    dist = torch.sqrt((po * po).sum(1))
    dist_s = dist.clamp(min=1e-9)
    view_cos = (po * loc_normal).sum(1) / dist_s
    level = matching.predict_level(loc_max, dist_s, c.log_sf, c.n_levels)
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

    # ---- 5. pose optimization 2 -----------------------------------------
    all_pts = torch.cat([last_pts, loc_pts], 0)   # (L+M, 3)
    obs2 = pose_obs(assign, all_pts)
    _stamp(c, 4)
    T2, inl2, n_in = pose_lm.optimize_pose(
        T1, obs2, fx, fy, cx, cy, bf, 4, 10)
    _stamp(c, 5)
    return SimpleNamespace(
        T2=T2, inlier=inl2 & (assign >= 0), n_in=n_in, assign=assign,
        vis_l=vis_l, n_mm=n_mm, n1=n1, vis=vis, use2=use2,
        inl1=inl1 & obs1.mask)


def _pack(T2, n_mm, n_in, feats, ur, depth, assign, inlier, vis_l,
          tail=None) -> torch.Tensor:
    """ONE float32 tensor = one device-to-host copy: the float fields,
    then the descriptor words' bits, then `tail` (the chained step's
    diagnostics)."""
    floats = torch.cat([
        T2.reshape(-1),                              # 16
        torch.stack([n_mm.float(), n_in.float()]),   # 2
        feats.xy.reshape(-1),                        # 2N
        feats.angle,                                 # N
        feats.octave.float(),                        # N
        feats.valid.float(),                         # N
        ur, depth,                                   # 2N
        feats.response,                              # N
        assign.float(),                              # N
        inlier.float(),                              # N
        vis_l.float(),                               # M
    ])
    parts = [floats.view(torch.int32), feats.desc.reshape(-1)]
    if tail is not None:
        parts.append(tail.view(torch.int32))
    return torch.cat(parts).view(torch.float32)


def _build_track_step(settings, mode: str, device: torch.device,
                      plain: bool):
    """Returns the eager step(img_l, img_r, scal, last block, local block,
    loc_excl) -> TrackOut for fixed shapes on `device`."""
    c = _step_consts(settings, mode, device, plain)

    def step(
        img_l, img_r,
        scal,                         # (20,) f32 packed host scalars
        last_f32,                     # (L, 4) [pts xyz, has]
        last_desc,                    # (L, 8) int32 point descriptors
        last_oct, last_angle,         # (L,) last frame's feature fields
        loc_f32,                      # (M, 8) [pts xyz, normal xyz, min, max]
        loc_desc,                     # (M, 8) int32
        loc_excl=None,                # (M,) u8: 1 = skip this candidate
        spans=None,                   # see GraphStep: the run as "launch"
    ) -> TrackOut:
        if spans is not None:
            with spans("launch"):
                return step(img_l, img_r, scal, last_f32, last_desc,
                            last_oct, last_angle, loc_f32, loc_desc,
                            loc_excl)
        _stamp(c, 0)
        # unpack the scalar block (packed on host into ONE upload)
        T_pred = scal[:16].reshape(4, 4)
        fwd = scal[16] > 0.5
        bwd = scal[17] > 0.5
        th_local = scal[18]
        n_cand = scal[19].int()
        loc_mask = torch.arange(loc_f32.shape[0], device=device) < n_cand
        if loc_excl is not None:
            loc_mask = loc_mask & (loc_excl == 0)

        feats, ur, depth = _frontend(c, img_l, img_r)
        _stamp(c, 1)
        r = _match_and_solve(
            c, feats, ur, T_pred, fwd, bwd, th_local,
            last_f32[:, :3], last_f32[:, 3] > 0.5, last_oct, last_angle,
            last_desc, loc_f32[:, :3], loc_f32[:, 3:6], loc_f32[:, 6],
            loc_f32[:, 7], loc_desc, loc_mask, relative_widen=False)
        f32_pack = _pack(r.T2, r.n_mm, r.n_in, feats, ur, depth, r.assign,
                         r.inlier, r.vis_l)
        _stamp(c, 6)
        return TrackOut(f32_pack, feats.desc, c.stamps.clone())

    return step


class GraphStep:
    """The eager step captured as one CUDA graph per input shape and
    replayed each frame: this package's counterpart of `@jax.jit`.

    A call copies its inputs into the graph's static device buffers
    (numpy arrays through pinned host staging, all non-blocking), replays
    the graph, copies `f32_pack` and the stamps into pinned host memory
    without blocking, and synchronises once.  It returns a TrackOut whose
    `f32_pack` is a host tensor, whose `stamps` are a list of ints (read
    without a tensor op, which would let another thread take the
    interpreter) and whose `desc` is a device tensor of its own (copies,
    so the next replay does not overwrite them).  Given `spans`, a function of a part's name that returns the
    context timing it, a call times its three parts: "upload" (the
    copies in), "launch" (the cudaGraphLaunch and the copies out
    enqueued) and "device_wait" (the synchronisation).  The eager step
    takes the same `spans` and times its whole run as "launch".

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
        self.captures = 0

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
        with DEVICE_CAPTURE_LOCK:   # no other thread on the device meanwhile
            side = _warmup_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    self.eager(*static)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph.graph):
                graph.out = self.eager(*static)
        self.captures += 1
        graph.host = torch.empty(graph.out.f32_pack.shape,
                                 dtype=torch.float32, pin_memory=True)
        graph.stamps = torch.empty(N_STAMPS, dtype=torch.int64,
                                   pin_memory=True)
        return graph

    def __call__(self, img_l, img_r, scal, last_f32, last_desc, last_oct,
                 last_angle, loc_f32, loc_desc, loc_excl=None,
                 spans=None) -> TrackOut:
        span = spans if spans is not None else _no_span
        args = tuple(_as_input(a) for a in (
            img_l, img_r, scal, last_f32, last_desc, last_oct, last_angle,
            loc_f32, loc_desc, loc_excl))
        key = self._key(args)
        graph = self._graphs.get(key)
        with torch.cuda.device(self.device):
            if graph is None:   # the capture leaves these inputs loaded
                graph = self._graphs[key] = self._capture(args)
            else:
                with span("upload"):
                    graph.load(args)
            with span("launch"):
                graph.graph.replay()
                graph.host.copy_(graph.out.f32_pack, non_blocking=True)
                graph.stamps.copy_(graph.out.stamps, non_blocking=True)
                desc = graph.out.desc.clone()
            with span("device_wait"):
                torch.cuda.current_stream(self.device).synchronize()
        return TrackOut(graph.host.clone(), desc, graph.stamps.tolist())


def _no_span(part):
    return contextlib.nullcontext()


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
        self.stamps = None

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


# number of trailing diagnostic floats in the CHAINED step's pack
# (n_th, n_vis, widened, inl1, |dt| of the solve-vs-prediction correction,
# its rotation angle in degrees): they drive the host's innovation gate
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


# ---------------------------------------------------------------------------
# Chained (pipelined) variant: the step consumes the PREVIOUS step's
# device-resident outputs and gathers point data from the DEVICE MAP
# MIRROR at execution time (slam/device_map.py).  Frame t+1 is dispatched
# before frame t's results are pulled; because positions come from the
# mirror (which the host flushes when it re-anchors the chain), bundle
# adjustment reaches later frames and the chain never rides a stale
# snapshot.  The step outputs per-feature POINT IDS directly, so the host
# does no slot bookkeeping at all.
# ---------------------------------------------------------------------------

class ChainState(NamedTuple):
    """Device-resident per-frame state threaded between steps."""

    xy: torch.Tensor         # (N, 2) f32
    ur: torch.Tensor         # (N,) f32
    octave: torch.Tensor     # (N,) i32
    angle: torch.Tensor      # (N,) f32
    desc: torch.Tensor       # (N, 8) i32 holding the uint32 words' bits
    pid: torch.Tensor        # (N,) i32 bound map-point id or -1
    T_cur: torch.Tensor      # (4, 4)
    velocity: torch.Tensor   # (4, 4) T_cur @ inv(T_prev); carried directly
                             # (recomputing it via a double closed-form
                             # inverse loses ~3 cm to f32 non-orthogonality,
                             # a full matching window)


def build_track_step_chained(settings, sensor_stereo, device="cuda",
                             plain: bool = False):
    """The eager chained step for these settings on `device`, memoized like
    build_track_step.  All three sensors: for rgbd the step's img_r input
    is the FLOAT depth image (same contract as the fast step).  It holds
    no state, so every Tracker wraps it in a `ChainRunner` of its own."""
    mode = _sensor_mode(sensor_stereo)
    device = _canonical(device)
    key = (("chain",) + _step_cache_key(settings, mode)
           + (str(device), bool(plain)))
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = _build_track_step_chained(settings, mode, device,
                                                     plain)
    return _STEP_CACHE[key]


def _build_track_step_chained(settings, mode: str, device: torch.device,
                              plain: bool):
    """Returns step(img_l, img_r, chain, mir_f32, mir_desc, cand_pids,
    scal) -> (TrackOut, ChainState)."""
    c = _step_consts(settings, mode, device, plain)

    def step(img_l, img_r, chain: ChainState,
             mir_f32,                 # (P, 9) [pos, normal, min, max, valid]
             mir_desc,                # (P, 8) int32
             cand_pids,               # (M,) int32 local candidates, -1 = pad
             scal):                   # (2,) f32 [th_local, unused]
        _stamp(c, 0)
        th_local = scal[0]
        cap = mir_f32.shape[0]

        # gather chained + candidate point data from the mirror.  An id
        # beyond the mirror (a point born since its last flush grew it)
        # is masked out: the JAX gather clamps it onto the last row and
        # reads another point's data under this id.
        cpid = chain.pid.clamp(0, cap - 1).long()
        last_rows = mir_f32[cpid]                       # (L, 9)
        last_pts = last_rows[:, 0:3]
        last_has = ((chain.pid >= 0) & (chain.pid < cap)
                    & (last_rows[:, 8] > 0.5))
        qpid = cand_pids.clamp(0, cap - 1).long()
        loc_rows = mir_f32[qpid]                        # (M, 9)
        loc_desc = mir_desc[qpid]
        # a candidate is usable if it exists, is alive, and is not
        # already carried by the chain (device-side exclusion)
        carried = ((cand_pids[:, None] == chain.pid[None, :])
                   & last_has[None, :]).any(1)
        loc_mask = ((cand_pids >= 0) & (cand_pids < cap)
                    & (loc_rows[:, 8] > 0.5) & ~carried)

        velocity = chain.velocity
        T_pred = velocity @ chain.T_cur
        # relative z-motion gate uses inv(velocity)'s z-translation
        vz = se3.inverse(velocity)[2, 3]
        fwd = c.is_stereo & (vz > c.baseline)
        bwd = c.is_stereo & (-vz > c.baseline)

        feats, ur, depth = _frontend(c, img_l, img_r)
        _stamp(c, 1)
        # The doubled motion-model window opens when matches are weak in
        # ABSOLUTE terms (ref: Tracking.cc:842-847 does th -> 2*th below
        # 20 matches) or RELATIVE to how many carried points project
        # in-frustum: a blind pipelined frame whose prediction has drifted
        # loses matches long before the absolute floor, and the 2x window
        # is the only mechanism that can still see the true
        # correspondences at that point.
        r = _match_and_solve(
            c, feats, ur, T_pred, fwd, bwd, th_local,
            last_pts, last_has, chain.octave, chain.angle, chain.desc,
            loc_rows[:, 0:3], loc_rows[:, 3:6], loc_rows[:, 6],
            loc_rows[:, 7], loc_desc, loc_mask, relative_widen=True)
        T2, inlier = r.T2, r.inlier

        # resolve per-feature point ids directly on device
        all_pids = torch.cat([chain.pid, cand_pids], 0)
        feat_pid = torch.where(
            r.assign >= 0, all_pids[r.assign.clamp(min=0).long()], -1)

        # trailing diagnostics (always pulled, drive the host innovation
        # gate): th-window matches, carried points visible, widened window
        # used?, inliers after the first (motion-only) solve, |t| and
        # rotation angle of the correction the solve applied to the
        # prediction
        corr = T2 @ se3.inverse(T_pred)
        cos = ((corr[0, 0] + corr[1, 1] + corr[2, 2] - 1.0) / 2.0).clamp(
            -1.0, 1.0)
        diag = torch.stack([
            r.n1.float(), r.vis.sum().float(), r.use2.float(),
            r.inl1.sum().float(),
            torch.sqrt((corr[:3, 3] * corr[:3, 3]).sum()),
            torch.rad2deg(torch.acos(cos)),
        ])                                               # N_DIAG
        f32_pack = _pack(T2, r.n_mm, r.n_in, feats, ur, depth,
                         feat_pid,                       # pid, not slot
                         inlier, r.vis_l, tail=diag)
        _stamp(c, 6)

        # chain-poisoning guard: a weak pose solve (few inliers) must not
        # become the next frame's anchor — carry the motion-model
        # prediction and the previous velocity instead, and drop the
        # feature->point bindings so the next motion match can't lock
        # onto a wrong geometry.  The host sees the weak n_in and runs
        # its fallback; the chain stays on the motion-model rail until
        # a confident solve or a host re-anchor.
        trust = r.n_in >= 30
        # Damped velocity update.  The raw update V = T2 inv(T_prev)
        # folds the full solve innovation into the next prediction:
        # with pose error e(t) the blind CV prediction error becomes
        # 2e(t) - e(t-1), which DOUBLES every frame once window-biased
        # matching can no longer pull the solve all the way back.
        # Letting only half the innovation enter the velocity
        # (V' = exp(0.5 log(V_meas inv(V))) V) keeps the loop stable
        # while still tracking real accelerations with ~1-frame lag.
        # The host re-anchors with its exact velocity every refresh,
        # so the lag never accumulates.
        v_meas = T2 @ se3.inverse(chain.T_cur)
        dv = se3.log(v_meas @ se3.inverse(velocity))
        v_damped = se3.exp(0.5 * dv) @ velocity
        new_chain = ChainState(
            xy=feats.xy, ur=ur, octave=feats.octave, angle=feats.angle,
            desc=feats.desc,
            pid=torch.where(trust & inlier, feat_pid, -1),
            T_cur=torch.where(trust, T2, T_pred),
            velocity=torch.where(trust, v_damped, velocity),
        )
        return TrackOut(f32_pack, feats.desc, c.stamps.clone()), new_chain

    return step


class _Slot:
    """One entry of the staging ring: pinned host buffers for a frame's
    inputs and for its pack, and the event recorded behind the last copy
    that used them."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.held = False
        self.event = None
        self._bufs = {}

    def buf(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        key = (name, tuple(shape), dtype)
        if key not in self._bufs:
            self._bufs[key] = torch.empty(tuple(shape), dtype=dtype,
                                          pin_memory=self.pinned)
        return self._bufs[key]


class SlotRing:
    """Staging buffers for frames in flight.  A frame takes a slot when it
    is dispatched and holds it until its result has been copied out (or
    the frame is dropped); the host writes a slot's buffers only after the
    event behind their last copy has completed.  So neither the next
    frame's inputs nor the next frame's pack can overtake a copy still in
    flight, however many frames the caller keeps unread: when every slot
    is held the ring grows."""

    def __init__(self, size: int, pinned: bool):
        self.pinned = pinned
        self.slots = [_Slot(pinned) for _ in range(size)]
        self._next = 0

    def acquire(self) -> _Slot:
        n = len(self.slots)
        for k in range(n):
            slot = self.slots[(self._next + k) % n]
            if not slot.held:
                self._next = (self._next + k + 1) % n
                break
        else:
            slot = _Slot(self.pinned)
            self.slots.append(slot)
            self._next = 0
        slot.held = True
        if slot.event is not None:
            slot.event.synchronize()
        return slot

    def release(self, slot: _Slot) -> None:
        slot.held = False

    def held(self) -> int:
        return sum(s.held for s in self.slots)


class PendingFrame:
    """A dispatched chained frame: the counterpart of a JAX array with
    `copy_to_host_async()` started.  `is_ready()` asks the event behind
    the copy and never blocks; `wait()` blocks on that event alone and
    hands back the pack as a numpy array of its own."""

    def __init__(self, host: torch.Tensor, desc: torch.Tensor,
                 ring: Optional[SlotRing] = None,
                 slot: Optional[_Slot] = None):
        self.desc = desc
        self._host = host
        self._ring, self._slot = ring, slot
        self._event = slot.event if slot is not None else None
        self._buf = None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> np.ndarray:
        if self._buf is None:
            if self._event is not None:
                self._event.synchronize()
            self._buf = self._host.detach().numpy().copy()
            self.release()
        return self._buf

    def release(self) -> None:
        """Give the slot back (a frame dropped unread)."""
        if self._slot is not None:
            self._ring.release(self._slot)
            self._slot = None
        self._host = None


class _ChainGraph:
    """One captured chained step: its static inputs, the graph and its
    outputs."""

    def __init__(self, static: dict):
        self.static = static
        self.graph = None
        self.out: Optional[TrackOut] = None


class ChainRunner:
    """Drives the chained step for one Tracker.

    On the CPU `dispatch` runs the eager step and the result is ready at
    once.  On a CUDA device it is this package's counterpart of JAX's
    asynchronous dispatch: the step is captured as one CUDA graph per
    (candidate rows, image shapes, mirror address) and a dispatch

      - takes a slot of the staging ring, writes the frame's host inputs
        (images, candidate ids, scalars) into its pinned buffers and
        copies them into the graph's static inputs, non-blocking;
      - replays the graph, which reads the `ChainState` from static
        buffers and copies the new chain back into them at its end, so
        the next replay continues from it;
      - copies the pack into the slot's pinned buffer, non-blocking,
        clones the descriptors, and records the slot's event.

    Nothing in a dispatch waits for the device.  All of it is enqueued on
    the caller's current stream, as are `set_chain` (a re-anchor) and the
    mirror's flush, so each lands between two replays, never inside one.
    There is no eager fallback: a capture that fails raises."""

    WARMUP = GraphStep.WARMUP

    def __init__(self, step, device, depth: int = 3):
        self.eager = step
        self.device = _canonical(device)
        self.chain: Optional[ChainState] = None
        self.captures = 0
        self.capture_log = []      # (candidate rows, why) of each capture
        self._graphs = {}
        self._mirror = None        # addresses the live graphs were made for
        self.ring = SlotRing(depth + 2, self.device.type == "cuda")

    def set_chain(self, chain: ChainState) -> None:
        """Re-anchor: overwrite the chain with host-built state."""
        if self.device.type != "cuda" or self.chain is None:
            self.chain = ChainState(*[t.clone() for t in chain])
            return
        for dst, src in zip(self.chain, chain):
            dst.copy_(src, non_blocking=True)

    def _to_tensor(self, a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(_as_input(a)).to(self.device)
        return a

    def dispatch(self, img_l, img_r, mir_f32, mir_desc, cand_pids,
                 scal) -> PendingFrame:
        """One frame through the step; images, `cand_pids` and `scal` as
        numpy arrays or device tensors."""
        if self.chain is None:
            raise RuntimeError("dispatch before set_chain")
        inputs = dict(img_l=img_l, img_r=img_r, cand_pids=cand_pids,
                      scal=scal)
        if self.device.type != "cuda":
            t = {k: self._to_tensor(a) for k, a in inputs.items()}
            out, self.chain = self.eager(
                t["img_l"], t["img_r"], self.chain, mir_f32, mir_desc,
                t["cand_pids"], t["scal"])
            return PendingFrame(out.f32_pack, out.desc)

        mirror = (mir_f32.data_ptr(), mir_desc.data_ptr(),
                  mir_f32.shape[0])
        key = tuple((k, tuple(a.shape), torch.as_tensor(a).dtype)
                    for k, a in inputs.items())
        with torch.cuda.device(self.device):
            if mirror != self._mirror:
                # the mirror moved (it grew): its graphs read freed memory
                why = "first" if self._mirror is None else "mirror moved"
                self._graphs.clear()
                self._mirror = mirror
            else:
                why = "new shape"
            graph = self._graphs.get(key)
            if graph is None:
                graph = self._graphs[key] = self._capture(
                    inputs, mir_f32, mir_desc, why)
            slot = self.ring.acquire()
            for name, a in inputs.items():
                if isinstance(a, np.ndarray):
                    stage = slot.buf(name, a.shape, graph.static[name].dtype)
                    stage.numpy()[...] = a
                    a = stage
                graph.static[name].copy_(a, non_blocking=True)
            graph.graph.replay()
            host = slot.buf("pack", graph.out.f32_pack.shape, torch.float32)
            host.copy_(graph.out.f32_pack, non_blocking=True)
            desc = graph.out.desc.clone()
            if slot.event is None:
                slot.event = torch.cuda.Event()
            slot.event.record(torch.cuda.current_stream(self.device))
        return PendingFrame(host, desc, self.ring, slot)

    def _capture(self, inputs: dict, mir_f32, mir_desc, why: str):
        dev = self.device
        static = {}
        for name, a in inputs.items():
            t = self._to_tensor(a)
            static[name] = torch.empty(t.shape, dtype=t.dtype, device=dev)
            static[name].copy_(t)
        graph = _ChainGraph(static)

        def run():
            return self.eager(static["img_l"], static["img_r"], self.chain,
                              mir_f32, mir_desc, static["cand_pids"],
                              static["scal"])

        with DEVICE_CAPTURE_LOCK:   # no other thread on the device meanwhile
            side = _warmup_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    run()            # the chain itself is left as it is
            torch.cuda.current_stream(dev).wait_stream(side)
            graph.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph.graph):
                graph.out, new_chain = run()
                for dst, src in zip(self.chain, new_chain):
                    dst.copy_(src)
        self.captures += 1
        rows = int(static["cand_pids"].shape[0])
        self.capture_log.append((rows, why))
        if why == "mirror moved":
            print(f"chained step: capture {self.captures} at {rows} "
                  f"candidate rows after the device map mirror moved",
                  flush=True)
        return graph
