"""Warm-up and graph capture of every shape-bucketed device program.

The reference's CPU kernels need no preparation, so its worst frame is
bounded by actual work (Examples/Stereo/stereo_kitti.cc:100-122 paces a
loop that never stalls).  Here the first call of a tracking step at a new
shape warms it up eagerly and captures its CUDA graph, the first use of a
kernel builds the library and uploads its tables, and the first call of
each solver initialises what it uses of the device's libraries: a
capture landing mid-run (while the mapping thread wants the device) turns
a real-time system into one with a frame of seconds.

Every dynamically sized device program in this package pads its data
dimensions to bucket minimums pinned in Settings (bucket_* fields), so
the set of (program, shape) pairs a run needs is ENUMERABLE from the
configuration alone.  `precompile(system)` walks that registry and runs
each one with dummy inputs before the first frame; afterwards a run whose
live sizes stay under the pins captures nothing on the hot path.

Port of orb_slam2_tpu/precompile.py without its XLA specifics (there is
no compile cache: a graph lives in its process).  The stages "reloc",
"loop" and "gba" wait for the relocalizer, the loop closer and global BA
(ROADMAP item 6) and raise NotImplementedError naming it.

Usage:
    system = System(settings, Sensor.STEREO)
    system.precompile()          # seconds per program via the return dict
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.ops import matching
from orb_slam2_tpu_torch.ops.frontend import padded_total
from orb_slam2_tpu_torch.slam import device_map
from orb_slam2_tpu_torch.slam import track_step as ts
from orb_slam2_tpu_torch.solvers import ba, pose_lm
from orb_slam2_tpu_torch.solvers import triangulation as tri
from orb_slam2_tpu_torch.utils import bucket_size

STAGES = ("frontend", "track", "modular", "mapping")
LATER_STAGES = ("reloc", "loop", "gba")     # ROADMAP item 6
MIRROR_DELTA_MAX_ROWS = 16384


def precompile(system, stages: Optional[List[str]] = None,
               verbose: bool = False) -> Dict[str, float]:
    """Run every device program the given System can dispatch, once, at
    its pinned shapes.

    stages: subset of {"frontend", "track", "modular", "mapping"};
    default = all of them.  Returns {program_name: seconds} (warm-up,
    capture and execution of the dummy call).
    """
    if stages is None:
        stages = list(STAGES)
    for st in stages:
        if st in LATER_STAGES:
            raise NotImplementedError(
                f"precompile stage {st!r} waits for ROADMAP item 6")
        if st not in STAGES:
            raise ValueError(f"unknown precompile stage {st!r}")
    s = system.settings
    sensor = system.sensor
    mono = sensor == Sensor.MONOCULAR
    tracker, mapper = system.tracker, system.local_mapper
    dev = system.device
    rng = np.random.default_rng(0)

    H, W = s.height, s.width
    n_feat = padded_total(s.n_features, s.n_levels, s.scale_factor)
    n_levels = s.n_levels
    log_sf = float(np.log(s.scale_factor))
    cam = (s.fx, s.fy, s.cx, s.cy, s.bf)

    def up(a):
        """A host array on the System's device, as the Tracker and the
        mapper upload theirs (uint32 words as int32 bits)."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(dev)

    sf = up(s.scale_factors().astype(np.float32))
    ls2 = up(s.level_sigma2().astype(np.float32))
    bounds = up(np.array([0.0, W, 0.0, H], np.float32))
    eye4 = up(np.eye(4, dtype=np.float32))

    # dummy per-frame feature blocks at the frame shape
    def feat_block(n):
        return dict(
            xy=up(rng.uniform(0, min(H, W), (n, 2)).astype(np.float32)),
            ur=up(np.full(n, -1.0, np.float32)),
            depth=up(np.full(n, -1.0, np.float32)),
            octave=up(np.zeros(n, np.int32)),
            angle=up(np.zeros(n, np.float32)),
            desc=up(np.zeros((n, 8), np.uint32)),
            node=up(np.zeros(n, np.int32)),
            valid=up(np.zeros(n, bool)),
        )

    fb = feat_block(n_feat)
    img_u8 = rng.integers(0, 255, (H, W), np.uint8)
    depth_img = np.full((H, W), 5.0, np.float32)

    items: List[Tuple[str, str, Callable]] = []

    def add(stage, name, fn):
        items.append((stage, name, fn))

    # ------------------------------------------------------------------
    # frontend: FrameBuilder's extraction paths (modular frames + init);
    # on a card the first frame compiles the kernels' library
    # ------------------------------------------------------------------
    def _frontend_frames():
        next_id = system.builder._next_id
        if sensor == Sensor.STEREO:
            system.builder.stereo_pair(img_u8, img_u8, 0.0)
        elif sensor == Sensor.RGBD:
            system.builder.rgbd(img_u8, depth_img, 0.0)
        else:
            system.builder.monocular(img_u8, 0.0, init_boost=True)
            system.builder.monocular(img_u8, 0.0, init_boost=False)
        # the dummy frames do not shift the run's frame ids
        system.builder._next_id = next_id

    add("frontend", "frames", _frontend_frames)

    # ------------------------------------------------------------------
    # track: the fused fast step and the pipelined chain step, each
    # captured at the pinned candidate bucket
    # ------------------------------------------------------------------
    M_loc = s.bucket_local
    img_r = depth_img if sensor == Sensor.RGBD else img_u8

    def _fast_step():
        step = tracker._get_fast_step()
        scal = np.zeros(20, np.float32)
        scal[:16] = np.eye(4, dtype=np.float32).reshape(-1)
        scal[18] = 1.0
        out = step(
            system.builder._upload(img_u8),
            (system.builder._upload_depth(img_r)
             if sensor == Sensor.RGBD else system.builder._upload(img_r)),
            tracker._step_in(scal),
            tracker._step_in(np.zeros((n_feat, 4), np.float32)),
            tracker._step_in(np.zeros((n_feat, 8), np.uint32)),
            fb["octave"], fb["angle"],
            up(np.zeros((M_loc, 8), np.float32)),
            up(np.zeros((M_loc, 8), np.uint32)),
            tracker._step_in(np.zeros(M_loc, np.uint8)),
        )
        ts.unpack_track_out(out, n_feat, M_loc)

    add("track", "fast_step", _fast_step)

    def _chain_step():
        # through the Tracker's own runner and mirror: a graph is tied to
        # the runner's chain buffers and to the mirror's address
        tracker._flush_pipeline()
        runner = tracker._get_chain_step()
        dmap = tracker._get_device_map()
        runner.set_chain(ts.ChainState(
            xy=fb["xy"], ur=fb["ur"], octave=fb["octave"],
            angle=fb["angle"], desc=fb["desc"],
            pid=up(np.full(n_feat, -1, np.int32)),
            T_cur=eye4, velocity=eye4))
        pending = runner.dispatch(
            tracker._chain_image(img_u8),
            tracker._chain_image(img_r, depth=sensor == Sensor.RGBD),
            dmap.f32, dmap.desc, np.full(M_loc, -1, np.int32),
            np.array([1.0, 0.0], np.float32))
        ts.unpack_track_out(None, n_feat, M_loc, buf=pending.wait())
        tracker._chain = None      # the next pipelined frame re-anchors

    add("track", "chain_step", _chain_step)

    def _mirror_deltas():
        # every delta size a flush can take, into the dump row only
        dmap = tracker._get_device_map()
        n_pad = device_map.MIN_DELTA_ROWS
        while n_pad <= MIRROR_DELTA_MAX_ROWS:
            device_map._apply_delta(
                dmap._f32, dmap._desc, up(np.full(n_pad, -1, np.int32)),
                up(np.zeros((n_pad, 9), np.float32)),
                up(np.zeros((n_pad, 8), np.uint32)))
            n_pad *= 2

    add("track", "mirror_deltas", _mirror_deltas)

    # ------------------------------------------------------------------
    # modular tracking path (fallbacks: ref-KF tracking, local map)
    # ------------------------------------------------------------------
    def _optimize_pose():
        obs = pose_lm.PoseObs(
            up(np.zeros((n_feat, 3), np.float32)),
            up(np.zeros((n_feat, 3), np.float32)),
            up(np.ones(n_feat, np.float32)), up(np.zeros(n_feat, bool)))
        T, inl, _ = pose_lm.optimize_pose(eye4, obs, *cam)
        # the host pulls T+inliers as ONE packed tensor (tracking.py)
        torch.cat([T.reshape(-1), inl.float()]).cpu()

    add("modular", "optimize_pose", _optimize_pose)

    def _local_points():
        proj = matching.project_points(
            up(np.zeros((M_loc, 3), np.float32)),
            up(np.zeros((M_loc, 3), np.float32)),
            up(np.zeros(M_loc, np.float32)), up(np.ones(M_loc, np.float32)),
            up(np.zeros(M_loc, bool)), eye4, *cam, bounds, log_sf, n_levels)
        matching.to_host(matching.search_local_points(
            proj, up(np.zeros((M_loc, 8), np.uint32)),
            fb["xy"], fb["ur"], fb["octave"], fb["desc"], fb["valid"],
            sf, 1.0))

    add("modular", "project+search_local", _local_points)

    def _search_last():
        variants = [(False, False)]
        if not mono:
            variants += [(True, False), (False, True)]
        for fwd, bwd in variants:
            matching.to_host(matching.search_last_frame(
                up(np.zeros((n_feat, 3), np.float32)),
                up(np.zeros(n_feat, bool)), fb["octave"], fb["desc"],
                fb["angle"], eye4,
                fb["xy"], fb["ur"], fb["octave"], fb["desc"], fb["angle"],
                fb["valid"], *cam, bounds, sf, 7.0,
                forward=fwd, backward=bwd))

    add("modular", "search_last_frame", _search_last)

    # ------------------------------------------------------------------
    # local mapping: triangulation, fusion, local BA at the pinned buckets
    # ------------------------------------------------------------------
    B = s.bucket_nb
    B_tri = bucket_size(20 if mono else 10, s.bucket_nb)
    M_fuse = s.bucket_fuse
    n_feat_s = system.store.n_feat
    fbs = fb if n_feat_s == n_feat else feat_block(n_feat_s)
    mir = mapper.kf_mirror
    eye4_b = eye4[None].expand(B, 4, 4).contiguous()

    def fuse_points_block(M):
        return (up(np.zeros((M, 3), np.float32)), up(np.zeros(M, bool)),
                up(np.zeros((M, 8), np.uint32)),
                up(np.zeros((M, 3), np.float32)),
                up(np.zeros(M, np.float32)), up(np.ones(M, np.float32)))

    fuse_tail = (*cam, bounds, sf, ls2, log_sf, n_levels)

    if mir is not None:
        def _triangulate_gather():
            packed = tri.triangulate_gather(
                eye4, eye4[None].expand(B_tri, 4, 4).contiguous(),
                0, up(np.zeros(B_tri, np.int64)), fbs["node"],
                mir.f32, mir.i32, mir.desc,
                fbs["valid"], up(np.zeros((B_tri, n_feat_s), bool)),
                up(np.zeros(B_tri, bool)), *cam, sf, ls2)
            tri.unpack_triangulate_batch(packed, B_tri, n_feat_s)

        add("mapping", "triangulate_gather", _triangulate_gather)

        def _fuse_gather():
            packed = matching.fuse_points_gather(
                *fuse_points_block(M_fuse), eye4_b,
                up(np.zeros(B, np.int64)),
                mir.f32, mir.i32, mir.desc, mir.valid,
                up(np.zeros(B, bool)), *fuse_tail)
            matching.unpack_fuse_batch(packed, B, M_fuse)

        add("mapping", "fuse_points_gather", _fuse_gather)
    else:
        def stack(a, b):
            return a[None].expand(b, *a.shape).contiguous()

        def _triangulate():
            packed = tri.triangulate_batch(
                eye4,
                fbs["xy"], fbs["ur"], fbs["depth"], fbs["octave"],
                fbs["desc"], fbs["node"], fbs["angle"], fbs["valid"],
                eye4[None].expand(B_tri, 4, 4).contiguous(),
                *[stack(fbs[k], B_tri) for k in (
                    "xy", "ur", "depth", "octave", "desc", "node", "angle",
                    "valid")],
                up(np.zeros(B_tri, bool)), *cam, sf, ls2)
            tri.unpack_triangulate_batch(packed, B_tri, n_feat_s)

        add("mapping", "triangulate_batch", _triangulate)

        def _fuse_batch():
            packed = matching.fuse_points_batch(
                *fuse_points_block(M_fuse), eye4_b,
                *[stack(fbs[k], B) for k in ("xy", "ur", "octave", "desc",
                                             "valid")],
                up(np.zeros(B, bool)), *fuse_tail)
            matching.unpack_fuse_batch(packed, B, M_fuse)

        add("mapping", "fuse_points_batch", _fuse_batch)

    def _fuse():
        # reverse fuse into the new keyframe
        fm = matching.fuse_points(
            *fuse_points_block(M_fuse), eye4,
            fbs["xy"], fbs["ur"], fbs["octave"], fbs["desc"], fbs["valid"],
            *fuse_tail)
        fm.ok.cpu()

    add("mapping", "fuse_points", _fuse)

    K, P, E = s.bucket_ba_cams, s.bucket_ba_pts, s.bucket_ba_edges

    def _local_ba():
        uv = np.zeros((E, 3), np.float32)
        uv[:, 2] = -1.0
        prob = ba.BAProblem(
            eye4[None].expand(K, 4, 4).contiguous(),
            up(np.concatenate([[True], np.zeros(K - 1, bool)])),
            up(np.ones(K, bool)),
            up(rng.normal(0, 1, (P, 3)).astype(np.float32)
               + np.array([0, 0, 5], np.float32)),
            up(np.ones(P, bool)),
            up((np.arange(E) % K).astype(np.int64)),
            up((np.arange(E) % P).astype(np.int64)),
            up(uv), up(np.ones(E, np.float32)), up(np.ones(E, bool)))
        for second in (True, False):
            out = ba.local_ba_chain(prob, *cam, iters1=5, iters2=10,
                                    mode="dense", second_round=second)
            out[0].cpu()

    add("mapping", "local_ba_chain", _local_ba)

    # ------------------------------------------------------------------
    out: Dict[str, float] = {}
    for stage, name, fn in items:
        if stage not in stages:
            continue
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        out[f"{stage}/{name}"] = round(dt, 2)
        if verbose:
            print(f"precompile {stage}/{name}: {dt:.1f}s", flush=True)
    return out
