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
no compile cache: a graph lives in its process).  The stages "reloc"
and "loop" (with a vocabulary) and "gba" run their eager programs once at
the pinned buckets, so the device libraries behind them (`eigh`, the
batched solves, `index_add_`) are initialised and the allocator holds
their blocks before the run; none of them is captured as a graph.

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
from orb_slam2_tpu_torch.solvers import (
    ba, epnp, initializer, pose_graph, pose_lm, sim3_solver,
)
from orb_slam2_tpu_torch.solvers import triangulation as tri
from orb_slam2_tpu_torch.utils import bucket_size

STAGES = ("frontend", "track", "modular", "mapping", "reloc", "loop", "gba")
MIRROR_DELTA_MAX_ROWS = 16384


def precompile(system, stages: Optional[List[str]] = None,
               verbose: bool = False) -> Dict[str, float]:
    """Run every device program the given System can dispatch, once, at
    its pinned shapes.

    stages: subset of {"frontend", "track", "modular", "mapping",
    "reloc", "loop", "gba"}; default = all applicable to the System's
    configuration (reloc/loop only when a vocabulary is present).
    Returns {program_name: seconds} (warm-up, capture and execution of
    the dummy call).
    """
    have_voc = system.vocabulary is not None
    if stages is None:
        stages = ["frontend", "track", "modular", "mapping"]
        if have_voc:
            stages += ["reloc", "loop"]
        stages += ["gba"]
    for st in stages:
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
    # keyframe rows: a mono store carries the init frames' 2x budget
    n_feat_s = system.store.n_feat
    fbs = fb if n_feat_s == n_feat else feat_block(n_feat_s)
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

    if not mono:
        # System demotes a mono `pipelined` to the fast path: mono never
        # dispatches the chained step
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

    if have_voc:
        def _search_by_nodes():
            for ratio in (0.7, 0.75):
                m = matching.search_by_nodes(
                    fb["desc"], fb["node"], fb["valid"], fb["angle"],
                    fb["desc"], fb["node"], fb["valid"], fb["angle"],
                    ratio=ratio,
                )
                matching.to_host(m)

        add("modular", "search_by_nodes", _search_by_nodes)

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

    if mono:
        def _mono_init():
            # an init attempt at its shapes: two frames of the 2x budget
            # through the init matcher, then the H/F initializer over all
            # their rows with 200 minimal sets (slam/tracking.py)
            a = feat_block(n_feat_s)
            matching.to_host(matching.search_for_initialization(
                a["xy"], a["desc"], a["octave"], a["angle"],
                up(np.ones(n_feat_s, bool)),
                fbs["xy"], fbs["desc"], fbs["octave"], fbs["angle"],
                up(np.ones(n_feat_s, bool))))
            xy1 = rng.uniform((0, 0), (W, H), (n_feat_s, 2))
            res = initializer.initialize(
                up(xy1.astype(np.float32)),
                up((xy1 + rng.normal(0, 2, xy1.shape)).astype(np.float32)),
                up(np.ones(n_feat_s, bool)), up(s.K.astype(np.float32)),
                up(initializer.make_ransac_samples(n_feat_s, rng)))
            torch.cat([res.success.float()[None], res.R21.reshape(-1),
                       res.good_mask.float()]).cpu()

        add("modular", "mono_init", _mono_init)

    # ------------------------------------------------------------------
    # local mapping: triangulation, fusion, local BA at the pinned buckets
    # ------------------------------------------------------------------
    B = s.bucket_nb
    B_tri = bucket_size(20 if mono else 10, s.bucket_nb)
    M_fuse = s.bucket_fuse
    mir = mapper.kf_mirror

    if have_voc and n_feat_s != n_feat:
        # the mapper's deferred keyframe BoW descends store-width rows
        # (mono keeps the 2x init width); the frontend entry covered
        # frame width only
        def _kf_bow():
            system.vocabulary.assign_nodes(fbs["desc"], fbs["valid"])

        add("mapping", "kf_bow_descend", _kf_bow)

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

    def _ba_problem(K, P, E):
        uv = np.zeros((E, 3), np.float32)
        uv[:, 2] = -1.0
        return ba.BAProblem(
            eye4[None].expand(K, 4, 4).contiguous(),
            up(np.concatenate([[True], np.zeros(K - 1, bool)])),
            up(np.ones(K, bool)),
            up(rng.normal(0, 1, (P, 3)).astype(np.float32)
               + np.array([0, 0, 5], np.float32)),
            up(np.ones(P, bool)),
            up((np.arange(E) % K).astype(np.int64)),
            up((np.arange(E) % P).astype(np.int64)),
            up(uv), up(np.ones(E, np.float32)), up(np.ones(E, bool)))

    def _local_ba():
        prob = _ba_problem(K, P, E)
        for second in (True, False):
            out = ba.local_ba_chain(prob, *cam, iters1=5, iters2=10,
                                    mode="dense", second_round=second)
            out[0].cpu()

    add("mapping", "local_ba_chain", _local_ba)

    # ------------------------------------------------------------------
    # relocalization (EPnP RANSAC + guided reprojection)
    # ------------------------------------------------------------------
    fx, fy, cx, cy = cam[:4]
    eye3 = up(np.eye(3, dtype=np.float32))

    def zeros(*shape, dtype=np.float32):
        return up(np.zeros(shape, dtype))

    def ones(*shape, dtype=np.float32):
        return up(np.ones(shape, dtype))

    if have_voc:
        def _pnp():
            # BoW match counts land in [15, ~500]: two bucket shapes
            for Mr in (s.bucket_reloc, 2 * s.bucket_reloc):
                res = epnp.solve_pnp_ransac(
                    up(rng.normal(0, 1, (Mr, 3)).astype(np.float32)),
                    zeros(Mr, 2), ones(Mr), zeros(Mr, dtype=bool),
                    up(rng.integers(0, Mr, (128, 6)).astype(np.int64)),
                    fx, fy, cx, cy,
                )
                res.Tcw.cpu()

        add("reloc", "solve_pnp_ransac", _pnp)

        def _reloc_search():
            # guided reprojection pads candidates to the KF feature
            # capacity (relocalization.py) — one shape per orb_dist round
            Mr = system.store.n_feat
            for orb_dist in (100, 64):
                m = matching.search_reloc_points(
                    zeros(Mr, 3), zeros(Mr, dtype=bool),
                    zeros(Mr, 8, dtype=np.uint32),
                    zeros(Mr), ones(Mr), zeros(Mr),
                    eye4,
                    fb["xy"], fb["octave"], fb["desc"], fb["angle"],
                    fb["valid"],
                    fx, fy, cx, cy, bounds, sf, log_sf, n_levels,
                    10.0, orb_dist=orb_dist,
                )
                matching.to_host(m)

        add("reloc", "search_reloc_points", _reloc_search)

    # ------------------------------------------------------------------
    # loop closing: Sim3 solve/refine, guided projection, pose graph
    # ------------------------------------------------------------------
    if have_voc:
        fix_scale = sensor != Sensor.MONOCULAR
        M_lp = s.bucket_loop_pts

        def _sim3_ladder():
            # BoW match counts (RANSAC) and Sim3-extended counts (refine)
            # land in [20, ~512] on real circuits
            for n_pad in (s.bucket_sim3, 2 * s.bucket_sim3,
                          4 * s.bucket_sim3):
                pts = up(rng.normal(0, 1, (n_pad, 3)).astype(np.float32))
                uv = zeros(n_pad, 2)
                mk = zeros(n_pad, dtype=bool)
                res = sim3_solver.solve_sim3_ransac(
                    pts, pts, uv, uv, ones(n_pad), ones(n_pad), mk,
                    up(rng.integers(0, n_pad, (128, 3)).astype(np.int64)),
                    fx, fy, cx, cy, fix_scale=fix_scale,
                )
                out = sim3_solver.refine_sim3(
                    pts, pts, uv, uv, ones(n_pad), ones(n_pad),
                    mk, res.R12, res.t12, res.s12,
                    fx, fy, cx, cy, fix_scale=fix_scale,
                )
                out[0].cpu()

        add("loop", "sim3_solve+refine", _sim3_ladder)

        def _sim3_mutual():
            nf = system.store.n_feat
            side = (zeros(nf, 3), zeros(nf, dtype=bool),
                    zeros(nf, 8, dtype=np.uint32), zeros(nf), ones(nf),
                    zeros(nf, dtype=np.int32), zeros(nf, 2))
            _, agree = matching.search_by_sim3_mutual(
                *side, *side, eye4, eye4, eye3, zeros(3), ones(),
                fx, fy, cx, cy, bounds, sf, log_sf, n_levels, th=7.5,
            )
            agree.cpu()

        add("loop", "search_by_sim3_mutual", _sim3_mutual)

        def _sim3_projection():
            # th=10 (acceptance count) and th=4 (SearchAndFuse)
            for th in (10.0, 4.0):
                m = matching.search_by_sim3_projection(
                    zeros(M_lp, 3), zeros(M_lp, dtype=bool),
                    zeros(M_lp, 8, dtype=np.uint32),
                    zeros(M_lp), ones(M_lp),
                    eye3, zeros(3), ones(),
                    fb["xy"], fb["octave"], fb["desc"], fb["valid"],
                    fx, fy, cx, cy, bounds, sf, log_sf, n_levels, th,
                )
                matching.to_host(m)

        add("loop", "search_by_sim3_projection", _sim3_projection)

        def _pose_graph():
            Kp, Ep = s.bucket_pg_cams, s.bucket_pg_edges
            prob = pose_graph.PoseGraphProblem(
                eye3[None].expand(Kp, 3, 3).contiguous(),
                zeros(Kp, 3), ones(Kp),
                up(np.concatenate([[True], np.zeros(Kp - 1, bool)])),
                ones(Kp, dtype=bool),
                up((np.arange(Ep) % Kp).astype(np.int64)),
                up(((np.arange(Ep) + 1) % Kp).astype(np.int64)),
                eye3[None].expand(Ep, 3, 3).contiguous(),
                zeros(Ep, 3), ones(Ep), ones(Ep, dtype=bool),
            )
            mode = "dense" if Kp <= 256 else "cg"
            _, _, s_o = pose_graph.optimize(prob, iters=20, mode=mode)
            s_o.cpu()

        add("loop", "pose_graph", _pose_graph)

    # ------------------------------------------------------------------
    # global BA (background thread; chunked LM + outlier pass)
    # ------------------------------------------------------------------
    def _gba():
        # GBA packs ALL keyframes; its buckets outgrow the local-BA pins
        # as the map grows.  The three dims grow INDEPENDENTLY
        # (StickyBuckets), so warm the reachable lattice: K in {2K, 4K}
        # (dense mode caps at 64 cams, global_ba.py _snapshot), P in
        # {P, 2P, 4P}, E/P in {2, 4} (every point carries 2-4
        # observations in practice; E below 2P needs majority
        # single-observation points, which MapPointCulling removes).
        rungs = []
        for Kg in (2 * K, 4 * K):
            for Pg in (P, 2 * P, 4 * P):
                for Eg in (2 * Pg, 4 * Pg):
                    # E's sticky minimum is the configured edge bucket —
                    # shapes below it are unreachable
                    Eg = max(Eg, E)
                    if (Kg, Pg, Eg) not in rungs:
                        rungs.append((Kg, Pg, Eg))
        for Kg, Pg, Eg in rungs:
            prob = _ba_problem(Kg, Pg, Eg)
            cam_T, _, _ = ba.optimize(prob, *cam, iters=5, use_kernel=True,
                                      mode="dense")
            bad = ba.classify_outliers(prob, *cam)
            # the outlier-mask update between GBA passes (global_ba.py)
            (prob.edge_mask & ~bad).cpu()
            cam_T.cpu()

    add("gba", "global_ba", _gba)

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
