"""Smoke test of the PyTorch / CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a Hopper card (the kernels
are built for sm_90a) and the CUDA toolkit.  It imports nothing of JAX and
nothing of the JAX package, and exits non-zero, printing no result, when
there is no CUDA device or any phase fails.  Phases:

  1. build   compile the three Hopper kernels from csrc/ with nvcc;
  2. kernels hold each kernel against its plain PyTorch version on the
             card, at the shapes of the main path (a 376x1240 KITTI-shaped
             stereo pair, 2000 features): FAST maps exactly equal, angles
             within 1e-4 deg, descriptors bit-identical on >= 99.9% of
             valid keypoints -- FAST and describe both as one launch over
             all 8 levels (both images) and one level a launch; the fused
             stereo refinement's u_right, depth and SAD bit-identical to
             refine_plain's (torch.equal) on random matches and on the
             real Hamming matches of the 5 pairs, and its scores, and the
             scores-only kernel's, equal to sad_strips_plain;
  3. slice   FrameBuilder.stereo_pair on 5 rendered stereo pairs with the
             kernels: >= 500 valid features and >= 100 stereo depths a
             frame, median depth error <= 3% against the rendered depth,
             the same xy / octave / valid as the plain path on the card,
             and u_right and depth equal to it on >= 99.9% of rows;
  4. counts  exactly one FAST and one describe launch an image and one
             stereo refinement launch a pair during the slice, and no
             scores-only launch;
  5. times   stereo_pair per frame; each kernel against its plain version
             by CUDA events and inside a CUDA graph, FAST and describe also
             as 8 one-level launches, the stereo refinement also as the
             unfused step 3 (scores launch plus the PyTorch epilogue) and
             as the scores-only launch, and at N = 256, 1024 and 2048, in
             alternating order; each kernel's bound (the least time the
             card could take for the same work, from this run's inputs)
             and its share of it;
  6. track   the fused stereo tracking step (slam/track_step.py) on 12
             consecutive rendered poses, 2.25 deg apart: frame 0 gives the
             map, frames 1-11 go through the step replayed as one CUDA
             graph a frame.  Every frame: >= 20 motion-model matches,
             >= 30 inliers, pose within 0.05 m and 0.5 deg of the truth;
             the replay equals the eager step (Tcw within 1e-5, assign,
             inlier and vis_local equal) and the kernel path the plain
             path (Tcw within 1e-4, assign equal on >= 99% of valid
             features); exactly one FAST and one describe launch an image
             while the step is warmed up and captured, and a profiled
             replay runs exactly 2 FAST, 2 describe and 1 stereo
             refinement kernels, and its node count is printed;
             step times (graph, eager, eager plain),
             launches a frame and the device's busy share;
  7. system  the port's stereo System (slam/tracking.py, local mapping,
             system.py) on the card with the sync scheduler:
             (a) the 16-frame 240x320 sequence of tests/test_golden.py:
                 the golden's frame count and timestamps, every camera
                 centre within 5 mm of tests/data/golden_stereo_traj.npz;
             (b) 40 consecutive KITTI-shaped frames (the poses of phase 6)
                 through System.track_stereo: no frame LOST and no reset,
                 >= 3 keyframes, a triangulation that bore points, a local
                 BA, every pose within 0.05 m and 0.5 deg of the truth, the
                 three kernels launched and found by name in a profiled
                 frame; median ms of fast-path and keyframe frames, the
                 stage timers, launches per keyframe in the mapper, the
                 graph captures and the map's size;
             (c) one local-BA problem gathered in (b), solved on the card
                 and on the CPU: cam_T within 1e-4, points within 1e-3 m,
                 outlier masks equal on >= 99% of edges; two card solves
                 compared for determinism;
  8. pipeline the pipelined tracking chain and the async scheduler, at the
             KITTI shape:
             (a) the chained step (slam/track_step.py ChainRunner) replayed
                 as a CUDA graph against the eager chained step on the same
                 chain, mirror and candidates, for an anchor frame and the
                 blind frame dispatched behind it before either is read:
                 Tcw within 1e-5, point ids, inliers and vis_local equal;
                 a profiled replay runs exactly 2 FAST, 2 describe and 1
                 stereo refinement kernels; its node count beside the fast
                 step's; a mirror at a new address is captured for again;
             (b) phase 7b's 40 poses through System(pipelined) with the
                 sync scheduler after System.precompile(), then the flush:
                 no frame LOST, no reset, every trajectory entry within
                 0.05 m / 0.5 deg of the truth, >= 3 keyframes; anchors,
                 blind frames, the most frames in flight, drift-gate
                 rejects and salvages, mirror flushes and rows, captures,
                 the ms of a track_stereo call by kind of frame (no
                 synchronisation around the call: a blind frame's call must
                 not wait for the device) and from dispatch to applied pose;
             (c) the same frames through System(scheduler="async"), once
                 unpipelined and once pipelined, paced at 10 Hz: the mapper
                 busy during tracked frames, quiescence within a bounded
                 wait, the worker dead after shutdown(), the store's
                 invariants, every trajectory entry within 0.15 m / 1.5
                 deg (three times the sync bound: which frames become
                 keyframes, and when their BA lands, depends on the two
                 threads' timing, and runs of the same code read 0.025 to
                 0.076 m); the caller's ms on
                 keyframe frames against phase 7b's inline figure, and the
                 fast-path ms with the mapper idle and busy;
             (d) System.precompile()'s seconds per program, and the graph
                 captures made during (b) and (c) after it, each attributed
                 (none expected).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors and times.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# KITTI-00 stereo geometry (Examples/Stereo/KITTI00-02.yaml), as bench.py
H, W = 376, 1240
FX = FY = 718.856
CX, CY = 607.19, 185.22
BF = 386.1448
N_FEATURES = 2000
N_PAIRS = 5
N_TIMED = 20
BACK_TO_BACK = 20     # launches in one graph for a kernel's device time

ANGLE_ATOL_DEG = 1e-4
DESC_MIN_SHARE = 0.999
STEREO_MIN_SHARE = 0.999
MIN_VALID = 500       # the stereo-init floor (slam/tracking.py:1171)
MIN_DEPTHS = 100
MAX_MEDIAN_DEPTH_ERR = 0.03

# the tracking phase
N_TRACK = 12          # consecutive poses; frame 0 gives the map
MIN_MM, MIN_INLIERS = 20, 30   # the Tracker's gates (slam/tracking.py:493,521)
MAX_POSE_ERR_M, MAX_POSE_ERR_DEG = 0.05, 0.5
REPLAY_TCW_ATOL = 1e-5
PLAIN_TCW_ATOL = 1e-4
PLAIN_ASSIGN_SHARE = 0.99
KERNEL_NAMES = {"fast": "fast_levels_kernel",
                "orb": "orb_describe_levels_kernel",
                "stereo": "stereo_refine_kernel"}
# kernel launches a stereo frame: one FAST and one describe an image
LAUNCHES_PER_PAIR = {"fast": 2, "orb": 2, "stereo": 1}

# the bounds: NVIDIA's H100 SXM data sheet, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12     # outside the tensor cores
FP64_OPS_PER_S = 34e12     # outside the tensor cores
# csrc/fast.cu per pixel: the early exit's 4 compass differences, 8 pair
# min/max, 6 to reduce them and 4 to test; the NMS's 6 max and 3
# compares, 4 border compares and 3 selects for the mask and fallback.
# Per pixel that passes the compass test, also: 12 more ring
# differences, 2 x 64 doubling min/max and 2 x 15 over the arcs, 1
# negation, 1 max, 1 subtraction and 2 for the threshold
FAST_OPS_PER_PX = 4 + 8 + 6 + 4 + 6 + 3 + 4 + 3
FAST_OPS_PER_PASSING_PX = 12 + 2 * 64 + 2 * 15 + 5
# csrc/orb.cu per valid keypoint: 749 circle pixels x (2 multiplies + 2
# adds) in float64; 512 taps x (4 multiplies, 2 adds, 2 roundings) and
# 256 compares in float32
DESC_FP64_OPS_PER_KP = 749 * 4
DESC_FP32_OPS_PER_KP = 512 * 8 + 256
# csrc/stereo.cu per keypoint: 11 shifts x 121 x (2 subtractions, 1
# absolute value, 1 add); then the epilogue: the centres' 3 conversions
# and 6 clamps, 10 compares for the first minimum, and the parabola and
# depth's 26 float operations (denominator 3, its test 3, numerator 2,
# max 1, division 1, clamp 2, u_right 4, disparity 1, window 3, snap 2,
# depth 1, 3 selects)
SAD_OPS_PER_KP = 11 * 121 * 4
REFINE_OPS_PER_KP = 9 + 10 + 26
# a FAST low threshold below any score: every pixel passes the kernel's
# compass-point early exit, so the launch does the full work everywhere
NO_EXIT_MIN_TH = -1e30

# the system phase
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_stereo_traj.npz")
GOLDEN_MAX_DEV_M = 5e-3
N_SYSTEM = 40
MIN_KEYFRAMES = 3
BA_CAM_ATOL, BA_PTS_ATOL, BA_BAD_SHARE = 1e-4, 1e-3, 0.99
PROFILED_KEYFRAME_PASS = 3     # the mapper's fourth pass (0-based)

# the pipeline phase
FRAME_PERIOD_S = 0.1           # KITTI's 10 Hz
QUIESCE_MAX_S = 60.0
# a blind pipelined frame's call: the host's prep and one graph launch.  A
# call that waited for its own replay would take the replay's ~40 ms
BLIND_CALL_MAX_MS = 30.0
# under the async scheduler the threads' timing decides the keyframes
ASYNC_MAX_POSE_ERR_M, ASYNC_MAX_POSE_ERR_DEG = 0.15, 1.5


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(torch, fn, iters: int = 10, reps: int = 5) -> float:
    """Median over `reps` of the mean device time of `iters` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def capture(torch, fn, calls: int = 1):
    """`calls` calls of `fn`, warmed up and captured back to back in one
    CUDA graph."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """`fn` captured once in a CUDA graph: median over `reps` of the mean
    time of `iters` replays, by CUDA events.  No Python runs between the
    kernels, so this is the device's time plus the graph's own launch
    gaps; for a kernel of a few us it is the rate at which the host
    launches graphs."""
    return cuda_ms(torch, capture(torch, fn).replay, iters, reps)


def back_to_back(torch, fn, kname: str) -> dict:
    """BACK_TO_BACK calls of `fn` in one CUDA graph: the replay's time a
    call by CUDA events (the kernels and the gaps between graph nodes, no
    host launch between them), and the mean device duration of the
    kernels named `kname` in one profiled replay (the kernel alone)."""
    graph = capture(torch, fn, BACK_TO_BACK)
    ms = cuda_ms(torch, graph.replay, 5, 5) / BACK_TO_BACK
    runs = [v for name, v in profile_call(
        torch, graph.replay)["device_ms_by_name"].items() if kname in name]
    count = sum(c for c, _ in runs)
    check(count == BACK_TO_BACK, f"{kname}: {count} kernels in a replay of "
          f"{BACK_TO_BACK} calls")
    return {"graph_ms": ms, "device_ms": sum(t for _, t in runs) / count}


def profile_call(torch, fn) -> dict:
    """One call of `fn` under torch.profiler: the device kernels' names,
    how many times each of the port's kernels ran, the launch API calls by
    name, the device's busy share of the call's wall time, and device time
    by kernel family."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke_call"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e for e in events if e.name == "smoke_call").time_range
    # device-side events but the range's own annotation
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != "smoke_call"]
    launches = {}
    for e in events:
        if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cudaGraphLaunch",
                      "cudaMemcpyAsync"):
            launches[e.name] = launches.get(e.name, 0) + 1
    busy, end = 0.0, span.start
    for e in sorted(dev, key=lambda e: e.time_range.start):
        a = max(e.time_range.start, end)
        b = min(e.time_range.end, span.end)
        if b > a:
            busy += b - a
            end = b
    by_family, by_name = {}, {}
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        fam = kernel_family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + ms
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + ms)
    counts = {name: sum(kname in e.name for e in dev)
              for name, kname in KERNEL_NAMES.items()}
    return {"names": {e.name for e in dev}, "n_device": len(dev),
            "counts": counts,
            "launches": launches,
            "wall_ms": (span.end - span.start) / 1e3,
            "busy_ms": busy / 1e3,
            "busy_share": busy / max(span.end - span.start, 1e-9),
            "device_ms_by_family": by_family,
            "device_ms_by_name": by_name}


def kernel_family(name: str) -> str:
    """A coarse class of a device kernel's name, for the time breakdown."""
    low = name.lower()
    for kname in KERNEL_NAMES.values():
        if kname in name:
            return kname
    for fam, keys in (("memcpy", ("memcpy", "memset")),
                      ("gemm", ("gemm", "cutlass", "cublas", "ampere",
                                "sm90_", "xmma")),
                      ("sort", ("sort", "radix")),
                      ("scatter/gather/index", ("scatter", "gather",
                                                "index")),
                      ("reduce", ("reduce",)),
                      ("cat", ("catarray",)),
                      ("elementwise", ("elementwise",))):
        if any(k in low for k in keys):
            return fam
    return "other"


def circ_diff(a, b):
    d = (a - b).abs() % 360.0
    return d.minimum(360.0 - d)

def track_phase(torch, np, dev, settings, scene, gpu) -> dict:
    """Phase 6: the fused stereo tracking step on N_TRACK consecutive
    poses, replayed as one CUDA graph a frame.  Returns the kernels'
    launch counts during the graph-driven run (warm-up and capture: a
    replay launches through the graph, not through the wrappers)."""
    from orb_slam2_tpu_torch import convert, utils
    from orb_slam2_tpu_torch.ops import (
        fast_cuda, frontend, orb_cuda, stereo_cuda,
    )
    from orb_slam2_tpu_torch.slam import track_step
    from orb_slam2_tpu_torch.solvers import pose_lm
    from orb_slam2_tpu_torch.slam.frame import FrameBuilder
    from synthetic import circle_trajectory
    import test_torch_track_blocks as blocks_mod

    poses = circle_trajectory(240, orbit_r=3.0,
                              total_angle=3 * np.pi)[:N_TRACK]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BF / FX
    pairs = [(scene.render(T).astype(np.uint8),
              scene.render(Trl @ T).astype(np.uint8)) for T in poses]

    # frame 0 is the world origin and gives the map
    f0 = FrameBuilder(settings, device=dev).stereo_pair(*pairs[0], 0.0).feats
    pts = blocks_mod.stereo_init_map(
        f0.xy, f0.depth, f0.valid, f0.octave, f0.desc, settings.fx,
        settings.fy, settings.cx, settings.cy, settings.scale_factors())
    n = f0.n
    M = utils.StickyBuckets(local=settings.bucket_local)("local",
                                                        len(pts["pos"]))
    state = blocks_mod.TrackState(pts, f0.octave, f0.angle, M,
                                  settings.baseline)
    # the trajectory's constant motion, as a tracker that ran one frame
    # before frame 0 holds it (with the identity, frame 1's 2.25 deg
    # motion, ~45 px, falls outside the motion-model window)
    state.velocity = (poses[1] @ np.linalg.inv(poses[0])).astype(np.float32)
    print(f"[track] map of {len(pts['pos'])} points from frame 0; "
          f"N = L = {n}, M = {M}")

    step = track_step.build_track_step(settings, "stereo", device=dev)
    check(isinstance(step, track_step.GraphStep),
          "build_track_step on CUDA is not the graph step")

    # ---- the main path: frames 1.. through the graph-replayed step
    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    frames = []
    t0 = time.perf_counter()
    for k in range(1, N_TRACK):
        blk, cand, pids = state.blocks()
        args = dict(img_l=pairs[k][0], img_r=pairs[k][1], **blk)
        out = step(*[args[name] for name in convert.TRACK_INPUTS])
        res, _ = track_step.unpack_track_out(out, n, M)
        res = res._asdict()
        frames.append((args, res))
        state.apply(res, cand, pids)
    torch.cuda.synchronize()
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    print(f"[track] {N_TRACK - 1} frames in "
          f"{time.perf_counter() - t0:.1f} s (first: warm-up and capture); "
          f"kernel launches during warm-up and capture: {launches}")
    # the step's body ran WARMUP + 1 times (warm-up, then the capture);
    # the replays launch through the graph, not through the wrappers
    runs = track_step.GraphStep.WARMUP + 1
    for name, c in launches.items():
        check(c == LAUNCHES_PER_PAIR[name] * runs,
              f"kernel {name}: {c} launches in {runs} runs of the step, "
              f"expected {LAUNCHES_PER_PAIR[name]} a run")

    errs = []
    for k, (_, res) in enumerate(frames, 1):
        truth = poses[k] @ np.linalg.inv(poses[0])
        dt, dr = blocks_mod.pose_error(res["Tcw"], truth)
        errs.append((dt, dr))
        print(f"[track] frame {k}: {res['n_matches_mm']} motion-model "
              f"matches, {res['n_inliers']} inliers, pose error "
              f"{dt:.5f} m {dr:.4f} deg")
        check(res["n_matches_mm"] >= MIN_MM, f"frame {k}: too few matches")
        check(res["n_inliers"] >= MIN_INLIERS, f"frame {k}: too few inliers")
        check(dt <= MAX_POSE_ERR_M and dr <= MAX_POSE_ERR_DEG,
              f"frame {k}: pose error {dt} m {dr} deg")

    # ---- replay against the eager step, kernel path against plain path
    eager = step.eager
    plain = track_step.build_track_step(settings, "stereo", device=dev,
                                        plain=True).eager
    worst = {"replay_tcw": 0.0, "plain_tcw": 0.0, "plain_assign": 1.0}
    for k, (args, res) in enumerate(frames, 1):
        inputs = convert.track_inputs_from_numpy(args, dev)
        e = convert.track_result_to_numpy(eager(*inputs), n, M)
        p = convert.track_result_to_numpy(plain(*inputs), n, M)
        d_replay = float(np.abs(e["Tcw"] - res["Tcw"]).max())
        d_plain = float(np.abs(p["Tcw"] - e["Tcw"]).max())
        v = e["valid"]
        share = float((p["assign"] == e["assign"])[v].mean())
        worst["replay_tcw"] = max(worst["replay_tcw"], d_replay)
        worst["plain_tcw"] = max(worst["plain_tcw"], d_plain)
        worst["plain_assign"] = min(worst["plain_assign"], share)
        check(d_replay <= REPLAY_TCW_ATOL,
              f"frame {k}: replay and eager Tcw differ by {d_replay}")
        for key in ("assign", "inlier", "vis_local"):
            check(np.array_equal(e[key], res[key]),
                  f"frame {k}: replay and eager {key} differ")
        check(d_plain <= PLAIN_TCW_ATOL,
              f"frame {k}: kernel and plain Tcw differ by {d_plain}")
        check(share >= PLAIN_ASSIGN_SHARE,
              f"frame {k}: kernel and plain assign agree on {share}")
    print(f"[track] replay vs eager: max Tcw diff {worst['replay_tcw']:.3g}, "
          f"assign/inlier/vis_local equal; kernel vs plain path: max Tcw "
          f"diff {worst['plain_tcw']:.3g}, assign equal on >= "
          f"{100 * worst['plain_assign']:.2f}% of valid features")

    # ---- what a replayed frame runs on the device
    last_inputs = [frames[-1][0][name] for name in convert.TRACK_INPUTS]
    dev_inputs = convert.track_inputs_from_numpy(frames[-1][0], dev)
    prof_graph = profile_call(torch, lambda: step(*last_inputs))
    prof_eager = profile_call(torch, lambda: eager(*dev_inputs))
    for name, kname in KERNEL_NAMES.items():
        check(prof_graph["counts"][name] == LAUNCHES_PER_PAIR[name],
              f"kernel {kname} ran {prof_graph['counts'][name]} times in a "
              f"replay, expected {LAUNCHES_PER_PAIR[name]}")
    print(f"[track] kernels in one profiled replay: {prof_graph['counts']}")
    for name, prof in (("replay", prof_graph), ("eager step", prof_eager)):
        print(f"[track] profiled {name}: {prof['n_device']} device kernels "
              f"and copies (graph nodes run); launch calls "
              f"{prof['launches']}; device busy "
              f"{prof['busy_ms']:.2f} ms = {100 * prof['busy_share']:.1f}% "
              f"of {prof['wall_ms']:.2f} ms")
    fams = sorted(prof_graph["device_ms_by_family"].items(),
                  key=lambda kv: -kv[1])
    print("[track] replay device ms by kernel family: " + ", ".join(
        f"{k} {v:.3f}" for k, v in fams))
    by_name = prof_graph["device_ms_by_name"].items()
    print("[track] the port's kernels in the replay, device us: " + ", ".join(
        f"{kname} {1e3 * sum(t for nm, (_, t) in by_name if kname in nm):.2f}"
        for kname in KERNEL_NAMES.values()))

    # ---- where a replayed frame's time goes: the frontend and one pose
    # LM, each captured alone in a graph at the step's shapes
    args, res = frames[-1]
    img_l = torch.from_numpy(args["img_l"]).to(dev)
    img_r = torch.from_numpy(args["img_r"]).to(dev)
    sf = torch.from_numpy(settings.scale_factors().astype(np.float32)).to(dev)
    frontend_ms = graph_ms(torch, lambda: frontend.extract_stereo_pair(
        img_l, img_r, sf, settings.bf, settings.fx, n_features=N_FEATURES,
        n_levels=settings.n_levels, scale_factor=settings.scale_factor,
        ini_th=settings.ini_th_fast, min_th=settings.min_th_fast), 5, 3)
    a = res["assign"]
    all_pts = np.concatenate([args["last_f32"][:, :3],
                              args["loc_f32"][:, :3]])
    ls2 = settings.level_sigma2().astype(np.float32)
    obs = pose_lm.PoseObs(*[torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                            for x in (
        all_pts[np.maximum(a, 0)],
        np.stack([res["xy"][:, 0], res["xy"][:, 1], res["ur"]], -1),
        (1.0 / ls2[res["octave"]]).astype(np.float32),
        (a >= 0) & res["valid"])])
    T0 = torch.from_numpy(res["Tcw"]).to(dev)
    lm_ms = graph_ms(torch, lambda: pose_lm.optimize_pose(
        T0, obs, settings.fx, settings.fy, settings.cx, settings.cy,
        settings.bf), 5, 3)
    print(f"[track] in a graph: frontend (both images, stereo match) "
          f"{frontend_ms:.3f} ms, one pose LM (4x10, N={n}, "
          f"{int(obs.mask.sum())} bound) {lm_ms:.3f} ms")

    # ---- step times: graph, eager kernel path, eager plain path
    step_ms = {"graph": [], "eager": [], "plain": []}
    calls = {"graph": lambda a, d: step(*a), "eager": lambda a, d: eager(*d),
             "plain": lambda a, d: plain(*d)}
    order = ("graph", "eager", "plain")
    for i in range(N_TIMED):
        args = frames[i % len(frames)][0]
        a = [args[name] for name in convert.TRACK_INPUTS]
        d = convert.track_inputs_from_numpy(args, dev)
        for name in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = calls[name](a, d)
            out.f32_pack.cpu()
            torch.cuda.synchronize()
            step_ms[name].append(1e3 * (time.perf_counter() - t))
    times = {k: statistics.median(v) for k, v in step_ms.items()}
    print(json.dumps({
        "metric": "track_step_ms_per_frame", "shape": [H, W],
        "n_features": N_FEATURES, "L": n, "M": M, "frames": N_TIMED,
        "graph_ms": times["graph"], "eager_ms": times["eager"],
        "eager_plain_ms": times["plain"],
        "launch_calls_graph": prof_graph["launches"],
        "launch_calls_eager": prof_eager["launches"],
        "busy_share_graph": prof_graph["busy_share"],
        "busy_share_eager": prof_eager["busy_share"],
        # the replay's device-busy time over the median unprofiled frame
        "busy_share_graph_timed": prof_graph["busy_ms"] / times["graph"],
        "frontend_graph_ms": frontend_ms, "pose_lm_graph_ms": lm_ms,
        "max_pose_err_m": max(e[0] for e in errs),
        "max_pose_err_deg": max(e[1] for e in errs), "gpu": gpu}))
    return {"launches": launches, "times": times,
            "replay_nodes": prof_graph["n_device"]}


def golden_phase(np, dev) -> dict:
    """Phase 7a: tests/test_golden.py's sequence through the System on the
    card, read as that test reads it."""
    from orb_slam2_tpu_torch.config import Sensor, Settings
    from orb_slam2_tpu_torch.system import System
    from synthetic import stereo_sequence, straight_trajectory

    h, w, fx, base = 240, 320, 260.0, 0.12    # tests/test_golden.py:28-37
    s = Settings(fx=fx, fy=fx, cx=w / 2, cy=h / 2, bf=fx * base, width=w,
                 height=h, n_features=800, fps=10.0, th_depth=40.0)
    poses = straight_trajectory(16, step=0.05, yaw_step=0.004)
    _, pairs = stereo_sequence(s.K, h, w, base, poses)
    system = System(s, Sensor.STEREO, device=dev)
    for i, (l, r) in enumerate(pairs):
        system.track_stereo(l, r, i * 0.1)
    store = system.store
    ts, centres = [], []
    for e in system.tracker.trajectory:
        if e.lost or not store.kf_valid[e.ref_kf]:
            continue
        T = e.Tcr @ store.kf_pose[e.ref_kf]
        ts.append(e.timestamp)
        centres.append(-T[:3, :3].T @ T[:3, 3])
    g = np.load(GOLDEN)
    check(len(ts) == len(g["ts"]),
          f"golden: {len(ts)} frames against {len(g['ts'])}")
    check(np.allclose(ts, g["ts"], atol=1e-9), "golden: timestamps differ")
    dev_m = np.linalg.norm(np.array(centres, np.float32) - g["centers"], axis=1)
    print(f"[system] golden on the card: {len(ts)} frames, timestamps equal, "
          f"max camera-centre deviation {dev_m.max():.3g} m (limit "
          f"{GOLDEN_MAX_DEV_M} m), {int(store.kf_valid.sum())} keyframes")
    check(dev_m.max() < GOLDEN_MAX_DEV_M,
          f"golden: deviation {dev_m.max()} m at frame {int(dev_m.argmax())}")
    return {"frames": len(ts), "max_dev_m": float(dev_m.max())}


def system_frames(np, scene):
    """(poses, stereo pairs) of the System phases, rendered once."""
    if not hasattr(system_frames, "cache"):
        from synthetic import circle_trajectory

        poses = circle_trajectory(240, orbit_r=3.0,
                                  total_angle=3 * np.pi)[:N_SYSTEM]
        Trl = np.eye(4, dtype=np.float32)
        Trl[0, 3] = -BF / FX
        pairs = [(scene.render(T).astype(np.uint8),
                  scene.render(Trl @ T).astype(np.uint8)) for T in poses]
        system_frames.cache = (poses, pairs)
    return system_frames.cache


def system_phase(torch, np, dev, settings, scene, gpu) -> dict:
    """Phase 7b and 7c: N_SYSTEM KITTI-shaped frames through the System on
    the card, then one gathered local-BA problem on the card against the
    CPU."""
    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda
    from orb_slam2_tpu_torch.slam.track_step import GraphStep
    from orb_slam2_tpu_torch.solvers import ba
    from orb_slam2_tpu_torch.system import System
    import test_torch_track_blocks as blocks_mod

    poses, pairs = system_frames(np, scene)
    system = System(settings, Sensor.STEREO, device=dev)
    tracker, mapper = system.tracker, system.local_mapper

    # observe the mapper without changing it: births of each
    # triangulation, the gathered BA problems, one profiled keyframe pass
    births, problems, mapper_prof = [], [], {}
    tri_apply, gather, process_one = (mapper._triangulate_apply,
                                      mapper._gather_ba_problem,
                                      mapper.process_one)

    def counted_tri_apply(kf, pend):
        n0 = system.store.n_pt
        tri_apply(kf, pend)
        births.append(system.store.n_pt - n0)

    def kept_gather(*a, **k):
        out = gather(*a, **k)
        problems.append(out[0])
        return out

    def profiled_process_one():
        # the fourth keyframe pass: the origin's has no neighbours, the
        # second warms the mapper up, the third is the first with a local
        # BA (more than two keyframes), the fourth is a warm one with BA
        seen = mapper_prof.get("seen", 0)
        mapper_prof["seen"] = seen + 1
        if seen != PROFILED_KEYFRAME_PASS:
            return process_one()
        n_ba = mapper.timers.counts["lm/ba_device"]
        mapper_prof.update(profile_call(torch, process_one))
        mapper_prof["frame"] = len(frame_ms)
        mapper_prof["with_ba"] = mapper.timers.counts["lm/ba_device"] > n_ba

    mapper._triangulate_apply = counted_tri_apply
    mapper._gather_ba_problem = kept_gather
    mapper.process_one = profiled_process_one

    torch.cuda.reset_peak_memory_stats()
    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    frame_ms, kinds, errs = [], [], []
    for i, (l, r) in enumerate(pairs):
        n_kf, n_fast = system.store.n_kf, tracker.timers.counts["fast_step"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        T = system.track_stereo(l, r, 0.1 * i)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t))
        check(T is not None and tracker.state.name == "OK"
              and tracker.resets == 0, f"system frame {i}: lost or reset")
        kf = system.store.n_kf > n_kf
        fast = tracker.timers.counts["fast_step"] > n_fast
        kinds.append("keyframe" if kf else ("fast" if fast else "modular"))
        errs.append(blocks_mod.pose_error(
            T, poses[i] @ np.linalg.inv(poses[0])))
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    print("[system] frame: kind, ms, pose error m/deg: " + "; ".join(
        f"{i} {k} {ms:.1f} {dt:.4f}/{dr:.3f}"
        for i, (k, ms, (dt, dr)) in enumerate(zip(kinds, frame_ms, errs))))
    for i, (dt, dr) in enumerate(errs):
        check(dt <= MAX_POSE_ERR_M and dr <= MAX_POSE_ERR_DEG,
              f"system frame {i}: pose error {dt} m {dr} deg")
    mapper._triangulate_apply, mapper._gather_ba_problem = tri_apply, gather
    mapper.process_one = process_one
    n_keyframes = sum(k == "keyframe" for k in kinds)
    print(f"[system] {N_SYSTEM} KITTI-shaped frames: {n_keyframes} keyframe "
          f"frames (at {[i for i, k in enumerate(kinds) if k == 'keyframe']}),"
          f" triangulation births {births}, "
          f"{mapper.timers.counts['lm/ba_device']} local BAs; max pose error "
          f"{max(e[0] for e in errs):.4f} m "
          f"{max(e[1] for e in errs):.4f} deg; kernel launches {launches}")
    check(n_keyframes >= MIN_KEYFRAMES, f"only {n_keyframes} keyframes")
    check(any(b > 0 for b in births), "no triangulation bore points")
    check(mapper.timers.counts["lm/ba_device"] >= 1, "no local BA ran")
    for name, c in launches.items():
        check(c > 0, f"kernel {name} was not launched by the system phase")

    # the kernels by name in one profiled fast-path frame
    prof = profile_call(torch, lambda: system.track_stereo(
        *pairs[-1], 0.1 * N_SYSTEM))
    for name, kname in KERNEL_NAMES.items():
        check(any(kname in nm for nm in prof["names"]),
              f"kernel {kname} not among a system frame's device kernels")

    # times: the first fast-path frame warms up and captures its graph;
    # the profiled keyframe pass is left out
    first_fast = kinds.index("fast")
    skip = {first_fast, mapper_prof.get("frame", -1)}
    by_kind = {k: [ms for i, (ms, kk) in enumerate(zip(frame_ms, kinds))
                   if kk == k and i not in skip]
               for k in ("fast", "keyframe", "modular")}
    med = {k: (statistics.median(v) if v else None)
           for k, v in by_kind.items()}
    step = tracker._get_fast_step()
    check(isinstance(step, GraphStep), "the System's step is not a GraphStep")
    graphs = getattr(step, "_graphs", {})
    # (L, M): the rows of the last-frame and local-candidate blocks
    captures = sorted((key[3][0][0], key[7][0][0]) for key in graphs)
    store = system.store
    print("[system] tracker stage timers:\n" + tracker.timers.report())
    print("[system] mapper stage timers:\n" + mapper.timers.report())
    mapper_launches = {k: v for k, v in mapper_prof.get("launches",
                                                        {}).items()}
    fams = sorted(mapper_prof.get("device_ms_by_family", {}).items(),
                  key=lambda kv: -kv[1])
    print(f"[system] one profiled keyframe pass of the mapper (frame "
          f"{mapper_prof.get('frame')}, local BA: "
          f"{mapper_prof.get('with_ba')}): "
          f"{mapper_prof.get('n_device')} device kernels and copies, launch "
          f"calls {mapper_launches}, {mapper_prof.get('wall_ms', 0):.1f} ms "
          f"profiled, device busy {100 * mapper_prof.get('busy_share', 0):.1f}"
          "%; device ms by kernel family: " + ", ".join(
              f"{k} {v:.3f}" for k, v in fams))
    print(f"[system] peak device memory during the run: {peak_mb:.0f} MiB")
    print(f"[system] graph captures: {len(graphs)} "
          f"((L, M) of each: {captures}); map: "
          f"{int(store.kf_valid.sum())} keyframes, "
          f"{len(store.valid_pt_ids())} points")

    # ---- 7c: one gathered local-BA problem, card against CPU
    check(len(problems) > 0, "no local-BA problem was gathered")
    prob = problems[-1]
    args = (settings.fx, settings.fy, settings.cx, settings.cy, settings.bf)
    onehot = prob.edge_cam.shape[0] * prob.pts.shape[0] <= \
        ba.ONEHOT_MAX_ENTRIES
    card = [ba.local_ba_chain(prob, *args) for _ in range(2)]
    cpu = ba.local_ba_chain(ba.BAProblem(*[t.cpu() for t in prob]), *args)
    card0 = [t.cpu() for t in card[0]]
    same_twice = all(torch.equal(a, b) for a, b in zip(card[0], card[1]))
    cam_err = float((card0[0] - cpu[0]).abs().max())
    pm = prob.pt_mask.cpu()
    pts_err = float((card0[1] - cpu[1]).abs()[pm].max())
    em = prob.edge_mask.cpu()
    bad_share = float((card0[2] == cpu[2])[em].float().mean())
    ba_ms = cuda_ms(torch, lambda: ba.local_ba_chain(prob, *args), 1, 3)
    t = time.perf_counter()
    ba.local_ba_chain(ba.BAProblem(*[t_.cpu() for t_ in prob]), *args)
    ba_cpu_ms = 1e3 * (time.perf_counter() - t)
    K, P, E = (prob.cam_T.shape[0], prob.pts.shape[0],
               prob.edge_cam.shape[0])
    print(f"[system] local BA K={K} P={P} E={E} "
          f"({int(pm.sum())} points, {int(em.sum())} edges; "
          f"{'one-hot' if onehot else 'scatter'} route): card vs CPU "
          f"cam_T {cam_err:.3g}, points {pts_err:.3g} m, outlier masks equal "
          f"on {100 * bad_share:.2f}% of edges; two card solves bit-equal: "
          f"{same_twice}; chain {ba_ms:.1f} ms on the card, "
          f"{ba_cpu_ms:.1f} ms on the CPU")
    check(cam_err <= BA_CAM_ATOL, f"local BA cam_T differs by {cam_err}")
    check(pts_err <= BA_PTS_ATOL, f"local BA points differ by {pts_err} m")
    check(bad_share >= BA_BAD_SHARE, f"local BA outliers agree on {bad_share}")

    print(json.dumps({
        "metric": "system_ms_per_frame", "shape": [H, W],
        "n_features": N_FEATURES, "frames": N_SYSTEM,
        "fast_path_median_ms": med["fast"],
        "keyframe_median_ms": med["keyframe"],
        "modular_median_ms": med["modular"],
        "frames_by_kind": {k: len(v) for k, v in by_kind.items()},
        "keyframes": n_keyframes, "graph_captures": len(graphs),
        "mapper_launch_calls_per_keyframe": mapper_launches,
        "mapper_busy_share": mapper_prof.get("busy_share"),
        "peak_device_mib": peak_mb,
        "local_ba_card_ms": ba_ms, "local_ba_cpu_ms": ba_cpu_ms,
        "local_ba_route": "one-hot" if onehot else "scatter",
        "local_ba_card_deterministic": same_twice,
        "max_pose_err_m": max(e[0] for e in errs),
        "max_pose_err_deg": max(e[1] for e in errs), "gpu": gpu}))
    return {"launches": launches, "keyframe_median_ms": med["keyframe"],
            "fast_path_median_ms": med["fast"]}


def trajectory_errors(np, system, poses) -> dict:
    """{frame: (m, deg)} of the trajectory entries against the truth, read
    as the trajectory savers read them (Tcr @ the reference keyframe)."""
    import test_torch_track_blocks as blocks_mod

    store = system.store
    errs = {}
    for e in system.tracker.trajectory:
        check(not e.lost, f"trajectory entry at t={e.timestamp} is LOST")
        if not store.kf_valid[e.ref_kf]:
            continue
        i = int(round(e.timestamp / FRAME_PERIOD_S))
        errs[i] = blocks_mod.pose_error(
            e.Tcr @ store.kf_pose[e.ref_kf],
            poses[i] @ np.linalg.inv(poses[0]))
    return errs


def check_store_invariants(np, store) -> None:
    """The async scheduler's store invariants (tests/test_system_e2e.py):
    finite poses and points, bound ids in range, and every entry of the
    observation engine mirrored in kf_obs."""
    with store.lock:
        kfs = store.valid_kf_ids()
        check(bool(np.isfinite(store.kf_pose[kfs]).all()),
              "a keyframe pose is not finite")
        rows = store.kf_obs[kfs]
        check(bool((rows[rows >= 0] < store.n_pt).all()),
              "out-of-range point id bound")
        pids = store.valid_pt_ids()
        check(bool(np.isfinite(store.pt_pos[pids]).all()),
              "a point is not finite")
        idx, okfs, ofeats = store.obs.dump(pids)
        check(bool((store.kf_obs[okfs, ofeats] == pids[idx]).all()),
              "observation engine entries not mirrored in kf_obs")


def med_ms(values):
    return statistics.median(values) if values else None


def fmt(v) -> str:
    return "none" if v is None else f"{v:.2f}"


def chain_step_check(torch, np, dev, settings, scene, fast_nodes) -> dict:
    """Phase 8a: the chained step as a graph against the eager chained
    step, an anchor frame and the blind frame behind it."""
    from orb_slam2_tpu_torch import utils
    from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda
    from orb_slam2_tpu_torch.slam import track_step
    from orb_slam2_tpu_torch.slam.frame import FrameBuilder
    import test_torch_track_blocks as blocks_mod

    poses, pairs = system_frames(np, scene)
    f0 = FrameBuilder(settings, device=dev).stereo_pair(*pairs[0], 0.0).feats
    pts = blocks_mod.stereo_init_map(
        f0.xy, f0.depth, f0.valid, f0.octave, f0.desc, settings.fx,
        settings.fy, settings.cx, settings.cy, settings.scale_factors())
    n, n_pt = f0.n, len(pts["pos"])
    cap = settings.device_map_cap
    M = utils.StickyBuckets(local=settings.bucket_local)("local", n_pt)

    def up(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a).to(dev)

    mir_f32 = torch.zeros((cap, 9), device=dev)
    mir_f32[:n_pt] = up(np.concatenate(
        [pts["pos"], pts["normal"], pts["min_dist"][:, None],
         pts["max_dist"][:, None], np.ones((n_pt, 1), np.float32)], 1))
    mir_desc = torch.zeros((cap, 8), dtype=torch.int32, device=dev)
    mir_desc[:n_pt] = up(pts["desc"])
    pid = np.full(n, -1, np.int32)
    pid[pts["feat"]] = np.arange(n_pt)
    anchor = track_step.ChainState(
        xy=up(f0.xy), ur=up(f0.ur), octave=up(f0.octave.astype(np.int32)),
        angle=up(f0.angle), desc=up(f0.desc), pid=up(pid),
        T_cur=up(np.eye(4, dtype=np.float32)),
        velocity=up((poses[1] @ np.linalg.inv(poses[0])).astype(np.float32)))
    cand = np.full(M, -1, np.int32)
    cand[:n_pt] = np.arange(n_pt)
    scal = np.array([1.0, 0.0], np.float32)

    eager = track_step.build_track_step_chained(settings, "stereo",
                                                device=dev)
    runner = track_step.ChainRunner(eager, dev, depth=3)
    runner.set_chain(anchor)
    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    # both frames dispatched before either is read
    t0 = time.perf_counter()
    pend = [runner.dispatch(*pairs[k], mir_f32, mir_desc, cand, scal)
            for k in (1, 2)]
    t_dispatch = time.perf_counter() - t0
    in_flight = runner.ring.held()
    bufs = [p.wait() for p in pend]
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    runs = track_step.ChainRunner.WARMUP + 1
    for name, c in launches.items():
        check(c == LAUNCHES_PER_PAIR[name] * runs,
              f"chained step: kernel {name} launched {c} times in {runs} "
              f"runs of its body")
    check(runner.captures == 1 and in_flight == 2 and
          runner.ring.held() == 0, "chained runner: captures or ring slots")

    chain, worst = anchor, 0.0
    for k, buf in zip((1, 2), bufs):
        out, chain = eager(up(pairs[k][0]), up(pairs[k][1]), chain, mir_f32,
                           mir_desc, up(cand), up(scal))
        e, _ = track_step.unpack_track_out(out, n, M)
        g, _ = track_step.unpack_track_out(None, n, M, buf=buf)
        d = float(np.abs(e.Tcw - g.Tcw).max())
        worst = max(worst, d)
        check(d <= REPLAY_TCW_ATOL,
              f"chained frame {k}: replay and eager Tcw differ by {d}")
        for key in ("assign", "inlier", "vis_local"):
            check(np.array_equal(getattr(e, key), getattr(g, key)),
                  f"chained frame {k}: replay and eager {key} differ")
        dt, dr = blocks_mod.pose_error(
            g.Tcw, poses[k] @ np.linalg.inv(poses[0]))
        diag = buf[-track_step.N_DIAG:]
        print(f"[pipeline] chained frame {k} "
              f"({'anchor' if k == 1 else 'blind'}): {g.n_matches_mm} "
              f"matches, {g.n_inliers} inliers, "
              f"{int((g.assign >= 0).sum())} point ids, pose error "
              f"{dt:.5f} m {dr:.4f} deg; diagnostics n_th={int(diag[0])} "
              f"n_vis={int(diag[1])} widened={int(diag[2])} "
              f"inl1={int(diag[3])} dt={diag[4]:.4f} m "
              f"drot={diag[5]:.4f} deg")
        check(g.n_inliers >= MIN_INLIERS and dt <= MAX_POSE_ERR_M
              and dr <= MAX_POSE_ERR_DEG, f"chained frame {k}: pose")
    # the replay left the eager run's chain in the runner's buffers
    torch.cuda.synchronize()
    check(torch.equal(runner.chain.pid, chain.pid)
          and float((runner.chain.T_cur - chain.T_cur).abs().max())
          <= REPLAY_TCW_ATOL, "the replayed chain differs from the eager one")

    prof = profile_call(torch, lambda: runner.dispatch(
        *pairs[3], mir_f32, mir_desc, cand, scal).wait())
    for name, kname in KERNEL_NAMES.items():
        check(prof["counts"][name] == LAUNCHES_PER_PAIR[name],
              f"kernel {kname} ran {prof['counts'][name]} times in a "
              f"chained replay")
    replay_ms = []
    for k in range(4, 14):
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner.dispatch(*pairs[k], mir_f32, mir_desc, cand, scal).wait()
        replay_ms.append(1e3 * (time.perf_counter() - t))
    # the mirror moves (as when it grows): the runner must capture again
    # for the new address, say so, and still equal the eager step
    torch.cuda.synchronize()
    before = track_step.ChainState(*[t.clone() for t in runner.chain])
    moved = (mir_f32.clone(), mir_desc.clone())
    buf = runner.dispatch(*pairs[14], *moved, cand, scal).wait()
    out, _ = eager(up(pairs[14][0]), up(pairs[14][1]), before, *moved,
                   up(cand), up(scal))
    e, _ = track_step.unpack_track_out(out, n, M)
    g, _ = track_step.unpack_track_out(None, n, M, buf=buf)
    check(runner.captures == 2
          and runner.capture_log[-1] == (M, "mirror moved"),
          f"no new capture for a moved mirror: {runner.capture_log}")
    check(float(np.abs(e.Tcw - g.Tcw).max()) <= REPLAY_TCW_ATOL
          and np.array_equal(e.assign, g.assign),
          "the replay for a moved mirror differs from the eager step")
    print(f"[pipeline] chained replay vs eager: max Tcw diff {worst:.3g}, "
          f"point ids, inliers and vis_local equal; two dispatches returned "
          f"in {1e3 * t_dispatch:.1f} ms (capture included) with "
          f"{in_flight} frames in flight; kernels in one profiled replay "
          f"{prof['counts']}; {prof['n_device']} device kernels and copies "
          f"(the fast step's replay: {fast_nodes}); launch calls "
          f"{prof['launches']}; device busy {prof['busy_ms']:.2f} ms; "
          f"dispatch + wait median {med_ms(replay_ms):.2f} ms")
    return {"launches": launches, "nodes": prof["n_device"],
            "replay_ms": med_ms(replay_ms)}


def pipelined_run(torch, np, dev, settings, scene, scheduler: str,
                  pipelined: bool, paced: bool) -> dict:
    """Phase 8b / 8c: the 40 frames through one System after its
    precompile; returns its times and counts."""
    import copy

    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.system import System

    poses, pairs = system_frames(np, scene)
    s = copy.copy(settings)
    s.pipelined = pipelined
    tag = f"{scheduler}/{'pipelined' if pipelined else 'fast'}"
    system = System(s, Sensor.STEREO, scheduler=scheduler, device=dev)
    tracker, mapper = system.tracker, system.local_mapper
    pre = system.precompile()
    fast_step = tracker._get_fast_step()
    runner = tracker._get_chain_step()
    captures0 = (fast_step.captures, runner.captures)

    calls = []          # (kind, ms, mapper busy at the call's start)
    overlap = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    t_next = t_start
    for i, (l, r) in enumerate(pairs):
        if paced:
            while True:
                left = t_next - time.perf_counter()
                if left <= 0:
                    break
                system.poll()
                time.sleep(min(left, 0.002))
            t_next = max(t_next + FRAME_PERIOD_S, time.perf_counter())
        n_kf, anchors = system.store.n_kf, tracker.pipe_stats["anchors"]
        n_fast = (tracker.timers.counts["fast_step"]
                  + tracker.timers.counts["pipelined_step"])
        busy = not mapper.idle()
        t = time.perf_counter()
        system.track_stereo(l, r, FRAME_PERIOD_S * i)
        ms = 1e3 * (time.perf_counter() - t)
        if not mapper.idle():
            overlap += 1
        check(tracker.state.name == "OK" and tracker.resets == 0,
              f"{tag} frame {i}: lost or reset")
        stepped = (tracker.timers.counts["fast_step"]
                   + tracker.timers.counts["pipelined_step"]) > n_fast
        kind = ("keyframe" if system.store.n_kf > n_kf else
                "modular" if not stepped else
                "anchor" if tracker.pipe_stats["anchors"] > anchors else
                "blind" if pipelined else "fast")
        calls.append((kind, ms, busy))
    system.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while not mapper.idle():
        check(time.perf_counter() - t0 < QUIESCE_MAX_S,
              f"{tag}: the mapper never quiesced")
        time.sleep(0.01)
    quiesce_s = time.perf_counter() - t0
    system.shutdown()
    check(all(not w.is_alive() for w in system._workers),
          f"{tag}: a worker outlived shutdown()")
    check(len(system._workers) == (1 if scheduler == "async" else 0),
          f"{tag}: {len(system._workers)} workers")
    check_store_invariants(np, system.store)
    check(tracker.state.name == "OK" and tracker.resets == 0,
          f"{tag}: lost or reset by the end")

    errs = trajectory_errors(np, system, poses)
    check(len(errs) >= N_SYSTEM - 2, f"{tag}: only {len(errs)} entries")
    worst = (max(e[0] for e in errs.values()),
             max(e[1] for e in errs.values()))
    max_m, max_deg = ((MAX_POSE_ERR_M, MAX_POSE_ERR_DEG)
                      if scheduler == "sync" else
                      (ASYNC_MAX_POSE_ERR_M, ASYNC_MAX_POSE_ERR_DEG))
    check(worst[0] <= max_m and worst[1] <= max_deg,
          f"{tag}: pose error {worst}")
    n_kf = int(system.store.kf_valid.sum())
    check(system.store.n_kf >= MIN_KEYFRAMES, f"{tag}: {n_kf} keyframes")
    if scheduler == "async":
        check(overlap > 0, f"{tag}: the mapper never ran beside a frame")

    captures = (fast_step.captures - captures0[0],
                runner.captures - captures0[1])
    by_kind = {k: [ms for kk, ms, _ in calls if kk == k]
               for k in ("blind", "anchor", "fast", "keyframe", "modular")}
    steady = [(ms, busy) for kk, ms, busy in calls
              if kk in ("blind", "fast", "anchor")]
    idle_ms = med_ms([ms for ms, busy in steady if not busy])
    busy_ms = med_ms([ms for ms, busy in steady if busy])
    to_pose = tracker.timers.samples.get("pipe/dispatch_to_pose", [])
    wait = tracker.timers.samples.get("pipe/wait", [])
    out = {
        "metric": "pipeline_ms_per_frame", "scheduler": scheduler,
        "pipelined": pipelined, "paced_hz": 1 / FRAME_PERIOD_S if paced
        else None, "frames": N_SYSTEM, "wall_s": wall,
        "call_ms_median": {k: med_ms(v) for k, v in by_kind.items()},
        "call_ms_max": {k: (max(v) if v else None)
                        for k, v in by_kind.items()},
        "frames_by_kind": {k: len(v) for k, v in by_kind.items()},
        "steady_call_ms_mapper_idle": idle_ms,
        "steady_call_ms_mapper_busy": busy_ms,
        "steady_calls_mapper_busy": sum(b for _, b in steady),
        "dispatch_to_pose_ms_median": med_ms([1e3 * x for x in to_pose]),
        "device_wait_ms_median": med_ms([1e3 * x for x in wait]),
        "frames_mapper_busy_after_call": overlap,
        "quiesce_s": quiesce_s, "keyframes": n_kf,
        "max_pose_err_m": worst[0], "max_pose_err_deg": worst[1],
        "pipe_stats": dict(tracker.pipe_stats),
        "captures_after_precompile": {"fast_step": captures[0],
                                      "chain_step": captures[1]},
        "chain_capture_log": runner.capture_log,
        "precompile_s": pre,
    }
    if tracker._device_map is not None:
        dm = tracker._device_map
        out["mirror"] = {"flushes": dm.flushes, "rows": dm.rows_flushed,
                         "moves": dm.moves, "cap": dm.cap}
    print(f"[pipeline] {tag}{' paced 10 Hz' if paced else ''}: "
          f"{N_SYSTEM} frames in {wall:.2f} s; call ms median by kind "
          + ", ".join(f"{k} {fmt(med_ms(v))} (n={len(v)})"
                      for k, v in by_kind.items() if v)
          + f"; steady call ms with the mapper idle {fmt(idle_ms)} / busy "
          f"{fmt(busy_ms)} ({out['steady_calls_mapper_busy']} calls busy); "
          f"dispatch to applied pose {fmt(out['dispatch_to_pose_ms_median'])}"
          f" ms; device wait in a drain "
          f"{fmt(out['device_wait_ms_median'])} ms; mapper busy after "
          f"{overlap} calls; quiesced in {quiesce_s:.2f} s; {n_kf} keyframes;"
          f" max pose error {worst[0]:.4f} m {worst[1]:.4f} deg; "
          f"{tracker.pipe_stats}; mirror {out.get('mirror')}; captures after "
          f"precompile {out['captures_after_precompile']} "
          f"(chained log {runner.capture_log})")
    print("[pipeline] " + tag + " tracker stage timers:\n"
          + tracker.timers.report())
    # a capture after precompile is attributed to a candidate block that
    # outgrew its pinned bucket or to a mirror that moved, or it is a fault
    grew = tracker._buckets("local", 1) > s.bucket_local
    moved = out.get("mirror", {}).get("moves", 0) > 0
    for what, c in out["captures_after_precompile"].items():
        check(c == 0 or grew or (what == "chain_step" and moved),
              f"{tag}: {c} unattributed captures of {what} after precompile")
        if c:
            print(f"[pipeline] {tag}: {c} captures of {what} after "
                  f"precompile: candidate bucket grew={grew}, mirror "
                  f"moved={moved}")
    return out


def pipeline_phase(torch, np, dev, settings, scene, gpu, track,
                   system) -> dict:
    """Phase 8: the pipelined chain, the device map mirror, the async
    scheduler and the warm-up, at the KITTI shape."""
    from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda

    step = chain_step_check(torch, np, dev, settings, scene,
                            track["replay_nodes"])
    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    runs = {}
    for name, (scheduler, pipelined, paced) in {
            "b_sync_pipelined": ("sync", True, False),
            "c_async_fast": ("async", False, True),
            "c_async_pipelined": ("async", True, True)}.items():
        runs[name] = pipelined_run(torch, np, dev, settings, scene,
                                   scheduler, pipelined, paced)
        runs[name]["gpu"] = gpu
        print(json.dumps(runs[name]))
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    for name, c in launches.items():
        check(c > 0, f"kernel {name} was not launched by the pipeline phase")

    b = runs["b_sync_pipelined"]
    blind = b["call_ms_median"]["blind"]
    check(b["frames_by_kind"]["blind"] > 0 and b["pipe_stats"]["anchors"] > 0,
          "the pipelined run had no blind frame or no anchor")
    check(blind <= BLIND_CALL_MAX_MS,
          f"a blind frame's call takes {blind:.1f} ms: it waits for the "
          "device")
    kf_inline = system["keyframe_median_ms"]
    print(f"[pipeline] precompile seconds per program: "
          f"{b['precompile_s']}")
    print(f"[pipeline] a blind frame's call {blind:.2f} ms against the "
          f"sync fast path's {fmt(system['fast_path_median_ms'])} ms and "
          f"the chained replay's {step['replay_ms']:.2f} ms; keyframe "
          f"frames' caller ms: inline (phase 7b) {fmt(kf_inline)}, async "
          f"{fmt(runs['c_async_fast']['call_ms_median']['keyframe'])}, "
          f"async pipelined "
          f"{fmt(runs['c_async_pipelined']['call_ms_median']['keyframe'])}")
    return {"launches": {k: step["launches"][k] + launches[k]
                         for k in launches}, "runs": runs}


def alternate(fns: dict, timer, rounds: int = 4) -> dict:
    """Each of `fns` timed by `timer` in turn, the order reversed every
    round (a, b, c, then c, b, a, ...): {name: [ms of each round]}."""
    out = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            out[name].append(timer(fns[name]))
    return out


def bound_ms(n_bytes: float, ops_s: float):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations' time; and which of the two."""
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


def fast_bound(torch, levels, min_th: float):
    """FAST over `levels`: each pixel read once and its score written once;
    the operations of every pixel and, for the pixels that pass the
    kernel's compass-point early exit on these levels, of the full arc
    score."""
    from orb_slam2_tpu_torch.ops import fast

    n_px = sum(lv.numel() for lv in levels)
    n_pass = 0
    for lv in levels:
        c = fast._ring(lv)[[0, 4, 8, 12]] - lv[None]
        cn = torch.roll(c, -1, 0)
        dark = torch.minimum(c, cn).amax(0)
        bright = -torch.maximum(c, cn).amin(0)
        n_pass += int(((torch.maximum(dark, bright) - 1.0) >= min_th).sum())
    ops = n_px * FAST_OPS_PER_PX + n_pass * FAST_OPS_PER_PASSING_PX
    work = {"pixels": n_px, "pixels_past_early_exit": n_pass,
            "bytes": 8 * n_px, "ops": ops}
    return (*bound_ms(8 * n_px, ops / FP32_OPS_PER_S), work)


def describe_bound(torch, levels, xys, valids, n_rows: int):
    """Describe over one image's levels: each distinct pixel of `img` under
    a valid keypoint's circle and of `blur` under its taps read once, the
    keypoints and valid flags read once, angle and descriptor rows
    written once; float64 moments and float32 taps a valid keypoint."""
    from orb_slam2_tpu_torch.ops import brief, orientation

    dev = levels[0].device
    half = orientation.HALF_PATCH
    dv, du = [t.to(dev) - half for t in torch.nonzero(
        torch.from_numpy(orientation.circular_mask() > 0), as_tuple=True)]
    circle = taps = n_valid = n_kp = 0
    for lv, xy, v in zip(levels, xys, valids):
        h, w = lv.shape
        kp = xy[v].long()
        cx = kp[:, 0].clamp(half, w - 1 - half)[:, None]
        cy = kp[:, 1].clamp(half, h - 1 - half)[:, None]
        circle += torch.unique((cy + dv) * w + cx + du).numel()
        ang = orientation.ic_angles(lv, xy, v)[v]
        rows, cols = brief.tap_coords(h, w, xy[v], ang)
        taps += torch.unique(rows * w + cols).numel()
        n_valid += int(v.sum())
        n_kp += xy.shape[0]
    n_bytes = 4 * (circle + taps) + 9 * n_kp + (4 + 32) * n_rows
    ops_s = n_valid * (DESC_FP64_OPS_PER_KP / FP64_OPS_PER_S
                       + DESC_FP32_OPS_PER_KP / FP32_OPS_PER_S)
    work = {"circle_px": circle, "tap_px": taps, "valid": n_valid,
            "bytes": n_bytes, "fp64_ops": n_valid * DESC_FP64_OPS_PER_KP,
            "fp32_ops": n_valid * DESC_FP32_OPS_PER_KP}
    return (*bound_ms(n_bytes, ops_s), work)


def refine_bound(torch, w: int, yc, xl, xr):
    """The stereo refinement over N keypoints with these centres: each
    distinct pixel of the left 11x11 windows and the right 11x21 strips
    read once; a keypoint's xy (8 B), best_idx (8 B), best_dist (4 B) and
    the gathered right x (4 B) read once and its u_right, depth and SAD
    (12 B) written once; bf, min_disp and max_disp read once.  Ops: the
    SAD terms and the epilogue."""
    from orb_slam2_tpu_torch.ops import stereo_cuda

    dev = yc.device
    rw, rl = stereo_cuda.W, stereo_cuda.L
    d = torch.arange(-rw, rw + 1, device=dev)
    ds = torch.arange(-rw - rl, rw + rl + 1, device=dev)
    rows = (yc.long()[:, None, None] + d[None, :, None]) * w
    left = torch.unique(rows + xl.long()[:, None, None] + d[None, None, :])
    right = torch.unique(rows + xr.long()[:, None, None] + ds[None, None, :])
    n = yc.numel()
    n_bytes = 4 * (left.numel() + right.numel()) + 36 * n + 12
    ops = n * (SAD_OPS_PER_KP + REFINE_OPS_PER_KP)
    work = {"left_px": left.numel(), "right_px": right.numel(),
            "bytes": n_bytes, "ops": ops}
    return (*bound_ms(n_bytes, ops / FP32_OPS_PER_S), work)


def frontend_phases(torch, np, dev, settings, scene, poses, pairs,
                    gpu) -> dict:
    """Phases 2-5: each kernel against its plain version, the slice through
    FrameBuilder.stereo_pair, the launch counts, and the times and bounds.
    """
    from orb_slam2_tpu_torch.ops import (
        consts, fast, fast_cuda, frontend, gaussian, orb_cuda, pyramid,
        stereo, stereo_cuda,
    )
    from orb_slam2_tpu_torch.slam.frame import FrameBuilder

    # ---- 2. each kernel against its plain version --------------------------
    border = frontend.EDGE_THRESHOLD - 3
    budgets = frontend.level_budgets(N_FEATURES, 8, settings.scale_factor)
    n_rows = frontend.padded_total(N_FEATURES, 8, settings.scale_factor)
    img_l, img_r = [torch.from_numpy(im.astype(np.uint8)).to(dev)
                    for im in pairs[0]]
    per_image = []     # (levels, blurred, xys, valids) of the left, right
    fast_err = ang_err = 0.0
    n_same = n_valid = 0
    for side, img in (("left", img_l), ("right", img_r)):
        levels = pyramid.compute_pyramid(img, 8, settings.scale_factor)
        plain_maps = fast_cuda.detect_levels_plain(levels, 20, 7, border)
        multi = fast_cuda.detect_levels_cuda(levels, 20, 7, border)
        single = [fast_cuda.detect_with_fallback_cuda(lv, 20, 7, border)
                  for lv in levels]
        torch.cuda.synchronize()
        for l, (m, s1, p) in enumerate(zip(multi, single, plain_maps)):
            fast_err = max(fast_err, float((m - p).abs().max()),
                           float((s1 - p).abs().max()))
            check(torch.equal(m, p), f"FAST map ({side}, 8 levels a "
                  f"launch) differs at level {l}")
            check(torch.equal(s1, p), f"FAST map ({side}, one level a "
                  f"launch) differs at level {l}")
            check(int((p > 0).sum()) > 0, "FAST found no corners")
        print(f"[fast] {side}: 8 levels {[tuple(lv.shape) for lv in levels]}"
              f" exactly equal, as one launch and as one launch a level")

        picks = [fast.select_topk_grid(p, b, 24)
                 for p, b in zip(plain_maps, budgets)]
        xys, _, valids = zip(*picks)
        blurred = [gaussian.blur7x7(lv) for lv in levels]
        ka, kd = orb_cuda.describe_levels_cuda(levels, blurred, xys, valids,
                                               n_rows)
        pa, pd = orb_cuda.describe_levels_plain(levels, blurred, xys, valids,
                                                n_rows)
        sa, sd = zip(*[orb_cuda.describe_oriented_cuda(*a)
                       for a in zip(levels, blurred, xys, valids)])
        torch.cuda.synchronize()
        n_kp = sum(budgets)
        valid = torch.cat([*valids, valids[0].new_zeros(n_rows - n_kp)])
        ang_err = max(ang_err, float(circ_diff(ka, pa)[valid].max()))
        same = int((kd == pd).all(1)[valid].sum())
        n_same += same
        n_valid += int(valid.sum())
        check(bool((kd[~valid] == 0).all()) and bool((ka[~valid] == 0).all()),
              "descriptor or angle of an invalid or padding row")
        check(torch.equal(torch.cat(sa), ka[:n_kp])
              and torch.equal(torch.cat(sd), kd[:n_kp]),
              "describe as one launch a level differs from one launch")
        print(f"[describe] {side}: budgets {budgets}, {n_rows} rows: "
              f"descriptors identical on {same}/{int(valid.sum())} valid "
              f"keypoints; one launch a level equals one launch")
        per_image.append((levels, blurred, xys, valids))
    desc_share = n_same / max(n_valid, 1)
    print(f"[describe] both images: max angle err {ang_err:.3g} deg, "
          f"descriptors identical on {n_same}/{n_valid} = "
          f"{100 * desc_share:.3f}% of valid keypoints")
    check(ang_err <= ANGLE_ATOL_DEG, f"angle error {ang_err} deg")
    check(desc_share >= DESC_MIN_SHARE, f"descriptor share {desc_share}")

    # the stereo refinement: the fused launch against refine_plain, its
    # scores and the scores-only kernel's against sad_strips_plain
    bf_t, lo_t, hi_t = (consts.scalar(v, dev) for v in (BF, 0.0, FX))

    def check_refine(lf, rf, xy_l, xy_r, best_idx, best_dist, what):
        scores = torch.empty((xy_l.shape[0], 2 * stereo_cuda.L + 1),
                             device=dev)
        args = (lf, rf, xy_l, xy_r, best_idx, best_dist, bf_t, lo_t, hi_t)
        k = stereo_cuda.refine_cuda(*args, scores=scores)
        p = stereo_cuda.refine_plain(*args)
        cen = stereo_cuda.centres(xy_l, xy_r, best_idx, *lf.shape)
        ks = stereo_cuda.sad_strips_cuda(lf, rf, *cen)
        ps = stereo_cuda.sad_strips_plain(lf, rf, *cen)
        torch.cuda.synchronize()
        err = max(float(torch.where(a == b, 0.0, (a - b).abs()).max())
                  for a, b in zip((*k, scores, ks), (*p, ps, ps)))
        print(f"[refine] {what}: N={xy_l.shape[0]}, {int((p[1] > 0).sum())}"
              f" depths; u_right/depth/sad equal "
              f"{[torch.equal(a, b) for a, b in zip(k, p)]}, scores equal "
              f"{torch.equal(scores, ps)}, scores-only kernel equal "
              f"{torch.equal(ks, ps)}; max abs err {err}")
        for name, a, b in zip(("u_right", "depth", "sad"), k, p):
            check(torch.equal(a, b), f"refine {name} differs ({what})")
        check(torch.equal(scores, ps) and torch.equal(ks, ps),
              f"SAD scores differ ({what})")
        return err

    rng = np.random.default_rng(0)
    n = n_rows
    xy_l = np.stack([rng.uniform(-4, W + 4, n), rng.uniform(-4, H + 4, n)], 1)
    best_idx = rng.permutation(n)
    xy_r = np.empty_like(xy_l)
    xy_r[best_idx] = xy_l - np.stack([rng.uniform(-5, 70, n), np.zeros(n)], 1)
    rand = [torch.from_numpy(a).to(dev) for a in (
        xy_l.astype(np.float32), xy_r.astype(np.float32), best_idx,
        rng.integers(0, 100, n).astype(np.int32))]
    sad_err = check_refine(img_l.float(), img_r.float(), *rand,
                           "random matches")
    sf = torch.from_numpy(settings.scale_factors().astype(np.float32)).to(dev)
    real = []     # the real step-1/2 matches of each pair, for the timing
    for i, pair in enumerate(pairs):
        il, ir = [torch.from_numpy(im.astype(np.uint8)).to(dev) for im in pair]
        fl, fr = [frontend.extract(im, N_FEATURES, settings.n_levels,
                                   settings.scale_factor,
                                   settings.ini_th_fast, settings.min_th_fast)
                  for im in (il, ir)]
        bi, bd = stereo.row_matches(fl.xy, fl.octave, fl.desc, fl.valid,
                                    fr.xy, fr.octave, fr.desc, fr.valid, sf,
                                    lo_t, hi_t)
        real.append((il.float(), ir.float(), fl.xy, fr.xy, bi, bd))
        sad_err = max(sad_err, check_refine(*real[-1],
                                            f"pair {i} Hamming matches"))

    # ---- 3. the slice, through the kernels ---------------------------------
    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    stereo_cuda.strips_launches = 0
    builder = FrameBuilder(settings, device=dev)
    frames = [builder.stereo_pair(l, r, 0.1 * i)
              for i, (l, r) in enumerate(pairs)]
    torch.cuda.synchronize()
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    strips_launches = stereo_cuda.strips_launches

    plain_builder = FrameBuilder(settings, device=dev, plain=True)
    plain_frames = [plain_builder.stereo_pair(l, r, 0.1 * i)
                    for i, (l, r) in enumerate(pairs)]
    depth_errs = []
    for i, (T, f, pf) in enumerate(zip(poses, frames, plain_frames)):
        ff, pff = f.feats, pf.feats
        n_valid = int(ff.valid.sum())
        has_d = ff.valid & (ff.depth > 0)
        xy = np.rint(ff.xy[has_d]).astype(int)
        xy[:, 0] = xy[:, 0].clip(0, W - 1)
        xy[:, 1] = xy[:, 1].clip(0, H - 1)
        truth = scene.depth_at(T)[xy[:, 1], xy[:, 0]]
        err = float(np.median(np.abs(ff.depth[has_d] - truth) / truth))
        depth_errs.append(err)
        same_desc = float((ff.desc == pff.desc).all(1)[ff.valid].mean())
        same_depth = float((np.sign(ff.depth) == np.sign(pff.depth)).mean())
        same_stereo = float(((ff.ur == pff.ur) & (ff.depth == pff.depth))
                            .mean())
        print(f"[slice] frame {i}: {n_valid} valid, {int(has_d.sum())} depths, "
              f"median depth err {100 * err:.3f}%, vs plain path: xy/octave/"
              f"valid equal={np.array_equal(ff.xy, pff.xy)}/"
              f"{np.array_equal(ff.octave, pff.octave)}/"
              f"{np.array_equal(ff.valid, pff.valid)}, descriptors "
              f"{100 * same_desc:.3f}%, matched set {100 * same_depth:.3f}%, "
              f"u_right and depth equal on {100 * same_stereo:.3f}% of rows")
        check(ff.xy.shape == (n_rows, 2) and np.isfinite(ff.xy).all(),
              "xy shape or values")
        check(n_valid >= MIN_VALID, f"frame {i}: {n_valid} valid features")
        check(int(has_d.sum()) >= MIN_DEPTHS, f"frame {i}: too few depths")
        check(err <= MAX_MEDIAN_DEPTH_ERR, f"frame {i}: depth error {err}")
        check(np.array_equal(ff.xy, pff.xy)
              and np.array_equal(ff.octave, pff.octave)
              and np.array_equal(ff.valid, pff.valid),
              f"frame {i}: kernel and plain paths differ in xy/octave/valid")
        check(same_stereo >= STEREO_MIN_SHARE,
              f"frame {i}: u_right/depth equal on only {same_stereo}")

    # ---- 4. launch counts --------------------------------------------------
    print(f"[counts] launches during the slice ({N_PAIRS} stereo pairs): "
          f"{launches}; scores-only stereo launches {strips_launches}")
    check(strips_launches == 0, "the slice launched the scores-only kernel")
    for name, n in launches.items():
        check(n == LAUNCHES_PER_PAIR[name] * N_PAIRS,
              f"kernel {name}: {n} launches for {N_PAIRS} pairs, expected "
              f"{LAUNCHES_PER_PAIR[name]} a pair")

    # ---- 5. times ----------------------------------------------------------
    for b in (builder, plain_builder):   # warm-up
        b.stereo_pair(*pairs[0], 0.0)
    frame_ms = {"kernel": [], "plain": []}
    for i in range(N_TIMED):
        l, r = pairs[i % N_PAIRS]
        order = (("kernel", builder), ("plain", plain_builder))
        for name, b in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            b.stereo_pair(l, r, 0.0)
            torch.cuda.synchronize()
            frame_ms[name].append(1e3 * (time.perf_counter() - t))
    print(json.dumps({
        "metric": "stereo_pair_ms_per_frame", "shape": [H, W],
        "n_features": N_FEATURES, "frames": N_TIMED,
        "kernel_ms": statistics.median(frame_ms["kernel"]),
        "plain_ms": statistics.median(frame_ms["plain"]), "gpu": gpu}))

    # each kernel on the left image: one launch over the 8 levels, the
    # same kernel as 8 one-level launches, and the plain version
    levels, blurred, xys, valids = per_image[0]
    # the stereo refinement on pair 0's Hamming matches
    lf0, rf0, xyl0, xyr0, bi0, bd0 = real[0]
    cen0 = stereo_cuda.centres(xyl0, xyr0, bi0, H, W)
    refine_args = (lf0, rf0, xyl0, xyr0, bi0, bd0, bf_t, lo_t, hi_t)

    def unfused_step3():
        yc, xl, xr = stereo_cuda.centres(xyl0, xyr0, bi0, H, W)
        scores = stereo_cuda.sad_strips_cuda(lf0, rf0, yc, xl, xr)
        return stereo_cuda.refine_from_scores(scores, xyl0[:, 0], xr, bd0,
                                              bf_t, lo_t, hi_t)

    variants = {
        "fast": {
            "kernel": lambda: fast_cuda.detect_levels_cuda(levels, 20, 7,
                                                           border),
            "kernel_8": lambda: [fast_cuda.detect_with_fallback_cuda(
                lv, 20, 7, border) for lv in levels],
            # min_th far below any score: no pixel takes the early exit
            "kernel_no_exit": lambda: fast_cuda.detect_levels_cuda(
                levels, 20, NO_EXIT_MIN_TH, border),
            "plain": lambda: fast_cuda.detect_levels_plain(levels, 20, 7,
                                                           border)},
        "orb": {
            "kernel": lambda: orb_cuda.describe_levels_cuda(
                levels, blurred, xys, valids, n_rows),
            "kernel_8": lambda: [orb_cuda.describe_oriented_cuda(*a)
                                 for a in zip(levels, blurred, xys, valids)],
            "plain": lambda: orb_cuda.describe_levels_plain(
                levels, blurred, xys, valids, n_rows)},
        "stereo": {
            "kernel": lambda: stereo_cuda.refine_cuda(*refine_args),
            "unfused": unfused_step3,
            "scores": lambda: stereo_cuda.sad_strips_cuda(lf0, rf0, *cen0),
            "plain": lambda: stereo_cuda.refine_plain(*refine_args)},
    }
    times = {}
    for name, fns in variants.items():
        ev = alternate(fns, lambda fn: cuda_ms(torch, fn))
        gr = alternate(fns, lambda fn: graph_ms(torch, fn))
        times[name] = {**{k: statistics.median(v) for k, v in ev.items()},
                       **{f"graph_{k}": statistics.median(v)
                          for k, v in gr.items()},
                       "graph_kernel_range": [min(gr["kernel"]),
                                              max(gr["kernel"])]}
    # the fused launch at three N: its fixed cost against its cost a keypoint
    sweep_fns = {n: (lambda n=n: stereo_cuda.refine_cuda(
        lf0, rf0, xyl0[:n], xyr0, bi0[:n], bd0[:n], bf_t, lo_t, hi_t))
        for n in (256, 1024, 2048) if n <= n_rows}
    sweep_ev = alternate(sweep_fns, lambda fn: cuda_ms(torch, fn))
    sweep_gr = alternate(sweep_fns, lambda fn: graph_ms(torch, fn))
    sweep_bb = alternate(sweep_fns, lambda fn: back_to_back(
        torch, fn, KERNEL_NAMES["stereo"]))
    sweep = {n: {"ms": statistics.median(sweep_ev[n]),
                 "graph_ms": statistics.median(sweep_gr[n]),
                 "graph_ms_range": [min(sweep_gr[n]), max(sweep_gr[n])],
                 "back_to_back_ms": statistics.median(
                     b["graph_ms"] for b in sweep_bb[n]),
                 "device_ms": statistics.median(
                     b["device_ms"] for b in sweep_bb[n])}
             for n in sweep_fns}
    print(f"[times] stereo refinement by N (events / graph / {BACK_TO_BACK} "
          f"back to back in a graph / device ms): " + "; ".join(
              f"N={n} {v['ms']:.4f} / {v['graph_ms']:.4f} (rounds "
              f"{v['graph_ms_range']}) / {v['back_to_back_ms']:.4f} / "
              f"{v['device_ms']:.4f}" for n, v in sweep.items()))
    times["stereo"]["n_sweep"] = sweep
    # each kernel back to back in one graph, and its device duration
    b2b = {("fast", "kernel", KERNEL_NAMES["fast"]),
           ("orb", "kernel", KERNEL_NAMES["orb"]),
           ("stereo", "kernel", KERNEL_NAMES["stereo"]),
           ("stereo", "scores", "sad_strips_kernel")}
    for name, variant, kname in sorted(b2b):
        runs = [back_to_back(torch, variants[name][variant], kname)
                for _ in range(3)]
        times[name][f"back_to_back_{variant}"] = {
            k: statistics.median(r[k] for r in runs)
            for k in ("graph_ms", "device_ms")}
    bounds = {"fast": fast_bound(torch, levels, 7.0),
              "orb": describe_bound(torch, levels, xys, valids, n_rows),
              "stereo": refine_bound(torch, W, *cen0)}
    for name, (b_ms, b_by, work) in bounds.items():
        t = times[name]
        print(f"[times] {name}: kernel {t['kernel']:.4f} ms events, "
              f"{t['graph_kernel']:.4f} ms in a graph "
              f"(rounds {t['graph_kernel_range']}); "
              + (f"as 8 one-level launches {t['kernel_8']:.4f} / "
                 f"{t['graph_kernel_8']:.4f} ms; " if "kernel_8" in t else "")
              + (f"with no pixel past the early exit {t['kernel_no_exit']:.4f}"
                 f" / {t['graph_kernel_no_exit']:.4f} ms; "
                 if "kernel_no_exit" in t else "")
              + (f"unfused step 3 {t['unfused']:.4f} / "
                 f"{t['graph_unfused']:.4f} ms; scores-only launch "
                 f"{t['scores']:.4f} / {t['graph_scores']:.4f} ms; "
                 if "unfused" in t else "")
              + f"plain {t['plain']:.3f} / {t['graph_plain']:.3f} ms; "
              + "".join(f"{v} {BACK_TO_BACK} back to back in a graph "
                        f"{t[f'back_to_back_{v}']['graph_ms']:.4f} ms a "
                        f"launch, device "
                        f"{t[f'back_to_back_{v}']['device_ms']:.4f} ms; "
                        for v in ("kernel", "scores")
                        if f"back_to_back_{v}" in t)
              + f"bound {1e3 * b_ms:.3f} us by {b_by} {work}; share of bound "
              f"(bound / graph time) {100 * b_ms / t['graph_kernel']:.1f}%, "
              f"(bound / device time) "
              f"{100 * b_ms / t['back_to_back_kernel']['device_ms']:.1f}%")

    return {"launches": launches, "times": times, "bounds": bounds,
            "errs": {"fast": fast_err, "orb": ang_err, "stereo": sad_err},
            "desc_share": desc_share, "n_rows": n_rows,
            "n_kp": sum(budgets)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    from orb_slam2_tpu_torch.config import Settings
    from orb_slam2_tpu_torch.ops import cuda_build
    from synthetic import CylinderScene, circle_trajectory

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    so = cuda_build.build()
    cuda_build.library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for ln in so.with_suffix(".log").read_text().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"[build] {ln.strip()}")

    # ---- the data: rendered KITTI-shaped stereo pairs ----------------------
    settings = Settings(fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=W, height=H,
                        n_features=N_FEATURES, fps=10.0, th_depth=9.5)
    scene = CylinderScene(settings.K, H, W, radius=8.0, tex_h=2048)
    poses = circle_trajectory(240, orbit_r=3.0,
                              total_angle=2 * np.pi * 1.5)[::48][:N_PAIRS]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BF / FX
    pairs = [(scene.render(T), scene.render(Trl @ T)) for T in poses]

    # ---- 2-5. the kernels, the slice, the counts, the times -------------
    front = frontend_phases(torch, np, dev, settings, scene, poses, pairs,
                            gpu)
    launches, times, bounds = (front["launches"], front["times"],
                               front["bounds"])
    n_rows = front["n_rows"]

    # ---- 6. the fused tracking step, one CUDA graph a frame --------------
    track = track_phase(torch, np, dev, settings, scene, gpu)

    # ---- 7. the stereo System: golden, KITTI-shaped run, one local BA ------
    golden_phase(np, dev)
    system = system_phase(torch, np, dev, settings, scene, gpu)

    # ---- 8. the pipelined chain, the mirror, the async scheduler ----------
    pipeline = pipeline_phase(torch, np, dev, settings, scene, gpu, track,
                              system)
    meta = {
        "fast": ("fast_detect_with_fallback", "orb_slam2_tpu_torch/csrc/fast.cu",
                 "orb_slam2_tpu/ops/fast_pallas.py:137", front["errs"]["fast"],
                 "8 pyramid levels of one 376x1240 image, one launch"),
        "orb": ("orb_describe_oriented", "orb_slam2_tpu_torch/csrc/orb.cu",
                "orb_slam2_tpu/ops/orb_pallas.py:174", front["errs"]["orb"],
                f"8 levels' budgets of one image ({front['n_kp']} keypoints "
                f"in {n_rows} rows), one launch; max_abs_err is the angle "
                "in degrees"),
        "stereo": ("stereo_refine", "orb_slam2_tpu_torch/csrc/stereo.cu",
                   "orb_slam2_tpu/ops/stereo_pallas.py:125",
                   front["errs"]["stereo"],
                   f"N={n_rows} keypoints on level 0 (pair 0's Hamming "
                   "matches): SAD scores, best shift, parabola and depth in "
                   "one launch"),
    }
    kernels = []
    for key, (name, source, replaces, err, per) in meta.items():
        t = times[key]
        b_ms, b_by, work = bounds[key]
        k = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[key],
             "max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             "graph_ms": t["graph_kernel"],
             "plain_graph_ms": t["graph_plain"],
             "share_of_bound_graph": b_ms / t["graph_kernel"],
             "launches_per_stereo_frame": launches[key] / N_PAIRS,
             "launches_track_step": track["launches"][key],
             "launches_system": system["launches"][key],
             "launches_pipeline": pipeline["launches"][key],
             "bound_work": work, "per": per}
        if "kernel_8" in t:
            k["ms_8_launches"] = t["kernel_8"]
            k["graph_ms_8_launches"] = t["graph_kernel_8"]
        if "kernel_no_exit" in t:
            k["graph_ms_no_early_exit"] = t["graph_kernel_no_exit"]
        k["back_to_back_graph_ms"] = t["back_to_back_kernel"]["graph_ms"]
        k["device_ms"] = t["back_to_back_kernel"]["device_ms"]
        if "unfused" in t:
            k["scores_only_back_to_back"] = t["back_to_back_scores"]
            k["unfused_ms"] = t["unfused"]
            k["graph_unfused_ms"] = t["graph_unfused"]
            k["scores_only_ms"] = t["scores"]
            k["graph_scores_only_ms"] = t["graph_scores"]
            k["n_sweep"] = t["n_sweep"]
        if key == "orb":
            k["desc_identical_share"] = front["desc_share"]
        kernels.append(k)
    for k in kernels:
        print(json.dumps({"metric": "kernel_ms", "name": k["name"],
                          "ms": k["ms"], "plain_ms": k["plain_ms"],
                          "graph_ms": k["graph_ms"],
                          "plain_graph_ms": k["plain_graph_ms"],
                          "bound_ms": k["bound_ms"],
                          "share_of_bound_graph": k["share_of_bound_graph"],
                          "per": k["per"], "gpu": gpu}))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
