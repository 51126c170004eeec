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
                 (none expected);
  9. places  place recognition, relocalization and loop closing with a
             vocabulary trained on the scene's own descriptors (30 rendered
             views, k=10, L=4), at the KITTI shape:
             (a) the solvers on the card against the port's own CPU run on
                 the same seeded inputs at the pinned bucket shapes: the
                 vocabulary descent (2048 descriptors, k=10 / L=3: node and
                 word ids equal), horn_align (1e-5), solve_pnp_ransac (256
                 rows, 128 x 6 samples, 30% outliers: the same success,
                 inlier masks equal on >= 99% of rows, pose within 1e-3 m /
                 0.05 deg of the truth), solve_sim3_ransac + refine_sim3
                 (512 rows, scale fixed and free: R, t, s within 1e-4 of
                 the CPU's, masks equal on >= 99% of rows), and
                 pose_graph.optimize dense (K = 64, E = 512) and cg on a
                 drifted ring (camera centres within 1e-3 m of the CPU's);
                 each one's ms by CUDA events;
             (b) relocalization through System: phase 7b's 40 frames, 5
                 black pairs, then mapped poses again: LOST after the black
                 frames, OK again within 3 frames, relocalizations >= 1,
                 the first OK frame within 0.1 m of the truth; its ms;
             (c) a loop closed through System (sync scheduler) on the 240
                 frames of circle_trajectory(240, orbit_r=3, 3 pi), 1.5
                 orbits, after System.precompile() with its reloc, loop and
                 gba stages: loops_closed >= 1, loop_detected, a finished
                 global BA, keyframe ATE <= 0.5 m, the store's invariants,
                 no capture after precompile; the closing pass's ms by
                 stage and the global BA's seconds; the ATE of the same
                 frames with the loop closer disabled;
             (d) the 300-keyframe drifted ring map of tests/test_scale.py
                 through _correct_loop + _optimize_essential_graph (cg, 20
                 x 1024 eager CG steps) on the card: finite poses, the loop
                 edge, the tail within 1.0 m of the truth; its seconds;
             (e) phase 8c's async pipelined 40 frames at 10 Hz once more
                 with the vocabulary, three threads on the card: 8c's
                 gates, two workers, shutdown() returns within its timeout.

  10. mono  monocular SLAM at the KITTI shape (KITTI 00-02's monocular
             settings: the same camera, 2000 features):
             (a) the H/F initializer on the card against the port's own CPU
                 run on seeded matches at KITTI intrinsics (N = 2048 and
                 4096, an init attempt's rows; 30% outliers): a general scene (F chosen), a plane (H
                 chosen) and a pure rotation (must fail): the same success
                 and model, R21 within 1e-3, t21 direction cos >= 0.9999,
                 good_mask equal on >= 99% of rows; search_for_initialization
                 on two rendered frames' init-budget features: idx and ok
                 equal; the ms of each by CUDA events;
             (b) FAST and describe at the init budget (4000 features, 4096
                 rows) on 5 rendered frames against their plain versions
                 with phase 2's gates; FrameBuilder.monocular with and
                 without init_boost: xy / octave / valid equal to the plain
                 path, exactly one FAST and one describe launch an image and
                 no stereo launch;
             (c) after a mono init through System, the fused mono step
                 (build_track_step(..., "mono")) replayed as a CUDA graph on
                 the next 8 frames: replay == eager (Tcw within 1e-5, assign
                 and inliers equal), kernel path == plain path (Tcw within
                 1e-4), a profiled replay runs 1 FAST, 1 describe and 0
                 stereo kernels; its node count beside phase 6's;
             (d) bench.py's mono pass (bench.py:304-336) through
                 System(MONOCULAR, vocabulary, scheduler="async") with
                 settings.pipelined asked for and demoted, after
                 System.precompile(): circle_trajectory(720, 3 m, 3 pi),
                 0.75 deg a frame, paced at 10 Hz with prefetch between
                 frames; healthy by bench.py's rule (final state OK, >= 3
                 keyframes, no reset, a loop closed or the Sim3-aligned
                 keyframe ATE <= 0.5 m), no capture after precompile; the
                 init frame and its ms by stage, frame ms p50 / p90 / worst,
                 keyframes, loops, ATE;
             (e) the grid mapper attached before (d)'s first frame: free
                 and occupied cells, a closed loop rebuilds it,
                 save_grid_map_tum writes the 450x300 file.

  11. viz/multi  the viewers and multi-device at the KITTI shape:
             (a) viz/ar.py's fit_plane on the card against the port's own
                 CPU run on seeded clouds (tests/test_ar.py's, N = 160 with
                 25% outliers and S = 100; N = 2048 with 30% outliers at
                 S = 50, the reference's count, and S = 1024): the same ok,
                 normals and d within 1e-4 after sign alignment, inlier
                 masks equal on >= 99% of points; the ms of each by events;
             (b) 20 KITTI-shaped stereo pairs of synthetic.PlaneScene along
                 straight_trajectory through System(STEREO) (sync), then
                 ARViewer.detect_plane on the card: the plane normal within
                 cos 0.999 of the rendered one, its offset within 2%;
             (c) where cv2 imports, the same frames through
                 System(use_viewer=True): /state OK, /map.jpg a JPEG, the
                 menu's localization mode applied by the next frame both
                 ways, no render error, the fast-path frames' median ms
                 beside (b)'s without the viewer; where cv2 does not
                 import, System(use_viewer=True) raises ImportError naming
                 cv2;
             (d) multi-device over NCCL, one rank on this card:
                 extract_batch_sharded on 4 of phase 6's left images equal
                 to frontend.extract; track_step_sharded on 4 of phase 6's
                 frames against its map, Tcw within 1e-5 of the unsharded
                 step, assign and inliers equal; optimize_sharded (cg, 5
                 iterations) on synthetic_ba_problem(64 cameras, 8192
                 points, 65536 edges) against ba.optimize, both with
                 index_add_'s deterministic route: cam_T within 1e-4,
                 points within 1e-3 m, error within 1e-4 relative; its ms
                 beside the unsharded ms (default route), the all-reduces
                 an LM iteration, and two default-route solves' spread.

  12. bench  bench_torch.py, the port's bench.py, run in this process at
             its full depth (BENCH_FRAMES=240: mono 720 frames, the kidnap
             at frame 60) with phase 9's vocabulary where phase 9 ran:
             its last line has exactly bench.py's keys (read from
             bench.py's source); all five passes ran; no graph capture
             inside any timed window; the unpipelined, pipelined and
             kidnap passes healthy by bench.py's rule, the kidnap pass
             relocalized; FAST, describe and the stereo refinement
             launched inside each stereo pass's window (the wrappers'
             counts).  Mono's and RGB-D's health is printed, not gated
             (phase 10d gates mono's).

Every phase's seconds and the whole script's are printed.  `--phases`
(e.g. `--phases 9`) runs the build and only the named phases, for
development: the kernels line is then left out (`--phases 11` runs
phase 6 first, whose frames 11d shards).  The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels with
their launch counts, errors and times.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# torch.profiler leaves its CUPTI callbacks attached after a profiled call,
# and every later launch in the process pays for them: with them attached
# the launch of the ~21,700-node chained graph takes ~12 ms of host time,
# without them ~1.4 ms, and every eager stage runs 1.5-2x slower.  Ask
# Kineto to detach after each profile, so that only the profiled calls
# themselves carry the profiler's cost.  (Set before torch is imported.)
os.environ.setdefault("TEARDOWN_CUPTI", "1")

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

# the places phase
HORN_ATOL = 1e-5
PNP_MAX_ERR_M, PNP_MAX_ERR_DEG = 1e-3, 0.05
SIM3_ATOL = 1e-4
MASK_MIN_SHARE = 0.99
PG_MAX_DEV_M = 1e-3
N_BLACK = 5                    # bench.py's kidnap window
RELOC_WITHIN_FRAMES = 3
RELOC_MAX_ERR_M = 0.1
N_CIRCUIT = 240                # 1.5 orbits, bench.py's circuit
LOOP_MAX_ATE_M = 0.5           # bench.py's drift-corrected bound
RING_KEYFRAMES = 300
RING_MAX_TAIL_ERR_M = 1.0
SHUTDOWN_MAX_S = 60.0

# the mono phase: bench.py's mono pass, 720 frames of the 1.5-orbit
# circuit (0.75 deg a frame), KITTI 00-02's monocular settings
MONO_FRAMES = 720
MONO_INIT_ROWS = 4096          # padded_total(2 * N_FEATURES): init frames
MONO_MATCH_ROWS = (2048, MONO_INIT_ROWS)   # the initializer's test rows
MONO_OUTLIERS = 0.3
MONO_R_ATOL = 1e-3
MONO_T_MIN_COS = 0.9999
N_MONO_TRACK = 8               # fast-path frames after the init
MONO_GRID_CELLS_PER_UNIT = 20.0
MONO_GRID_HALF = 5.0           # the grid's half width in map units
# phase 11: the viewers and multi-device
PLANE_CASES = (("test_ar", 3, 120, 40, 100),      # (name, seed, inliers,
               ("kitti S=50", 11, 1434, 614, 50),  # outliers, hypotheses)
               ("kitti S=1024", 12, 1434, 614, 1024))
PLANE_ATOL = 1e-4
PLANE_MASK_SHARE = 0.99
AR_FRAMES = 20
AR_MIN_COS = 0.999
AR_MAX_D_REL = 0.02
N_SHARDED = 4                  # frames of the sharded extraction and step
SHARDED_BA = dict(n_cams=64, n_pts=8192, n_edges=65536)
SHARDED_BA_ITERS = 5
SHARDED_CAM_ATOL = 1e-4
SHARDED_PTS_ATOL = 1e-3
SHARDED_ERR_RTOL = 1e-4
VIEWER_WAIT_S = 10.0

# the bench phase: bench_torch.py at its own depth.  BENCH_FRAMES spreads
# the same 1.5 orbits over fewer frames, and at 60 (9 deg a frame) or 120
# (4.5 deg) the unpipelined stereo pass drifted to a keyframe ATE of
# 1.8-3.4 m in 4 of 6 runs on the H100 (healthy only when its loop closed)
BENCH_SMOKE_FRAMES = 240
# each pass's frames in units of BENCH_FRAMES, in bench.py's order
BENCH_PASS_FRAMES = {"mono": 3, "rgbd": 1, "unpipelined": 1, "pipelined": 1,
                     "kidnap": 1}
BENCH_STEREO_PASSES = ("unpipelined", "pipelined", "kidnap")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


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
    for attempt in range(2):
        prof = profile_call(torch, graph.replay)
        runs = [v for name, v in prof["device_ms_by_name"].items()
                if kname in name]
        count = sum(c for c, _ in runs)
        if count or attempt:
            break
        # a replay that ran shows its kernels; a trace with none of them
        # was lost by the profiler (seen once in ~40 profiles on the
        # H100 machine, torch 2.11): profile the same replay once more
        print(f"[profile] {kname}: none of the replay's kernels in its "
              f"trace ({prof['n_device']} device events); profiling again")
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
            "replay_nodes": prof_graph["n_device"],
            "frames": [args for args, _ in frames]}


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
                  pipelined: bool, paced: bool, vocabulary=None) -> dict:
    """Phase 8b / 8c / 9e: the 40 frames through one System after its
    precompile; returns its times and counts.  With a vocabulary the loop
    closer runs too (on a second worker under the async scheduler)."""
    import copy

    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.system import System

    poses, pairs = system_frames(np, scene)
    s = copy.copy(settings)
    s.pipelined = pipelined
    tag = (f"{scheduler}/{'pipelined' if pipelined else 'fast'}"
           f"{'/vocabulary' if vocabulary is not None else ''}")
    system = System(s, Sensor.STEREO, vocabulary=vocabulary,
                    scheduler=scheduler, device=dev)
    tracker, mapper = system.tracker, system.local_mapper
    closer = system.loop_closer
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
    while not (mapper.idle() and (closer is None or closer.idle())):
        check(time.perf_counter() - t0 < QUIESCE_MAX_S,
              f"{tag}: the workers never quiesced")
        time.sleep(0.01)
    quiesce_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    system.shutdown()
    shutdown_s = time.perf_counter() - t0
    check(shutdown_s < SHUTDOWN_MAX_S and
          all(not w.is_alive() for w in system._workers),
          f"{tag}: a worker outlived shutdown() ({shutdown_s:.1f} s)")
    n_workers = (0 if scheduler == "sync" else 1 if closer is None else 2)
    check(len(system._workers) == n_workers,
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
        "quiesce_s": quiesce_s, "shutdown_s": shutdown_s,
        "workers": len(system._workers), "keyframes": n_kf,
        "loop_closer_passes": (closer.timers.counts["loop/detect"]
                               if closer is not None else None),
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


# ---------------------------------------------------------------------------
# phase 9: place recognition, relocalization, loop closing
# ---------------------------------------------------------------------------

def _world(rng, np, n):
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                     rng.uniform(4, 10, n)], -1).astype(np.float32)


def _small_pose(rng, np, rot, trans):
    """A 4x4 pose from a rotation vector ~ N(0, rot) and a translation ~
    N(0, trans), by Rodrigues' formula in float64."""
    w = rng.normal(0, rot, 3)
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + (np.sin(th) / th) * Kx \
        + ((1 - np.cos(th)) / th ** 2) * (Kx @ Kx)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = rng.normal(0, trans, 3)
    return T


def _pixels(np, pc):
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                     FY * pc[:, 1] / pc[:, 2] + CY], -1).astype(np.float32)


def _ring_problem(np, K, n_edges, drift_yaw, drift_step):
    """A drifted ring of K keyframes with exact relative measurements
    (tests/test_ba.py's ring): the ring's K edges, then chords, padded
    with masked edges to n_edges.  Returns the problem's numpy fields and
    the true camera centres."""
    th = 2 * np.pi * np.arange(K) / K
    Cs = np.stack([6 * np.cos(th), 6 * np.sin(th), np.zeros(K)], -1)
    c, s_ = np.cos(th), np.sin(th)
    Rw = np.zeros((K, 3, 3))
    Rw[:, 0, 0], Rw[:, 0, 1], Rw[:, 1, 0], Rw[:, 1, 1] = c, -s_, s_, c
    Rw[:, 2, 2] = 1.0
    R_true = Rw.transpose(0, 2, 1).astype(np.float32)
    t_true = -np.einsum("kij,kj->ki", R_true, Cs).astype(np.float32)
    R_est, t_est = R_true.copy(), t_true.copy()
    accR, acct = np.eye(3), np.zeros(3)
    cy, sy = np.cos(drift_yaw), np.sin(drift_yaw)
    dR = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    for k in range(K):
        R_est[k] = R_true[k] @ accR.T
        t_est[k] = t_true[k] - R_true[k] @ accR.T @ acct
        accR = accR @ dR
        acct = acct + np.asarray(drift_step)
    pairs = [(k, (k + 1) % K) for k in range(K)]
    pairs += [(k, (k + 5) % K) for k in range(0, K, 4)]
    pairs = pairs[:n_edges]
    E = len(pairs)
    ei = np.array([p[0] for p in pairs] + [0] * (n_edges - E), np.int64)
    ej = np.array([p[1] for p in pairs] + [0] * (n_edges - E), np.int64)
    mR = np.tile(np.eye(3, dtype=np.float32), (n_edges, 1, 1))
    mt = np.zeros((n_edges, 3), np.float32)
    for e, (i, j) in enumerate(pairs):
        mR[e] = R_true[j] @ R_true[i].T
        mt[e] = t_true[j] - mR[e] @ t_true[i]
    fields = dict(
        R=R_est, t=t_est, s=np.ones(K, np.float32),
        fixed=np.arange(K) == 0, vmask=np.ones(K, bool),
        edge_i=ei, edge_j=ej, meas_R=mR, meas_t=mt,
        meas_s=np.ones(n_edges, np.float32),
        emask=np.arange(n_edges) < E)
    return fields, Cs


def place_solvers_check(torch, np, dev, gpu) -> dict:
    """Phase 9a: each place-recognition solver on the card against the
    port's own CPU run, same seeded inputs, pinned bucket shapes."""
    import test_torch_track_blocks as blocks_mod
    from orb_slam2_tpu_torch import convert
    from orb_slam2_tpu_torch.places.vocabulary import Vocabulary
    from orb_slam2_tpu_torch.solvers import (
        epnp, horn, pose_graph, sim3_solver,
    )

    rng = np.random.default_rng(9)
    cam = (FX, FY, CX, CY)
    ms = {}

    def both(fn, *arrays):
        """fn on CPU tensors and on card tensors of the same arrays."""
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        card = [t.to(dev) for t in cpu]
        return fn(*cpu), fn(*card), card

    def to_np(x):
        return x.detach().cpu().numpy()

    def once_ms(fn):
        """One call by CUDA events (the call's result is kept): for the
        stages of seconds, warmed up by the caller."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # -- vocabulary descent: 2048 descriptors, a k=10 / L=3 tree
    train = rng.integers(0, 2 ** 32, (6000, 8), dtype=np.uint64).astype(
        np.uint32)
    voc = Vocabulary.train(train, k=10, L=3, levels_up=1)
    desc = rng.integers(0, 2 ** 32, (2048, 8), dtype=np.uint64).astype(
        np.uint32)
    valid = rng.random(2048) > 0.05
    node_c, word_c = voc.assign_nodes(desc, valid)
    d_dev = torch.from_numpy(desc.view(np.int32)).to(dev)
    v_dev = torch.from_numpy(valid).to(dev)
    node_g, word_g = voc.assign_nodes(d_dev, v_dev)
    check(bool((node_c == node_g).all() and (word_c == word_g).all()),
          "vocabulary descent: card and CPU ids differ")
    check(len(voc._tables) == len({torch.device("cpu"), torch.device(dev)}),
          "the node tables were uploaded per call")
    ms["descend_2048_k10_L3"] = cuda_ms(
        torch, lambda: voc.descend(d_dev, v_dev))

    # -- Horn: 128 hypotheses of 6 weighted points
    p1 = rng.normal(0, 2, (128, 6, 3)).astype(np.float32)
    Rs = np.stack([_small_pose(rng, np, 0.5, 1.0) for _ in range(128)])
    p2 = (np.einsum("bij,bnj->bni", Rs[:, :3, :3], p1)
          + Rs[:, None, :3, 3]).astype(np.float32)
    w = (rng.random((128, 6)) > 0.1).astype(np.float32)
    cpu, card, args = both(lambda a, b, c: horn.horn_align(a, b, c, False),
                           p1, p2, w)
    err = max(float(np.abs(to_np(a) - to_np(b)).max())
              for a, b in zip(cpu, card))
    check(err <= HORN_ATOL, f"horn_align: card vs CPU {err}")
    ms["horn_align_128x6"] = cuda_ms(
        torch, lambda: horn.horn_align(*args, False))
    horn_err = err

    # -- EPnP RANSAC: 256 rows (200 live, 30% outliers), 128 x 6 samples
    n, live = 256, 200
    pts = _world(rng, np, n)
    T_true = _small_pose(rng, np, 0.2, 0.5)
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = _pixels(np, pc) + rng.normal(0, 0.05, (n, 2)).astype(np.float32)
    n_out = int(0.3 * live)
    uv[:n_out] = rng.uniform([0, 0], [W, H], (n_out, 2))
    mask = np.arange(n) < live
    pts[live:], uv[live:] = 0.0, 0.0
    max_err = np.where(mask, 5.991, 0.0).astype(np.float32)
    samples = rng.integers(0, live, (128, 6))

    def pnp(*a):
        return epnp.solve_pnp_ransac(*a, *cam)

    cpu, card, args = both(pnp, pts, uv.astype(np.float32), max_err, mask,
                           samples)
    check(bool(cpu.success) and bool(card.success),
          f"solve_pnp_ransac: success CPU {bool(cpu.success)} card "
          f"{bool(card.success)}")
    share = float((to_np(cpu.inliers) == to_np(card.inliers)).mean())
    check(share >= MASK_MIN_SHARE, f"solve_pnp_ransac: masks equal on "
          f"{share}")
    pnp_err = blocks_mod.pose_error(to_np(card.Tcw), T_true)
    check(pnp_err[0] <= PNP_MAX_ERR_M and pnp_err[1] <= PNP_MAX_ERR_DEG,
          f"solve_pnp_ransac: pose error {pnp_err}")
    check(not to_np(card.inliers)[live:].any(), "a padded row is an inlier")
    ms["solve_pnp_ransac_256"] = cuda_ms(torch, lambda: pnp(*args), 3, 3)
    pnp_inl = int(card.n_inliers)

    # -- Sim3 RANSAC + refine: 512 rows (300 live, 60 wrong), 128 x 3
    sim3_out = {}
    for fix_scale, s12 in ((True, 1.0), (False, 1.15)):
        n, live = 512, 300
        pts2 = _world(rng, np, n)
        T12 = _small_pose(rng, np, 0.1, 0.3)
        pts1 = (s12 * (pts2 @ T12[:3, :3].T) + T12[:3, 3]).astype(
            np.float32)
        uv1 = _pixels(np, pts1) + rng.normal(0, 0.3, (n, 2)).astype(
            np.float32)
        uv2 = _pixels(np, pts2) + rng.normal(0, 0.3, (n, 2)).astype(
            np.float32)
        pts2c = pts2.copy()
        pts2c[:60] += rng.uniform(1, 3, (60, 3)).astype(np.float32)
        mask = np.arange(n) < live
        e = np.full(n, 9.21, np.float32)
        one = np.ones(n, np.float32)
        samples = rng.integers(0, live, (128, 3))

        def solve(p1_, p2_, u1, u2, e_, o, m, smp):
            r = sim3_solver.solve_sim3_ransac(
                p1_, p2_, u1, u2, e_, e_, m, smp, *cam,
                fix_scale=fix_scale)
            f = sim3_solver.refine_sim3(
                p1_, p2_, u1, u2, o, o, m, r.R12, r.t12, r.s12, *cam,
                fix_scale=fix_scale)
            return r, f

        (rc, fc), (rg, fg), args = both(solve, pts1, pts2c, uv1, uv2, e,
                                        one, mask, samples)
        check(bool(rc.success) and bool(rg.success),
              f"solve_sim3_ransac fix_scale={fix_scale}: no success")
        err = max(float(np.abs(to_np(a) - to_np(b)).max())
                  for a, b in zip(list(rc[1:4]) + list(fc[:3]),
                                  list(rg[1:4]) + list(fg[:3])))
        check(err <= SIM3_ATOL, f"sim3 fix_scale={fix_scale}: card vs CPU "
              f"{err}")
        share = min(float((to_np(rc.inliers) == to_np(rg.inliers)).mean()),
                    float((to_np(fc[3]) == to_np(fg[3])).mean()))
        check(share >= MASK_MIN_SHARE,
              f"sim3 fix_scale={fix_scale}: masks equal on {share}")
        s_err = abs(float(fg[2]) - s12)
        check(s_err <= (0.0 if fix_scale else 0.01),
              f"sim3 fix_scale={fix_scale}: scale {float(fg[2])}")
        tag = "fixed" if fix_scale else "free"
        ms[f"solve_sim3_ransac_512_{tag}"] = cuda_ms(
            torch, lambda: sim3_solver.solve_sim3_ransac(
                *args[:4], args[4], args[4], args[6], args[7], *cam,
                fix_scale=fix_scale), 3, 3)
        _, ms[f"refine_sim3_512_{tag}"] = once_ms(
            lambda: sim3_solver.refine_sim3(
                *args[:4], args[5], args[5], args[6], rg.R12, rg.t12,
                rg.s12, *cam, fix_scale=fix_scale))
        sim3_out[tag] = {"card_vs_cpu": err, "inliers": int(fg[4]),
                         "scale": float(fg[2])}

    # -- pose graph: dense at the pinned (64, 512) and cg on a ring
    def centers(R, t, s):
        R, t, s = to_np(R), to_np(t), to_np(s)
        return -np.einsum("kji,kj->ki", R, t) / s[:, None]

    pg_out = {}
    for mode, K, E in (("dense", 64, 512), ("cg", 64, 512)):
        f, Cs = _ring_problem(np, K, E, 0.012, [0.02, 0.01, 0.0])
        prob_c = convert.pose_graph_problem_from_numpy(**f)
        prob_g = convert.pose_graph_problem_from_numpy(**f, device=dev)
        out_c = pose_graph.optimize(prob_c, iters=20, mode=mode)
        pose_graph.optimize(prob_g, iters=1, mode=mode)      # warm-up
        out_g, ms[f"pose_graph_{mode}_K{K}_E{E}"] = once_ms(
            lambda: pose_graph.optimize(prob_g, iters=20, mode=mode))
        dev_m = float(np.linalg.norm(centers(*out_c) - centers(*out_g),
                                     axis=1).max())
        err_m = float(np.linalg.norm(centers(*out_g) - Cs, axis=1).max())
        check(dev_m <= PG_MAX_DEV_M, f"pose graph {mode}: card vs CPU "
              f"{dev_m} m")
        check(err_m <= 5e-3, f"pose graph {mode}: {err_m} m from the ring")
        pg_out[mode] = {"card_vs_cpu_m": dev_m, "err_m": err_m}

    print(f"[places] solvers, card vs CPU: descent ids equal; horn "
          f"{horn_err:.2g}; PnP {pnp_inl} inliers, pose error "
          f"{pnp_err[0]:.2g} m {pnp_err[1]:.2g} deg; sim3 {sim3_out}; "
          f"pose graph {pg_out}")
    print("[places] solver ms by CUDA events: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    print(json.dumps({"metric": "place_solver_ms", "ms": ms,
                      "sim3": sim3_out, "pose_graph": pg_out, "gpu": gpu}))
    return ms


def reloc_run(torch, np, dev, settings, scene, voc, gpu) -> dict:
    """Phase 9b: lost, then relocalized, through System."""
    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.system import System
    import test_torch_track_blocks as blocks_mod

    poses, pairs = system_frames(np, scene)
    system = System(settings, Sensor.STEREO, vocabulary=voc, device=dev)
    tracker = system.tracker
    system.precompile(stages=["reloc"])
    for i, (l, r) in enumerate(pairs):
        system.track_stereo(l, r, FRAME_PERIOD_S * i)
    check(tracker.state.name == "OK" and tracker.resets == 0,
          "reloc run: not OK after the tracked frames")
    n_kf = int(system.store.kf_valid.sum())
    check(n_kf > 5, f"reloc run: {n_kf} keyframes (a LOST camera with <= 5 "
          "resets the map)")
    check(len(system.kf_database.bow) >= 3,
          "reloc run: the keyframe database is nearly empty")
    black = np.zeros((H, W), np.uint8)
    t = N_SYSTEM
    for _ in range(N_BLACK):
        system.track_stereo(black, black, FRAME_PERIOD_S * t)
        t += 1
    check(tracker.state.name == "LOST" and tracker.resets == 0,
          f"reloc run: {tracker.state.name} after the black frames")
    # mapped poses again, from 8 frames before the blackout
    frame_ms, first_ok = [], None
    for j, i in enumerate(range(N_SYSTEM - 8, N_SYSTEM)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T = system.track_stereo(*pairs[i], FRAME_PERIOD_S * t)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        t += 1
        if first_ok is None and tracker.state.name == "OK":
            first_ok = j
            err = blocks_mod.pose_error(
                T, poses[i] @ np.linalg.inv(poses[0]))
    check(first_ok is not None and first_ok < RELOC_WITHIN_FRAMES,
          f"reloc run: OK again at revisited frame {first_ok}")
    check(tracker.relocalizations >= 1 and tracker.resets == 0,
          "reloc run: no relocalization counted")
    check(err[0] <= RELOC_MAX_ERR_M, f"reloc run: pose error {err[0]} m")
    check(tracker.state.name == "OK", "reloc run: lost again")
    reloc_ms = tracker.timers.samples["relocalize"]
    out = {"metric": "relocalization", "keyframes": n_kf,
           "relocalizations": tracker.relocalizations,
           "first_ok_frame": first_ok,
           "relocalizing_frame_ms": frame_ms[first_ok],
           "relocalize_stage_ms": [1e3 * x for x in reloc_ms],
           "lost_frame_ms_median": med_ms(frame_ms[:first_ok]),
           "tracked_again_ms_median": med_ms(frame_ms[first_ok + 1:]),
           "pose_err_m": err[0], "pose_err_deg": err[1], "gpu": gpu}
    print(f"[places] relocalization: LOST after {N_BLACK} black pairs, OK "
          f"again at revisited frame {first_ok} in "
          f"{frame_ms[first_ok]:.1f} ms (the relocalize stage "
          f"{1e3 * reloc_ms[-1]:.1f} ms; attempts "
          f"{[round(1e3 * x, 1) for x in reloc_ms]}), pose error "
          f"{err[0]:.4f} m {err[1]:.3f} deg; frames after it "
          f"{fmt(out['tracked_again_ms_median'])} ms")
    print(json.dumps(out))
    return out


def circuit_frames(np, scene):
    """(poses, stereo pairs) of bench.py's circuit: 240 frames, 1.5
    orbits; its first 40 are phase 7b's."""
    from concurrent.futures import ThreadPoolExecutor

    from synthetic import circle_trajectory

    poses = circle_trajectory(N_CIRCUIT, orbit_r=3.0, total_angle=3 * np.pi)
    _, head = system_frames(np, scene)
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BF / FX

    def pair(T):
        return (scene.render(T).astype(np.uint8),
                scene.render(Trl @ T).astype(np.uint8))

    # the renderer is numpy on the host: a few threads at once
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        pairs = list(head) + list(pool.map(pair, poses[N_SYSTEM:]))
    return poses, pairs


def loop_run(torch, np, dev, settings, scene, voc, circuit, gpu,
             with_loop: bool) -> dict:
    """Phase 9c: bench.py's circuit through System with the sync
    scheduler; with_loop=False disables the loop closer's queue, for the
    drift the closure has to correct."""
    from bench_torch import kf_ate
    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.system import System

    poses, pairs = circuit
    system = System(settings, Sensor.STEREO, vocabulary=voc, device=dev)
    tracker, closer = system.tracker, system.loop_closer
    if not with_loop:
        closer.insert_keyframe = lambda kf: None
    pre = system.precompile()
    check({"reloc/solve_pnp_ransac", "loop/pose_graph",
           "loop/sim3_solve+refine", "gba/global_ba"} <= set(pre),
          f"precompile ran {sorted(pre)}")
    captures0 = tracker._get_fast_step().captures
    frame_ms, closed_at, closing = [], None, {}
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for i, (l, r) in enumerate(pairs):
        t0 = time.perf_counter()
        system.track_stereo(l, r, FRAME_PERIOD_S * i)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        check(tracker.state.name == "OK" and tracker.resets == 0,
              f"circuit frame {i}: {tracker.state.name}")
        if closed_at is None and closer.loops_closed:
            closed_at = i
            closing = {k: round(1e3 * v[-1], 2)
                       for k, v in closer.timers.samples.items()}
    wall = time.perf_counter() - t_start
    system.shutdown()
    store = system.store
    check_store_invariants(np, store)
    ate = kf_ate(system, poses)
    n_kf = int(store.kf_valid.sum())
    captures = tracker._get_fast_step().captures - captures0
    grew = tracker._buckets("local", 1) > settings.bucket_local
    check(captures == 0 or grew,
          f"circuit: {captures} unattributed captures after precompile")
    out = {"metric": "loop_circuit", "with_loop": with_loop,
           "frames": N_CIRCUIT, "wall_s": wall, "keyframes": n_kf,
           "kf_ate_m": ate, "frame_ms_median": med_ms(frame_ms),
           "frame_ms_max": max(frame_ms),
           "captures_after_precompile": captures,
           "precompile_s": pre, "gpu": gpu}
    if not with_loop:
        print(f"[places] circuit without loop closing: {n_kf} keyframes, "
              f"keyframe ATE {ate:.4f} m, {wall:.1f} s")
        print(json.dumps(out))
        return out

    gba = closer.gba
    check(closer.loops_closed >= 1 and closer.loop_detected,
          f"circuit: {closer.loops_closed} loops closed "
          f"({closer.timers.counts['loop/detect']} detections run, "
          f"{closer.timers.counts['loop/sim3_ransac']} Sim3 attempts)")
    check(gba is not None and gba.runs_finished >= 1,
          "circuit: no global BA finished")
    check(ate <= LOOP_MAX_ATE_M, f"circuit: keyframe ATE {ate} m")
    check(any(store.kf_loop_edges.values()), "circuit: no loop edge stored")
    detect = closer.timers.samples["loop/detect"]
    out.update({
        "loops_closed": closer.loops_closed, "closed_at_frame": closed_at,
        "closing_frame_ms": frame_ms[closed_at],
        "gba_runs_finished": gba.runs_finished,
        "gba_runs_aborted": gba.runs_aborted,
        "gba_launch_s": closer.timers.samples["loop/gba_launch"],
        "detect_ms_median": med_ms([1e3 * x for x in detect]),
        "closing_pass_ms": closing,
        "sim3_attempts": closer.timers.counts["loop/sim3_ransac"]})
    print(f"[places] circuit: loop closed at frame {closed_at} "
          f"({closer.loops_closed} closed, "
          f"{closer.timers.counts['loop/sim3_ransac']} Sim3 attempts), that "
          f"frame {frame_ms[closed_at]:.0f} ms (its pass by stage, ms: "
          f"{closing}); {n_kf} keyframes, keyframe "
          f"ATE {ate:.4f} m; global BA {gba.runs_finished} finished / "
          f"{gba.runs_aborted} aborted; captures after precompile "
          f"{captures}; {N_CIRCUIT} frames in {wall:.1f} s")
    print("[places] loop closer stage timers:\n" + closer.timers.report())
    print(f"[places] precompile seconds per program: {pre}")
    print(json.dumps(out))
    return out


def ring_run(torch, np, dev, settings, gpu) -> dict:
    """Phase 9d: the 300-keyframe ring map's loop correction on the card."""
    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.slam.loop_closing import LoopCloser
    from orb_slam2_tpu_torch.slam.map_store import FrameFeatures, MapStore
    from test_torch_ring_map import build_ring_map, correct_ring_loop

    store, true_poses = build_ring_map(
        MapStore, FrameFeatures, K=RING_KEYFRAMES, pts_per_kf=30, span=5,
        n_feat=600, drift_per_kf=0.004, device=dev)
    closer = LoopCloser(settings, Sensor.STEREO, store, kf_database=None,
                        local_mapper=None, device=dev)
    out = correct_ring_loop(closer, store, true_poses)
    torch.cuda.synchronize()
    check(out["poses_finite"] and out["points_finite"],
          "ring map: a pose or a point is not finite")
    check(out["loop_edge"], "ring map: no loop edge recorded")
    check(out["moved"] > 0, "ring map: the correction moved no point")
    check(out["tail_err"] < RING_MAX_TAIL_ERR_M,
          f"ring map: tail error {out['tail_err']} m")
    check(out["points_kept"] > 0.9, "ring map: points deleted")
    t = closer.timers
    out.update({"metric": "ring_map_loop_correction",
                "keyframes": RING_KEYFRAMES,
                "essential_graph_s": t.totals["loop/essential_graph"],
                "search_and_fuse_s": t.totals["loop/search_and_fuse"],
                "gpu": gpu})
    print(f"[places] ring map, {RING_KEYFRAMES} keyframes: _correct_loop "
          f"{out['seconds']:.2f} s (essential graph, cg "
          f"{out['essential_graph_s']:.2f} s; search and fuse "
          f"{out['search_and_fuse_s']:.3f} s), tail error "
          f"{out['tail_err']:.2g} m")
    print(json.dumps(out))
    return out


def places_phase(torch, np, dev, settings, scene, gpu) -> dict:
    """Phase 9: place recognition, relocalization and loop closing."""
    from bench_torch import train_vocabulary
    from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda

    spans = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spans[name] = time.perf_counter() - t0
        return out

    timed("9a solvers", place_solvers_check, torch, np, dev, gpu)
    voc = timed("vocabulary", train_vocabulary, scene, dev)
    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    reloc = timed("9b relocalization", reloc_run, torch, np, dev, settings,
                  scene, voc, gpu)
    circuit = timed("circuit frames", circuit_frames, np, scene)
    loop = timed("9c loop", loop_run, torch, np, dev, settings, scene, voc,
                 circuit, gpu, True)
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    for name, c in launches.items():
        check(c > 0, f"kernel {name} was not launched by the places phase")
    noloop = timed("9c without loop closing", loop_run, torch, np, dev,
                   settings, scene, voc, circuit, gpu, False)
    print(f"[places] keyframe ATE with the loop closed {loop['kf_ate_m']:.4f}"
          f" m, without loop closing {noloop['kf_ate_m']:.4f} m")
    ring = timed("9d ring map", ring_run, torch, np, dev, settings, gpu)
    run = timed("9e async", pipelined_run, torch, np, dev, settings, scene,
                "async", True, True, vocabulary=voc)
    run["gpu"] = gpu
    print(json.dumps(run))
    print("[places] seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in spans.items()))
    return {"launches": launches, "reloc": reloc, "loop": loop,
            "ring": ring, "async": run, "voc": voc}


# ---------------------------------------------------------------------------
# Phase 10: monocular SLAM through the normal entry points
# ---------------------------------------------------------------------------
def _two_view_scene(np, rng, kind: str, n: int):
    """Matches of two KITTI-intrinsics views: a general scene (F), a plane
    (H) or a pure rotation (no parallax).  Rays through pixels spread over
    the image meet a depth in [3, 15] m or the plane z = 8 + 0.2 x; the
    second camera turns by ~3 deg and moves 1 m sideways; 0.25 px of
    noise; MONO_OUTLIERS of the rows replaced by random pixels; rows
    outside either image masked.  (With KITTI's 376-px-high image the
    200-set 8-point RANSAC needs that much motion and that little noise
    to be well posed at 30% outliers.)"""
    from scipy.spatial.transform import Rotation

    ray = np.stack([(rng.uniform(0, W, n) - CX) / FX,
                    (rng.uniform(0, H, n) - CY) / FY, np.ones(n)], -1)
    z = (8.0 / (1.0 - 0.2 * ray[:, 0]) if kind == "planar"
         else rng.uniform(3, 15, n))
    pts = ray * z[:, None]
    R = Rotation.from_rotvec(rng.normal(0, np.radians(3.0), 3)).as_matrix()
    t = (np.zeros(3) if kind == "rotation"
         else np.array([1.0, 0.05, 0.05]))

    def px(pc):
        return np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                         FY * pc[:, 1] / pc[:, 2] + CY], -1)

    uv1 = px(pts) + rng.normal(0, 0.25, (n, 2))
    uv2 = px(pts @ R.T + t) + rng.normal(0, 0.25, (n, 2))
    out = rng.choice(n, int(MONO_OUTLIERS * n), replace=False)
    uv2[out] = rng.uniform((0, 0), (W, H), (len(out), 2))
    mask = ((uv1 >= 0) & (uv1 < (W, H)) & (uv2 >= 0)
            & (uv2 < (W, H))).all(1)
    return (uv1.astype(np.float32), uv2.astype(np.float32), mask, R,
            t / max(np.linalg.norm(t), 1e-12))


def mono_init_check(torch, np, dev, settings, scene, poses, gpu) -> dict:
    """Phase 10a: the H/F initializer and the init matcher on the card
    against the port's own CPU run on the same inputs."""
    from orb_slam2_tpu_torch.ops import matching
    from orb_slam2_tpu_torch.slam.frame import FrameBuilder
    from orb_slam2_tpu_torch.solvers import initializer

    cpu = torch.device("cpu")
    K = settings.K.astype(np.float32)
    rng = np.random.default_rng(10)
    times = {}
    expect = {"general": (True, False), "planar": (True, True),
              "rotation": (False, None)}
    cases = [(kind, n) for n in MONO_MATCH_ROWS for kind in expect]
    for kind, n in cases:
        want_ok, want_h = expect[kind]
        uv1, uv2, mask, R, t = _two_view_scene(np, rng, kind, n)
        rows = np.nonzero(mask)[0]
        samples = rows[initializer.make_ransac_samples(
            len(rows), np.random.default_rng(0))].astype(np.int32)

        def args(d):
            return [torch.from_numpy(a).to(d) for a in (uv1, uv2, mask, K,
                                                        samples)]

        a_dev, a_cpu = args(dev), args(cpu)
        card = initializer.initialize(*a_dev)
        host = initializer.initialize(*a_cpu)
        c = {k: v.cpu().numpy() for k, v in card._asdict().items()}
        h = {k: v.numpy() for k, v in host._asdict().items()}
        check(bool(c["success"]) == bool(h["success"]) == want_ok,
              f"init {kind}: success card {c['success']} cpu {h['success']}")
        check(bool(c["used_homography"]) == bool(h["used_homography"]),
              f"init {kind}: the card and the CPU chose different models")
        line = {"scene": kind, "rows": n,
                "valid_rows": int(mask.sum()), "success": bool(c["success"]),
                "used_homography": bool(c["used_homography"])}
        if want_ok:
            check(bool(c["used_homography"]) == want_h,
                  f"init {kind}: used_homography {c['used_homography']}")
            dR = float(np.abs(c["R21"] - h["R21"]).max())
            cos = float(c["t21"] @ h["t21"] / max(
                np.linalg.norm(c["t21"]) * np.linalg.norm(h["t21"]), 1e-12))
            share = float((c["good_mask"] == h["good_mask"]).mean())
            truth_R = float(np.abs(c["R21"] - R).max())
            truth_cos = float(abs(c["t21"] @ t) / max(
                np.linalg.norm(c["t21"]), 1e-12))
            check(dR <= MONO_R_ATOL, f"init {kind}: R21 card vs CPU {dR}")
            check(cos >= MONO_T_MIN_COS, f"init {kind}: t21 cos {cos}")
            check(share >= MASK_MIN_SHARE,
                  f"init {kind}: good_mask agrees on {share}")
            line.update(R21_card_vs_cpu=dR, t21_cos_card_vs_cpu=cos,
                        good_mask_share=share,
                        n_good=int(c["good_mask"].sum()),
                        R21_vs_truth=truth_R, t21_cos_vs_truth=truth_cos)
        line["card_ms"] = times[f"initialize_{kind}_{n}"] = cuda_ms(
            torch, lambda: initializer.initialize(*a_dev), 3, 3)
        print(f"[mono] 10a initialize: {json.dumps(line)}")

    # the init matcher on two rendered frames' init-budget features
    builder = FrameBuilder(settings, device=dev)
    f0, f1 = [builder.monocular(scene.render(poses[i]).astype(np.uint8),
                                0.1 * i, init_boost=True).feats
              for i in (0, 2)]
    keys = ("xy", "desc", "octave", "angle", "valid")
    a_dev = [f.device(k) for f in (f0, f1) for k in keys]
    card = matching.to_host(matching.search_for_initialization(*a_dev))
    host = matching.to_host(matching.search_for_initialization(
        *[a.cpu() for a in a_dev]))
    ok = host[2]
    check(ok.sum() >= 100, f"init matcher: {int(ok.sum())} matches")
    check(np.array_equal(card[2], ok) and np.array_equal(card[0][ok],
                                                         host[0][ok])
          and np.array_equal(card[1][ok], host[1][ok]),
          "init matcher: the card's idx / ok differ from the CPU's")
    times["search_for_initialization"] = cuda_ms(
        torch, lambda: matching.search_for_initialization(*a_dev), 5, 3)
    print(f"[mono] 10a search_for_initialization: {f0.n} x {f1.n} rows, "
          f"{int(ok.sum())} matches, idx/ok equal to the CPU's, "
          f"{times['search_for_initialization']:.3f} ms on the card")
    return times


def mono_kernel_check(torch, np, dev, settings, scene, poses) -> dict:
    """Phase 10b: FAST and describe at the init budget against their plain
    versions, FrameBuilder.monocular with and without init_boost against
    the plain path, and the launches a mono image makes."""
    from orb_slam2_tpu_torch.ops import (
        fast, fast_cuda, frontend, gaussian, orb_cuda, pyramid, stereo_cuda,
    )
    from orb_slam2_tpu_torch.slam.frame import FrameBuilder

    n_init = 2 * N_FEATURES
    border = frontend.EDGE_THRESHOLD - 3
    budgets = frontend.level_budgets(n_init, 8, settings.scale_factor)
    n_rows = frontend.padded_total(n_init, 8, settings.scale_factor)
    imgs = [scene.render(poses[i]).astype(np.uint8)
            for i in range(0, len(poses), len(poses) // N_PAIRS)][:N_PAIRS]
    ang_err, n_same, n_valid = 0.0, 0, 0
    for img in imgs:
        levels = pyramid.compute_pyramid(torch.from_numpy(img).to(dev), 8,
                                         settings.scale_factor)
        kmaps = fast_cuda.detect_levels_cuda(levels, 20, 7, border)
        pmaps = fast_cuda.detect_levels_plain(levels, 20, 7, border)
        for l, (k, p) in enumerate(zip(kmaps, pmaps)):
            check(torch.equal(k, p), f"mono FAST map differs at level {l}")
        picks = [fast.select_topk_grid(p, b, 24)
                 for p, b in zip(pmaps, budgets)]
        xys, _, valids = zip(*picks)
        blurred = [gaussian.blur7x7(lv) for lv in levels]
        ka, kd = orb_cuda.describe_levels_cuda(levels, blurred, xys, valids,
                                               n_rows)
        pa, pd = orb_cuda.describe_levels_plain(levels, blurred, xys, valids,
                                                n_rows)
        valid = torch.cat([*valids, valids[0].new_zeros(n_rows
                                                        - sum(budgets))])
        ang_err = max(ang_err, float(circ_diff(ka, pa)[valid].max()))
        n_same += int((kd == pd).all(1)[valid].sum())
        n_valid += int(valid.sum())
    share = n_same / max(n_valid, 1)
    print(f"[mono] 10b at the init budget ({n_init} features, {n_rows} rows,"
          f" budgets {budgets}): FAST maps equal on {len(imgs)} images; "
          f"max angle err {ang_err:.3g} deg; descriptors identical on "
          f"{n_same}/{n_valid} = {100 * share:.3f}% of valid keypoints")
    check(ang_err <= ANGLE_ATOL_DEG, f"mono angle error {ang_err} deg")
    check(share >= DESC_MIN_SHARE, f"mono descriptor share {share}")

    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    builder = FrameBuilder(settings, device=dev)
    frames = [(builder.monocular(img, 0.1 * i, init_boost=b).feats, b)
              for i, img in enumerate(imgs) for b in (True, False)]
    torch.cuda.synchronize()
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    want = {"fast": len(frames), "orb": len(frames), "stereo": 0}
    check(launches == want, f"mono launches {launches}, expected {want}")
    plain = FrameBuilder(settings, device=dev, plain=True)
    for i, (f, b) in enumerate(frames):
        p = plain.monocular(imgs[i // 2], 0.0, init_boost=b).feats
        check(f.n == p.n == (n_rows if b else frontend.padded_total(
            N_FEATURES, 8, settings.scale_factor)), f"mono rows {f.n}")
        for k in ("xy", "octave", "valid"):
            check(np.array_equal(getattr(f, k), getattr(p, k)),
                  f"mono frame {i // 2} (init_boost={b}): {k} differs from "
                  "the plain path")
    print(f"[mono] 10b FrameBuilder.monocular with and without init_boost: "
          f"xy / octave / valid equal to the plain path on {len(imgs)} "
          f"images; launches {launches} for {len(frames)} frames")
    return launches


def mono_track_check(torch, np, dev, settings, scene, poses,
                     stereo_nodes) -> dict:
    """Phase 10c: after a mono init through System, the fused mono step's
    graph replays against its eager and plain versions on the frames that
    follow, and what one replay runs."""
    from orb_slam2_tpu_torch import convert
    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.ops import frontend
    from orb_slam2_tpu_torch.slam import track_step
    from orb_slam2_tpu_torch.system import System

    system = System(settings, Sensor.MONOCULAR, device=dev)
    tracker = system.tracker
    step = tracker._get_fast_step()
    recorded = []

    def keep(a):
        if torch.is_tensor(a):
            return a.clone()
        return None if a is None else np.array(a, copy=True)

    def recording(*args):
        kept = [keep(a) for a in args]
        out = step(*args)
        recorded.append((kept, out.f32_pack.clone(), out.desc.clone()))
        return out

    tracker._fast_step = recording
    init_at = None
    for i, T in enumerate(poses):
        system.track_monocular(scene.render(T).astype(np.uint8), 0.1 * i)
        if init_at is None and tracker.state.name == "OK":
            init_at = i
        if len(recorded) >= N_MONO_TRACK:
            break
    check(len(recorded) == N_MONO_TRACK and tracker.state.name == "OK",
          f"mono: {len(recorded)} fast-path frames after the init at frame "
          f"{init_at}, state {tracker.state.name}")
    n_feat = frontend.padded_total(N_FEATURES, 8, settings.scale_factor)
    plain = track_step.build_track_step(system.settings, "mono", device=dev,
                                        plain=True).eager
    worst = {"replay_tcw": 0.0, "plain_tcw": 0.0}
    widths = []
    for k, (args, pack, desc) in enumerate(recorded):
        M = args[7].shape[0]
        widths.append(int(args[3].shape[0]))
        dev_args = [None if a is None else
                    torch.as_tensor(track_step._as_input(a)).to(dev)
                    for a in args]
        res, _ = track_step.unpack_track_out(
            track_step.TrackOut(pack, desc), n_feat, M)
        e = convert.track_result_to_numpy(step.eager(*dev_args), n_feat, M)
        p = convert.track_result_to_numpy(plain(*dev_args), n_feat, M)
        d_replay = float(np.abs(e["Tcw"] - res.Tcw).max())
        d_plain = float(np.abs(p["Tcw"] - e["Tcw"]).max())
        worst["replay_tcw"] = max(worst["replay_tcw"], d_replay)
        worst["plain_tcw"] = max(worst["plain_tcw"], d_plain)
        check(d_replay <= REPLAY_TCW_ATOL,
              f"mono frame {k}: replay and eager Tcw differ by {d_replay}")
        for key in ("assign", "inlier"):
            check(np.array_equal(e[key], getattr(res, key)),
                  f"mono frame {k}: replay and eager {key} differ")
        check(d_plain <= PLAIN_TCW_ATOL,
              f"mono frame {k}: kernel and plain Tcw differ by {d_plain}")
    prof = profile_call(torch, lambda: step(*recorded[-1][0]))
    want = {"fast": 1, "orb": 1, "stereo": 0}
    check(prof["counts"] == want,
          f"mono replay ran {prof['counts']}, expected {want}")
    out = {"init_frame": init_at, "frames": N_MONO_TRACK,
           "last_block_rows": widths, "replay_vs_eager_tcw":
           worst["replay_tcw"], "plain_vs_kernel_tcw": worst["plain_tcw"],
           "replay_kernels": prof["counts"],
           "replay_nodes": prof["n_device"],
           "stereo_replay_nodes": stereo_nodes,
           "replay_busy_ms": prof["busy_ms"], "captures": step.captures}
    print(f"[mono] 10c {json.dumps(out)}")
    system.shutdown()
    return out


def mono_bench_run(torch, np, dev, settings, poses, frames, voc,
                   gpu) -> dict:
    """Phases 10d and 10e: bench.py's mono pass (bench.py:304-336) on the
    port through System, with the fork's grid mapper attached before the
    first frame.  Returns the wrappers' launch counts over the pass."""
    import copy

    from bench_torch import kf_ate
    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.mapping2d.gridmap import GridParams
    from orb_slam2_tpu_torch.mapping2d.stream import attach_grid_mapper
    from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda
    from orb_slam2_tpu_torch.system import System

    s = copy.copy(settings)
    s.pipelined = True        # bench.py asks; the mono System demotes it
    system = System(s, Sensor.MONOCULAR, vocabulary=voc, scheduler="async",
                    device=dev)
    tracker, mapper, closer = (system.tracker, system.local_mapper,
                               system.loop_closer)
    check(system.settings.pipelined is False and not tracker.pipelined
          and s.pipelined is True, "mono System did not demote pipelined")
    check(system.store.n_feat == MONO_INIT_ROWS,
          f"mono store of {system.store.n_feat} rows")
    grid, _ = attach_grid_mapper(system, GridParams(
        scale_factor=MONO_GRID_CELLS_PER_UNIT, cloud_min_x=-MONO_GRID_HALF,
        cloud_max_x=MONO_GRID_HALF, cloud_min_z=-MONO_GRID_HALF,
        cloud_max_z=MONO_GRID_HALF), all_pts_gap=0)
    rebuilds = []
    rebuild = grid.rebuild

    def counted_rebuild():
        rebuilds.append(closer.loops_closed)
        rebuild()

    grid.rebuild = counted_rebuild
    pre = system.precompile()
    check({"modular/mono_init", "track/fast_step", "mapping/kf_bow_descend"}
          <= set(pre) and "track/chain_step" not in pre,
          f"mono precompile ran {sorted(pre)}")
    step = tracker._get_fast_step()
    captures0 = step.captures

    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    frame_ms, init_at, init_ms = [], None, {}
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    t_next = t_start
    for i, img in enumerate(frames):
        while True:
            left = t_next - time.perf_counter()
            if left <= 0:
                break
            system.poll()
            time.sleep(min(left, 0.002))
        t_next = max(t_next + FRAME_PERIOD_S, time.perf_counter())
        t0 = time.perf_counter()
        system.track_monocular(img, FRAME_PERIOD_S * i)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        if i + 1 < len(frames):
            system.prefetch(frames[i + 1])
        if init_at is None and tracker.state.name == "OK":
            init_at = i
            init_ms = {k: round(1e3 * tracker.timers.samples[k][-1], 2)
                       for k in ("init/search", "init/initialize",
                                 "init/create_map", "init/global_ba",
                                 "init/normalize")}
            init_ms["attempts"] = tracker.timers.counts["init/initialize"]
    wall = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while not (mapper.idle() and (closer is None or closer.idle())):
        check(time.perf_counter() - t0 < QUIESCE_MAX_S,
              "mono: the workers never quiesced")
        time.sleep(0.01)
    torch.cuda.synchronize()
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    captures = step.captures - captures0
    grew = tracker._buckets("local", 1) > system.settings.bucket_local
    state, resets = tracker.state.name, tracker.resets
    system.shutdown()
    store = system.store
    check_store_invariants(np, store)
    n_kf = int(store.kf_valid.sum())
    loops = closer.loops_closed
    ate = kf_ate(system, poses, mono_scale=True)
    timed = sorted(frame_ms)
    out = {
        "metric": "mono_pass", "frames": len(frames),
        "deg_per_frame": float(np.degrees(3 * np.pi / len(frames))),
        "paced_hz": 1 / FRAME_PERIOD_S, "wall_s": wall,
        "init_frame": init_at, "init_frame_ms": (frame_ms[init_at]
                                                 if init_at is not None
                                                 else None),
        "init_stage_ms": init_ms,
        "frame_ms_p50": timed[len(timed) // 2],
        "frame_ms_p90": timed[int(0.9 * len(timed))],
        "frame_ms_worst": timed[-1],
        "worst_frame": int(np.argmax(frame_ms)),
        "keyframes": n_kf, "map_points": int(len(store.valid_pt_ids())),
        "loops_closed": loops, "kf_ate_m": ate, "state": state,
        "resets": resets, "relocalizations": tracker.relocalizations,
        "captures_after_precompile": captures, "local_bucket_grew": grew,
        "launches": launches, "precompile_s": pre, "gpu": gpu,
    }
    print(f"[mono] 10d {json.dumps(out)}")
    print("[mono] 10d tracker stage timers:\n" + tracker.timers.report())
    print("[mono] 10d mapper stage timers:\n" + mapper.timers.report())
    # bench.py's health rule (bench.py:250-259)
    check(state == "OK" and resets == 0,
          f"mono pass ended {state} after {resets} resets")
    check(n_kf >= MIN_KEYFRAMES, f"mono pass: {n_kf} keyframes")
    check(loops >= 1 or ate <= LOOP_MAX_ATE_M,
          f"mono pass: no loop closed and keyframe ATE {ate} m")
    check(init_at is not None, "mono pass never initialized")
    check(captures == 0, f"mono pass: {captures} captures after precompile "
          f"(local bucket grew: {grew})")
    for name in ("fast", "orb"):
        check(launches[name] > 0, f"kernel {name} was not launched by the "
              "mono pass")
    check(launches["stereo"] == 0, "the mono pass launched the stereo "
          "refinement")

    # 10e: the grid map the stream kept
    occ = grid.occupancy()
    n_free, n_occ = int((occ == 255).sum()), int((occ == 0).sum())
    check(n_free > 0 and n_occ > 0,
          f"grid: {n_free} free and {n_occ} occupied cells")
    if loops:
        check(len(rebuilds) >= 1 and rebuilds[0] >= 1,
              f"grid: {len(rebuilds)} rebuilds after {loops} loops")
    else:
        # no loop closed (the pass was healthy by its ATE): fire the loop
        # hook as the loop closer does, and the grid must rebuild
        for cb in closer.on_loop:
            cb(int(store.valid_kf_ids()[-1]))
        check(len(rebuilds) == 1, "grid: the loop hook did not rebuild")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grid_tum.pgm")
        system.save_grid_map_tum(path)
        with open(path) as f:
            head = [f.readline().strip() for _ in range(3)]
    check(head == ["P2", "450 300", "255"], f"grid file header {head}")
    print(f"[mono] 10e grid {occ.shape}: {n_free} free, {n_occ} occupied, "
          f"{int((occ == 128).sum())} unknown cells; {len(rebuilds)} "
          f"rebuilds ({loops} loops closed); save_grid_map_tum wrote a "
          f"{head[1]} file")
    out["grid"] = {"free": n_free, "occupied": n_occ,
                   "rebuilds": len(rebuilds)}
    return out


def mono_phase(torch, np, dev, settings, scene, gpu, track, voc) -> dict:
    """Phase 10: monocular SLAM at the KITTI shape."""
    from concurrent.futures import ThreadPoolExecutor

    from bench_torch import train_vocabulary
    from synthetic import circle_trajectory

    spans = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spans[name] = time.perf_counter() - t0
        return out

    poses = circle_trajectory(MONO_FRAMES, orbit_r=3.0,
                              total_angle=3 * np.pi)

    def render(T):
        return scene.render(T).astype(np.uint8)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        frames = timed("render", lambda: list(pool.map(render, poses)))
    if voc is None:
        voc = timed("vocabulary", train_vocabulary, scene, dev)
    init = timed("10a init", mono_init_check, torch, np, dev, settings,
                 scene, poses, gpu)
    kern = timed("10b kernels", mono_kernel_check, torch, np, dev,
                 settings, scene, poses)
    trk = timed("10c track", mono_track_check, torch, np, dev, settings,
                scene, poses, track["replay_nodes"])
    run = timed("10d-e pass", mono_bench_run, torch, np, dev, settings,
                poses, frames, voc, gpu)
    print("[mono] seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in spans.items()))
    return {"launches": run["launches"], "init_ms": init,
            "builder_launches": kern, "track": trk, "run": run}


def plane_cloud(np, rng, n_in: int, n_out: int):
    """tests/test_ar.py's cloud: n_in points near the plane z = 0.3 x -
    0.2 y + 1.5 (5 mm noise) and n_out uniform outliers."""
    xy = rng.uniform(-2, 2, (n_in, 2))
    z = 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + 1.5
    inliers = np.column_stack([xy, z + rng.normal(0, 0.005, n_in)])
    outliers = rng.uniform(-3, 3, (n_out, 3))
    return np.concatenate([inliers, outliers]).astype(np.float32)


def fit_plane_check(torch, np, dev) -> dict:
    """11a: viz/ar.py's fit_plane on the card against the port's own CPU
    run on the same seeded points, tolerances and samples."""
    from orb_slam2_tpu_torch.viz import ar

    out = {}
    for name, seed, n_in, n_out, S in PLANE_CASES:
        rng = np.random.default_rng(seed)
        pts = plane_cloud(np, rng, n_in, n_out)
        N = len(pts)
        samples = rng.integers(0, N, (S, 3)).astype(np.int32)
        host = (torch.from_numpy(pts), torch.ones(N, dtype=torch.bool),
                torch.full((N,), 0.02), torch.from_numpy(samples))
        card = tuple(t.to(dev) for t in host)
        c, h = ar.fit_plane(*card), ar.fit_plane(*host)
        check(bool(c.ok) == bool(h.ok) and bool(h.ok),
              f"fit_plane {name}: ok card {bool(c.ok)} cpu {bool(h.ok)}")
        nc, dc = c.normal.cpu().numpy(), float(c.d)
        nh, dh = h.normal.numpy(), float(h.d)
        if np.dot(nc, nh) < 0:
            nc, dc = -nc, -dc
        dn = float(np.abs(nc - nh).max())
        dd = abs(dc - dh)
        share = float((c.inliers.cpu() == h.inliers).float().mean())
        check(dn <= PLANE_ATOL and dd <= PLANE_ATOL,
              f"fit_plane {name}: normal {dn}, d {dd} card vs CPU")
        check(share >= PLANE_MASK_SHARE,
              f"fit_plane {name}: inlier masks agree on {share}")
        ms = cuda_ms(torch, lambda: ar.fit_plane(*card), 10, 5)
        out[name] = {"N": N, "S": S, "ms": ms, "normal_diff": dn,
                     "d_diff": dd, "mask_share": share,
                     "n_inliers": int(c.n_inliers)}
        print(f"[viz] fit_plane {name} (N={N}, S={S}): {ms:.3f} ms by "
              f"events; card vs CPU normal {dn:.2g}, d {dd:.2g}, masks "
              f"equal on {100 * share:.2f}%, {int(c.n_inliers)} inliers")
    return out


def plane_frames(np, settings):
    """11b-c's frames: KITTI-shaped stereo pairs of synthetic.PlaneScene
    (n ~ (0, 0.25, 1), d = 3 m in the first camera's frame) along
    straight_trajectory, rendered as synthetic.stereo_sequence renders
    them, at the KITTI baseline."""
    from synthetic import stereo_sequence, straight_trajectory

    poses = straight_trajectory(AR_FRAMES, step=0.05, yaw_step=0.002)
    scene, pairs = stereo_sequence(settings.K, H, W, BF / FX, poses)
    return scene, [(l.astype(np.uint8), r.astype(np.uint8))
                   for l, r in pairs]


def run_frames(torch, system, pairs) -> list:
    """Track every pair through `system`: (kind, ms) of each call,
    synchronised; every frame must stay OK with no reset."""
    tracker = system.tracker
    calls = []
    for i, (l, r) in enumerate(pairs):
        n_kf, n_fast = system.store.n_kf, tracker.timers.counts["fast_step"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        T = system.track_stereo(l, r, 0.1 * i)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        check(T is not None and tracker.state.name == "OK"
              and tracker.resets == 0, f"plane frame {i}: lost or reset")
        kind = ("keyframe" if system.store.n_kf > n_kf else
                "fast" if tracker.timers.counts["fast_step"] > n_fast
                else "modular")
        calls.append((kind, ms))
    return calls


def fast_median(calls):
    return med_ms([ms for kind, ms in calls if kind == "fast"])


def ar_run(torch, np, dev, settings, scene, pairs) -> dict:
    """11b: the frames through System(STEREO) with the sync scheduler, then
    ARViewer.detect_plane on the card: the rendered plane's normal and
    offset."""
    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.system import System
    from orb_slam2_tpu_torch.viz import ar

    system = System(settings, Sensor.STEREO, device=dev)
    calls = run_frames(torch, system, pairs)
    viewer = ar.ARViewer(system)
    t = time.perf_counter()
    found = viewer.detect_plane()
    torch.cuda.synchronize()
    detect_ms = 1e3 * (time.perf_counter() - t)
    check(found, "ARViewer found no plane")
    n = viewer.Tpw[:3, 2].astype(np.float64)
    cos = abs(float(np.dot(n, scene.n)))
    offset = abs(float(np.dot(n, viewer.Tpw[:3, 3])))
    d_rel = abs(offset - scene.d) / scene.d
    check(cos >= AR_MIN_COS, f"AR plane normal cos {cos}")
    check(d_rel <= AR_MAX_D_REL, f"AR plane offset {offset} m, rendered "
          f"{scene.d} m")
    n_tracked = int((system.tracker.current.bindings >= 0).sum())
    system.shutdown()
    print(f"[viz] AR: {len(pairs)} frames, {system.store.n_kf} keyframes, "
          f"{n_tracked} tracked points; detect_plane {detect_ms:.2f} ms; "
          f"normal cos {cos:.6f}, offset {offset:.4f} m (rendered "
          f"{scene.d} m, {100 * d_rel:.3f}%); fast-path frames median "
          f"{fmt(fast_median(calls))} ms")
    return {"calls": calls, "detect_ms": detect_ms, "cos": cos,
            "d_rel": d_rel}


def live_viewer_run(torch, np, dev, settings, pairs, off_calls) -> dict:
    """11c: the same frames through System(use_viewer=True) where cv2
    imports (the HTTP panel's state and map, the menu's localization
    requests applied by the next frame, no render error, frame ms beside
    the viewer-off run); elsewhere, the System's ImportError naming cv2."""
    import urllib.request

    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.system import System

    try:
        import cv2  # noqa: F401
    except ImportError as e:
        print(f"[viz] cv2 does not import here ({e}): the live viewer is "
              "not run; checking that System(use_viewer=True) refuses")
        try:
            System(settings, Sensor.STEREO, use_viewer=True, device=dev)
        except ImportError as refusal:
            check("cv2" in str(refusal), f"the refusal names {refusal}")
            return {"cv2": False}
        raise RuntimeError("chip_smoke: FAILED: System(use_viewer=True) "
                           "built without cv2")

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5.0) as r:
            return r.read()

    def wait(cond, what):
        deadline = time.time() + VIEWER_WAIT_S
        while not cond():
            check(time.time() < deadline, what)
            time.sleep(0.02)

    system = System(settings, Sensor.STEREO, use_viewer=True,
                    viewer_port=0, device=dev)
    viewer = system.viewer
    try:
        calls = run_frames(torch, system, pairs)
        port = viewer.port
        check(json.loads(get(port, "/state"))["state"] == "OK",
              "/state is not OK")
        wait(lambda: get(port, "/map.jpg")[:2] == b"\xff\xd8",
             "/map.jpg is no JPEG")
        l, r = pairs[-1]
        for k, on in enumerate((True, False)):
            get(port, f"/menu?localization_mode={int(on)}")
            wait(lambda: system._mode_request is on, "no mode request")
            system.track_stereo(l, r, 10.0 + k)
            check(system.tracker.only_tracking is on,
                  f"localization mode {on} not applied")
        check(viewer.render_errors == 0,
              f"render errors: {viewer.last_render_error}")
        render_ms = 1e3 * viewer.render_s / max(viewer.renders, 1)
    finally:
        system.shutdown()
    on, off = fast_median(calls), fast_median(off_calls)
    print(f"[viz] live viewer: /state OK, /map.jpg a JPEG, localization "
          f"mode toggled both ways by the menu, 0 render errors; "
          f"{viewer.renders} renders, {render_ms:.2f} ms each; fast-path "
          f"frames median {fmt(on)} ms with the viewer, {fmt(off)} ms "
          f"without")
    return {"cv2": True, "render_ms": render_ms, "renders": viewer.renders,
            "fast_ms_viewer_on": on, "fast_ms_viewer_off": off}


def multidevice_check(torch, np, dev, settings, track_frames) -> dict:
    """11d: the sharded paths over NCCL, one rank on this script's card,
    each against the unsharded function: frame-parallel extraction and
    tracking step, edge-parallel BA.  Returns the kernels' launches on
    the two frame-parallel paths."""
    import datetime

    import torch.distributed as dist

    from orb_slam2_tpu_torch.parallel import multichip

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            "nccl", init_method=f"file://{d}/init", world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=60))
        try:
            mesh = multichip.make_mesh(1)
            check(mesh.device.type == "cuda", f"mesh on {mesh.device}")
            return sharded_paths(torch, np, mesh, settings, track_frames)
        finally:
            dist.destroy_process_group()


def sharded_paths(torch, np, mesh, settings, track_frames) -> dict:
    """11d's checks and times on `mesh`."""
    from orb_slam2_tpu_torch import convert
    from orb_slam2_tpu_torch.ops import (
        fast_cuda, frontend, orb_cuda, stereo_cuda,
    )
    from orb_slam2_tpu_torch.parallel import multichip
    from orb_slam2_tpu_torch.slam import track_step
    from orb_slam2_tpu_torch.solvers import ba

    dev = mesh.device
    launches = {"fast": 0, "orb": 0, "stereo": 0}

    def counted(fn):
        fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
        out = fn()
        torch.cuda.synchronize()
        for k, m in (("fast", fast_cuda), ("orb", orb_cuda),
                     ("stereo", stereo_cuda)):
            launches[k] += m.launches
        return out

    def twice(fn):
        """`fn` counted, then again: (its result, ms of the first call,
        which sets up the communicator or captures a graph, and of the
        second)."""
        t = time.perf_counter()
        out = counted(fn)
        first = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        out = counted(fn)
        return out, first, 1e3 * (time.perf_counter() - t)

    # frame-parallel extraction: 4 KITTI-shaped frames (phase 6's lefts)
    imgs = np.stack([f["img_l"] for f in track_frames[:N_SHARDED]])
    kw = dict(n_features=N_FEATURES, n_levels=settings.n_levels,
              scale_factor=settings.scale_factor)
    feats, *extract_ms = twice(
        lambda: multichip.extract_batch_sharded(mesh, imgs, **kw))
    for i in range(N_SHARDED):
        f = frontend.extract(torch.from_numpy(imgs[i]).to(dev),
                             N_FEATURES, settings.n_levels,
                             settings.scale_factor, 20, 7, 24)
        for k in ("desc", "xy", "octave", "valid"):
            check(torch.equal(getattr(f, k), getattr(feats, k)[i]),
                  f"sharded extraction's {k} of frame {i} differs")

    # frame-parallel tracking step: phase 6's frames against its map
    names = ("img_l", "img_r", "scal", "last_f32", "last_desc", "last_oct",
             "last_angle", "loc_f32", "loc_desc")
    batch = [np.stack([f[k] for f in track_frames[:N_SHARDED]])
             for k in names]
    n, M = batch[3].shape[1], batch[7].shape[1]
    res, *track_ms = twice(
        lambda: multichip.track_step_sharded(mesh, settings, *batch))
    step = track_step.build_track_step(settings, "stereo", dev)
    worst = 0.0
    for i in range(N_SHARDED):
        one, _ = track_step.unpack_track_out(step(
            *convert.track_inputs_from_numpy(
                {k: a[i] for k, a in zip(names, batch)}, dev)), n, M)
        got, _ = track_step.unpack_track_out(
            track_step.TrackOut(res.f32_pack[i], res.desc[i]), n, M)
        d = float(np.abs(got.Tcw - one.Tcw).max())
        worst = max(worst, d)
        check(d <= REPLAY_TCW_ATOL, f"sharded step frame {i}: Tcw {d}")
        check(np.array_equal(got.assign, one.assign)
              and np.array_equal(got.inlier, one.inlier),
              f"sharded step frame {i}: assign or inliers differ")
        check(got.n_inliers >= MIN_INLIERS,
              f"sharded step frame {i}: {got.n_inliers} inliers")

    # edge-parallel BA at the pose graph's 64-keyframe bucket
    prob, k = multichip.synthetic_ba_problem(**SHARDED_BA, device=dev)
    it = SHARDED_BA_ITERS

    def sharded():
        return multichip.optimize_sharded(mesh, prob, *k, iters=it,
                                          mode="cg")

    def unsharded():
        return ba.optimize(prob, *k, iters=it, use_kernel=True, mode="cg")

    def diff(a, b):
        """max |d cam_T|, max |d points| (m), relative d error."""
        return (float((a[0] - b[0]).abs().max()),
                float((a[1] - b[1]).abs().max()),
                abs(float(a[2]) / float(b[2]) - 1.0))

    r0 = mesh.all_reduces
    sharded()
    reduces = (mesh.all_reduces - r0) / it
    ms = {"sharded": cuda_ms(torch, sharded, 3, 3),
          "unsharded": cuda_ms(torch, unsharded, 3, 3)}
    # index_add_'s atomics reorder the float sums from call to call, and
    # the problem's free scale gauge (mono edges, one fixed camera) and
    # its points seen once or twice amplify that; the gates compare the
    # sharded and the unsharded arithmetic with index_add_'s
    # deterministic route (a one-rank all-reduce is a copy)
    spread = diff(unsharded(), unsharded())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = unsharded()
        diffs = {"sharded": diff(sharded(), det),
                 "unsharded_twice": diff(unsharded(), det)}
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[multi] one rank over NCCL on {torch.cuda.get_device_name(0)}:"
          f" extract_batch_sharded {N_SHARDED} frames {extract_ms[0]:.1f} "
          f"ms first (the communicator's set-up), {extract_ms[1]:.1f} ms "
          f"next (equal to frontend.extract); track_step_sharded "
          f"{N_SHARDED} frames {track_ms[0]:.1f} ms first (a capture), "
          f"{track_ms[1]:.1f} ms next (Tcw within {worst:.2g} of the "
          f"unsharded step, assign / inliers equal); optimize_sharded cg "
          f"x{it} on {SHARDED_BA}: {ms['sharded']:.2f} ms, unsharded "
          f"{ms['unsharded']:.2f} ms by events, {reduces:.0f} all-reduces "
          f"an LM iteration; max |diff| (cam_T, points m, err rel) with "
          f"deterministic index_add_: sharded vs unsharded "
          f"{diffs['sharded']}, unsharded twice {diffs['unsharded_twice']};"
          f" two default-route unsharded solves {spread}; launches "
          f"{launches}")
    cam_d, pts_d, err_d = diffs["sharded"]
    check(cam_d <= SHARDED_CAM_ATOL, f"sharded BA cam_T differs by {cam_d}")
    check(pts_d <= SHARDED_PTS_ATOL, f"sharded BA points differ by {pts_d}")
    check(err_d <= SHARDED_ERR_RTOL, f"sharded BA error differs by {err_d}")
    return {"launches": launches, "extract_ms": extract_ms,
            "track_ms": track_ms, "ba_ms": ms, "ba_diffs": diffs,
            "ba_default_route_spread": spread,
            "all_reduces_per_iter": reduces}


def viz_multi_phase(torch, np, dev, settings, gpu, track) -> dict:
    """Phase 11: the viewers and multi-device on the card."""
    spans = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spans[name] = time.perf_counter() - t0
        return out

    plane = timed("11a fit_plane", fit_plane_check, torch, np, dev)
    scene, pairs = timed("render", plane_frames, np, settings)
    from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda

    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    ar_out = timed("11b AR", ar_run, torch, np, dev, settings, scene, pairs)
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}
    live = timed("11c live viewer", live_viewer_run, torch, np, dev,
                 settings, pairs, ar_out["calls"])
    multi = timed("11d multi-device", multidevice_check, torch, np, dev,
                  settings, track["frames"])
    for k, v in multi["launches"].items():
        launches[k] += v
    for k, v in launches.items():
        check(v > 0, f"kernel {k} not launched on phase 11's paths")
    print("[viz/multi] seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in spans.items()))
    print(json.dumps({
        "metric": "viz_multidevice", "fit_plane": plane,
        "ar": {k: v for k, v in ar_out.items() if k != "calls"},
        "ar_fast_ms": fast_median(ar_out["calls"]), "live": live,
        "multi": {k: v for k, v in multi.items() if k != "launches"},
        "launches": launches, "gpu": gpu}))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 12: the port's bench, bench_torch.py, at its full depth
# ---------------------------------------------------------------------------
def bench_phase(voc) -> dict:
    """Phase 12: bench_torch.main in this process at BENCH_FRAMES =
    BENCH_SMOKE_FRAMES; voc, where given, is phase 9's vocabulary of the
    same scene."""
    import bench_torch
    from bench_reference import reference_keys
    from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda

    saved = os.environ.get("BENCH_FRAMES")
    os.environ["BENCH_FRAMES"] = str(BENCH_SMOKE_FRAMES)
    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    try:
        run = bench_torch.main(["--device", "cuda"], vocabulary=voc)
    finally:
        if saved is None:
            del os.environ["BENCH_FRAMES"]
        else:
            os.environ["BENCH_FRAMES"] = saved
    launches = bench_torch.kernel_launches()
    out, passes = run["out"], run["passes"]
    keys = reference_keys()
    check(set(out) == keys, "bench line's keys differ from bench.py's: "
          f"extra {sorted(set(out) - keys)}, "
          f"missing {sorted(keys - set(out))}")
    check(list(passes) == list(BENCH_PASS_FRAMES),
          f"bench ran the passes {list(passes)}")
    for name, rec in passes.items():
        want = BENCH_PASS_FRAMES[name] * BENCH_SMOKE_FRAMES
        check(rec["frames"] == want,
              f"bench {name}: {rec['frames']} frames, not {want}")
        caps = rec["captures"]
        check(caps["fast_step"] == 0 and caps["chain_step"] == 0,
              f"bench {name}: graph captures inside the timed window {caps}")
    for name in BENCH_STEREO_PASSES:
        check(passes[name]["healthy"] and name not in out["degraded_passes"],
              f"bench {name} pass degraded: {out}")
        for kernel, n in passes[name]["launches"].items():
            check(n > 0, f"bench {name}: kernel {kernel} not launched")
    check(out["relocalizations"] >= 1,
          f"bench kidnap pass: {out['relocalizations']} relocalizations")
    print(f"[bench] {BENCH_SMOKE_FRAMES} frames: degraded "
          f"{out['degraded_passes']} (mono and RGB-D not gated here: mono "
          f"healthy {passes['mono']['healthy']}, RGB-D healthy "
          f"{passes['rgbd']['healthy']}); seconds "
          + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in passes.items())
          + f"; launches {launches}")
    return {"launches": launches, "out": out, "passes": passes}


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


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="", help="comma-separated subset of "
                    "front,6,7,8,9,10,11,12 for development (default: all; "
                    "11 runs 6 first)")
    only = {p for p in ap.parse_args(argv).phases.split(",") if p}
    t_script = time.perf_counter()
    spans = {}

    def phase(name, fn, *a, **k):
        """Run one phase, keep its seconds."""
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spans[name] = time.perf_counter() - t0
        print(f"[phase] {name}: {spans[name]:.1f} s")
        return out

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    from bench_torch import gpu_line
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
    spans["1 build"] = time.perf_counter() - t0
    print(f"[build] {so.name} in {spans['1 build']:.1f} s")
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

    if only:
        # development: the named phases alone, no kernels line
        stubs = ({"replay_nodes": -1},
                 {"keyframe_median_ms": None, "fast_path_median_ms": None})
        if "front" in only:
            phase("2-5 frontend", frontend_phases, torch, np, dev, settings,
                  scene, poses, pairs, gpu)
        track = (phase("6 track", track_phase, torch, np, dev, settings,
                       scene, gpu) if only & {"6", "11"} else stubs[0])
        system = stubs[1]
        if "7" in only:
            phase("7a golden", golden_phase, np, dev)
            system = phase("7bc system", system_phase, torch, np, dev,
                           settings, scene, gpu)
        if "8" in only:
            phase("8 pipeline", pipeline_phase, torch, np, dev, settings,
                  scene, gpu, track, system)
        voc = None
        if "9" in only:
            voc = phase("9 places", places_phase, torch, np, dev, settings,
                        scene, gpu)["voc"]
        if "10" in only:
            phase("10 mono", mono_phase, torch, np, dev, settings, scene,
                  gpu, track, voc)
        if "11" in only:
            phase("11 viz/multi", viz_multi_phase, torch, np, dev, settings,
                  gpu, track)
        if "12" in only:
            phase("12 bench", bench_phase, voc)
        print(f"[phase] seconds: {spans}; whole script "
              f"{time.perf_counter() - t_script:.1f} s")
        print(gpu)
        print(json.dumps({"ok": True, "partial": sorted(only), "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2-5. the kernels, the slice, the counts, the times -------------
    front = phase("2-5 frontend", frontend_phases, torch, np, dev, settings,
                  scene, poses, pairs, gpu)
    launches, times, bounds = (front["launches"], front["times"],
                               front["bounds"])
    n_rows = front["n_rows"]

    # ---- 6. the fused tracking step, one CUDA graph a frame --------------
    track = phase("6 track", track_phase, torch, np, dev, settings, scene,
                  gpu)

    # ---- 7. the stereo System: golden, KITTI-shaped run, one local BA ------
    phase("7a golden", golden_phase, np, dev)
    system = phase("7bc system", system_phase, torch, np, dev, settings,
                   scene, gpu)

    # ---- 8. the pipelined chain, the mirror, the async scheduler ----------
    pipeline = phase("8 pipeline", pipeline_phase, torch, np, dev, settings,
                     scene, gpu, track, system)

    # ---- 9. place recognition, relocalization, loop closing ---------------
    places = phase("9 places", places_phase, torch, np, dev, settings,
                   scene, gpu)

    # ---- 10. monocular SLAM: initializer, mono step, bench's mono pass ------
    mono = phase("10 mono", mono_phase, torch, np, dev, settings, scene,
                 gpu, track, places["voc"])

    # ---- 11. the viewers and multi-device ----------------------------------
    viz_multi = phase("11 viz/multi", viz_multi_phase, torch, np, dev,
                      settings, gpu, track)

    # ---- 12. bench_torch.py: bench.py's five passes on the port ------------
    bench = phase("12 bench", bench_phase, places["voc"])
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
             "launches_places": places["launches"][key],
             "launches_mono": mono["launches"][key],
             "launches_viz_multidevice": viz_multi["launches"][key],
             "launches_bench": bench["launches"][key],
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
    print(f"[phase] seconds: {spans}; whole script "
          f"{time.perf_counter() - t_script:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
