"""Smoke test of the PyTorch / CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a Hopper card (the kernels
are built for sm_90a) and the CUDA toolkit.  It imports nothing of JAX and
nothing of the JAX package, and exits non-zero, printing no result, when
there is no CUDA device or any phase fails.  Phases:

  1. build   compile the three Hopper kernels from csrc/ with nvcc;
  2. kernels hold each kernel against its plain PyTorch version on the
             card, at the shapes of the main path (a 376x1240 KITTI-shaped
             frame, 2000 features): FAST maps and SAD scores exactly
             equal, angles within 1e-4 deg, descriptors bit-identical on
             >= 99.9% of valid keypoints;
  3. slice   FrameBuilder.stereo_pair on 5 rendered stereo pairs with the
             kernels: >= 500 valid features and >= 100 stereo depths a
             frame, median depth error <= 3% against the rendered depth,
             and the same xy / octave / valid as the plain path on the card;
  4. counts  every kernel launched during the slice;
  5. times   stereo_pair per frame and each kernel, against the plain path,
             each kernel also timed inside a CUDA graph;
  6. track   the fused stereo tracking step (slam/track_step.py) on 12
             consecutive rendered poses, 2.25 deg apart: frame 0 gives the
             map, frames 1-11 go through the step replayed as one CUDA
             graph a frame.  Every frame: >= 20 motion-model matches,
             >= 30 inliers, pose within 0.05 m and 0.5 deg of the truth;
             the replay equals the eager step (Tcw within 1e-5, assign,
             inlier and vis_local equal) and the kernel path the plain
             path (Tcw within 1e-4, assign equal on >= 99% of valid
             features); the three kernels appear among the device kernels
             of a profiled replay; step times (graph, eager, eager plain),
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
                 compared for determinism.

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

ANGLE_ATOL_DEG = 1e-4
DESC_MIN_SHARE = 0.999
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
KERNEL_NAMES = {"fast": "fast_cell_kernel", "orb": "orb_describe_kernel",
                "stereo": "sad_strips_kernel"}

# the system phase
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_stereo_traj.npz")
GOLDEN_MAX_DEV_M = 5e-3
N_SYSTEM = 40
MIN_KEYFRAMES = 3
BA_CAM_ATOL, BA_PTS_ATOL, BA_BAD_SHARE = 1e-4, 1e-3, 0.99
PROFILED_KEYFRAME_PASS = 3     # the mapper's fourth pass (0-based)


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


def graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """`fn` captured once in a CUDA graph: median over `reps` of the mean
    time of `iters` replays, by CUDA events.  No Python runs between the
    kernels, so this is the device's time plus the graph's own launch
    gaps."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, iters, reps)


def profile_call(torch, fn) -> dict:
    """One call of `fn` under torch.profiler: the device kernels' names,
    the launch API calls by name, the device's busy share of the call's
    wall time, and device time by kernel name."""
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
    by_family = {}
    for e in dev:
        fam = kernel_family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    return {"names": {e.name for e in dev}, "n_device": len(dev),
            "launches": launches,
            "wall_ms": (span.end - span.start) / 1e3,
            "busy_ms": busy / 1e3,
            "busy_share": busy / max(span.end - span.start, 1e-9),
            "device_ms_by_family": by_family}


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
    for name, c in launches.items():
        check(c > 0, f"kernel {name} was not launched by the track step")

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
        check(any(kname in nm for nm in prof_graph["names"]),
              f"kernel {kname} not among the replay's device kernels")
    for name, prof in (("replay", prof_graph), ("eager step", prof_eager)):
        print(f"[track] profiled {name}: {prof['n_device']} device kernels "
              f"and copies; launch calls {prof['launches']}; device busy "
              f"{prof['busy_ms']:.2f} ms = {100 * prof['busy_share']:.1f}% "
              f"of {prof['wall_ms']:.2f} ms")
    fams = sorted(prof_graph["device_ms_by_family"].items(),
                  key=lambda kv: -kv[1])
    print("[track] replay device ms by kernel family: " + ", ".join(
        f"{k} {v:.3f}" for k, v in fams))

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
    return {"launches": launches, "times": times}


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


def system_phase(torch, np, dev, settings, scene, gpu) -> dict:
    """Phase 7b and 7c: N_SYSTEM KITTI-shaped frames through the System on
    the card, then one gathered local-BA problem on the card against the
    CPU."""
    from orb_slam2_tpu_torch.config import Sensor
    from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda
    from orb_slam2_tpu_torch.slam.track_step import GraphStep
    from orb_slam2_tpu_torch.solvers import ba
    from orb_slam2_tpu_torch.system import System
    from synthetic import circle_trajectory
    import test_torch_track_blocks as blocks_mod

    poses = circle_trajectory(240, orbit_r=3.0,
                              total_angle=3 * np.pi)[:N_SYSTEM]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BF / FX
    pairs = [(scene.render(T).astype(np.uint8),
              scene.render(Trl @ T).astype(np.uint8)) for T in poses]
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
    return {"launches": launches}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    from orb_slam2_tpu_torch.config import Settings
    from orb_slam2_tpu_torch.ops import (
        cuda_build, fast, fast_cuda, frontend, gaussian, orb_cuda, pyramid,
        stereo_cuda,
    )
    from orb_slam2_tpu_torch.slam.frame import FrameBuilder
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

    # ---- 2. each kernel against its plain version --------------------------
    img_l = torch.from_numpy(pairs[0][0].astype(np.uint8)).to(dev)
    img_r = torch.from_numpy(pairs[0][1].astype(np.uint8)).to(dev)
    levels = pyramid.compute_pyramid(img_l, 8, settings.scale_factor)
    budgets = frontend.level_budgets(N_FEATURES, 8, settings.scale_factor)
    border = frontend.EDGE_THRESHOLD - 3
    blurred = [gaussian.blur7x7(lv) for lv in levels]
    per_level = []
    fast_err = 0.0
    for lv, bud in zip(levels, budgets):
        k = fast_cuda.detect_with_fallback_cuda(lv, 20, 7, border)
        p = fast_cuda.detect_with_fallback_plain(lv, 20, 7, border)
        torch.cuda.synchronize()
        fast_err = max(fast_err, float((k - p).abs().max()))
        check(torch.equal(k, p), f"FAST map differs at level {tuple(lv.shape)}")
        check(int((p > 0).sum()) > 0, "FAST found no corners")
        xy, _, valid = fast.select_topk_grid(p, bud, 24)
        per_level.append((xy, valid))
    print(f"[fast] 8 levels {[tuple(lv.shape) for lv in levels]} "
          f"exactly equal")

    ang_err = 0.0
    n_same = n_valid = 0
    for lv, bl, (xy, valid) in zip(levels, blurred, per_level):
        ka, kd = orb_cuda.describe_oriented_cuda(lv, bl, xy, valid)
        pa, pd = orb_cuda.describe_oriented_plain(lv, bl, xy, valid)
        torch.cuda.synchronize()
        ang_err = max(ang_err, float(circ_diff(ka, pa)[valid].max()))
        n_same += int((kd == pd).all(1)[valid].sum())
        n_valid += int(valid.sum())
        check(bool((kd[~valid] == 0).all()), "descriptor of an invalid kp")
    desc_share = n_same / max(n_valid, 1)
    print(f"[describe] budgets {budgets}: max angle err {ang_err:.3g} deg, "
          f"descriptors identical on {n_same}/{n_valid} = "
          f"{100 * desc_share:.3f}% of valid keypoints")
    check(ang_err <= ANGLE_ATOL_DEG, f"angle error {ang_err} deg")
    check(desc_share >= DESC_MIN_SHARE, f"descriptor share {desc_share}")

    n_sad = frontend.padded_total(N_FEATURES, 8, settings.scale_factor)
    rng = np.random.default_rng(0)
    lo, hi = stereo_cuda.W + stereo_cuda.L, W - 1 - stereo_cuda.W - stereo_cuda.L
    yc = torch.from_numpy(rng.integers(stereo_cuda.W, H - stereo_cuda.W,
                                       n_sad).astype(np.int32)).to(dev)
    xl = torch.from_numpy(rng.integers(lo, hi + 1, n_sad).astype(np.int32)).to(dev)
    xr = (xl - torch.from_numpy(rng.integers(0, 60, n_sad).astype(np.int32))
          .to(dev)).clamp(lo, hi).int()
    lf, rf = img_l.float(), img_r.float()
    ks = stereo_cuda.sad_strips_cuda(lf, rf, yc, xl, xr)
    ps = stereo_cuda.sad_strips_plain(lf, rf, yc, xl, xr)
    torch.cuda.synchronize()
    sad_err = float((ks - ps).abs().max())
    check(torch.equal(ks, ps), f"SAD differs by up to {sad_err}")
    print(f"[sad] N={n_sad} on {H}x{W}: exactly equal")

    # ---- 3. the slice, through the kernels ---------------------------------
    fast_cuda.launches = orb_cuda.launches = stereo_cuda.launches = 0
    builder = FrameBuilder(settings, device=dev)
    frames = [builder.stereo_pair(l, r, 0.1 * i)
              for i, (l, r) in enumerate(pairs)]
    torch.cuda.synchronize()
    launches = {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
                "stereo": stereo_cuda.launches}

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
        print(f"[slice] frame {i}: {n_valid} valid, {int(has_d.sum())} depths, "
              f"median depth err {100 * err:.3f}%, vs plain path: xy/octave/"
              f"valid equal={np.array_equal(ff.xy, pff.xy)}/"
              f"{np.array_equal(ff.octave, pff.octave)}/"
              f"{np.array_equal(ff.valid, pff.valid)}, descriptors "
              f"{100 * same_desc:.3f}%, matched set {100 * same_depth:.3f}%")
        check(ff.xy.shape == (n_sad, 2) and np.isfinite(ff.xy).all(),
              "xy shape or values")
        check(n_valid >= MIN_VALID, f"frame {i}: {n_valid} valid features")
        check(int(has_d.sum()) >= MIN_DEPTHS, f"frame {i}: too few depths")
        check(err <= MAX_MEDIAN_DEPTH_ERR, f"frame {i}: depth error {err}")
        check(np.array_equal(ff.xy, pff.xy)
              and np.array_equal(ff.octave, pff.octave)
              and np.array_equal(ff.valid, pff.valid),
              f"frame {i}: kernel and plain paths differ in xy/octave/valid")

    # ---- 4. launch counts --------------------------------------------------
    print(f"[counts] launches during the slice: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the slice")

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

    fast_ms = cuda_ms(torch, lambda: [fast_cuda.detect_with_fallback_cuda(
        lv, 20, 7, border) for lv in levels])
    fast_plain_ms = cuda_ms(torch, lambda: [
        fast_cuda.detect_with_fallback_plain(lv, 20, 7, border)
        for lv in levels])
    orb_args = list(zip(levels, blurred, *zip(*per_level)))
    orb_ms = cuda_ms(torch, lambda: [orb_cuda.describe_oriented_cuda(*a)
                                     for a in orb_args])
    orb_plain_ms = cuda_ms(torch, lambda: [
        orb_cuda.describe_oriented_plain(*a) for a in orb_args])
    sad_ms = cuda_ms(torch, lambda: stereo_cuda.sad_strips_cuda(
        lf, rf, yc, xl, xr))
    sad_plain_ms = cuda_ms(torch, lambda: stereo_cuda.sad_strips_plain(
        lf, rf, yc, xl, xr))
    # the same launch loops, each captured once in a CUDA graph: the
    # wrappers' Python cost leaves the measurement
    in_graph = {
        "fast": (lambda: [fast_cuda.detect_with_fallback_cuda(
                     lv, 20, 7, border) for lv in levels],
                 lambda: [fast_cuda.detect_with_fallback_plain(
                     lv, 20, 7, border) for lv in levels]),
        "orb": (lambda: [orb_cuda.describe_oriented_cuda(*a)
                         for a in orb_args],
                lambda: [orb_cuda.describe_oriented_plain(*a)
                         for a in orb_args]),
        "stereo": (lambda: stereo_cuda.sad_strips_cuda(lf, rf, yc, xl, xr),
                   lambda: stereo_cuda.sad_strips_plain(lf, rf, yc, xl,
                                                        xr)),
    }
    graph_times = {name: (graph_ms(torch, k), graph_ms(torch, p))
                   for name, (k, p) in in_graph.items()}

    # ---- 6. the fused tracking step, one CUDA graph a frame --------------
    track = track_phase(torch, np, dev, settings, scene, gpu)

    # ---- 7. the stereo System: golden, KITTI-shaped run, one local BA ------
    golden_phase(np, dev)
    system = system_phase(torch, np, dev, settings, scene, gpu)
    kernels = [
        {"name": "fast_detect_with_fallback", "route": "cuda",
         "source": "orb_slam2_tpu_torch/csrc/fast.cu",
         "replaces": "orb_slam2_tpu/ops/fast_pallas.py:137",
         "launches": launches["fast"], "max_abs_err": fast_err,
         "ms": fast_ms, "plain_ms": fast_plain_ms,
         "graph_ms": graph_times["fast"][0],
         "plain_graph_ms": graph_times["fast"][1],
         "launches_track_step": track["launches"]["fast"],
         "launches_system": system["launches"]["fast"],
         "per": "8 pyramid levels of one 376x1240 image"},
        {"name": "orb_describe_oriented", "route": "cuda",
         "source": "orb_slam2_tpu_torch/csrc/orb.cu",
         "replaces": "orb_slam2_tpu/ops/orb_pallas.py:174",
         "launches": launches["orb"], "max_abs_err": ang_err,
         "ms": orb_ms, "plain_ms": orb_plain_ms,
         "graph_ms": graph_times["orb"][0],
         "plain_graph_ms": graph_times["orb"][1],
         "launches_track_step": track["launches"]["orb"],
         "launches_system": system["launches"]["orb"],
         "per": "8 levels' budgets of one image (2000 keypoints); "
                "max_abs_err is the angle in degrees",
         "desc_identical_share": desc_share},
        {"name": "stereo_sad_strips", "route": "cuda",
         "source": "orb_slam2_tpu_torch/csrc/stereo.cu",
         "replaces": "orb_slam2_tpu/ops/stereo_pallas.py:125",
         "launches": launches["stereo"], "max_abs_err": sad_err,
         "ms": sad_ms, "plain_ms": sad_plain_ms,
         "graph_ms": graph_times["stereo"][0],
         "plain_graph_ms": graph_times["stereo"][1],
         "launches_track_step": track["launches"]["stereo"],
         "launches_system": system["launches"]["stereo"],
         "per": f"N={n_sad} keypoints on level 0"},
    ]
    for k in kernels:
        print(json.dumps({"metric": "kernel_ms", "name": k["name"],
                          "ms": k["ms"], "plain_ms": k["plain_ms"],
                          "graph_ms": k["graph_ms"],
                          "plain_graph_ms": k["plain_graph_ms"],
                          "per": k["per"], "gpu": gpu}))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
