"""The port's benchmark: bench.py's five timed passes on one CUDA card.

    python3 bench_torch.py [--device cuda|cpu]

Prints, last, ONE JSON line with exactly bench.py's keys.  It runs what
bench.py runs (bench.py:53-431), on orb_slam2_tpu_torch and in the same
order, on one process: the KITTI-shaped circuit (376x1240 stereo, 2000
ORB features, a textured cylinder, BENCH_FRAMES poses over 1.5 orbits), a
vocabulary trained on 30 rendered views, one stereo System precompiled and
timed (`precompile_s`), then five timed passes, each on a System of its
own with the async scheduler and the vocabulary:

  1. mono: 3 x BENCH_FRAMES poses of the same orbit, at a third of the
     angular rate (bench.py:301-334);
  2. RGB-D: the left images with the rendered depth (bench.py:335-340);
  3. unpipelined stereo: a call's time is the time to a solved pose;
  4. pipelined stereo: the headline `value` and the pose latency;
  5. pipelined stereo with a kidnap: 5 black pairs from BENCH_KIDNAP_AT.

Every pass paces its calls to `settings.fps` (10 Hz), polls delivered
results while it waits, prefetches the next frame's images after each call
and ends with bench.py's untimed drain of at most 20 s.  Unlike bench.py,
which leans on JAX's process-wide compile cache, every pass's System runs
`precompile()` before its first timed frame (untimed): each Tracker holds
its own chained step and graphs.  The captures made inside each timed
window are printed and should be 0.

Health, a pass at a time (`degraded_passes`): final state OK, >= 3
keyframes, no reset, and a loop closed or keyframe ATE <= 0.5 m (the
Umeyama-aligned ATE for mono; not asked of the kidnap pass), and on the
kidnap pass at least one relocalization (bench.py:235-259).

What the timer wraps, as in bench.py: the caller's `track_*` call, not
synchronised.  A pipelined call returns once the frame's graph is
launched, so `value` (1 / median call time of the pipelined pass)
measures how long the caller is held; `pose_latency_*` measures the time
from a frame's call to its solved pose landing in the trajectory.  A
pipelined pass's last frames still in flight when the drain ends are
missing from its trajectory, as in bench.py (it does not call
System.drain()).

`unit` names the card as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` prints it; `vs_baseline` is fps / 30, the 30 Hz
camera rate.  Earlier lines, each with the card's name and power limit:
each pass's captures and kernel launches inside its timed window, its
seconds, and the memory allocated after it.

Knobs, under bench.py's names: BENCH_FRAMES (default 240) and
BENCH_KIDNAP_AT (default min(60, BENCH_FRAMES // 3)).  `--device`
defaults to the card; without one the bench exits non-zero unless the CPU
is asked for by name.
"""

import argparse
import copy
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from orb_slam2_tpu_torch import convert  # noqa: E402
from orb_slam2_tpu_torch.config import Sensor, Settings  # noqa: E402
from orb_slam2_tpu_torch.ops import (  # noqa: E402
    fast_cuda, frontend, orb_cuda, stereo_cuda,
)
from orb_slam2_tpu_torch.places.vocabulary import Vocabulary  # noqa: E402
from orb_slam2_tpu_torch.system import System  # noqa: E402
from synthetic import CylinderScene, circle_trajectory  # noqa: E402

# KITTI-00 stereo geometry (Examples/Stereo/KITTI00-02.yaml)
H, W = 376, 1240
FX = FY = 718.856
CX, CY = 607.19, 185.22
BF = 386.1448
N_FEATURES = 2000
KIDNAP_LEN = 5
VOC_VIEWS, VOC_K, VOC_L = 30, 10, 4
DRAIN_S = 20.0
MAX_ATE_M = 0.5
MIN_KEYFRAMES = 3


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def kitti_settings() -> Settings:
    """bench.py:68-81.  th_depth=9.5 splits the synthetic cylinder's
    5.5-11 m depth band the way ThDepth=35 splits KITTI's."""
    settings = Settings(
        fx=FX, fy=FY, cx=CX, cy=CY, bf=BF, width=W, height=H,
        n_features=N_FEATURES, fps=10.0, th_depth=9.5,
    )
    settings.pipelined = True
    return settings


def render_all(fn, poses) -> list:
    """fn(T) for every pose, on a few host threads (the renderer is numpy)."""
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        return list(pool.map(fn, poses))


def make_circuit(n_frames: int):
    """bench.py's circuit (bench.py:82-98): the textured cylinder, n_frames
    poses over 1.5 orbits and their rendered stereo pairs.  Returns
    (scene, poses, pairs)."""
    scene = CylinderScene(kitti_settings().K, H, W, radius=8.0, tex_h=2048)
    poses = circle_trajectory(n_frames, orbit_r=3.0,
                              total_angle=2 * np.pi * 1.5)
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BF / FX
    pairs = render_all(lambda T: (scene.render(T), scene.render(Trl @ T)),
                       poses)
    return scene, poses, pairs


def train_vocabulary(scene, device) -> Vocabulary:
    """bench.py's recipe (bench.py:101-114): the descriptors of VOC_VIEWS
    rendered views around the orbit, extracted on `device`, then a k=10 /
    L=4 tree by hierarchical k-medians on the host."""
    t0 = time.perf_counter()
    descs = []
    for T in circle_trajectory(VOC_VIEWS, orbit_r=3.0,
                               total_angle=2 * np.pi):
        img = torch.from_numpy(scene.render(T).astype(np.uint8)).to(device)
        d = convert.features_to_numpy(
            frontend.extract(img, n_features=N_FEATURES))
        descs.append(d["desc"][d["valid"]])
    t1 = time.perf_counter()
    voc = Vocabulary.train(np.concatenate(descs), k=VOC_K, L=VOC_L,
                           levels_up=1)
    print(f"[vocabulary] {sum(len(d) for d in descs)} descriptors of "
          f"{VOC_VIEWS} views in {t1 - t0:.1f} s, trained k={VOC_K} "
          f"L={VOC_L} ({len(voc.node_desc)} nodes, {voc.n_words} words) in "
          f"{time.perf_counter() - t1:.1f} s on the host")
    return voc


def kf_ate(s, gt_poses, period=0.1, mono_scale=False):
    """Keyframe ATE against the rendered trajectory (bench.py:116-155).
    mono_scale: a similarity (Umeyama) alignment first, the standard mono
    ATE protocol: the mono map is anchored at its init frame, a rigid
    transform and a scale away from gt_poses[0]."""
    st = s.map
    T0 = gt_poses[0].copy()
    est, gt = [], []
    for k in st.valid_kf_ids():
        k = int(k)
        fi = int(round(st.kf_timestamp[k] / period))
        if fi >= len(gt_poses):
            continue
        Tg = gt_poses[fi] @ np.linalg.inv(T0)
        Te = st.kf_pose[k]
        est.append(-Te[:3, :3].T @ Te[:3, 3])
        gt.append(-Tg[:3, :3].T @ Tg[:3, 3])
    est, gt = np.asarray(est), np.asarray(gt)
    if len(est) < 3:
        return float("inf")
    if mono_scale:
        me, mg = est.mean(0), gt.mean(0)
        ec, gc_ = est - me, gt - mg
        ne = np.linalg.norm(ec, axis=1)
        keep = ne > 1e-6
        if keep.sum() >= 3:
            U, _, Vt = np.linalg.svd(ec.T @ gc_)
            Ra = (U @ Vt).T
            if np.linalg.det(Ra) < 0:
                U[:, -1] *= -1
                Ra = (U @ Vt).T
            sc = np.median(np.linalg.norm(gc_[keep], axis=1) / ne[keep])
            est = (ec @ Ra.T) * sc + mg
            gt = gc_ + mg
    return float(np.sqrt(((est - gt) ** 2).sum(1).mean()))


def kernel_launches() -> dict:
    """The three kernel wrappers' launch counts so far."""
    return {"fast": fast_cuda.launches, "orb": orb_cuda.launches,
            "stereo": stereo_cuda.launches}


def _captures(step) -> int:
    """CUDA-graph captures of a tracking step so far (0 for an eager step
    or none)."""
    return getattr(step, "captures", 0)


def run_pass(make_system, track_name, frames, gt_poses, *, pipelined,
             kidnap, kidnap_at, kidnap_len=KIDNAP_LEN, precompile=True):
    """One timed pass at the camera rate: bench.py's run_once
    (bench.py:157-275) on the System that make_system(pipelined) returns,
    through its method `track_name` ("track_stereo", "track_rgbd" or
    "track_monocular").  `frames` holds each call's images; on the kidnap
    pass frames kidnap_at .. kidnap_at + kidnap_len - 1 are all zeros.
    precompile: warm up and capture the System's programs first, untimed.

    Returns (call seconds, pose latencies in seconds, stats, healthy).
    stats holds bench.py's per-pass keys and "window": what the timed
    window saw (graph captures, kernel launches, precompile, frames' and
    drain seconds, the final tracking state)."""
    s = make_system(pipelined)
    track = getattr(s, track_name)
    t0 = time.perf_counter()
    if precompile:
        s.precompile()
    precompile_s = time.perf_counter() - t0
    # the fast step is one per settings in the process; each Tracker
    # builds its chained step (and captures its graphs) itself
    fast = s.tracker._get_fast_step()
    chain = s.tracker._chain_step
    fast0, chain0 = _captures(fast), _captures(chain)
    log0 = len(getattr(chain, "capture_log", ()))
    launches0 = kernel_launches()
    times = []
    max_queue = 0
    t_disp = {}           # frame timestamp -> dispatch wall time
    lat = []              # authoritative-pose latency per frame
    n_seen = 0

    def note(now):
        """Stamp latencies for trajectory entries appended since the last
        call (authoritative poses land exactly once per frame, in
        order)."""
        nonlocal n_seen
        traj = s.tracker.trajectory
        while n_seen < len(traj):
            ts = traj[n_seen].timestamp
            if ts in t_disp:
                lat.append(now - t_disp[ts])
            n_seen += 1

    period = 1.0 / s.settings.fps
    t_start = t_next = time.perf_counter()
    for i, frame in enumerate(frames):
        while True:
            now = time.perf_counter()
            if now >= t_next:
                break
            if s.poll():
                note(time.perf_counter())
            time.sleep(min(0.002, max(t_next - now, 0.0)))
        t_next = max(t_next + period, time.perf_counter())
        if kidnap and kidnap_at <= i < kidnap_at + kidnap_len:
            frame = tuple(np.zeros_like(f) for f in frame)
        ts = i * 0.1
        t0 = time.perf_counter()
        t_disp[ts] = t0
        track(*frame, ts)
        t1 = time.perf_counter()
        note(t1)
        times.append(t1 - t0)
        if i + 1 < len(frames):
            s.prefetch(*frames[i + 1])
        max_queue = max(max_queue, len(s.local_mapper.queue))
    t_drain = time.perf_counter()
    while time.perf_counter() - t_drain < DRAIN_S:
        if s.poll():
            note(time.perf_counter())
        if (not s.tracker._pending and s.local_mapper.idle()
                and (s.loop_closer is None or s.loop_closer.idle())):
            break
        time.sleep(0.002)
    note(time.perf_counter())
    drain_s = time.perf_counter() - t_drain
    chain_end = s.tracker._chain_step
    log = list(getattr(chain_end, "capture_log", ()))
    if chain_end is chain:
        chain_caps, log = _captures(chain) - chain0, log[log0:]
    else:     # built inside the window, or replaced by a reset
        chain_caps = _captures(chain) - chain0 + _captures(chain_end)
    launches = kernel_launches()

    ate = (kf_ate(s, gt_poses, mono_scale=track_name == "track_monocular")
           if gt_poses is not None else float("inf"))
    drift_corrected = (
        (s.loop_closer is not None
         and s.loop_closer.loops_closed >= 1) or ate <= MAX_ATE_M)
    ok = (s.tracker.state.name == "OK"
          and int(s.map.kf_valid.sum()) >= MIN_KEYFRAMES
          and s.tracker.resets == 0
          and (kidnap or drift_corrected)
          and (not kidnap or s.tracker.relocalizations >= 1))
    stats = {
        "n_keyframes": int(s.map.kf_valid.sum()),
        "loops_closed": int(s.loop_closer.loops_closed
                            if s.loop_closer else 0),
        "max_queue": max_queue,
        "n_resets": s.tracker.resets,
        "relocalizations": s.tracker.relocalizations,
        "kf_ate_m": round(ate, 3) if np.isfinite(ate) else None,
    }
    # mean mapping time per processed keyframe; the lm/ba_* timers are
    # nested inside lm/local_ba, so summing them too would double-count,
    # and the pass's own span, its queue wait and its lock waits are not
    # stages
    lm = s.local_mapper.timers
    n_kf_proc = max(lm.counts.get("lm/process_new_kf", 1), 1)
    stats["mapper_ms_per_kf"] = round(
        sum(v for k, v in lm.totals.items()
            if not k.startswith("lm/ba_") and k not in (
                "lm/keyframe", "lm/queue_wait", "lm/lock_wait"))
        / n_kf_proc * 1e3, 1)
    stats["window"] = {
        "captures": {"fast_step": _captures(fast) - fast0,
                     "chain_step": chain_caps, "chain_log": log},
        "launches": {k: launches[k] - launches0[k] for k in launches},
        "precompile_s": precompile_s,
        "frames_s": t_drain - t_start, "drain_s": drain_s,
        "state": s.tracker.state.name,
    }
    s.shutdown()
    return times, lat, stats, ok


def quantiles(xs, skip=3):
    xs = sorted(xs[skip:])
    if not xs:
        return 0.0, 0.0, 0.0
    return (xs[len(xs) // 2], xs[int(len(xs) * 0.9)], xs[-1])


def worst_at(xs, skip=3):
    """Frame index of the worst per-call time (a worst frame at the kidnap
    or the revisit is SLAM work, one at a random index a stall)."""
    if len(xs) <= skip:
        return -1
    return int(max(range(skip, len(xs)), key=lambda i: xs[i]))


def report(results: dict, n_frames: int, precompile_s: float,
           card: str) -> dict:
    """bench.py's output line (bench.py:360-430) from the five passes'
    (times, latencies, stats, healthy), keyed "mono", "rgbd",
    "unpipelined", "pipelined" and "kidnap"; stats without "window"."""
    times_m, _, stats_m, ok_m = results["mono"]
    times_r, _, stats_r, ok_r = results["rgbd"]
    times_u, _, stats_u, ok_u = results["unpipelined"]
    times_p, lat_p, stats_p, ok_p = results["pipelined"]
    times_k, _, stats_k, ok_k = results["kidnap"]
    degraded = [name for name, ok in (
        ("unpipelined", ok_u), ("pipelined", ok_p), ("kidnap", ok_k),
        ("mono", ok_m), ("rgbd", ok_r)) if not ok]

    p50_u, p90_u, worst_u = quantiles(times_u)
    p50_p, p90_p, worst_p = quantiles(times_p)
    p50_k, p90_k, worst_k = quantiles(times_k)
    lat50, lat90, lat_worst = quantiles(lat_p)
    fps = 1.0 / p50_p
    out = {
        "metric": "kitti_shape_stereo_tracking_fps",
        "value": round(fps, 2),
        "unit": "frames/sec (median dispatch, 1240x376 stereo, 2000 ORB "
                f"features, {n_frames}-frame loop circuit, async "
                f"pipelined) [{card}]",
        # vs the 30 Hz camera rate
        "vs_baseline": round(fps / 30.0, 3),
        "p50_ms": round(p50_p * 1e3, 1),
        "p90_ms": round(p90_p * 1e3, 1),
        "worst_ms": round(worst_p * 1e3, 1),
        "pose_latency_p50_ms": round(lat50 * 1e3, 1),
        "pose_latency_p90_ms": round(lat90 * 1e3, 1),
        "pose_latency_worst_ms": round(lat_worst * 1e3, 1),
        "fps_unpipelined": round(1.0 / p50_u, 2),
        "unpipelined_p90_ms": round(p90_u * 1e3, 1),
        "unpipelined_worst_ms": round(worst_u * 1e3, 1),
        "worst_frame_idx": worst_at(times_p),
        "unpipelined_worst_frame_idx": worst_at(times_u),
        "precompile_s": precompile_s,
        "n_frames": n_frames,
        "degraded_passes": degraded,
    }
    out.update(stats_p)
    out["n_keyframes_unpipelined"] = stats_u["n_keyframes"]
    out.update({
        "kidnap_fps": round(1.0 / max(p50_k, 1e-9), 2),
        "kidnap_p90_ms": round(p90_k * 1e3, 1),
        "kidnap_worst_ms": round(worst_k * 1e3, 1),
        "relocalizations": stats_k["relocalizations"],
        "kidnap_resets": stats_k["n_resets"],
    })
    p50_m, p90_m, worst_m = quantiles(times_m)
    p50_r, p90_r, worst_r = quantiles(times_r)
    out.update({
        "mono_fps": round(1.0 / max(p50_m, 1e-9), 2),
        "mono_p90_ms": round(p90_m * 1e3, 1),
        "mono_worst_ms": round(worst_m * 1e3, 1),
        "mono_keyframes": stats_m["n_keyframes"],
        "mono_loops": stats_m["loops_closed"],
        "mono_ate_m": stats_m["kf_ate_m"],
        "rgbd_fps": round(1.0 / max(p50_r, 1e-9), 2),
        "rgbd_p90_ms": round(p90_r * 1e3, 1),
        "rgbd_worst_ms": round(worst_r * 1e3, 1),
        "rgbd_keyframes": stats_r["n_keyframes"],
        "rgbd_loops": stats_r["loops_closed"],
        "rgbd_ate_m": stats_r["kf_ate_m"],
        "kf_ate_unpipelined_m": stats_u["kf_ate_m"],
        "kidnap_ate_m": stats_k["kf_ate_m"],
    })
    return out


def settle(device) -> dict:
    """Free what the last System left behind; the card's memory after."""
    gc.collect()
    if device.type != "cuda":
        return {}
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return {"memory_allocated": torch.cuda.memory_allocated(device),
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}


def main(argv=None, vocabulary=None) -> dict:
    """Run the bench and print its lines.  vocabulary: one already trained
    by train_vocabulary on this circuit's scene (else it is trained here).
    Returns {"out": the last line's dict, "passes": each pass's
    record}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the Systems run (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("bench_torch: torch.cuda.is_available() is false; pass "
                 "--device cpu to run on the CPU")
    if args.device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        card = gpu_line()
    else:
        device, card = torch.device("cpu"), "cpu"

    n_frames = int(os.environ.get("BENCH_FRAMES", "240"))
    # after the map is established (> 5 keyframes, so the lost-near-init
    # reset cannot fire); the blackout strands the camera until the view
    # overlaps the map again and relocalization re-anchors it
    kidnap_at = int(os.environ.get("BENCH_KIDNAP_AT",
                                   str(min(60, n_frames // 3))))
    settings = kitti_settings()
    scene, poses, pairs = make_circuit(n_frames)
    voc = (vocabulary if vocabulary is not None
           else train_vocabulary(scene, device))

    def factory(sensor):
        def make(pipelined):
            s = copy.copy(settings)       # each System its own settings
            s.pipelined = pipelined
            return System(s, sensor, vocabulary=voc, scheduler="async",
                          device=device)
        return make

    # every shape-bucketed program warmed up before any timed frame
    t0 = time.perf_counter()
    pre_sys = System(copy.copy(settings), Sensor.STEREO, vocabulary=voc,
                     scheduler="sync", device=device)
    pre_sys.precompile()
    precompile_s = round(time.perf_counter() - t0, 1)
    pre_sys.shutdown()
    del pre_sys
    print(json.dumps({"metric": "bench_precompile", "seconds": precompile_s,
                      **settle(device), "gpu": card}))

    results, passes = {}, {}

    def timed_pass(name, sensor, track_name, frames, gt_poses, **kw):
        t0 = time.perf_counter()
        res = run_pass(factory(sensor), track_name, frames, gt_poses,
                       kidnap_at=kidnap_at, **kw)
        window = res[2].pop("window")
        rec = {"metric": "bench_pass", "pass": name, "healthy": res[3],
               "frames": len(frames), "seconds": time.perf_counter() - t0,
               **window, "stats": res[2], **settle(device), "gpu": card}
        print(json.dumps(rec))
        results[name], passes[name] = res, rec

    # mono and RGB-D first, as bench.py runs them (bench.py:303-340)
    poses_m = circle_trajectory(3 * n_frames, orbit_r=3.0,
                                total_angle=2 * np.pi * 1.5)
    mono_frames = render_all(lambda T: (scene.render(T),), poses_m)
    timed_pass("mono", Sensor.MONOCULAR, "track_monocular", mono_frames,
               poses_m, pipelined=True, kidnap=False)
    del mono_frames
    depth_frames = [(left, scene.depth_at(T).astype(np.float32))
                    for (left, _), T in zip(pairs, poses)]
    timed_pass("rgbd", Sensor.RGBD, "track_rgbd", depth_frames, poses,
               pipelined=True, kidnap=False)
    del depth_frames
    timed_pass("unpipelined", Sensor.STEREO, "track_stereo", pairs, poses,
               pipelined=False, kidnap=False)
    timed_pass("pipelined", Sensor.STEREO, "track_stereo", pairs, poses,
               pipelined=True, kidnap=False)
    timed_pass("kidnap", Sensor.STEREO, "track_stereo", pairs, poses,
               pipelined=True, kidnap=True)

    out = report(results, n_frames, precompile_s, card)
    print(card)
    print(json.dumps(out))
    return {"out": out, "passes": passes}


if __name__ == "__main__":
    main()
