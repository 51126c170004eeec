"""The benchmark of orb_slam2_tpu_torch: one cell, one run, one result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the port.  One process runs
one cell of BENCHMARK.json once, on one CUDA card:

  1. set-up: build or load the port's kernels (their build directories
     lie inside the checkout), render the cell's frames from the seed on
     the card and copy them to the host, load the configuration's
     vocabulary (trained from its fixed views on a checkout's first run),
     build one System with the async scheduler and call precompile();
  2. offer frames for --seconds, open loop at the camera's rate or closed
     loop, per the cell's traffic mix; with --trace 1 a fixed run of
     frames is profiled;
  3. drain for a bounded time;
  4. read the peak memory, shut the System down, judge its map, its
     trajectory and the frames caught in the window against the frozen
     reference (harness/check.py), and print
     the compared numbers on standard error and, last on standard output,
     one JSON line.

Exits non-zero, with no result line, without a card (unless `--device
cpu`, which exists only for the folder's own CPU tests), when the port is
missing, and when `jax`, `jaxlib`, `flax` or the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_tpu")
PORT = "orb_slam2_tpu_torch"
SENSOR_CALL = {"stereo": "track_stereo", "rgbd": "track_rgbd"}


def _set_cache_dirs() -> None:
    """Every kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[slambench {time.perf_counter() - T_START:7.1f} s] {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the whole name before the first dot: the port's own name begins
    with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu only for the harness's own CPU tests")
    return ap.parse_args(argv)


def quantile(values, q: float) -> float:
    """Nearest-rank quantile; a missing value is +inf."""
    xs = sorted(values)
    if not xs:
        return math.inf
    return xs[max(math.ceil(q * len(xs)) - 1, 0)]


def latencies_ms(window, open_loop: bool, t_gave_up: float) -> list:
    """Each offered frame's ms from its due time (closed loop: its offer)
    to its OK pose; a frame that got none waited until the drain gave up."""
    out = []
    for f in window.frames:
        start = f.due if open_loop else f.offered
        end = f.landed if f.landed is not None and f.ok else t_gave_up
        out.append((end - start) * 1e3)
    return out


def finite(v):
    """A number for JSON: a non-finite reading is written as null."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def timer_state(timers) -> dict:
    return {k: (timers.counts[k], timers.totals[k]) for k in timers.totals}


def timer_diff(before: dict, after: dict) -> dict:
    return {k: (c - before.get(k, (0, 0.0))[0], t - before.get(k, (0, 0.0))[1])
            for k, (c, t) in after.items()}


def train_or_load_vocabulary(cfg: dict, scene, device):
    """The configuration's vocabulary: trained once per checkout from the
    fixed views of its scene (seed-free), saved in ORBvoc.txt's format,
    and loaded from that file by every run."""
    import numpy as np
    import torch

    from orb_slam2_tpu_torch import convert
    from orb_slam2_tpu_torch.ops import frontend
    from orb_slam2_tpu_torch.places.vocabulary import Vocabulary
    from reference.truth import orbit_poses

    v = cfg["vocabulary"]
    path = CACHE / "vocabulary" / f"{cfg['name']}.txt"
    if not path.exists():
        st = cfg["settings"]
        imgs, _ = scene.render(orbit_poses(
            int(v["views"]), scene.orbit_r, 360.0 / int(v["views"]), 0.0))
        descs = []
        for img in imgs:
            f = convert.features_to_numpy(frontend.extract(
                torch.from_numpy(img).to(device),
                n_features=int(st["ORBextractor.nFeatures"]),
                n_levels=int(st["ORBextractor.nLevels"]),
                scale_factor=float(st["ORBextractor.scaleFactor"]),
                ini_th=int(st["ORBextractor.iniThFAST"]),
                min_th=int(st["ORBextractor.minThFAST"])))
            descs.append(f["desc"][f["valid"]])
        voc = Vocabulary.train(np.concatenate(descs), k=int(v["k"]),
                               L=int(v["L"]), levels_up=int(v["levels_up"]))
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        voc.save_text(str(tmp))
        os.replace(tmp, path)
    return Vocabulary.load_text(str(path), levels_up=int(v["levels_up"]))


def profiled_bounds(frames: list, profiled, cfg: dict, device) -> dict:
    """Each kernel's summed least time over the profiled frames' images,
    and the launches those frames ask for (harness/check.py's reference
    frontend gives the levels, picks and SAD centres)."""
    sys.path.insert(0, str(HERE / "metrics"))
    import kernel_bounds as kb

    from harness import check

    s = check.frontend_settings(cfg)
    n_rows = check.orb.padded_total(s["n_features"], s["n_levels"],
                                    s["scale"])
    out = {"fast": 0.0, "orb": 0.0, "stereo": 0.0, "frames": 0}
    for i in profiled:
        ref = check.reference_frame(frames[i], cfg, device)
        images = [ref] + ([ref["right"]] if "right" in ref else [])
        for im in images:
            out["fast"] += kb.fast_work(im["levels"], s["min_th"])["bound_s"]
            out["orb"] += kb.describe_work(im["levels"], im["xys"],
                                           im["valids"], n_rows)["bound_s"]
        if "centres" in ref:
            out["stereo"] += kb.refine_work(ref["levels"][0].shape[1],
                                            *ref["centres"])["bound_s"]
        out["frames"] += 1
    out["images_per_frame"] = 2 if cfg["sensor"] == "stereo" else 1
    return out


def main(argv=None, spec=None, controls: bool = False) -> dict:
    """Run one cell; print the result; return it.  `controls` (for
    control.py, never a benchmark run) adds the control's readings of the
    compared numbers to the returned dict under "controls"."""
    args = parse(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    from harness.spec import Spec

    spec = spec or Spec.load(ROOT)
    cell = spec.workload(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if not (ROOT / PORT / "__init__.py").exists():
        sys.exit(f"slambench: the port {PORT}/ is not in this checkout")
    _set_cache_dirs()

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("slambench: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(cell["chips"]):
            sys.exit(f"slambench: {cell['name']} needs {cell['chips']} "
                     f"card(s), {torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")

    from harness import check, drive, scene as scene_mod, trace
    from orb_slam2_tpu_torch.config import Sensor, Settings
    from orb_slam2_tpu_torch.system import System

    # ---- 1. set-up --------------------------------------------------------
    settings = Settings.from_dict(cfg["settings"])
    settings.pipelined = bool(cfg["pipelined"])
    fps = float(settings.fps)
    open_loop = mix["arrival"] == "open"
    rate = fps if open_loop else float(mix["max_rate_hz"])
    n_frames = int(math.ceil(args.seconds * rate)) + 1
    log(f"{cell['name']}: seed {args.seed}, {n_frames} frames to render")
    scene = scene_mod.Cylinder(cfg, device)
    poses = scene.poses(n_frames, float(mix["deg_per_frame"]), args.seed)
    sensor = cfg["sensor"]
    if sensor == "stereo":
        left, _ = scene.render(poses)
        right, _ = scene.render(poses, right=True)
        frames = list(zip(left, right))
    else:
        left, depth = scene.render(
            poses, depth_factor=float(cfg["settings"]["DepthMapFactor"]))
        frames = list(zip(left, depth))
    log("frames rendered")
    voc = train_or_load_vocabulary(cfg, scene, device)
    log("vocabulary loaded")
    del scene
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    system = System(settings, Sensor.STEREO if sensor == "stereo"
                    else Sensor.RGBD, vocabulary=voc, scheduler="async",
                    device=device)
    system.precompile(stages=mix.get("precompile"))
    log("System built and precompiled")
    track = getattr(system, SENSOR_CALL[sensor])
    timers0 = {"tracker": timer_state(system.tracker.timers),
               "mapper": timer_state(system.local_mapper.timers),
               "loop": timer_state(system.loop_closer.timers)}
    loops0 = system.loop_closer.loops_closed
    catcher = check.FrameCatcher(
        system, args.seconds, fps, args.seed, int(cfg["check"]["frames"]),
        quiet_notes=10 if settings.pipelined else 2)
    profile = None
    sub = None
    if args.trace:
        sub = trace.SubWindow()
        p = mix["profile"]
        profile = (int(p["first"]), int(p["frames"]), sub)
    setup_s = time.perf_counter() - T_START

    # ---- 2. the window, 3. the drain ---------------------------------------
    window = drive.run_window(system, track, frames, mix, fps, args.seconds,
                              profile=profile,
                              prefetch=bool(mix.get("prefetch", False)),
                              watch=catcher)
    log(f"window closed: {len(window.frames)} frames offered")
    drive.drain(system, window, fps, float(mix["drain_s"]), watch=catcher)
    t_gave_up = time.perf_counter()
    stats = system.stats()
    log(f"drained in {window.drain_s:.1f} s: {stats}")
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    run = SimpleNamespace(
        window=window, cfg=cfg, mix=mix, seconds=args.seconds,
        timers={k: timer_diff(v, timer_state(t)) for (k, v), t in zip(
            timers0.items(), (system.tracker.timers,
                              system.local_mapper.timers,
                              system.loop_closer.timers))},
        loops_closed=system.loop_closer.loops_closed - loops0,
        trace={}, bounds={})
    snap = check.snapshot(system)
    system.shutdown()
    catcher.system = catcher.seen = None
    del system, track
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if sub is not None and sub.prof is not None and window.profiled:
        run.trace = trace.read(sub)
        run.bounds = profiled_bounds(frames, window.profiled, cfg, device)
        sub.prof = None

    # ---- 4. correct, metrics, the line ---------------------------------------
    lat = latencies_ms(window, open_loop, t_gave_up)
    attempted = len(window.frames)
    failed = sum(1 for f in window.frames if f.landed is None or not f.ok)
    got = check.readings(snap, frames, poses, cfg, attempted, args.seed,
                         device, caught=catcher.caught, controls=controls)
    values, info = got[0], got[1]
    limits = json.loads((spec.dir / "limits" / f"{cell['name']}.json")
                        .read_text())["limits"]
    correct, compared = check.judge(values, limits)

    metrics = {}
    if not args.trace:
        in_window = sum(1 for f in window.frames if f.ok and f.landed
                        is not None and f.landed <= window.t_close)
        e2e = {"setup_s": setup_s,
               "pose_latency_p50_ms": quantile(lat, 0.50),
               "pose_latency_p95_ms": quantile(lat, 0.95),
               "tracked_fps": in_window / args.seconds}
        for m in spec.metrics("end_to_end", cell["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in spec.metrics("per_layer", cell["name"]):
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if args.trace and run.trace:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["compared"] = {name: {"value": finite(v), "limit": lim,
                              "sense": sense}
                       for name, v, lim, sense in compared}

    bad = forbidden_modules()
    if bad:
        sys.exit(f"slambench: loaded {', '.join(bad)}, which the port must "
                 "never import; no result")
    detail = {"setup_s": setup_s, "drain_s": window.drain_s,
              "drained": window.drained, "seed": args.seed,
              "frames_rendered": n_frames, "system": stats,
              "frames_passed_over": catcher.passed_over,
              "late_s_max": max((f.offered - f.due for f in window.frames),
                                default=0.0),
              "lost_frames": [i for i, f in enumerate(window.frames)
                              if not f.ok][:20],
              "latency_ms_p50_p95_max": [quantile(lat, 0.5),
                                         quantile(lat, 0.95), max(lat or [0])],
              "call_ms_median": statistics.median(
                  [(f.returned - f.offered) * 1e3 for f in window.frames])
              if window.frames else None,
              **info}
    print(json.dumps({"slambench_detail": detail}), file=sys.stderr)
    for name, v, lim, sense in compared:
        print(f"compared {name} {v} {sense} {lim}", file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    if controls:
        out = dict(out, controls=got[2], detail=detail,
                   control_correct=check.judge(got[2], limits)[0])
    return out


if __name__ == "__main__":
    main()
