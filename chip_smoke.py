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
  5. times   stereo_pair per frame and each kernel, against the plain path.

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


def circ_diff(a, b):
    d = (a - b).abs() % 360.0
    return d.minimum(360.0 - d)


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
    kernels = [
        {"name": "fast_detect_with_fallback", "route": "cuda",
         "source": "orb_slam2_tpu_torch/csrc/fast.cu",
         "replaces": "orb_slam2_tpu/ops/fast_pallas.py:137",
         "launches": launches["fast"], "max_abs_err": fast_err,
         "ms": fast_ms, "plain_ms": fast_plain_ms,
         "per": "8 pyramid levels of one 376x1240 image"},
        {"name": "orb_describe_oriented", "route": "cuda",
         "source": "orb_slam2_tpu_torch/csrc/orb.cu",
         "replaces": "orb_slam2_tpu/ops/orb_pallas.py:174",
         "launches": launches["orb"], "max_abs_err": ang_err,
         "ms": orb_ms, "plain_ms": orb_plain_ms,
         "per": "8 levels' budgets of one image (2000 keypoints); "
                "max_abs_err is the angle in degrees",
         "desc_identical_share": desc_share},
        {"name": "stereo_sad_strips", "route": "cuda",
         "source": "orb_slam2_tpu_torch/csrc/stereo.cu",
         "replaces": "orb_slam2_tpu/ops/stereo_pallas.py:125",
         "launches": launches["stereo"], "max_abs_err": sad_err,
         "ms": sad_ms, "plain_ms": sad_plain_ms,
         "per": f"N={n_sad} keypoints on level 0"},
    ]
    for k in kernels:
        print(json.dumps({"metric": "kernel_ms", "name": k["name"],
                          "ms": k["ms"], "plain_ms": k["plain_ms"],
                          "per": k["per"], "gpu": gpu}))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
