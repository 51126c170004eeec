"""Multi-device dry run: N ranks of a torch.distributed group on this
machine run the three sharded paths and hold each against the unsharded
one.

    python -m orb_slam2_tpu_torch.parallel.dryrun N [--device cpu|cuda]

Port of orb_slam2_tpu/parallel/dryrun.py.  The JAX package ran its
sharded programs on a virtual N-device CPU mesh in one process; the
counterpart here is N processes spawned with torch.multiprocessing
(spawn start method) in one group: gloo on the CPU, NCCL on CUDA with
one rank per card.  The group rendezvous is a file in a temporary
directory, so parallel runs never compete for a TCP port.  Each rank
uses one torch thread.  The run exits non-zero if a rank fails or if the
whole run outlasts its timeout; the group's own operations time out after
GROUP_TIMEOUT_S.

The three checks (`checks`):
  1. frame-parallel ORB extraction: descriptors, xy, octave and valid of
     every frame equal to the unsharded frontend's;
  2. edge-parallel global bundle adjustment (edges sharded, every edge
     sum all-reduced) on `ba_problem()`: every rank holds the same result,
     and cameras, points and the final error lie within tolerance of the
     unsharded optimizer (the reduction order differs);
  3. the full stereo tracking step, frames sharded: finite, and each
     frame's pose within 1e-5 of the unsharded step's, its assignments and
     inliers equal.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing

from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Settings
from orb_slam2_tpu_torch.ops import frontend
from orb_slam2_tpu_torch.parallel import multichip
from orb_slam2_tpu_torch.slam import track_step
from orb_slam2_tpu_torch.solvers import ba

GROUP_TIMEOUT_S = 60.0
RUN_TIMEOUT_S = 600.0
BA_RTOL, BA_ATOL = 1e-2, 5e-3     # the JAX package's dry-run bounds
BA_ITERS = 4
TCW_ATOL = 1e-5


def _rank_main(rank, n_ranks, device, init_file, target, args):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=f"file://{init_file}", world_size=n_ranks, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        target(multichip.make_mesh(n_ranks), *args)
    finally:
        dist.destroy_process_group()


def launch(target, n_ranks: int, device: str, args=(),
           timeout: float = RUN_TIMEOUT_S) -> None:
    """Run `target(mesh, *args)` on `n_ranks` spawned processes forming
    one group (gloo for device "cpu", NCCL for "cuda", one rank per card).
    `target` must be importable by name (a module-level function).
    Raises if a rank fails (torch.multiprocessing's ProcessRaisedException
    or ProcessExitedException) or TimeoutError after `timeout` seconds;
    no rank outlives the call."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"unknown device {device!r}")
    if device == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"{n_ranks} ranks need {n_ranks} cards (NCCL "
                         f"takes one rank a card); "
                         f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as d:
        ctx = torch.multiprocessing.start_processes(
            _rank_main,
            args=(n_ranks, device, os.path.join(d, "init"), target, args),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"dry run of {n_ranks} ranks outlasted {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5.0)


def _stereo_settings(W: int = 128, H: int = 96):
    return Settings(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, bf=10.0,
                    width=W, height=H, n_features=64, n_levels=3,
                    fps=10.0, th_depth=40.0)


def track_inputs(B: int, settings, seed: int = 1) -> tuple:
    """The JAX dry run's seeded tracking-step batch: random stereo images,
    an identity prediction, a random last frame and 32 local candidates
    8 m ahead.  Returns the arguments of `track_step_sharded` after
    `settings` and (L, M)."""
    rng = np.random.default_rng(seed)
    H, W = settings.height, settings.width
    L = frontend.padded_total(settings.n_features, settings.n_levels,
                     settings.scale_factor)
    M = 32
    scal = np.zeros((B, 20), np.float32)
    scal[:, :16] = np.eye(4, dtype=np.float32).reshape(-1)
    scal[:, 19] = M
    last_f32 = np.concatenate([
        rng.normal(0, 2, (B, L, 3)).astype(np.float32)
        + np.array([0, 0, 8], np.float32),
        np.ones((B, L, 1), np.float32)], -1)
    loc_f32 = np.zeros((B, M, 8), np.float32)
    loc_f32[:, :, :3] = rng.normal(0, 2, (B, M, 3)) + np.array([0, 0, 8])
    loc_f32[:, :, 5] = -1.0
    loc_f32[:, :, 6] = 1.0
    loc_f32[:, :, 7] = 50.0
    args = (
        rng.uniform(0, 255, (B, H, W)).astype(np.float32),
        rng.uniform(0, 255, (B, H, W)).astype(np.float32),
        scal, last_f32,
        rng.integers(0, 2 ** 32, (B, L, 8), dtype=np.uint64).astype(
            np.uint32),
        rng.integers(0, 3, (B, L)).astype(np.int32),
        rng.uniform(0, 360, (B, L)).astype(np.float32),
        loc_f32,
        rng.integers(0, 2 ** 32, (B, M, 8), dtype=np.uint64).astype(
            np.uint32),
    )
    return args, (L, M)


def ba_problem(device):
    """The BA of the check: the JAX package's seeded synthetic problem at
    its test's size (4 cameras, 64 points, 512 edges; 4 LM iterations),
    with cameras 0 and 1 fixed.  Its edges are all mono and the JAX recipe
    fixes camera 0 only, which leaves the scale free: solves that sum in
    different orders then part along that gauge (on the CPU, 37 of 40
    random edge orders move cameras past the 5e-3 bound while the error
    agrees within 3e-6, and at the dry run's former 64 edges a rank two
    iterations flip LM's accept / reject; scripts/ba_order_spread.py), so
    only a problem with the scale fixed can hold a sharded solve to an
    unsharded one."""
    prob, k = multichip.synthetic_ba_problem(n_cams=4, n_pts=64,
                                             n_edges=512, device=device)
    fixed = prob.cam_fixed.clone()
    fixed[:2] = True
    return prob._replace(cam_fixed=fixed), k


def checks(mesh, out_dir=None, n_frames=None) -> None:
    """The three sharded paths on `n_frames` frames (default: one a rank)
    and `ba_problem()`, each held against the unsharded function on this
    rank's device.  With `out_dir`, rank 0 writes the sharded results to
    out_dir/sharded.npz."""
    dev = mesh.device
    B = n_frames or mesh.size
    out = {}

    # 1. frame-parallel extraction: sharded == unsharded, frame by frame
    imgs = np.random.default_rng(0).uniform(0, 255, (B, 96, 128)).astype(
        np.float32)
    feats = multichip.extract_batch_sharded(mesh, imgs, n_features=128,
                                            n_levels=3)
    for i in range(B):
        f = frontend.extract(torch.from_numpy(imgs[i]).to(dev), 128, 3, 1.2,
                             20, 7, 24)
        for k in ("desc", "xy", "octave", "valid"):
            if not torch.equal(getattr(f, k), getattr(feats, k)[i]):
                raise AssertionError(f"sharded extraction's {k} of frame "
                                     f"{i} != the unsharded frontend's")
    out.update({f"extract_{k}": v.cpu().numpy()
                for k, v in feats._asdict().items()})

    # 2. edge-parallel BA: the same on every rank, close to unsharded
    prob, (fx, fy, cx, cy, bf) = ba_problem(dev)
    n_reduce = mesh.all_reduces
    cam_s, pts_s, err_s = multichip.optimize_sharded(
        mesh, prob, fx, fy, cx, cy, bf, iters=BA_ITERS, mode="cg")
    out["ba_reduces_per_iter"] = np.array(
        (mesh.all_reduces - n_reduce) / BA_ITERS)
    for t in (cam_s, pts_s, err_s):
        every = mesh.all_gather(t.reshape(1, -1))
        if not (every == every[:1]).all():
            raise AssertionError("the ranks' BA results differ")
    cam_1, pts_1, err_1 = ba.optimize(prob, fx, fy, cx, cy, bf,
                                      iters=BA_ITERS, use_kernel=True,
                                      mode="cg")
    if not torch.isfinite(err_s):
        raise AssertionError("sharded BA's error is not finite")
    torch.testing.assert_close(cam_s, cam_1, rtol=BA_RTOL, atol=BA_ATOL)
    torch.testing.assert_close(pts_s, pts_1, rtol=BA_RTOL, atol=BA_ATOL)
    torch.testing.assert_close(err_s, err_1, rtol=BA_RTOL, atol=0.0)
    out.update(ba_cam_T=cam_s.cpu().numpy(), ba_pts=pts_s.cpu().numpy(),
               ba_err=err_s.cpu().numpy())

    # 3. the full tracking step, frames sharded
    settings = _stereo_settings()
    args, (L, M) = track_inputs(B, settings)
    res = multichip.track_step_sharded(mesh, settings, *args)
    pack = res.f32_pack.cpu().numpy()
    # the pack's tail is the descriptors' bits viewed as f32 (possibly NaN
    # patterns): only the numeric prefix must be finite
    if not np.isfinite(pack[:, : pack.shape[1] - 8 * L]).all():
        raise AssertionError("sharded tracking step is not finite")
    step = track_step.build_track_step(settings, "stereo", dev)
    names = ("img_l", "img_r", "scal", "last_f32", "last_desc", "last_oct",
             "last_angle", "loc_f32", "loc_desc")
    for i in range(B):
        one = step(*convert.track_inputs_from_numpy(
            {k: a[i] for k, a in zip(names, args)}, dev))
        a, _ = track_step.unpack_track_out(one, L, M)
        b, _ = track_step.unpack_track_out(
            track_step.TrackOut(res.f32_pack[i], res.desc[i]), L, M)
        np.testing.assert_allclose(b.Tcw, a.Tcw, rtol=0, atol=TCW_ATOL)
        np.testing.assert_array_equal(b.assign, a.assign)
        np.testing.assert_array_equal(b.inlier, a.inlier)
    out["track_f32_pack"] = pack
    out["track_desc"] = res.desc.cpu().numpy()

    if out_dir is not None and mesh.rank == 0:
        np.savez(os.path.join(out_dir, "sharded.npz"), **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_ranks", type=int, nargs="?", default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="cpu: gloo ranks; cuda: NCCL, one rank a card")
    ap.add_argument("--timeout", type=float, default=RUN_TIMEOUT_S)
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    launch(checks, a.n_ranks, a.device, timeout=a.timeout)
    print(f"dryrun_multichip OK: {a.n_ranks} ranks, device={a.device}, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
