"""CLI drivers — equivalents of the reference's example binaries.

ref: Examples/{Monocular,Stereo,RGB-D}/*.cc (mono_tum, mono_kitti,
mono_euroc, stereo_kitti, stereo_euroc, rgbd_tum; CMakeLists.txt:86-115).
Each driver loads a sequence, runs SLAM per frame, prints the
median/mean tracking time like the reference (stereo_kitti.cc:114-122),
and saves trajectories.

Port of orb_slam2_tpu/apps/run_slam.py: stereo_kitti, with --scheduler
and --pipelined.  The other entries and the --vocab /
--grid-map / --ar / --viewer options wait for ROADMAP items 6-8 and raise
NotImplementedError naming theirs.

Usage:
  python -m orb_slam2_tpu_torch.apps.run_slam stereo_kitti SETTINGS.yaml SEQ_DIR
Options: --device cuda|cpu  --out PREFIX  --max-frames N  --localization
         --save-map PATH  --scheduler sync|async  --pipelined
"""

from __future__ import annotations

import argparse
import time

from orb_slam2_tpu_torch.config import Sensor, Settings
from orb_slam2_tpu_torch.io import datasets
from orb_slam2_tpu_torch.system import System

# what each unported driver and option waits for
_LATER = {
    "mono_tum": 7, "mono_kitti": 7, "mono_euroc": 7, "stereo_euroc": 8,
    "rgbd_tum": 8, "vocab": 6, "grid_map": 8, "ar": 8, "viewer": 8,
}


def _later(what: str):
    raise NotImplementedError(
        f"{what} waits for ROADMAP item {_LATER[what]}")


def _build_system(args, sensor: Sensor) -> System:
    settings = Settings.from_yaml(args.settings)
    for opt in ("vocab", "viewer", "ar", "grid_map"):
        if getattr(args, opt) not in (None, False):
            _later(opt)
    if args.pipelined:
        settings.pipelined = True
    return System(settings, sensor, scheduler=args.scheduler,
                  device=args.device)


def _finish(sys_: System, args, times):
    sys_.drain()       # the pipelined frames still in flight
    times = sorted(times)
    if times:
        print(f"median tracking time: {times[len(times) // 2]:.4f}")
        print(f"mean tracking time: {sum(times) / len(times):.4f}")
    print("run stats:", sys_.stats())
    prefix = args.out
    sys_.save_trajectory_tum(prefix + "_CameraTrajectory_TUM.txt")
    sys_.save_keyframe_trajectory_tum(prefix + "_KeyFrameTrajectory_TUM.txt")
    sys_.save_trajectory_kitti(prefix + "_CameraTrajectory_KITTI.txt")
    if args.save_map:
        sys_.save_map(args.save_map)
    sys_.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("driver", choices=[
        "mono_tum", "mono_kitti", "mono_euroc",
        "stereo_kitti", "stereo_euroc", "rgbd_tum"])
    ap.add_argument("settings")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tracker and the mapper "
                         "(cuda raises without a card)")
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--out", default="result")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--localization", action="store_true")
    ap.add_argument("--scheduler", choices=["sync", "async"], default=None,
                    help="sync = deterministic (default); async = the "
                         "reference's thread topology (mapping on a "
                         "thread of its own)")
    ap.add_argument("--pipelined", action="store_true",
                    help="pipelined tracking: keep several frames in "
                         "flight, so a call does not wait for the device")
    ap.add_argument("--grid-map", default=None)
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--ar", default=None, metavar="OUT_DIR",
                    help="AR demo (ref: ros_mono_ar.cc): detect a plane, "
                         "anchor a virtual cube, save overlay frames")
    ap.add_argument("--viewer", nargs="?", type=int, const=0, default=None,
                    metavar="PORT",
                    help="serve the live viewer (map + frame MJPEG, menu "
                         "toggles) at http://localhost:PORT/ "
                         "(ref: src/Viewer.cc Pangolin loop)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="narrate subsystem lifecycle (loop closures, "
                         "GBA, resets) like the reference's couts")
    args = ap.parse_args(argv)
    if args.verbose:
        from orb_slam2_tpu_torch import logs
        logs.set_verbose()

    if args.driver != "stereo_kitti":
        _later(args.driver)
    seq = datasets.load_kitti_stereo(args.paths[0])
    sensor = Sensor.STEREO
    frames = seq.frames_stereo()

    sys_ = _build_system(args, sensor)
    if args.localization:
        sys_.activate_localization_mode()

    times = []
    for i, frame in enumerate(frames):
        if args.max_frames and i >= args.max_frames:
            break
        t0 = time.perf_counter()
        l, r, ts = frame
        sys_.track_stereo(l, r, ts)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}: {sys_.tracking_state().name} "
                  f"kf={int(sys_.map.kf_valid.sum())} "
                  f"pts={int(sys_.map.pt_valid.sum())} "
                  f"{times[-1] * 1000:.0f} ms")
    _finish(sys_, args, times)


if __name__ == "__main__":
    main()
