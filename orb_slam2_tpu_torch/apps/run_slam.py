"""CLI drivers — equivalents of the reference's example binaries.

ref: Examples/{Monocular,Stereo,RGB-D}/*.cc (mono_tum, mono_kitti,
mono_euroc, stereo_kitti, stereo_euroc, rgbd_tum; CMakeLists.txt:86-115).
Each driver loads a sequence, runs SLAM per frame, prints the
median/mean tracking time like the reference (stereo_kitti.cc:114-122),
and saves trajectories.

Port of orb_slam2_tpu/apps/run_slam.py, with --device, --scheduler,
--pipelined and --vocabulary (an ORBvoc.txt-format file: relocalization,
loop closing and global BA).  The --ar and --viewer options wait for
ROADMAP item 8 and raise NotImplementedError naming it.

Usage:
  python -m orb_slam2_tpu_torch.apps.run_slam mono_tum SETTINGS.yaml SEQ_DIR
  python -m orb_slam2_tpu_torch.apps.run_slam mono_kitti SETTINGS.yaml SEQ_DIR
  python -m orb_slam2_tpu_torch.apps.run_slam mono_euroc SETTINGS.yaml CAM0 TIMES
  python -m orb_slam2_tpu_torch.apps.run_slam stereo_kitti SETTINGS.yaml SEQ_DIR
  python -m orb_slam2_tpu_torch.apps.run_slam stereo_euroc SETTINGS.yaml CAM0 CAM1 TIMES
  python -m orb_slam2_tpu_torch.apps.run_slam rgbd_tum SETTINGS.yaml SEQ_DIR ASSOC
Options: --device cuda|cpu  --vocabulary VOC.txt  --out PREFIX
         --max-frames N  --localization  --grid-map PGM  --save-map PATH
         --scheduler sync|async  --pipelined
"""

from __future__ import annotations

import argparse
import time

from orb_slam2_tpu_torch.config import Sensor, Settings
from orb_slam2_tpu_torch.io import datasets
from orb_slam2_tpu_torch.system import System

# what each unported option waits for
_LATER = {"ar": 8, "viewer": 8}


def _later(what: str):
    raise NotImplementedError(
        f"{what} waits for ROADMAP item {_LATER[what]}")


def _build_system(args, sensor: Sensor) -> System:
    settings = Settings.from_yaml(args.settings)
    for opt in _LATER:
        if getattr(args, opt) is not None:
            _later(opt)
    if args.pipelined:
        settings.pipelined = True
    voc = None
    if args.vocab:
        from orb_slam2_tpu_torch.places.vocabulary import Vocabulary

        voc = Vocabulary.load_text(args.vocab)
    return System(settings, sensor, vocabulary=voc,
                  scheduler=args.scheduler, device=args.device)


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
    if args.grid_map:
        sys_.save_grid_map_tum(args.grid_map)
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
    ap.add_argument("--vocab", "--vocabulary", dest="vocab", default=None,
                    help="ORBvoc.txt-format vocabulary: enables "
                         "relocalization, loop closing and global BA")
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

    d = args.driver
    if d == "mono_tum":
        seq = datasets.load_tum_mono(args.paths[0])
        sensor = Sensor.MONOCULAR
        frames = seq.frames_mono()
    elif d == "mono_kitti":
        seq = datasets.load_kitti_mono(args.paths[0])
        sensor = Sensor.MONOCULAR
        frames = seq.frames_mono()
    elif d == "mono_euroc":
        seq = datasets.load_euroc_stereo(
            args.paths[0], args.paths[0], args.paths[1])
        sensor = Sensor.MONOCULAR
        frames = seq.frames_mono()
    elif d == "stereo_kitti":
        seq = datasets.load_kitti_stereo(args.paths[0])
        sensor = Sensor.STEREO
        frames = seq.frames_stereo()
    elif d == "stereo_euroc":
        seq = datasets.load_euroc_stereo(
            args.paths[0], args.paths[1], args.paths[2])
        sensor = Sensor.STEREO
        frames = seq.frames_stereo()
    else:
        seq = datasets.load_tum_rgbd(args.paths[0], args.paths[1])
        sensor = Sensor.RGBD
        frames = seq.frames_rgbd()

    sys_ = _build_system(args, sensor)
    if args.localization:
        sys_.activate_localization_mode()

    times = []
    for i, frame in enumerate(frames):
        if args.max_frames and i >= args.max_frames:
            break
        t0 = time.perf_counter()
        if sensor == Sensor.MONOCULAR:
            img, ts = frame
            sys_.track_monocular(img, ts)
        elif sensor == Sensor.STEREO:
            l, r, ts = frame
            sys_.track_stereo(l, r, ts)
        else:
            img, depth, ts = frame
            sys_.track_rgbd(img, depth, ts)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}: {sys_.tracking_state().name} "
                  f"kf={int(sys_.map.kf_valid.sum())} "
                  f"pts={int(sys_.map.pt_valid.sum())} "
                  f"{times[-1] * 1000:.0f} ms")
    _finish(sys_, args, times)


if __name__ == "__main__":
    main()
