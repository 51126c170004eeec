"""Repeat bench_torch.py's mono pass on the card under named variants,
one JSON line a run.

    python3 scripts/mono_pass_probe.py VARIANTS [FRAMES]
        [--parent-local-mapping PATH]

VARIANTS is a comma-separated list, run in that order in one process:
  f32     the bench's float32 renders (bench_torch.py's mono pass);
  uint8   the same frames as uint8, as chip_smoke.py phase 10d feeds them;
  grid    float32 frames with the 2D grid mapper attached, as phase 10d;
  parent  float32 frames, with LocalMapper.local_bundle_adjustment taken
          from the local_mapping.py at --parent-local-mapping (another
          checkout's), to hold a change to it against its parent.
FRAMES cuts the pass to its first FRAMES poses (default: all 720).  Each
line gives the final tracking state, the tracker's LOST warnings, the
bench's per-pass stats, the calls' p50 / p90 ms and the card.
"""

import argparse
import copy
import gc
import importlib.util
import json
import logging
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_torch as b  # noqa: E402
from orb_slam2_tpu_torch.config import Sensor  # noqa: E402
from orb_slam2_tpu_torch.mapping2d.gridmap import GridParams  # noqa: E402
from orb_slam2_tpu_torch.mapping2d.stream import (  # noqa: E402
    attach_grid_mapper,
)
from orb_slam2_tpu_torch.slam import local_mapping  # noqa: E402
from orb_slam2_tpu_torch.system import System  # noqa: E402
from synthetic import circle_trajectory  # noqa: E402


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants")
    ap.add_argument("frames", nargs="?", type=int, default=720)
    ap.add_argument("--parent-local-mapping")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("mono_pass_probe: torch.cuda.is_available() is false")
    lbas = {"own": local_mapping.LocalMapper.local_bundle_adjustment}
    if args.parent_local_mapping:
        spec = importlib.util.spec_from_file_location(
            "parent_local_mapping", args.parent_local_mapping)
        parent = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent)
        lbas["parent"] = parent.LocalMapper.local_bundle_adjustment
    dev = torch.device("cuda", 0)
    card = b.gpu_line()
    settings = b.kitti_settings()
    scene, _, _ = b.make_circuit(4)
    voc = b.train_vocabulary(scene, dev)
    poses = circle_trajectory(720, orbit_r=3.0,
                              total_angle=3 * np.pi)[:args.frames]
    f32 = b.render_all(lambda T: (scene.render(T),), poses)
    u8 = [(f.astype(np.uint8),) for (f,) in f32]
    for variant in args.variants.split(","):
        local_mapping.LocalMapper.local_bundle_adjustment = lbas[
            "parent" if variant == "parent" else "own"]
        frames = u8 if variant == "uint8" else f32
        warnings, loggers = _Warnings(), []

        def make(pipelined):
            s = copy.copy(settings)
            s.pipelined = pipelined
            system = System(s, Sensor.MONOCULAR, vocabulary=voc,
                            scheduler="async", device=dev)
            if variant == "grid":
                attach_grid_mapper(system, GridParams(
                    scale_factor=20.0, cloud_min_x=-5.0, cloud_max_x=5.0,
                    cloud_min_z=-5.0, cloud_max_z=5.0), all_pts_gap=0)
            system.tracker.log.addHandler(warnings)
            loggers.append(system.tracker.log)
            return system

        times, _, stats, ok = b.run_pass(
            make, "track_monocular", frames, poses, pipelined=True,
            kidnap=False, kidnap_at=len(frames))
        window = stats.pop("window")
        xs = sorted(times[3:])
        print(json.dumps({
            "variant": variant, "frames": len(frames), "healthy": ok,
            "state": window["state"], "lost": warnings.messages, **stats,
            "p50_ms": 1e3 * xs[len(xs) // 2],
            "p90_ms": 1e3 * xs[int(len(xs) * 0.9)], "gpu": card}),
            flush=True)
        for logger in loggers:
            logger.removeHandler(warnings)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
