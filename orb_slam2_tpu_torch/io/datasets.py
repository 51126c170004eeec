"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

Host-side equivalents of the reference drivers' LoadImages functions
(ref: Examples/Monocular/mono_tum.cc:57-84, mono_kitti.cc:67-107,
mono_euroc.cc:74-107, Stereo/stereo_kitti.cc:140-180,
RGB-D/rgbd_tum.cc:120-148 association parsing).  Each loader yields
(grayscale float32 image(s), timestamp) pairs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _imread_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def _imread_depth(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


@dataclass
class Sequence:
    """A loaded dataset sequence: lists of file paths + timestamps."""

    timestamps: List[float]
    left: List[str]
    right: Optional[List[str]] = None      # stereo
    depth: Optional[List[str]] = None      # rgb-d

    def __len__(self):
        return len(self.timestamps)

    def frames_mono(self) -> Iterator[Tuple[np.ndarray, float]]:
        for t, p in zip(self.timestamps, self.left):
            yield _imread_gray(p), t

    def frames_stereo(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        for t, l, r in zip(self.timestamps, self.left, self.right):
            yield _imread_gray(l), _imread_gray(r), t

    def frames_rgbd(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        for t, l, d in zip(self.timestamps, self.left, self.depth):
            yield _imread_gray(l), _imread_depth(d), t


def load_tum_mono(seq_dir: str) -> Sequence:
    """TUM rgb.txt format: `timestamp filename` lines
    (ref: mono_tum.cc LoadImages)."""
    ts, files = [], []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, name = line.split()[:2]
            ts.append(float(t))
            files.append(os.path.join(seq_dir, name))
    return Sequence(ts, files)


def load_tum_rgbd(seq_dir: str, assoc_file: str) -> Sequence:
    """TUM with associations: `t_rgb rgb t_depth depth` lines
    (ref: rgbd_tum.cc LoadImages; associations shipped in
    Examples/RGB-D/associations/)."""
    ts, rgb, depth = [], [], []
    with open(assoc_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            ts.append(float(p[0]))
            rgb.append(os.path.join(seq_dir, p[1]))
            depth.append(os.path.join(seq_dir, p[3]))
    return Sequence(ts, rgb, depth=depth)


def load_kitti_stereo(seq_dir: str) -> Sequence:
    """KITTI odometry layout: image_0/ image_1/ %06d.png + times.txt
    (ref: stereo_kitti.cc LoadImages)."""
    ts = []
    with open(os.path.join(seq_dir, "times.txt")) as f:
        for line in f:
            line = line.strip()
            if line:
                ts.append(float(line))
    left = [os.path.join(seq_dir, "image_0", f"{i:06d}.png")
            for i in range(len(ts))]
    right = [os.path.join(seq_dir, "image_1", f"{i:06d}.png")
             for i in range(len(ts))]
    return Sequence(ts, left, right=right)


def load_kitti_mono(seq_dir: str) -> Sequence:
    seq = load_kitti_stereo(seq_dir)
    return Sequence(seq.timestamps, seq.left)


def load_euroc_stereo(cam0_dir: str, cam1_dir: str,
                      times_file: str) -> Sequence:
    """EuRoC: timestamp file with `ns,name` (ref: stereo_euroc.cc
    LoadImages; timestamps in Examples/Stereo/EuRoC_TimeStamps/)."""
    ts, left, right = [], [], []
    with open(times_file) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line or line.startswith("#"):
                continue
            name = line.split(",")[0]
            ts.append(float(name) / 1e9)
            left.append(os.path.join(cam0_dir, name + ".png"))
            right.append(os.path.join(cam1_dir, name + ".png"))
    return Sequence(ts, left, right=right)
