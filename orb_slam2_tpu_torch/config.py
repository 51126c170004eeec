"""Settings: reference-compatible configuration.

Reads the same OpenCV-YAML settings files the reference consumes
(ref: src/Tracking.cc:54-148 parses Camera.*, ORBextractor.*, ThDepth,
DepthMapFactor; src/Viewer.cc:33-51 parses Viewer.*; stereo_euroc.cc:68-98
parses the LEFT.*/RIGHT.* rectification blocks).  OpenCV YAML is not valid
PyYAML (``%YAML:1.0`` directive, ``!!opencv-matrix`` tags), so a small
sanitizing loader is included; plain YAML/dict configs work too.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Any, Dict, Optional

import numpy as np


class Sensor(enum.Enum):
    """Sensor type (ref: include/System.h eSensor MONOCULAR/STEREO/RGBD)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


def _parse_opencv_yaml(text: str) -> Dict[str, Any]:
    """Parse an OpenCV FileStorage YAML document into a flat dict.

    Handles the ``%YAML:1.0`` directive, ``!!opencv-matrix`` nodes and flat
    ``key: value`` scalars with dotted key names, which is all the reference
    settings files use.
    """
    import yaml

    lines = []
    for ln in text.splitlines():
        if ln.strip().startswith("%YAML"):
            continue
        ln = ln.replace("!!opencv-matrix", "")
        lines.append(ln)
    data = yaml.safe_load("\n".join(lines)) or {}

    out: Dict[str, Any] = {}
    for k, v in data.items():
        if isinstance(v, dict) and {"rows", "cols", "data"} <= set(v.keys()):
            arr = np.array(v["data"], dtype=np.float64).reshape(
                int(v["rows"]), int(v["cols"])
            )
            out[k] = arr
        else:
            out[k] = v
    return out


@dataclasses.dataclass
class RectificationParams:
    """EuRoC-style stereo rectification block (ref: stereo_euroc.cc:68-98)."""

    K_l: np.ndarray
    K_r: np.ndarray
    D_l: np.ndarray
    D_r: np.ndarray
    R_l: np.ndarray
    R_r: np.ndarray
    P_l: np.ndarray
    P_r: np.ndarray
    width: int
    height: int


@dataclasses.dataclass
class Settings:
    """All tunables, defaulting to the reference's values.

    Key names in `from_yaml` match the reference settings files so a user can
    point this framework at an unmodified ORB-SLAM2 .yaml.
    """

    # Camera intrinsics (ref: src/Tracking.cc:55-88)
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0          # stereo baseline times fx
    fps: float = 30.0
    rgb: bool = True         # color channel order of input images
    width: int = 640
    height: int = 480

    # ORB extractor (ref: src/Tracking.cc:104-133)
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    # Depth handling (ref: src/Tracking.cc:135-148)
    th_depth: float = 35.0        # close/far point threshold, x baseline
    depth_map_factor: float = 1.0  # RGB-D depth scaling

    # Fixed-shape budgets for the TPU pipeline (new; not in reference).
    # Keypoints per frame are padded to max_keypoints so XLA compiles once.
    max_keypoints: int = 0   # 0 -> derived from n_features at finalize()

    # Pipeline scheduling: "sync" = deterministic single-threaded
    # (track->map->loop per frame), "async" = reference-style threads.
    scheduler: str = "sync"

    # Fixed-shape bucket pinning (new; SURVEY §5.7).  Every dynamically
    # sized device program pads its data dimension to one of these
    # pinned minimums; a run whose live sizes stay under them compiles
    # each program exactly ONCE, and System.precompile() can build all
    # executables before the first frame (a cold XLA compile landing
    # mid-run costs 10-50 s — the reference never stalls because its
    # CPU kernels need no compilation).  0 -> derived at finalize().
    bucket_local: int = 0        # tracking local-candidate block rows
    bucket_fuse: int = 0         # mapper fuse candidate rows
    bucket_ba_cams: int = 16     # local-BA camera vertices
    bucket_ba_pts: int = 0       # local-BA point vertices
    bucket_ba_edges: int = 0     # local-BA edges (observations)
    bucket_nb: int = 16          # neighbor keyframes per batched dispatch
    bucket_reloc: int = 256      # reloc PnP rows
    bucket_sim3: int = 512       # loop Sim3 correspondence rows
    bucket_loop_pts: int = 2048  # loop-point block (fuse / projection)
    bucket_pg_cams: int = 64     # pose-graph vertices
    bucket_pg_edges: int = 512   # pose-graph edges
    device_map_cap: int = 1 << 17  # device point-mirror rows
    # device keyframe-feature mirror capacity (slam/kf_mirror.py):
    # FIXED at construction — growing it would recompile the mapper's
    # gather programs mid-run.  2048 covers KITTI-00's ~1,300 keyframes;
    # ids beyond it fall back to the legacy stacking dispatch.  0 = off.
    mirror_kf_cap: int = 2048

    # Viewer (ref: src/Viewer.cc:33-51); kept for config compatibility.
    viewer_fps: float = 30.0
    viewpoint_x: float = 0.0
    viewpoint_y: float = -0.7
    viewpoint_z: float = -1.8
    viewpoint_f: float = 500.0

    rectification: Optional[RectificationParams] = None

    def __post_init__(self):
        self.finalize()

    def finalize(self) -> "Settings":
        if self.max_keypoints == 0:
            # x2 headroom: monocular init doubles the budget
            # (ref: src/Tracking.cc:126) and FAST can overshoot per cell.
            self.max_keypoints = int(2 * self.n_features)
        # derived bucket pins: sized so the KITTI-class bench circuit
        # (2000 features, ~80-KF local windows) never outgrows them
        def _pow2(n: int, lo: int) -> int:
            b = lo
            while b < n:
                b *= 2
            return b

        if self.bucket_local == 0:
            # one candidate block per frame feature budget: beyond the
            # cap the least-covisible candidates are dropped in window-
            # relevance order (tracking._update_local_map).  Measured on
            # the KITTI-shaped bench: a 4096 block costs ~3x the fused-
            # step time of 2048 for no tracking benefit (the frame has
            # n_features slots to bind; r03 ran healthy at <=2048 live
            # candidates).
            self.bucket_local = _pow2(self.n_features, 512)
        if self.bucket_fuse == 0:
            self.bucket_fuse = self.bucket_local
        if self.bucket_ba_pts == 0:
            self.bucket_ba_pts = 2 * self.bucket_local
        if self.bucket_ba_edges == 0:
            self.bucket_ba_edges = 4 * self.bucket_ba_pts
        return self

    # -- reference-compatible derived quantities ------------------------
    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.fx else 0.0

    @property
    def depth_threshold(self) -> float:
        """ThDepth scaled by baseline (ref: src/Tracking.cc:137-141)."""
        return self.bf * self.th_depth / self.fx if self.fx else 0.0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def dist_coeffs(self) -> np.ndarray:
        return np.array(
            [self.k1, self.k2, self.p1, self.p2, self.k3], dtype=np.float64
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(c) > 0 for c in (self.k1, self.k2, self.p1, self.p2, self.k3))

    # -- loaders ---------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Settings":
        """Build from a flat dict using the reference's YAML key names."""
        def g(key, default):
            v = d.get(key, default)
            return default if v is None else v

        s = cls(
            fx=float(g("Camera.fx", 517.306408)),
            fy=float(g("Camera.fy", 516.469215)),
            cx=float(g("Camera.cx", 318.643040)),
            cy=float(g("Camera.cy", 255.313989)),
            k1=float(g("Camera.k1", 0.0)),
            k2=float(g("Camera.k2", 0.0)),
            p1=float(g("Camera.p1", 0.0)),
            p2=float(g("Camera.p2", 0.0)),
            k3=float(g("Camera.k3", 0.0)),
            bf=float(g("Camera.bf", 0.0)),
            fps=float(g("Camera.fps", 30.0) or 30.0),
            rgb=bool(int(g("Camera.RGB", 1))),
            width=int(g("Camera.width", 640)),
            height=int(g("Camera.height", 480)),
            n_features=int(g("ORBextractor.nFeatures", 1000)),
            scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
            n_levels=int(g("ORBextractor.nLevels", 8)),
            ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
            min_th_fast=int(g("ORBextractor.minThFAST", 7)),
            th_depth=float(g("ThDepth", 35.0)),
            depth_map_factor=float(g("DepthMapFactor", 1.0)),
            viewer_fps=float(g("Camera.fps", 30.0) or 30.0),
            viewpoint_x=float(g("Viewer.ViewpointX", 0.0)),
            viewpoint_y=float(g("Viewer.ViewpointY", -0.7)),
            viewpoint_z=float(g("Viewer.ViewpointZ", -1.8)),
            viewpoint_f=float(g("Viewer.ViewpointF", 500.0)),
        )
        # EuRoC rectification block (all-or-nothing, like the reference check)
        rect_keys = [
            "LEFT.K", "RIGHT.K", "LEFT.D", "RIGHT.D",
            "LEFT.R", "RIGHT.R", "LEFT.P", "RIGHT.P",
            "LEFT.width", "LEFT.height",
        ]
        if all(k in d for k in rect_keys):
            s.rectification = RectificationParams(
                K_l=np.asarray(d["LEFT.K"]), K_r=np.asarray(d["RIGHT.K"]),
                D_l=np.asarray(d["LEFT.D"]).ravel(),
                D_r=np.asarray(d["RIGHT.D"]).ravel(),
                R_l=np.asarray(d["LEFT.R"]), R_r=np.asarray(d["RIGHT.R"]),
                P_l=np.asarray(d["LEFT.P"]), P_r=np.asarray(d["RIGHT.P"]),
                width=int(d["LEFT.width"]), height=int(d["LEFT.height"]),
            )
        return s

    @classmethod
    def from_yaml(cls, path: str) -> "Settings":
        with open(path, "r") as f:
            text = f.read()
        return cls.from_dict(_parse_opencv_yaml(text))

    def scale_factors(self) -> np.ndarray:
        """Per-level scale factors (ref: src/ORBextractor.cc:418-430)."""
        return self.scale_factor ** np.arange(self.n_levels)

    def level_sigma2(self) -> np.ndarray:
        """Per-level measurement variance = scale^2 (ref: ORBextractor ctor)."""
        return self.scale_factors() ** 2
