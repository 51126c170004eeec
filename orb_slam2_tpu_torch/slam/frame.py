"""Frame construction: device feature extraction + per-sensor association.

Port of orb_slam2_tpu/slam/frame.py, the host side of the three Frame
constructors (ref: src/Frame.cc:61-228): run the ORB frontend on the
device, undistort keypoints, stereo-match or associate RGB-D depth, and
land a fixed-shape FrameFeatures block with one device-to-host copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from orb_slam2_tpu_torch.config import Settings
from orb_slam2_tpu_torch.geometry import camera as cam
from orb_slam2_tpu_torch.ops import frontend, stereo
from orb_slam2_tpu_torch.slam.map_store import FrameFeatures


@dataclass
class Frame:
    """Per-frame tracking state (ref: include/Frame.h:43)."""

    frame_id: int
    timestamp: float
    feats: FrameFeatures
    Tcw: Optional[np.ndarray] = None          # (4,4) f32; None = untracked
    bindings: np.ndarray = None               # (N,) i64 map-point id or -1
    outlier: np.ndarray = None                # (N,) bool pose-opt outliers
    ref_kf: int = -1

    def __post_init__(self):
        n = self.feats.n
        if self.bindings is None:
            self.bindings = np.full(n, -1, np.int64)
        if self.outlier is None:
            self.outlier = np.zeros(n, bool)

    @property
    def n_feat(self) -> int:
        return self.feats.n

    def camera_center(self) -> np.ndarray:
        T = self.Tcw
        return -T[:3, :3].T @ T[:3, 3]


def _as_uint8(img: np.ndarray) -> np.ndarray:
    return img if img.dtype == np.uint8 else np.clip(img, 0, 255).astype(
        np.uint8)


class FrameBuilder:
    """Builds Frames for a given Settings on one torch device.

    device: where images go and the frontend runs ("cuda" launches the
    Hopper kernels).  plain=True runs the kernels' plain PyTorch versions
    on that device instead, to compare the two.
    """

    def __init__(self, settings: Settings, vocabulary=None,
                 device="cuda", plain: bool = False):
        self.s = settings
        self.vocabulary = vocabulary
        self.device = torch.device(device)
        self.plain = plain
        self.scale_factors = settings.scale_factors().astype(np.float32)
        self.level_sigma2 = settings.level_sigma2().astype(np.float32)
        self._scale_factors_dev = torch.from_numpy(self.scale_factors).to(
            self.device)
        self._next_id = 0
        self._prefetched = {}
        self.refresh_calibration()
        # EuRoC-style rectification maps (ref: stereo_euroc.cc:97-137)
        self._rect = None
        if settings.rectification is not None:
            self._rect = [
                tuple(torch.from_numpy(m).to(self.device) for m in side)
                for side in cam.rectify_maps(settings.rectification)
            ]

    def refresh_calibration(self):
        """Re-derive intrinsics/distortion/bounds from the (mutated)
        Settings (ref: Tracking::ChangeCalibration)."""
        s = self.s
        self.intr = cam.Intrinsics.from_settings(s, self.device)
        self.dist = (
            torch.as_tensor(s.dist_coeffs, dtype=torch.float32,
                            device=self.device)
            if s.has_distortion else None
        )
        self.bounds = cam.compute_image_bounds(
            s.width, s.height, self.intr,
            s.dist_coeffs if s.has_distortion else None,
        )

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host->device copy; on a CUDA device, non-blocking from pinned
        memory, so it overlaps whatever the host does next."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def prefetch(self, *imgs: np.ndarray, depth: np.ndarray = None) -> None:
        """Start async uploads for images that will be tracked NEXT.

        Issuing the uint8 upload in the dead time between frames takes the
        host-to-device copy off the tracked frame's critical path.  Keyed
        by object identity; consumed by the next _upload of the same
        array.  `depth` is uploaded float32 (RGB-D)."""
        self._prefetched = {
            id(im): self._to_device(_as_uint8(im))
            for im in imgs if im is not None
        }
        if depth is not None:
            self._prefetched[id(depth)] = self._to_device(
                depth.astype(np.float32, copy=False))

    def _take_prefetched(self, img, dtype) -> Optional[torch.Tensor]:
        dev = self._prefetched.pop(id(img), None)
        if (dev is not None and tuple(dev.shape) == img.shape
                and dev.dtype == dtype):
            return dev
        return None

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        """Host->device image upload as uint8 (4x fewer bytes than f32;
        the frontend casts on the device)."""
        dev = self._take_prefetched(img, torch.uint8)
        return dev if dev is not None else self._to_device(_as_uint8(img))

    def _upload_depth(self, img: np.ndarray) -> torch.Tensor:
        """Float32 upload for RGB-D depth images (no uint8 quantization)."""
        dev = self._take_prefetched(img, torch.float32)
        return dev if dev is not None else self._to_device(
            img.astype(np.float32, copy=False))

    def _extract(self, img: np.ndarray, n_features: int):
        return frontend.extract(
            self._upload(img),
            n_features=n_features,
            n_levels=self.s.n_levels,
            scale_factor=self.s.scale_factor,
            ini_th=self.s.ini_th_fast,
            min_th=self.s.min_th_fast,
            plain=self.plain,
        )

    def _base_features(self, feats, n: int, ur_dev=None,
                       depth_dev=None) -> FrameFeatures:
        xy_dev = feats.xy.float()
        if self.dist is not None:
            xy_dev = cam.undistort_points(xy_dev, self.intr, self.dist)
        dev = {
            "xy": xy_dev,
            "octave": feats.octave,
            "angle": feats.angle,
            "desc": feats.desc,
            "valid": feats.valid,
        }
        # every field in ONE device->host copy: the float fields' bits
        # viewed as int32 beside the descriptor words
        parts = [
            xy_dev.reshape(-1),
            feats.xy.float().reshape(-1),
            feats.angle.float(),
            feats.octave.float(),
            feats.valid.float(),
        ]
        if ur_dev is not None:
            dev["ur"] = ur_dev
            dev["depth"] = depth_dev
            parts += [ur_dev.float(), depth_dev.float()]
        packed = torch.cat([torch.cat(parts).view(torch.int32),
                            feats.desc.reshape(-1)]).cpu().numpy()
        f = packed[: -8 * n].view(np.float32)
        xy = f[:2 * n].reshape(n, 2)
        xy_raw = f[2 * n:4 * n].reshape(n, 2)
        angle = f[4 * n:5 * n]
        octave = f[5 * n:6 * n].astype(np.int32)
        valid = f[6 * n:7 * n] > 0.5
        if ur_dev is not None:
            ur = f[7 * n:8 * n].copy()
            depth = f[8 * n:9 * n].copy()
        else:
            ur = np.full(n, -1.0, np.float32)
            depth = np.full(n, -1.0, np.float32)
        return FrameFeatures(
            xy=xy.copy(),
            xy_raw=xy_raw.copy(),
            ur=ur,
            depth=depth,
            octave=octave,
            angle=angle.copy(),
            desc=packed[-8 * n:].view(np.uint32).reshape(n, 8),
            valid=valid,
            node=np.full(n, -1, np.int32),
            word=np.full(n, -1, np.int32),
            dev=dev,
            torch_device=str(self.device),
        )

    def _assign_bow(self, ff: FrameFeatures):
        if self.vocabulary is not None:
            node, word = self.vocabulary.assign_nodes(
                ff.device("desc"), ff.device("valid"))
            ff.node[:] = node
            ff.word[:] = word

    def _make(self, ff: FrameFeatures, timestamp: float) -> Frame:
        fid = self._next_id
        self._next_id += 1
        return Frame(frame_id=fid, timestamp=timestamp, feats=ff)

    # ------------------------------------------------------------------
    def monocular(self, img: np.ndarray, timestamp: float,
                  init_boost: bool = False) -> Frame:
        """ref: Frame mono ctor (src/Frame.cc:174-228); the initializer
        doubles the feature budget (ref: src/Tracking.cc:121-126)."""
        n_features = self.s.n_features * (2 if init_boost else 1)
        feats = self._extract(img, n_features)
        ff = self._base_features(feats, feats.n)
        self._assign_bow(ff)
        return self._make(ff, timestamp)

    def _rectified(self, img: np.ndarray, side: int) -> torch.Tensor:
        """Remap on the device, then quantise to uint8 as an upload of
        the remapped image would."""
        mx, my = self._rect[side]
        raw = self._to_device(img.astype(np.float32, copy=False))
        return cam.remap_bilinear(raw, mx, my).clamp(0, 255).to(torch.uint8)

    def stereo_pair(self, img_l: np.ndarray, img_r: np.ndarray,
                    timestamp: float) -> Frame:
        """ref: Frame stereo ctor (src/Frame.cc:61-117) — the reference
        spawns two extraction threads; here both images run back-to-back
        on the same device."""
        if self._rect is not None:
            dev_l, dev_r = self._rectified(img_l, 0), self._rectified(img_r, 1)
        else:
            dev_l, dev_r = self._upload(img_l), self._upload(img_r)
        fl, matches = frontend.extract_stereo_pair(
            dev_l, dev_r, self._scale_factors_dev,
            # maxD = bf / minZ with minZ = baseline (ref: Frame.cc:475-477)
            self.s.bf, self.s.fx,
            n_features=self.s.n_features,
            n_levels=self.s.n_levels,
            scale_factor=self.s.scale_factor,
            ini_th=self.s.ini_th_fast,
            min_th=self.s.min_th_fast,
            plain=self.plain,
        )
        ff = self._base_features(fl, fl.n, ur_dev=matches.u_right,
                                 depth_dev=matches.depth)
        self._assign_bow(ff)
        return self._make(ff, timestamp)

    def rgbd(self, img: np.ndarray, depth_img: np.ndarray,
             timestamp: float) -> Frame:
        """ref: Frame RGB-D ctor (src/Frame.cc:119-171)."""
        feats = self._extract(img, self.s.n_features)
        factor = self.s.depth_map_factor
        if abs(factor - 1.0) > 1e-9 and factor != 0:
            factor = 1.0 / factor
        ur, depth = stereo.depth_from_rgbd(
            feats.xy, feats.valid, self._upload_depth(depth_img),
            factor, self.s.bf,
        )
        ff = self._base_features(feats, feats.n, ur_dev=ur, depth_dev=depth)
        self._assign_bow(ff)
        return self._make(ff, timestamp)
