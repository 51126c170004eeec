"""Per-frame feature block of the SLAM map.

Port of `FrameFeatures` from orb_slam2_tpu/slam/map_store.py; the rest of
that module (the struct-of-arrays MapStore) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class FrameFeatures:
    """Per-frame fixed-shape feature block (device extraction output,
    pulled to host once per frame).

    `dev`, when present, holds device-resident copies of the hot fields
    (xy, ur, octave, angle, desc, valid, ...) so matcher calls reuse them
    instead of uploading again; `torch_device` is where `device()` puts
    the fields it uploads."""

    xy: np.ndarray        # (N, 2) f32 undistorted level-0 coords
    xy_raw: np.ndarray    # (N, 2) f32 raw (distorted) coords
    ur: np.ndarray        # (N,) f32 right-view u; -1 mono/unmatched
    depth: np.ndarray     # (N,) f32; -1 unknown
    octave: np.ndarray    # (N,) i32
    angle: np.ndarray     # (N,) f32 degrees
    desc: np.ndarray      # (N, 8) u32 packed rBRIEF
    valid: np.ndarray     # (N,) bool
    node: np.ndarray      # (N,) i32 BoW node id (-1 before assignment)
    word: np.ndarray      # (N,) i32 BoW word (leaf) id (-1 before)
    dev: Optional[dict] = None
    torch_device: str = "cpu"

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    def device(self, key: str) -> torch.Tensor:
        """Device tensor for a field, uploading and caching on first use.
        Descriptors go up as int32 holding the uint32 bits."""
        if self.dev is None:
            self.dev = {}
        if key not in self.dev:
            a = getattr(self, key)
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            self.dev[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
                self.torch_device)
        return self.dev[key]
