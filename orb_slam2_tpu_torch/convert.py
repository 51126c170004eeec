"""State conversion between the JAX package and this one.

The system has no weights: its state is the `Settings` and the constant
tables.  These helpers move them across as plain Python and numpy
values, so this module imports neither jax nor orb_slam2_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam2_tpu_torch.config import RectificationParams, Settings
from orb_slam2_tpu_torch.ops import brief
from orb_slam2_tpu_torch.slam.track_step import unpack_track_out


def settings_from_jax(s) -> Settings:
    """This package's Settings with every field of a JAX-package
    `Settings` (read through dataclasses.asdict)."""
    d = dataclasses.asdict(s)
    rect = d.pop("rectification")
    out = Settings(**d)
    if rect is not None:
        out.rectification = RectificationParams(**rect)
    return out


def pattern_from_numpy(p: np.ndarray) -> None:
    """Install a (256, 4) int32 [x0, y0, x1, y1] BRIEF pattern, e.g.
    `orb_slam2_tpu.ops.brief.get_pattern()`."""
    brief.set_pattern(np.asarray(p, np.int32))


def features_to_numpy(f, m=None) -> dict:
    """numpy fields of frontend `Features` (and optionally the matching
    `StereoMatches`): xy, octave, angle, desc as np.uint32 (the int32
    words' bits), valid, and u_right, depth when `m` is given."""
    def np_(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    out = {
        "xy": np_(f.xy),
        "octave": np_(f.octave),
        "angle": np_(f.angle),
        "desc": np.ascontiguousarray(np_(f.desc)).view(np.uint32),
        "valid": np_(f.valid),
    }
    if m is not None:
        out["u_right"] = np_(m.u_right)
        out["depth"] = np_(m.depth)
    return out


TRACK_INPUTS = ("img_l", "img_r", "scal", "last_f32", "last_desc",
                "last_oct", "last_angle", "loc_f32", "loc_desc", "loc_excl")


def track_inputs_from_numpy(blocks: dict, device="cpu") -> tuple:
    """The tracking step's inputs, in its argument order, as tensors on
    `device` from the numpy blocks the JAX step takes (keys as
    TRACK_INPUTS; loc_excl may be absent).  np.uint32 descriptor blocks
    become int32 tensors holding the same bits."""
    out = []
    for k in TRACK_INPUTS:
        a = blocks.get(k)
        if a is None:
            out.append(None)
            continue
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(device))
    return tuple(out)


def track_result_to_numpy(out, n: int, m: int) -> dict:
    """numpy fields of the port's TrackOut: every TrackResult field, plus
    `desc` as np.uint32 from the pack's tail."""
    res, desc = unpack_track_out(out, n, m)
    d = res._asdict()
    d["desc"] = desc
    return d
