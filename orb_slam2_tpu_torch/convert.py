"""State conversion between the JAX package and this one.

The system has no weights: its state is the `Settings`, the constant
tables and the map (`MapStore`).  These helpers move them across as
plain Python and numpy values, so this module imports neither jax nor
orb_slam2_tpu.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from orb_slam2_tpu_torch.config import RectificationParams, Settings
from orb_slam2_tpu_torch.ops import brief
from orb_slam2_tpu_torch.slam.map_store import MapStore
from orb_slam2_tpu_torch.slam.track_step import unpack_track_out
from orb_slam2_tpu_torch.solvers import ba


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


def map_store_from_jax(store, device="cpu") -> MapStore:
    """This package's MapStore from a JAX-package `MapStore`, read as its
    `save` reads it (the two packages share that layout), with every array
    and dict copied."""
    arrays, meta = MapStore.state(store)
    return MapStore.from_state({k: v.copy() for k, v in arrays.items()},
                               copy.deepcopy(meta), device=device)


def ba_problem_from_numpy(cam_T, cam_fixed, cam_mask, pts, pt_mask,
                          edge_cam, edge_pt, edge_uv, edge_inv_sigma2,
                          edge_mask, device="cpu") -> ba.BAProblem:
    """A `BAProblem` on `device` from numpy arrays (or anything
    np.asarray takes, e.g. the fields of a JAX-package BAProblem):
    float32 poses, points and observations, int64 edge indices, bool
    masks."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return ba.BAProblem(
        t(cam_T, np.float32), t(cam_fixed, bool), t(cam_mask, bool),
        t(pts, np.float32), t(pt_mask, bool),
        t(edge_cam, np.int64), t(edge_pt, np.int64),
        t(edge_uv, np.float32), t(edge_inv_sigma2, np.float32),
        t(edge_mask, bool))


def vocabulary_from_jax(voc):
    """This package's Vocabulary over copies of the tree arrays of a
    JAX-package `Vocabulary` (node descriptors, children, weights,
    parents, and k, L, levels_up)."""
    from orb_slam2_tpu_torch.places.vocabulary import Vocabulary

    return Vocabulary(
        int(voc.k), int(voc.L),
        np.array(voc.node_desc, np.uint32),
        np.array(voc.node_children, np.int32),
        np.array(voc.node_weight, np.float32),
        np.array(voc.node_parent, np.int32),
        levels_up=int(voc.levels_up))


def pose_graph_problem_from_numpy(R, t, s, fixed, vmask, edge_i, edge_j,
                                  meas_R, meas_t, meas_s, emask,
                                  device="cpu"):
    """A `PoseGraphProblem` on `device` from numpy arrays (or the fields
    of a JAX-package PoseGraphProblem): float32 Sim3 vertices and
    measurements, int64 edge indices, bool masks."""
    from orb_slam2_tpu_torch.solvers import pose_graph

    def t_(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return pose_graph.PoseGraphProblem(
        t_(R, np.float32), t_(t, np.float32), t_(s, np.float32),
        t_(fixed, bool), t_(vmask, bool),
        t_(edge_i, np.int64), t_(edge_j, np.int64),
        t_(meas_R, np.float32), t_(meas_t, np.float32),
        t_(meas_s, np.float32), t_(emask, bool))
