"""Intensity-centroid keypoint orientation (IC_Angle), batched.

Port of orb_slam2_tpu/ops/orientation.py (ref: IC_Angle,
src/ORBextractor.cc:77-104): moments m10, m01 over the discrete circle
of radius 15 around each keypoint, angle = atan2(m01, m10) in degrees.

The moments are summed in float64 and rounded once to float32.  The
float64 sum is exact in any order whenever every pixel of the patch is 0
or at least 2^-8 (each term is then a multiple of 2^-31 below 2^22), so
the Hopper kernel (`orb_cuda.describe_levels`), which sums in another
order, gets the same float32 moments and hence the same angles.  Resized
levels can hold smaller pixels; there the two float64 sums may differ in
the last bits, and their float32 roundings almost always agree.  On an
integer-valued level the float32 einsum of the JAX package is exact too;
on the resized levels it differs from this by its own rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_tpu_torch.ops import consts

HALF_PATCH = 15
DEG = float(np.float32(180.0 / np.pi))    # jnp.degrees' float32 factor
RAD = float(np.float32(np.pi / 180.0))    # jnp.radians' float32 factor


def _umax_table() -> np.ndarray:
    """Max |x| per |y| row of the discrete circle, radius HALF_PATCH."""
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(hp2 - v * v)))
    # ensure symmetry (the reference's second loop)
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def circular_mask() -> np.ndarray:
    """(31, 31) float mask of the discrete circle used by IC_Angle."""
    umax = _umax_table()
    size = 2 * HALF_PATCH + 1
    mask = np.zeros((size, size), np.float32)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        u_lim = umax[abs(v)]
        mask[v + HALF_PATCH, HALF_PATCH - u_lim : HALF_PATCH + u_lim + 1] = 1.0
    return mask


_MASK = circular_mask()
_DX = (np.arange(31) - HALF_PATCH).astype(np.float32)
# the moments' weights, mask * x and mask * y (exact in float64); copied
# to a device once, by consts.table
_W10 = _MASK.astype(np.float64) * _DX[None, :]
_W01 = _MASK.astype(np.float64) * _DX[:, None]


def ic_angles(
    img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Angles in degrees [0, 360) for keypoints at integer coords.

    img: (H, W) float32 level image.  xy: (N, 2) int32 (x, y) level coords.
    Centres are clipped to HALF_PATCH from the border; invalid keypoints
    get angle 0.
    """
    h, w = img.shape
    dev = img.device
    x = xy[:, 0].long().clamp(HALF_PATCH, w - 1 - HALF_PATCH)
    y = xy[:, 1].long().clamp(HALF_PATCH, h - 1 - HALF_PATCH)
    d = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=dev)
    rows = y[:, None] + d[None, :]                       # (N, 31)
    cols = x[:, None] + d[None, :]
    patches = img[rows[:, :, None], cols[:, None, :]].double()  # (N, 31, 31)
    w10 = consts.table(_W10, dev, torch.float64)
    w01 = consts.table(_W01, dev, torch.float64)
    m10 = (patches * w10).sum((1, 2)).float()
    m01 = (patches * w01).sum((1, 2)).float()
    ang = torch.atan2(m01, m10) * DEG
    ang = torch.where(ang < 0, ang + 360.0, ang)
    return torch.where(valid, ang, torch.zeros_like(ang))
