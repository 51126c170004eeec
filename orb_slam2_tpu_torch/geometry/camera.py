"""Pinhole camera model with radial-tangential distortion, in PyTorch.

Port of orb_slam2_tpu/geometry/camera.py, limited to what FrameBuilder
uses: intrinsics, iterative keypoint undistortion (ref: src/Frame.cc:404
via cv::undistortPoints), image bounds (src/Frame.cc:436), rectification
maps (Examples/Stereo/stereo_euroc.cc:97-137) and the bilinear remap.

Intrinsics are 0-dim float32 tensors on the working device: dividing a
CUDA tensor by a Python scalar is computed as a multiply by its
reciprocal, which is not the division the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @classmethod
    def from_settings(cls, s, device="cpu"):
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(f32(s.fx), f32(s.fy), f32(s.cx), f32(s.cy))


def undistort_points(
    uv: torch.Tensor, intr: Intrinsics, dist: torch.Tensor, iters: int = 8
) -> torch.Tensor:
    """Iterative undistortion, matching cv::undistortPoints' fixed-point
    scheme (ref usage: src/Frame.cc:404-434).  (...,2) pixels -> pixels."""
    x0 = (uv[..., 0] - intr.cx) / intr.fx
    y0 = (uv[..., 1] - intr.cy) / intr.fy
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    u = x * intr.fx + intr.cx
    v = y * intr.fy + intr.cy
    return torch.stack([u, v], -1)


def compute_image_bounds(width, height, intr: Intrinsics, dist) -> np.ndarray:
    """Undistorted image bounds [minX, maxX, minY, maxY]
    (ref: Frame::ComputeImageBounds src/Frame.cc:436-464)."""
    if dist is None or float(np.abs(np.asarray(dist)).sum()) == 0.0:
        return np.array([0.0, float(width), 0.0, float(height)], np.float32)
    dev = intr.fx.device
    corners = torch.tensor(
        [[0.0, 0.0], [width, 0.0], [0.0, height], [width, height]],
        dtype=torch.float32, device=dev,
    )
    und = undistort_points(
        corners, intr,
        torch.as_tensor(np.asarray(dist), dtype=torch.float32, device=dev),
    ).cpu().numpy()
    return np.array(
        [
            min(und[0, 0], und[2, 0]),
            max(und[1, 0], und[3, 0]),
            min(und[0, 1], und[1, 1]),
            max(und[2, 1], und[3, 1]),
        ],
        np.float32,
    )


def rectify_maps(rect) -> tuple:
    """Build left/right remap grids from a RectificationParams block,
    equivalent to cv::initUndistortRectifyMap (ref: stereo_euroc.cc:97-137).

    Returns ((map_xl, map_yl), (map_xr, map_yr)) as float32 numpy arrays of
    shape (H, W): for each rectified pixel, the source pixel to sample.
    """
    H, W = rect.height, rect.width
    out = []
    for K, D, R, P in ((rect.K_l, rect.D_l, rect.R_l, rect.P_l),
                       (rect.K_r, rect.D_r, rect.R_r, rect.P_r)):
        fx_p, fy_p = P[0, 0], P[1, 1]
        cx_p, cy_p = P[0, 2], P[1, 2]
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64))
        x = (u - cx_p) / fx_p
        y = (v - cy_p) / fy_p
        ones = np.ones_like(x)
        rays = np.stack([x, y, ones], -1) @ np.linalg.inv(R).T
        xn = rays[..., 0] / rays[..., 2]
        yn = rays[..., 1] / rays[..., 2]
        d = np.zeros(5)
        d[: len(np.ravel(D))] = np.ravel(D)[:5]
        k1, k2, p1, p2, k3 = d
        r2 = xn * xn + yn * yn
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
        yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
        map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
        map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
        out.append((map_x, map_y))
    return out[0], out[1]


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Bilinear remap (cv::remap INTER_LINEAR equivalent) on device."""
    H, W = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    wx = map_x - x0
    wy = map_y - y0
    x0i = x0.long().clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    y0i = y0.long().clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    f = img.float()
    v00 = f[y0i, x0i]
    v01 = f[y0i, x1i]
    v10 = f[y1i, x0i]
    v11 = f[y1i, x1i]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    inb = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    return torch.where(inb, out, torch.zeros_like(out))
