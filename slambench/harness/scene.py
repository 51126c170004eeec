"""The frames a cell offers: a textured cylinder seen from an orbit.

The camera stands inside a vertical cylinder whose wall carries a
blob texture, and orbits its axis looking outward (the loop-closure
circuit of the repository's own bench: a 360-degree turn returns to
views the map has not been connected to).  The scene comes from the
configuration and never from the seed; the seed sets where on the orbit
the camera starts, so every seed offers the same motion, sizes and
arrival times over other images.

Frames are rendered on the run's device in batches and copied to the
host once, as uint8 images (and uint16 depth for RGB-D, at the
configuration's DepthMapFactor), because a camera hands host images to
the system.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.truth import orbit_poses

PHASE_SALT = 0x5EED


def make_texture(h: int, w: int, seed: int) -> np.ndarray:
    """High-contrast rectangles at four scales, lightly smoothed."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for size, count in ((64, 40), (32, 120), (16, 300), (8, 600)):
        for _ in range(int(round(count * h / 512))):
            y = rng.integers(0, h - size)
            x = rng.integers(0, w - size)
            val = rng.uniform(40, 255)
            img[y:y + size // 2, x:x + size // 2] = val
            img[y + size // 2:y + size, x + size // 2:x + size] = 255 - val
    k = np.array([0.25, 0.5, 0.25], np.float32)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return np.clip(img, 0, 255)


def start_phase(seed: int) -> float:
    """The orbit's starting azimuth (radians) for a run's seed."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), PHASE_SALT])
    return float(rng.uniform(0.0, 2.0 * np.pi))


class Cylinder:
    """The configuration's scene on `device`."""

    def __init__(self, cfg: dict, device):
        sc, st = cfg["scene"], cfg["settings"]
        self.device = torch.device(device)
        self.h, self.w = int(st["Camera.height"]), int(st["Camera.width"])
        self.K = np.array([[st["Camera.fx"], 0.0, st["Camera.cx"]],
                           [0.0, st["Camera.fy"], st["Camera.cy"]],
                           [0.0, 0.0, 1.0]])
        self.radius = float(sc["radius_m"])
        self.px_per_m = float(sc["px_per_m"])
        self.orbit_r = float(sc["orbit_r_m"])
        self.baseline = float(st["Camera.bf"]) / float(st["Camera.fx"])
        tw = int(round(2 * np.pi * self.radius * self.px_per_m))
        self.tex = torch.from_numpy(make_texture(
            int(sc["tex_h"]), tw, int(sc["texture_seed"]))).to(self.device)
        dev = self.device
        u = torch.arange(self.w, dtype=torch.float64, device=dev)
        v = torch.arange(self.h, dtype=torch.float64, device=dev)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        self.rays = torch.stack([(uu - self.K[0, 2]) / self.K[0, 0],
                                 (vv - self.K[1, 2]) / self.K[1, 1],
                                 torch.ones_like(uu)], -1)   # (H, W, 3)

    def poses(self, n: int, deg_per_frame: float, seed: int) -> np.ndarray:
        return orbit_poses(n, self.orbit_r, deg_per_frame, start_phase(seed))

    def _trace(self, Tcw: torch.Tensor):
        """Per-pixel ray-cylinder hits of a batch (B, 4, 4): (theta, y, s),
        s the hit's depth along the camera's z."""
        R, t = Tcw[:, :3, :3], Tcw[:, :3, 3]
        C = -(R.transpose(1, 2) @ t[:, :, None])[:, :, 0]     # (B, 3)
        rays = torch.einsum("hwj,bjk->bhwk", self.rays, R)     # R^T row-wise
        dx, dz = rays[..., 0], rays[..., 2]
        cx, cz = C[:, 0, None, None], C[:, 2, None, None]
        a = dx * dx + dz * dz
        b = 2 * (cx * dx + cz * dz)
        c = cx * cx + cz * cz - self.radius ** 2
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        s = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-12)
        hit_x = cx + s * dx
        hit_z = cz + s * dz
        hit_y = C[:, 1, None, None] + s * rays[..., 1]
        return torch.atan2(hit_x, hit_z), hit_y, s

    def _shade(self, theta, y):
        th_, tw = self.tex.shape
        mx = (theta + np.pi) / (2 * np.pi) * tw
        my = y * self.px_per_m
        fx, fy = torch.floor(mx), torch.floor(my)
        x0 = fx.long() % tw
        y0 = fy.long() % th_
        x1, y1 = (x0 + 1) % tw, (y0 + 1) % th_
        wx, wy = mx - fx, my - fy
        f = self.tex.double()
        return (f[y0, x0] * (1 - wx) * (1 - wy) + f[y0, x1] * wx * (1 - wy)
                + f[y1, x0] * (1 - wx) * wy + f[y1, x1] * wx * wy)

    def render(self, poses: np.ndarray, right: bool = False,
               depth_factor: float = 0.0, batch: int = 8) -> tuple:
        """uint8 images of every pose (the right camera of a stereo rig
        with `right`), and with depth_factor > 0 also uint16 depth images
        in units of 1 / depth_factor m.  Host numpy arrays, one per frame,
        copied from the device once."""
        n = len(poses)
        out = np.empty((n, self.h, self.w), np.uint8)
        dep = np.empty((n, self.h, self.w), np.uint16) if depth_factor else None
        T = torch.as_tensor(np.asarray(poses, np.float64), device=self.device)
        if right:
            Trl = torch.eye(4, dtype=torch.float64, device=self.device)
            Trl[0, 3] = -self.baseline
            T = Trl @ T
        for i in range(0, n, batch):
            theta, y, s = self._trace(T[i:i + batch])
            img = torch.round(self._shade(theta, y)).clamp(0, 255)
            out[i:i + batch] = img.to(torch.uint8).cpu().numpy()
            if dep is not None:
                dep[i:i + batch] = torch.round(s * depth_factor).clamp(
                    0, 65535).to(torch.int32).cpu().numpy()
        return list(out), (list(dep) if dep is not None else None)
