"""Fused IC angle + rBRIEF descriptor: Hopper kernel and plain version.

The counterpart of orb_slam2_tpu/ops/orb_pallas.py (describe_oriented).
The kernel (csrc/orb.cu) computes the plain path's formula —
`orientation.ic_angles` then `brief.describe` — on the real level shapes,
without the TPU kernel's padding.  Angles agree with the plain version
to float rounding of the moments; descriptors bit for bit wherever the
angles do.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_tpu_torch.ops import brief, cuda_build, orientation

launches = 0   # kernel launches since the last reset
_tables_on = {}   # device index -> pattern bytes last copied to it


def describe_oriented_plain(img, img_blur, xy, valid):
    """The plain PyTorch version (any device)."""
    ang = orientation.ic_angles(img, xy, valid)
    return ang, brief.describe(img_blur, xy, ang, valid)


def _upload_tables(lib, dev: torch.device) -> None:
    pattern = np.ascontiguousarray(brief.get_pattern(), np.int32)
    key = pattern.tobytes()
    if _tables_on.get(dev.index) == key:
        return
    umax = np.ascontiguousarray(orientation._umax_table(), np.int32)
    err = lib.orb_set_tables(pattern.ctypes.data, umax.ctypes.data,
                             cuda_build.stream_ptr(dev))
    cuda_build.check_error(err, "orb_set_tables")
    _tables_on[dev.index] = key


def describe_oriented_cuda(img: torch.Tensor, img_blur: torch.Tensor,
                           xy: torch.Tensor, valid: torch.Tensor):
    """Launch csrc/orb.cu.  img, img_blur: (H, W) float32; xy: (N, 2)
    int32 level coords; valid: (N,) bool; all contiguous on one CUDA
    device.  Returns (angles_deg (N,) float32, desc (N, 8) int32)."""
    global launches
    dev = cuda_build.require_cuda(img, "img")
    h, w = img.shape
    n = xy.shape[0]
    cuda_build.check_tensor(img, "img", torch.float32, (h, w), dev)
    cuda_build.check_tensor(img_blur, "img_blur", torch.float32, (h, w), dev)
    cuda_build.check_tensor(xy, "xy", torch.int32, (n, 2), dev)
    cuda_build.check_tensor(valid, "valid", torch.bool, (n,), dev)
    if min(h, w) < 2 * orientation.HALF_PATCH + 1:
        raise ValueError(f"level {h}x{w} is smaller than the 31-px patch")
    angle = torch.empty(n, dtype=torch.float32, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        _upload_tables(lib, dev)
        err = lib.orb_describe(
            img.data_ptr(), img_blur.data_ptr(), h, w, xy.data_ptr(),
            valid.data_ptr(), n, angle.data_ptr(), desc.data_ptr(),
            cuda_build.stream_ptr(dev))
    cuda_build.check_error(err, "orb_describe")
    launches += 1
    return angle, desc


def describe_oriented(img: torch.Tensor, img_blur: torch.Tensor,
                      xy: torch.Tensor, valid: torch.Tensor):
    """Angles (degrees) and packed descriptors for one level's keypoints:
    the kernel on CUDA tensors, the plain version on CPU ones."""
    if img.device.type == "cpu":
        return describe_oriented_plain(img, img_blur, xy, valid)
    return describe_oriented_cuda(img, img_blur, xy, valid)
