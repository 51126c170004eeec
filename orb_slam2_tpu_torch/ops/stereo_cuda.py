"""Stereo SAD strip correlation: Hopper kernel and plain version.

The counterpart of orb_slam2_tpu/ops/stereo_pallas.py (sad_strips): 11
centre-normalised 11x11 SAD scores per keypoint, for right windows
shifted by -5..+5 (ref: Frame::ComputeStereoMatches, src/Frame.cc:551-622).
The kernel (csrc/stereo.cu) reads the real level-0 shapes; the callers
pre-clip the centres, as stereo.match does.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.ops import cuda_build

W = 5   # SAD half-window (ref: Frame.cc:557 w=5)
L = 5   # search range +/- 5 (ref: Frame.cc:563)
launches = 0   # kernel launches since the last reset


def sad_strips_plain(level0_l, level0_r, yc, xl, xr) -> torch.Tensor:
    """The plain PyTorch version (any device): batched gathers."""
    dev = level0_l.device
    d = torch.arange(-W, W + 1, device=dev)
    rows = yc.long()[:, None] + d[None, :]                 # (N, 11)
    patch_l = level0_l[rows[:, :, None],
                       (xl.long()[:, None] + d[None, :])[:, None, :]]
    # the right strip covers the 11-px window plus the +/-5 search
    dr = torch.arange(-W - L, W + L + 1, device=dev)       # (21,)
    strip_r = level0_r[rows[:, :, None],
                       (xr.long()[:, None] + dr[None, :])[:, None, :]]
    # centre-normalised like the reference (IL - IL(center), Frame.cc:566)
    patch_l_n = patch_l - patch_l[:, W, W][:, None, None]
    sads = []
    for s in range(2 * L + 1):
        win = strip_r[:, :, s : s + 2 * W + 1]
        cr = win[:, W, W][:, None, None]
        sads.append(torch.abs(patch_l_n - (win - cr)).sum((1, 2)))
    return torch.stack(sads, 1)                            # (N, 11)


def sad_strips_cuda(level0_l: torch.Tensor, level0_r: torch.Tensor,
                    yc: torch.Tensor, xl: torch.Tensor,
                    xr: torch.Tensor) -> torch.Tensor:
    """Launch csrc/stereo.cu.  level0_*: (H, W) float32; yc, xl, xr: (N,)
    int32; all contiguous on one CUDA device.  Returns (N, 11) float32."""
    global launches
    dev = cuda_build.require_cuda(level0_l, "level0_l")
    h, w = level0_l.shape
    n = yc.shape[0]
    cuda_build.check_tensor(level0_l, "level0_l", torch.float32, (h, w), dev)
    cuda_build.check_tensor(level0_r, "level0_r", torch.float32, (h, w), dev)
    for name, t in (("yc", yc), ("xl", xl), ("xr", xr)):
        cuda_build.check_tensor(t, name, torch.int32, (n,), dev)
    out = torch.empty((n, 2 * L + 1), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.orb_sad_strips(
            level0_l.data_ptr(), level0_r.data_ptr(), h, w, yc.data_ptr(),
            xl.data_ptr(), xr.data_ptr(), n, out.data_ptr(),
            cuda_build.stream_ptr(dev))
    cuda_build.check_error(err, "orb_sad_strips")
    launches += 1
    return out


def sad_strips(level0_l: torch.Tensor, level0_r: torch.Tensor,
               yc: torch.Tensor, xl: torch.Tensor,
               xr: torch.Tensor) -> torch.Tensor:
    """(N, 11) SAD scores: the kernel on CUDA tensors, the plain version
    on CPU ones."""
    if level0_l.device.type == "cpu":
        return sad_strips_plain(level0_l, level0_r, yc, xl, xr)
    return sad_strips_cuda(level0_l, level0_r, yc, xl, xr)
