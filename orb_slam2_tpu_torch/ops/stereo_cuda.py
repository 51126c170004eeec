"""Stereo SAD refinement: Hopper kernel and plain version.

The counterpart of orb_slam2_tpu/ops/stereo_pallas.py (sad_strips) and of
the code around it in stereo.match's step 3 (ref: Frame::
ComputeStereoMatches, src/Frame.cc:551-622): from the Hamming match
(best_idx, best_dist) to the pre-sweep u_right, depth and SAD of each left
keypoint.  On a CUDA device that is one launch of csrc/stereo.cu
(`refine_cuda`); `refine_plain` is the same computation in PyTorch: the
centres, the 11 SAD scores (`sad_strips_plain`) and the epilogue
(`refine_from_scores`).  The scores alone, the TPU kernel's output, come
from `sad_strips`, on the same device code.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.ops import consts, cuda_build, hamming

W = 5   # SAD half-window (ref: Frame.cc:557 w=5)
L = 5   # search range +/- 5 (ref: Frame.cc:563)
TH_ORB = (hamming.TH_HIGH + hamming.TH_LOW) // 2   # ref: Frame.cc:479
launches = 0          # refine kernel launches since the last reset
strips_launches = 0   # scores-only kernel launches since the last reset


def centres(xy_l, xy_r, best_idx, h: int, w: int):
    """The SAD windows' int32 centres (yc, xl, xr): the keypoints' level-0
    coordinates truncated to int and clamped so that both patches lie in
    an (h, w) image."""
    yc = xy_l[:, 1].int().clamp(W, h - 1 - W)
    xl = xy_l[:, 0].int().clamp(W + L, w - 1 - W - L)
    xr = xy_r[best_idx, 0].int().clamp(W + L, w - 1 - W - L)
    return yc, xl, xr


def sad_strips_plain(level0_l, level0_r, yc, xl, xr) -> torch.Tensor:
    """The plain PyTorch version of the scores (any device): batched
    gathers."""
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


def refine_from_scores(scores, u_l, xr, best_dist, bf, min_disp, max_disp):
    """The epilogue of step 3 on (N, 11) SAD scores: the best shift, the
    parabola fit, the disparity window and the depth.  u_l: the left
    keypoints' level-0 x; xr: the right centres; bf, min_disp, max_disp:
    0-dim float32 tensors.  Returns (u_right, depth, sad), -1 / -1 / +inf
    where the match is not good."""
    n = scores.shape[0]
    best_s = torch.argmin(scores, dim=1)
    best_sad = scores.amin(dim=1)
    interior = (best_s > 0) & (best_s < 2 * L)
    rows = torch.arange(n, device=scores.device)
    im1 = scores[rows, (best_s - 1).clamp(min=0)]
    ip1 = scores[rows, (best_s + 1).clamp(max=2 * L)]
    denom = im1 + ip1 - 2.0 * best_sad
    delta = torch.where(
        interior & (denom > 1e-6),
        0.5 * (im1 - ip1) / denom.clamp(min=1e-6),
        torch.zeros_like(denom),
    )
    delta = delta.clamp(-1.0, 1.0)   # ref rejects |delta|>1 (Frame.cc:600)

    u_right = xr.float() + (best_s - L).float() + delta
    disparity = u_l - u_right
    good = ((best_dist < TH_ORB) & (disparity >= min_disp)
            & (disparity < max_disp))
    # ref: disparity<=0 snapped to 0.01 (Frame.cc:609-612)
    disparity = torch.where(disparity <= 0,
                            consts.scalar(0.01, scores.device), disparity)

    neg = torch.full_like(disparity, -1.0)
    return (torch.where(good, u_right, neg),
            torch.where(good, bf / disparity, neg),
            torch.where(good, best_sad, torch.full_like(best_sad, torch.inf)))


def refine_plain(level0_l, level0_r, xy_l, xy_r, best_idx, best_dist, bf,
                 min_disp, max_disp):
    """The plain PyTorch version of the refinement (any device)."""
    h, w = level0_l.shape
    yc, xl, xr = centres(xy_l, xy_r, best_idx, h, w)
    scores = sad_strips_plain(level0_l, level0_r, yc, xl, xr)
    return refine_from_scores(scores, xy_l[:, 0], xr, best_dist, bf,
                              min_disp, max_disp)


def _check_images(level0_l, level0_r, dev) -> tuple[int, int]:
    h, w = level0_l.shape
    cuda_build.check_tensor(level0_l, "level0_l", torch.float32, (h, w), dev)
    cuda_build.check_tensor(level0_r, "level0_r", torch.float32, (h, w), dev)
    if h < 2 * W + 1 or w < 2 * (W + L) + 1:
        raise ValueError(f"level 0 {h}x{w} is smaller than the "
                         f"{2 * W + 1}x{2 * (W + L) + 1} SAD strip")
    return h, w


def refine_cuda(level0_l, level0_r, xy_l, xy_r, best_idx, best_dist, bf,
                min_disp, max_disp, scores: torch.Tensor | None = None):
    """Launch csrc/stereo.cu's refinement.  level0_*: (H, W) float32; xy_l
    (N, 2), xy_r (M, 2) float32; best_idx (N,) int64; best_dist (N,)
    int32; bf, min_disp, max_disp 0-dim float32 (read on the device, never
    on the host); all contiguous on one CUDA device.  If `scores` is given
    ((N, 11) float32), the kernel writes the SAD scores into it too.
    Returns (u_right, depth, sad), each (N,) float32."""
    global launches
    dev = cuda_build.require_cuda(level0_l, "level0_l")
    h, w = _check_images(level0_l, level0_r, dev)
    n = xy_l.shape[0]
    cuda_build.check_tensor(xy_l, "xy_l", torch.float32, (n, 2), dev)
    cuda_build.check_tensor(xy_r, "xy_r", torch.float32, (None, 2), dev)
    cuda_build.check_tensor(best_idx, "best_idx", torch.int64, (n,), dev)
    cuda_build.check_tensor(best_dist, "best_dist", torch.int32, (n,), dev)
    for name, t in (("bf", bf), ("min_disp", min_disp),
                    ("max_disp", max_disp)):
        cuda_build.check_tensor(t, name, torch.float32, (), dev)
    if scores is not None:
        cuda_build.check_tensor(scores, "scores", torch.float32,
                                (n, 2 * L + 1), dev)
    if xy_r.shape[0] == 0 and n > 0:
        raise ValueError("xy_r: no right keypoints to match")
    u_right, depth, sad = torch.empty((3, n), dtype=torch.float32,
                                      device=dev).unbind(0)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.orb_stereo_refine(
            level0_l.data_ptr(), level0_r.data_ptr(), h, w, xy_l.data_ptr(),
            xy_r.data_ptr(), best_idx.data_ptr(), best_dist.data_ptr(),
            TH_ORB, bf.data_ptr(), min_disp.data_ptr(), max_disp.data_ptr(),
            n, u_right.data_ptr(), depth.data_ptr(), sad.data_ptr(),
            None if scores is None else scores.data_ptr(),
            cuda_build.stream_ptr(dev))
    cuda_build.check_error(err, "orb_stereo_refine")
    launches += 1
    return u_right, depth, sad


def refine(level0_l, level0_r, xy_l, xy_r, best_idx, best_dist, bf,
           min_disp, max_disp):
    """(u_right, depth, sad) of each left keypoint from its Hamming match:
    one kernel launch on CUDA tensors, the plain version on CPU ones."""
    if level0_l.device.type == "cpu":
        return refine_plain(level0_l, level0_r, xy_l, xy_r, best_idx,
                            best_dist, bf, min_disp, max_disp)
    return refine_cuda(level0_l, level0_r, xy_l, xy_r, best_idx, best_dist,
                       bf, min_disp, max_disp)


def sad_strips_cuda(level0_l: torch.Tensor, level0_r: torch.Tensor,
                    yc: torch.Tensor, xl: torch.Tensor,
                    xr: torch.Tensor) -> torch.Tensor:
    """Launch csrc/stereo.cu's scores-only kernel.  level0_*: (H, W)
    float32; yc, xl, xr: (N,) int32 centres as `centres` gives them; all
    contiguous on one CUDA device.  Returns (N, 11) float32."""
    global strips_launches
    dev = cuda_build.require_cuda(level0_l, "level0_l")
    h, w = _check_images(level0_l, level0_r, dev)
    n = yc.shape[0]
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
    strips_launches += 1
    return out


def sad_strips(level0_l: torch.Tensor, level0_r: torch.Tensor,
               yc: torch.Tensor, xl: torch.Tensor,
               xr: torch.Tensor) -> torch.Tensor:
    """(N, 11) SAD scores: the kernel on CUDA tensors, the plain version
    on CPU ones."""
    if level0_l.device.type == "cpu":
        return sad_strips_plain(level0_l, level0_r, yc, xl, xr)
    return sad_strips_cuda(level0_l, level0_r, yc, xl, xr)
