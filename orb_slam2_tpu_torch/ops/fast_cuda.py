"""FAST score + NMS + per-cell threshold fallback: Hopper kernel and plain
version.

The counterpart of orb_slam2_tpu/ops/fast_pallas.py (nms_score_map and
its detect_with_fallback wrapper).  The kernel (csrc/fast.cu) fuses the
30-px per-cell fallback that the TPU wrapper did in XLA.  It is held
exactly equal to the plain version, `fast.detect_with_fallback`.
"""

from __future__ import annotations

import torch

from orb_slam2_tpu_torch.ops import cuda_build, fast

MAX_CELL = 30
launches = 0   # kernel launches since the last reset


# the plain PyTorch version (any device)
detect_with_fallback_plain = fast.detect_with_fallback


def detect_with_fallback_cuda(img: torch.Tensor, ini_threshold: float,
                              min_threshold: float, border: int,
                              cell: int = 30) -> torch.Tensor:
    """Launch csrc/fast.cu on a contiguous (H, W) float32 CUDA image."""
    global launches
    dev = cuda_build.require_cuda(img, "img")
    cuda_build.check_tensor(img, "img", torch.float32, (None, None), dev)
    if not 1 <= cell <= MAX_CELL:
        raise ValueError(f"cell must be in [1, {MAX_CELL}], got {cell}")
    h, w = img.shape
    out = torch.empty_like(img)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.orb_fast_detect(
            img.data_ptr(), out.data_ptr(), h, w, float(ini_threshold),
            float(min_threshold), int(border), int(cell),
            cuda_build.stream_ptr(dev))
    cuda_build.check_error(err, "orb_fast_detect")
    launches += 1
    return out


def detect_with_fallback(img: torch.Tensor, ini_threshold: float,
                         min_threshold: float, border: int,
                         cell: int = 30) -> torch.Tensor:
    """NMS'd FAST score map with the per-cell fallback, zero outside the
    border: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if img.device.type == "cpu":
        return detect_with_fallback_plain(img, ini_threshold, min_threshold,
                                          border, cell)
    return detect_with_fallback_cuda(img, ini_threshold, min_threshold,
                                     border, cell)
