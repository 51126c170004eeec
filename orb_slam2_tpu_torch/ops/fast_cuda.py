"""FAST score + NMS + per-cell threshold fallback: Hopper kernel and plain
version.

The counterpart of orb_slam2_tpu/ops/fast_pallas.py (nms_score_map and
its detect_with_fallback wrapper).  The kernel (csrc/fast.cu) fuses the
30-px per-cell fallback that the TPU wrapper did in XLA, and takes all
pyramid levels of one image in one launch: the levels' 30-px cells form
one grid, described by the table `cell_table` builds.  It is held exactly
equal to the plain version, `fast.detect_with_fallback`, level by level.
"""

from __future__ import annotations

import ctypes

import torch

from orb_slam2_tpu_torch.ops import cuda_build, fast

MAX_CELL = 30
MAX_LEVELS = 16   # csrc/fast.cu kMaxLevels
launches = 0   # kernel launches since the last reset


# the plain PyTorch version of one level (any device)
detect_with_fallback_plain = fast.detect_with_fallback


def cell_table(shapes, cell: int = 30):
    """The kernel's level table for levels of `shapes` ((h, w) each): per
    level (h, w, cells_x, cell0), where cell0 is the level's first cell in
    the launch's grid, and the number of cells of all levels."""
    rows = []
    n_cells = 0
    for h, w in shapes:
        cells_x = -(-w // cell)
        rows.append((h, w, cells_x, n_cells))
        n_cells += cells_x * -(-h // cell)
    return rows, n_cells


def detect_levels_plain(levels, ini_threshold: float, min_threshold: float,
                        border: int, cell: int = 30) -> list:
    """The plain version over a list of levels (any device)."""
    return [fast.detect_with_fallback(lv, ini_threshold, min_threshold,
                                      border, cell) for lv in levels]


def detect_levels_cuda(levels, ini_threshold: float, min_threshold: float,
                       border: int, cell: int = 30) -> list:
    """Launch csrc/fast.cu once over contiguous (H, W) float32 levels on
    one CUDA device.  Returns one score map a level, views of one buffer."""
    global launches
    if not levels:
        raise ValueError("levels: expected at least one level")
    dev = cuda_build.require_cuda(levels[0], "levels[0]")
    for i, lv in enumerate(levels):
        cuda_build.check_tensor(lv, f"levels[{i}]", torch.float32,
                                (None, None), dev)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(levels)}")
    if not 1 <= cell <= MAX_CELL:
        raise ValueError(f"cell must be in [1, {MAX_CELL}], got {cell}")
    shapes = [tuple(lv.shape) for lv in levels]
    table, n_cells = cell_table(shapes, cell)
    buf = torch.empty(sum(h * w for h, w in shapes), dtype=torch.float32,
                      device=dev)
    outs, start = [], 0
    for h, w in shapes:
        outs.append(buf[start:start + h * w].view(h, w))
        start += h * w
    ptrs = cuda_build.host_array(ctypes.c_void_p, [
        p for lv, o in zip(levels, outs) for p in (lv.data_ptr(),
                                                   o.data_ptr())])
    ints = cuda_build.host_array(ctypes.c_int,
                                 [v for row in table for v in row])
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        err = lib.orb_fast_levels(
            len(levels), ctypes.addressof(ptrs), ctypes.addressof(ints),
            n_cells, float(ini_threshold), float(min_threshold), int(border),
            int(cell), cuda_build.stream_ptr(dev))
    cuda_build.check_error(err, "orb_fast_levels")
    launches += 1
    return outs


def detect_levels(levels, ini_threshold: float, min_threshold: float,
                  border: int, cell: int = 30) -> list:
    """NMS'd FAST score maps with the per-cell fallback, one a level: one
    kernel launch for all levels on CUDA tensors, the plain version on CPU
    ones."""
    if levels[0].device.type == "cpu":
        return detect_levels_plain(levels, ini_threshold, min_threshold,
                                   border, cell)
    return detect_levels_cuda(levels, ini_threshold, min_threshold, border,
                              cell)


def detect_with_fallback_cuda(img: torch.Tensor, ini_threshold: float,
                              min_threshold: float, border: int,
                              cell: int = 30) -> torch.Tensor:
    """The kernel on one contiguous (H, W) float32 CUDA image."""
    return detect_levels_cuda([img], ini_threshold, min_threshold, border,
                              cell)[0]


def detect_with_fallback(img: torch.Tensor, ini_threshold: float,
                         min_threshold: float, border: int,
                         cell: int = 30) -> torch.Tensor:
    """NMS'd FAST score map with the per-cell fallback, zero outside the
    border: the kernel on a CUDA tensor, the plain version on a CPU one."""
    return detect_levels([img], ini_threshold, min_threshold, border,
                         cell)[0]
