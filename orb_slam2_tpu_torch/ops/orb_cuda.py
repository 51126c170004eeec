"""Fused IC angle + rBRIEF descriptor: Hopper kernel and plain version.

The counterpart of orb_slam2_tpu/ops/orb_pallas.py (describe_oriented).
The kernel (csrc/orb.cu) computes the plain path's formula —
`orientation.ic_angles` then `brief.describe` — on the real level shapes,
without the TPU kernel's padding, for all pyramid levels of one image in
one launch: level l's keypoints fill rows row0_l .. row0_l + count_l - 1
of the image's outputs (the table `row_table` builds), and rows past the
last level are zero.  Angles agree with the plain version to float
rounding of the moments; descriptors bit for bit wherever the angles do.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from orb_slam2_tpu_torch.ops import brief, cuda_build, orientation

MAX_LEVELS = 16    # csrc/orb.cu kMaxLevels
TAP_REACH = 19     # csrc/orb.cu kTapReach: the staged tap window's radius
launches = 0   # kernel launches since the last reset
_tables_on = {}   # device index -> pattern bytes last copied to it


def describe_oriented_plain(img, img_blur, xy, valid):
    """The plain PyTorch version of one level (any device)."""
    ang = orientation.ic_angles(img, xy, valid)
    return ang, brief.describe(img_blur, xy, ang, valid)


def row_table(counts, n_rows: int):
    """Per level (row0, count): level l's keypoints fill rows row0 ..
    row0 + count - 1 of the image's `n_rows` output rows, in level order."""
    rows, row0 = [], 0
    for c in counts:
        rows.append((row0, int(c)))
        row0 += int(c)
    if row0 > n_rows:
        raise ValueError(f"{row0} keypoints do not fit {n_rows} rows")
    return rows


def describe_levels_plain(imgs, blurs, xys, valids, n_rows: int):
    """The plain version over a list of levels (any device): the levels'
    angles and descriptors concatenated and zero-padded to `n_rows`."""
    row_table([xy.shape[0] for xy in xys], n_rows)
    angs, descs = zip(*[describe_oriented_plain(*lv)
                        for lv in zip(imgs, blurs, xys, valids)])
    ang, desc = torch.cat(angs), torch.cat(descs)
    pad = n_rows - ang.shape[0]
    return (torch.cat([ang, ang.new_zeros(pad)]),
            torch.cat([desc, desc.new_zeros((pad, 8))]))


def _upload_tables(lib, dev: torch.device) -> None:
    pattern = np.ascontiguousarray(brief.get_pattern(), np.int32)
    key = pattern.tobytes()
    if _tables_on.get(dev.index) == key:
        return
    r2 = np.maximum(pattern[:, 0] ** 2 + pattern[:, 1] ** 2,
                    pattern[:, 2] ** 2 + pattern[:, 3] ** 2).max()
    if r2 > TAP_REACH ** 2:
        raise ValueError(f"a BRIEF tap {np.sqrt(r2):.1f} px from the centre "
                         f"leaves the kernel's {TAP_REACH}-px tap window")
    umax = np.ascontiguousarray(orientation._umax_table(), np.int32)
    err = lib.orb_set_tables(pattern.ctypes.data, umax.ctypes.data,
                             cuda_build.stream_ptr(dev))
    cuda_build.check_error(err, "orb_set_tables")
    _tables_on[dev.index] = key


def describe_levels_cuda(imgs, blurs, xys, valids, n_rows: int):
    """Launch csrc/orb.cu once over one image's levels.  Level l: imgs[l],
    blurs[l] (H_l, W_l) float32; xys[l] (N_l, 2) int32 level coords;
    valids[l] (N_l,) bool; all contiguous on one CUDA device.  Returns
    (angles_deg (n_rows,) float32, desc (n_rows, 8) int32)."""
    global launches
    if not imgs:
        raise ValueError("imgs: expected at least one level")
    dev = cuda_build.require_cuda(imgs[0], "imgs[0]")
    if not len(imgs) == len(blurs) == len(xys) == len(valids):
        raise ValueError("imgs, blurs, xys and valids differ in length")
    if len(imgs) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(imgs)}")
    ptrs, ints = [], []
    table = row_table([xy.shape[0] for xy in xys], n_rows)
    for l, (img, blur, xy, valid) in enumerate(zip(imgs, blurs, xys,
                                                   valids)):
        h, w = img.shape
        n = xy.shape[0]
        cuda_build.check_tensor(img, f"imgs[{l}]", torch.float32, (h, w), dev)
        cuda_build.check_tensor(blur, f"blurs[{l}]", torch.float32, (h, w),
                                dev)
        cuda_build.check_tensor(xy, f"xys[{l}]", torch.int32, (n, 2), dev)
        cuda_build.check_tensor(valid, f"valids[{l}]", torch.bool, (n,), dev)
        if min(h, w) < 2 * orientation.HALF_PATCH + 1:
            raise ValueError(f"level {h}x{w} is smaller than the 31-px patch")
        ptrs += [img.data_ptr(), blur.data_ptr(), xy.data_ptr(),
                 valid.data_ptr()]
        ints += [h, w, *table[l]]
    angle = torch.empty(n_rows, dtype=torch.float32, device=dev)
    desc = torch.empty((n_rows, 8), dtype=torch.int32, device=dev)
    ptrs = cuda_build.host_array(ctypes.c_void_p, ptrs)
    ints = cuda_build.host_array(ctypes.c_int, ints)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        _upload_tables(lib, dev)
        err = lib.orb_describe_levels(
            len(imgs), ctypes.addressof(ptrs), ctypes.addressof(ints),
            n_rows, angle.data_ptr(), desc.data_ptr(),
            cuda_build.stream_ptr(dev))
    cuda_build.check_error(err, "orb_describe_levels")
    launches += 1
    return angle, desc


def describe_levels(imgs, blurs, xys, valids, n_rows: int):
    """Angles (degrees) and packed descriptors for one image's levels, in
    level order and zero-padded to `n_rows`: one kernel launch for all
    levels on CUDA tensors, the plain version on CPU ones."""
    if imgs[0].device.type == "cpu":
        return describe_levels_plain(imgs, blurs, xys, valids, n_rows)
    return describe_levels_cuda(imgs, blurs, xys, valids, n_rows)


def describe_oriented_cuda(img: torch.Tensor, img_blur: torch.Tensor,
                           xy: torch.Tensor, valid: torch.Tensor):
    """The kernel on one level: img, img_blur (H, W) float32; xy (N, 2)
    int32 level coords; valid (N,) bool; all contiguous on one CUDA
    device.  Returns (angles_deg (N,) float32, desc (N, 8) int32)."""
    return describe_levels_cuda([img], [img_blur], [xy], [valid],
                                xy.shape[0])


def describe_oriented(img: torch.Tensor, img_blur: torch.Tensor,
                      xy: torch.Tensor, valid: torch.Tensor):
    """Angles (degrees) and packed descriptors for one level's keypoints:
    the kernel on CUDA tensors, the plain version on CPU ones."""
    if img.device.type == "cpu":
        return describe_oriented_plain(img, img_blur, xy, valid)
    return describe_oriented_cuda(img, img_blur, xy, valid)
