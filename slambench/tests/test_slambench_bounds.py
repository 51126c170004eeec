"""The frozen kernel arithmetic against the figures the kernels were
measured with (PERF.md's table of kernels, 376x1240, 2000 features)."""

import torch

from metrics import kernel_bounds as kb
from reference import orb


def test_fast_bytes_at_kitti_size():
    levels = [torch.zeros(h, w) for h, w in orb.level_sizes(376, 1240, 8,
                                                             1.2)]
    work = kb.fast_work(levels, 7.0)
    assert work["pixels"] == 1_442_870
    assert work["bytes"] == 11_542_960
    assert work["passing"] == 0          # a flat image: nothing passes
    assert abs(work["bound_s"] - 11_542_960 / 3.35e12) < 1e-15


def test_fast_counts_the_pixels_past_the_early_exit():
    img = torch.zeros(40, 40)
    img[20, 20] = 100.0                  # a bright dot: its ring is dark
    work = kb.fast_work([img], 7.0)
    # the dot itself, and the 4 compass neighbours that see it (each has one
    # compass point bright and its own pair neighbour dark: not an arc)
    assert work["passing"] >= 1
    assert work["ops"] == 1600 * kb.FAST_OPS_PER_PX + \
        work["passing"] * kb.FAST_OPS_PER_PASSING_PX


def test_describe_counts_distinct_pixels_once():
    lv = torch.rand(100, 100) * 255
    xy = torch.tensor([[50, 50], [50, 50]], dtype=torch.int32)
    v = torch.tensor([True, True])
    one = kb.describe_work([lv], [xy[:1]], [v[:1]], 128)
    two = kb.describe_work([lv], [xy], [v], 128)
    assert two["circle_px"] == one["circle_px"] == int(
        (orb.circular_mask() > 0).sum())
    assert two["tap_px"] == one["tap_px"]
    assert two["bytes"] - one["bytes"] == 9


def test_refine_counts_windows_and_strips():
    yc = torch.tensor([20], dtype=torch.int32)
    xl = torch.tensor([30], dtype=torch.int32)
    xr = torch.tensor([25], dtype=torch.int32)
    work = kb.refine_work(100, yc, xl, xr)
    assert work["left_px"] == 121 and work["right_px"] == 11 * 21
    assert work["bytes"] == 4 * (121 + 231) + 36 + 12
    assert work["ops"] == kb.SAD_OPS_PER_KP + kb.REFINE_OPS_PER_KP
