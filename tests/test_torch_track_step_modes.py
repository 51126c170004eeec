"""The port's fused tracking step in its rgbd and mono modes against the
JAX package's, on the same inputs, both on the CPU.

The sequence and the comparisons are those of test_torch_track_step.py,
at 4 pyramid levels (the JAX step's CPU compile is shorter).  The map
comes from frame 0 with the rendered depth image (FrameBuilder.rgbd), in
both modes; rgbd frames pass the depth image as img_r, mono frames the
left image alone.

Tolerances as there (measured values in each docstring).  The largest
pose difference is rgbd's frame 2, 6.9e-5: a rotation of 1.2e-5 rad
traded against 6.9e-5 m of translation, the direction in which a pose
seen at 5 m is least determined, where the two float32 solvers stop at
different points of the same valley.
"""

import numpy as np
import pytest

from test_torch_track_blocks import pose_error
from test_torch_track_step import (
    MAX_ERR_DEG, MAX_ERR_M, MIN_SAME, POSE_ATOL, run_sequence,
)


@pytest.fixture(scope="module", params=["rgbd", "mono"])
def mode_run(request):
    return request.param, run_sequence(request.param, 4)


@pytest.mark.parametrize("i", [0, 1])
def test_fields_and_pose_match_jax(mode_run, i):
    """xy, octave, valid, ur and depth equal; Tcw within 1e-4 (measured
    <= 6.9e-5 in rgbd, 9.6e-7 in mono); descriptors identical on >= 99%
    of valid features (measured 100%)."""
    mode, run = mode_run
    j, t, _ = run[i]
    for k in ("xy", "octave", "valid", "ur", "depth"):
        np.testing.assert_array_equal(t[k], j[k])
    v = j["valid"]
    assert v.sum() > 250
    assert (t["desc"] == j["desc"]).all(1)[v].mean() >= 0.99
    np.testing.assert_allclose(t["Tcw"], j["Tcw"], atol=POSE_ATOL, rtol=0)
    if mode == "mono":
        assert (t["ur"] == -1).all() and (t["depth"] == -1).all()


@pytest.mark.parametrize("i", [0, 1])
def test_assign_inlier_and_counts_match_jax(mode_run, i):
    """assign and inlier equal on >= 99.5% of valid features (measured:
    all); vis_local equal; counts within 1 (measured: equal)."""
    _, run = mode_run
    j, t, _ = run[i]
    v = j["valid"]
    assert (t["assign"] == j["assign"])[v].mean() >= MIN_SAME
    assert (t["inlier"] == j["inlier"])[v].mean() >= MIN_SAME
    np.testing.assert_array_equal(t["vis_local"], j["vis_local"])
    assert abs(t["n_matches_mm"] - j["n_matches_mm"]) <= 1
    assert abs(t["n_inliers"] - j["n_inliers"]) <= 1
    assert j["n_matches_mm"] >= 20 and j["n_inliers"] >= 30


@pytest.mark.parametrize("i", [0, 1])
def test_pose_against_rendered_truth(mode_run, i):
    """Within 0.05 m and 0.5 deg of the rendered pose (measured: 0.036 m
    and 0.40 deg at most, mono's frame 2)."""
    _, run = mode_run
    _, t, truth = run[i]
    dt, dr = pose_error(t["Tcw"], truth)
    assert dt <= MAX_ERR_M and dr <= MAX_ERR_DEG, (dt, dr)
