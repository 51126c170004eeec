"""The port's fused stereo tracking step against the JAX package's
`build_track_step(..., "stereo")` on the same inputs, both on the CPU
(JAX on its XLA path, the port eagerly on its plain PyTorch versions).

A 128x384 CylinderScene sequence at 500 features and 8 levels (as
tests/test_torch_frontend.py): frame 0 is built by the port's
FrameBuilder and gives the map (tests/test_torch_track_blocks.py);
frames 1 and 2 go through both steps with the same blocks, and the
state advances on the JAX step's result.  The sequence is three
consecutive poses of circle_trajectory(240, orbit_r=3, 3 pi), 2.25 deg a
frame.  The velocity of frame 1 is the trajectory's constant motion, as a
tracker that ran one frame before frame 0 would hold it: with the
identity instead, the first step's matching window misses the motion
(both packages' poses are then off by 0.14 m).

Tolerances (measured values in each test's docstring): xy, octave and
valid equal; Tcw within 1e-4; assign and inlier equal on >= 99.5% of
valid features; vis_local equal; n_matches_mm and n_inliers within 1;
the pose within 0.05 m and 0.5 deg of the rendered truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Settings as JSettings
from orb_slam2_tpu.slam import track_step as jts
from orb_slam2_tpu_torch import convert, utils
from orb_slam2_tpu_torch.slam import track_step as tts
from orb_slam2_tpu_torch.slam.frame import FrameBuilder
from synthetic import CylinderScene, circle_trajectory
from test_torch_track_blocks import TrackState, pose_error, stereo_init_map

torch.set_num_threads(2)

H, W = 128, 384
FX = 220.0
BASELINE = 0.5
N_FEATURES = 500
POSE_ATOL = 1e-4
MIN_SAME = 0.995
MAX_ERR_M, MAX_ERR_DEG = 0.05, 0.5


def run_sequence(mode: str, n_levels: int, n_frames: int = 3) -> list:
    """Frames 1..n_frames-1 of the sequence through both steps in `mode`:
    a list of (JAX result dict, port result dict, truth Tcw)."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]])
    scene = CylinderScene(K, H, W, radius=8.0, tex_h=2048)
    poses = circle_trajectory(240, orbit_r=3.0,
                              total_angle=3 * np.pi)[:n_frames]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BASELINE
    js = JSettings(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=BASELINE * FX,
                   width=W, height=H, n_features=N_FEATURES,
                   n_levels=n_levels)
    s = convert.settings_from_jax(js)

    def images(T):
        """(left, right image | depth image) of a pose."""
        left = scene.render(T).astype(np.uint8)
        if mode == "stereo":
            return left, scene.render(Trl @ T).astype(np.uint8)
        return left, scene.depth_at(T).astype(np.float32)

    # frame 0 gives the map: stereo depths, or the rendered depth image
    builder = FrameBuilder(s, device="cpu")
    l0, r0 = images(poses[0])
    f0 = (builder.stereo_pair(l0, r0, 0.0) if mode == "stereo"
          else builder.rgbd(l0, r0, 0.0)).feats
    pts = stereo_init_map(f0.xy, f0.depth, f0.valid, f0.octave, f0.desc,
                          s.fx, s.fy, s.cx, s.cy, s.scale_factors())
    M = utils.bucket_size(len(pts["pos"]))
    state = TrackState(pts, f0.octave, f0.angle, M, s.baseline, mode)
    state.velocity = (poses[1] @ np.linalg.inv(poses[0])).astype(np.float32)

    jstep = jts.build_track_step(js, mode)
    tstep = tts.build_track_step(s, mode, device="cpu")
    out = []
    for k in range(1, n_frames):
        blocks, cand, pids = state.blocks()
        img_l, img_r = images(poses[k])
        if mode == "mono":                # the Tracker passes img_l twice
            img_r = img_l
        jo = jstep(jnp.asarray(img_l), jnp.asarray(img_r),
                   *[jnp.asarray(blocks[n]) for n in convert.TRACK_INPUTS[2:]])
        jres, jdesc = jts.unpack_track_out(jo, f0.n, M)
        j = jres._asdict()
        j["desc"] = jdesc
        to = tstep(*convert.track_inputs_from_numpy(
            dict(img_l=img_l, img_r=img_r, **blocks)))
        t = convert.track_result_to_numpy(to, f0.n, M)
        t["out_desc"] = to.desc.numpy().view(np.uint32)
        out.append((j, t, poses[k] @ np.linalg.inv(poses[0])))
        state.apply(j, cand, pids)
    return out


@pytest.fixture(scope="module")
def stereo_run():
    return run_sequence("stereo", 8)


FRAMES = [0, 1]   # frames 1 and 2 of the sequence


@pytest.mark.parametrize("i", FRAMES)
def test_frontend_fields_equal(stereo_run, i):
    """xy, octave and valid equal (measured: equal); descriptors
    identical on >= 99% of valid features (measured 100%)."""
    j, t, _ = stereo_run[i]
    for k in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(t[k], j[k])
    v = j["valid"]
    assert v.sum() > 250
    assert (t["desc"] == j["desc"]).all(1)[v].mean() >= 0.99


@pytest.mark.parametrize("i", FRAMES)
def test_pose_matches_jax(stereo_run, i):
    """Tcw within 1e-4 (measured <= 4.4e-7)."""
    j, t, _ = stereo_run[i]
    np.testing.assert_allclose(t["Tcw"], j["Tcw"], atol=POSE_ATOL, rtol=0)


@pytest.mark.parametrize("i", FRAMES)
def test_assign_and_inlier_agree(stereo_run, i):
    """assign and inlier equal on >= 99.5% of valid features (measured:
    all); vis_local equal; n_matches_mm and n_inliers within 1 (measured:
    equal)."""
    j, t, _ = stereo_run[i]
    v = j["valid"]
    assert (t["assign"] == j["assign"])[v].mean() >= MIN_SAME
    assert (t["inlier"] == j["inlier"])[v].mean() >= MIN_SAME
    np.testing.assert_array_equal(t["vis_local"], j["vis_local"])
    assert abs(t["n_matches_mm"] - j["n_matches_mm"]) <= 1
    assert abs(t["n_inliers"] - j["n_inliers"]) <= 1
    assert j["n_matches_mm"] >= 20 and j["n_inliers"] >= 30


@pytest.mark.parametrize("i", FRAMES)
def test_pose_against_rendered_truth(stereo_run, i):
    """Within 0.05 m and 0.5 deg of the rendered pose (measured: 0.014 m
    and 0.18 deg at most)."""
    _, t, truth = stereo_run[i]
    dt, dr = pose_error(t["Tcw"], truth)
    assert dt <= MAX_ERR_M and dr <= MAX_ERR_DEG, (dt, dr)


def test_unpack_round_trips_descriptor_bits(stereo_run):
    """The pack's float32 tail gives back TrackOut.desc bit for bit, and
    the other fields keep their types."""
    _, t, _ = stereo_run[0]
    np.testing.assert_array_equal(t["desc"], t["out_desc"])
    assert t["desc"].dtype == np.uint32 and t["assign"].dtype == np.int32
    assert t["valid"].dtype == bool and t["Tcw"].shape == (4, 4)

