"""The frames and the true trajectory come from the seed alone."""

import json
from pathlib import Path

import numpy as np

from harness import scene as scene_mod
from reference import truth

DATA = Path(__file__).resolve().parent / "data"


def _cfg():
    cfg = json.loads((DATA / "configs" / "tiny-stereo.json").read_text())
    cfg["settings"]["Camera.width"], cfg["settings"]["Camera.height"] = 96, 64
    cfg["settings"]["Camera.cx"], cfg["settings"]["Camera.cy"] = 48.0, 32.0
    return cfg


def test_orbit_poses_are_the_circle():
    T = truth.orbit_poses(5, 3.0, 2.25, 0.7)
    for i, Ti in enumerate(T):
        phi = 0.7 + np.deg2rad(2.25) * i
        C = truth.centre(Ti)[:, 0]
        np.testing.assert_allclose(C, 3.0 * np.array(
            [np.sin(phi), 0.0, np.cos(phi)]), atol=1e-12)
        np.testing.assert_allclose(Ti[:3, :3] @ Ti[:3, :3].T, np.eye(3),
                                   atol=1e-12)
        # the optical axis points away from the orbit's centre
        np.testing.assert_allclose(Ti[2, :3], C / 3.0, atol=1e-12)


def test_same_seed_same_frames_other_seed_other_frames():
    sc = scene_mod.Cylinder(_cfg(), "cpu")
    big = 2 ** 31 + 12345          # seeds above 32 signed bits are fine
    a = sc.render(sc.poses(3, 2.25, big))[0]
    b = sc.render(sc.poses(3, 2.25, big))[0]
    c = sc.render(sc.poses(3, 2.25, big + 1))[0]
    assert all(x.dtype == np.uint8 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert scene_mod.start_phase(big) == scene_mod.start_phase(big)
    assert 0.0 <= scene_mod.start_phase(2 ** 40) < 2 * np.pi


def test_every_seed_offers_the_same_motion():
    sc = scene_mod.Cylinder(_cfg(), "cpu")
    for seed in (1, 2 ** 33):
        T = sc.poses(4, 0.75, seed)
        steps = [np.linalg.norm(truth.centre(T[i + 1]) - truth.centre(T[i]))
                 for i in range(3)]
        np.testing.assert_allclose(steps, 2 * 3.0 * np.sin(
            np.deg2rad(0.75) / 2), rtol=1e-9)


def test_depth_is_the_rendered_distance_at_the_factor():
    cfg = json.loads((DATA / "configs" / "tiny-rgbd.json").read_text())
    cfg["settings"]["Camera.width"], cfg["settings"]["Camera.height"] = 64, 48
    cfg["settings"]["Camera.cx"], cfg["settings"]["Camera.cy"] = 32.0, 24.0
    sc = scene_mod.Cylinder(cfg, "cpu")
    T = sc.poses(1, 1.0, 5)
    _, dep = sc.render(T, depth_factor=5000.0)
    import torch

    _, _, s = sc._trace(torch.as_tensor(T))
    np.testing.assert_array_equal(dep[0], np.round(s[0].numpy() * 5000.0))
    r, c = sc.radius, sc.orbit_r
    # straight ahead the wall is radius - orbit away
    assert abs(dep[0][24, 32] / 5000.0 - (r - c)) < 0.01


def test_right_camera_is_shifted_by_the_baseline():
    sc = scene_mod.Cylinder(_cfg(), "cpu")
    T = sc.poses(1, 1.0, 3)
    left = sc.render(T)[0][0]
    right = sc.render(T, right=True)[0][0]
    assert not np.array_equal(left, right)
