"""The monocular initializer (solvers/initializer.py) and the
initialization matcher (ops/matching.py::search_for_initialization) of
the port against the JAX package on the CPU, on inputs made by numpy from
a seed and with the SAME RANSAC samples in both.

The initializer: the same `success` and `used_homography`; R21 and t21
within TOL = 1e-4; `good_mask` equal on >= 99.5% of rows; `points3d`
within 1e-3 relative on the rows both call good.  SVD bases differ
between the two backends' LAPACK calls, so hypothesis order can differ:
only the chosen motion is compared.  The matcher is integer Hamming work:
idx and ok must be EQUAL.  Mirrors tests/test_solvers.py::TestInitializer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.ops import matching as jmatching
from orb_slam2_tpu.solvers import initializer as jinit
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.ops import frontend, matching
from orb_slam2_tpu_torch.solvers import initializer
from synthetic import PlaneScene, straight_trajectory
from test_solvers import K, cam_pose, make_world, project

torch.set_num_threads(2)

TOL = 1e-4
GOOD_MIN_SHARE = 0.995
PTS_RTOL = 1e-3


def T(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def both(uv1, uv2, mask, samples):
    """(port result, JAX result) as numpy dicts on the same inputs."""
    uv1 = np.asarray(uv1, np.float32)
    uv2 = np.asarray(uv2, np.float32)
    got = initializer.initialize(T(uv1), T(uv2), T(mask), T(K), T(samples))
    want = jinit.initialize(jnp.asarray(uv1), jnp.asarray(uv2),
                            jnp.asarray(mask), jnp.asarray(K),
                            jnp.asarray(samples))
    return ({k: v.numpy() for k, v in got._asdict().items()},
            {k: np.asarray(v) for k, v in want._asdict().items()})


def assert_same_motion(got, want):
    assert bool(got["success"]) == bool(want["success"])
    assert bool(got["used_homography"]) == bool(want["used_homography"])
    if not bool(want["success"]):
        return
    np.testing.assert_allclose(got["R21"], want["R21"], atol=TOL, rtol=0)
    np.testing.assert_allclose(got["t21"], want["t21"], atol=TOL, rtol=0)
    share = np.mean(got["good_mask"] == want["good_mask"])
    assert share >= GOOD_MIN_SHARE, share
    rows = got["good_mask"] & want["good_mask"]
    assert rows.sum() > 0
    np.testing.assert_allclose(got["points3d"][rows], want["points3d"][rows],
                               rtol=PTS_RTOL, atol=PTS_RTOL)


def two_views(rng, n, planar, outlier_share=0.0):
    """TestInitializer's scenes: a 0.6 m sideways baseline and 4 deg of
    rotation, 0.4 px noise; `outlier_share` of the rows get random uv2."""
    if planar:
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                        np.full(n, 6.0)], -1).astype(np.float32)
    else:
        pts = make_world(rng, n)
    T2 = cam_pose(rng, rot_deg=4, trans=0.0)
    T2[:3, 3] = np.array([0.6, 0.05, 0.02])
    uv1 = project(pts) + rng.normal(0, 0.4, (n, 2))
    pc2 = pts @ T2[:3, :3].T + T2[:3, 3]
    uv2 = project(pc2) + rng.normal(0, 0.4, (n, 2))
    n_out = int(round(outlier_share * n))
    if n_out:
        rows = rng.choice(n, n_out, replace=False)
        uv2[rows] = rng.uniform((0, 0), (640, 480), (n_out, 2))
    inb = ((uv1[:, 0] > 0) & (uv1[:, 0] < 640) & (uv1[:, 1] > 0)
           & (uv1[:, 1] < 480) & (uv2[:, 0] > 0) & (uv2[:, 0] < 640)
           & (uv2[:, 1] > 0) & (uv2[:, 1] < 480))
    return uv1, uv2, inb, T2, pts


def test_make_ransac_samples_is_the_jax_packages():
    for n in (8, 150, 2048):
        a = initializer.make_ransac_samples(n, np.random.default_rng(0))
        b = jinit.make_ransac_samples(n, np.random.default_rng(0))
        assert a.dtype == b.dtype and a.shape == b.shape == (200, 8)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("planar, seed", [(False, 7), (True, 8)])
def test_test_solvers_scenes_match_jax(planar, seed):
    """tests/test_solvers.py::TestInitializer's general (F) and planar (H)
    scenes, 150 rows."""
    rng = np.random.default_rng(seed)
    uv1, uv2, inb, T2, _ = two_views(rng, 150, planar)
    samples = initializer.make_ransac_samples(150, rng)
    got, want = both(uv1, uv2, inb, samples)
    assert bool(got["success"])
    assert bool(got["used_homography"]) == planar
    assert_same_motion(got, want)
    np.testing.assert_allclose(got["R21"], T2[:3, :3],
                               atol=1e-2 if planar else 5e-3)


def test_pure_rotation_fails_as_in_jax():
    rng = np.random.default_rng(9)
    n = 150
    pts = make_world(rng, n)
    T2 = cam_pose(rng, rot_deg=5, trans=0.0)
    uv1 = project(pts)
    uv2 = project(pts @ T2[:3, :3].T)
    samples = initializer.make_ransac_samples(n, rng)
    got, want = both(uv1, uv2, np.ones(n, bool), samples)
    assert not bool(got["success"]) and not bool(want["success"])


@pytest.mark.parametrize("planar", [False, True])
def test_kitti_sized_with_outliers_and_masked_block(planar):
    """N = 2048 match rows, 30% outliers, and a block of masked-out rows
    holding junk coordinates (the rows a failed match leaves)."""
    rng = np.random.default_rng(21 + planar)
    n = 2048
    uv1, uv2, inb, _, _ = two_views(rng, n, planar, outlier_share=0.3)
    mask = inb.copy()
    mask[1500:1700] = False
    uv1[1500:1700] = rng.uniform(-1e4, 1e4, (200, 2))
    uv2[1500:1700] = rng.uniform(-1e4, 1e4, (200, 2))
    rows = np.nonzero(mask)[0]
    samples = rows[initializer.make_ransac_samples(
        len(rows), np.random.default_rng(0))].astype(np.int32)
    got, want = both(uv1, uv2, mask, samples)
    assert bool(want["success"])
    assert bool(want["used_homography"]) == planar
    assert_same_motion(got, want)
    assert not got["good_mask"][1500:1700].any()


def test_singular_homography_sample_raises_nothing():
    """A minimal set whose 8 points repeat one correspondence: its
    homography is singular (JAX inverts it to inf / nan, torch's inverse
    would raise), and it must simply lose the score."""
    rng = np.random.default_rng(7)
    uv1, uv2, inb, _, _ = two_views(rng, 150, False)
    samples = initializer.make_ransac_samples(150, rng)
    samples[:20] = samples[:20, :1]
    got, want = both(uv1, uv2, inb, samples)
    assert bool(got["success"])
    assert_same_motion(got, want)
    singular = torch.ones(2, 3, 3)
    singular[1] = torch.eye(3)
    inv = initializer._inv(singular)
    assert torch.isnan(inv[0]).all() and torch.equal(inv[1], torch.eye(3))


def collinear(seed, noise_px):
    """150 points on one 3D line seen from two cameras 0.6 m apart."""
    rng = np.random.default_rng(seed)
    n = 150
    x = rng.uniform(-3, 3, n)
    pts = np.stack([x, 0.5 * x, np.full(n, 6.0)], -1).astype(np.float32)
    uv1 = project(pts)
    uv2 = project(pts + np.array([0.6, 0.0, 0.0], np.float32))
    samples = initializer.make_ransac_samples(n, rng)
    if noise_px:
        noise = np.random.default_rng(seed + 100)
        uv1 = uv1 + noise.normal(0, noise_px, uv1.shape)
        uv2 = uv2 + noise.normal(0, noise_px, uv2.shape)
    return both(uv1, uv2, np.ones(n, bool), samples)


@pytest.mark.parametrize("seed", [0, 3])
def test_exactly_collinear_points_raise_nothing(seed):
    """Exactly collinear matches leave the DLT and 8-point null spaces more
    than one-dimensional: which null vector an SVD returns decides
    `success` in either package, and the two disagree on some seeds
    (ROADMAP §3).  The port must raise nothing and, where it succeeds,
    return a rotation."""
    got, _ = collinear(seed, 0.0)
    if bool(got["success"]):
        R = got["R21"]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2, 4])
def test_noisy_collinear_points_fail_as_in_jax(seed):
    """With 0.4 px of noise the two packages agree on `success`; on these
    seeds both fail."""
    got, want = collinear(seed, 0.4)
    assert not bool(want["success"])
    assert not bool(got["success"])


def test_non_finite_rows_raise_nothing():
    """NaN / inf coordinates in masked-out rows: JAX's normalisation
    multiplies them by a zero weight and carries the NaN into every model;
    the port's SVDs must not raise on them and must fail the same way."""
    rng = np.random.default_rng(7)
    uv1, uv2, inb, _, _ = two_views(rng, 150, False)
    mask = inb.copy()
    mask[:5] = False
    uv1[:3] = np.nan
    uv2[3:5] = np.inf
    rows = np.nonzero(mask)[0]
    samples = rows[initializer.make_ransac_samples(
        len(rows), np.random.default_rng(0))].astype(np.int32)
    got, want = both(uv1, uv2, mask, samples)
    assert not bool(want["success"])
    assert not bool(got["success"])
    assert not got["good_mask"].any()


# ---------------------------------------------------------------------------
# SearchForInitialization
# ---------------------------------------------------------------------------
def test_search_for_initialization_matches_jax():
    """Two rendered views of tests/synthetic.py's plane, 6 cm apart, each
    extracted once at the init budget (1600 features): the same feature
    blocks through both matchers give the same idx and ok."""
    H, W, F = 240, 320, 260.0
    Kp = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    scene = PlaneScene(Kp, H, W)
    poses = straight_trajectory(3, step=0.06, yaw_step=0.002)
    feats = [convert.features_to_numpy(frontend.extract(
        torch.from_numpy(scene.render(Tp)), n_features=1600))
        for Tp in (poses[0], poses[2])]
    keys = ("xy", "desc", "octave", "angle", "valid")
    got = matching.to_host(matching.search_for_initialization(
        *[T(feats[0][k]) for k in keys], *[T(feats[1][k]) for k in keys]))
    want = jmatching.to_host(jmatching.search_for_initialization(
        *[jnp.asarray(feats[0][k]) for k in keys],
        *[jnp.asarray(feats[1][k]) for k in keys]))
    ok = want[2]
    assert ok.sum() >= 100, ok.sum()
    np.testing.assert_array_equal(got[2], ok)
    np.testing.assert_array_equal(got[0][ok], want[0][ok])
    np.testing.assert_array_equal(got[1][ok], want[1][ok])
