"""The port's frontend and FrameBuilder against the JAX package's, and the
OpenCV goldens of tests/test_frontend.py against the port's plain path.

The slice runs on a 128x384 CylinderScene stereo pair at 500 features
and 8 levels, through both packages on the CPU (JAX on its XLA path, the
port on its plain PyTorch versions).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Settings as JSettings
from orb_slam2_tpu.ops import frontend as jfrontend
from orb_slam2_tpu.slam.frame import FrameBuilder as JFrameBuilder
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.ops import (
    brief, fast, frontend, gaussian, hamming, orientation, pyramid,
)
from orb_slam2_tpu_torch.slam.frame import FrameBuilder
from synthetic import CylinderScene, circle_trajectory

torch.set_num_threads(2)

H, W = 128, 384
N_FEATURES = 500
FX = 220.0
BASELINE = 0.5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def scene_pair():
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]])
    scene = CylinderScene(K, H, W, radius=8.0, tex_h=2048)
    T = circle_trajectory(4, orbit_r=3.0)[1]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -BASELINE
    return scene.render(T), scene.render(Trl @ T)


@pytest.fixture(scope="module")
def settings():
    return JSettings(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=BASELINE * FX,
                     width=W, height=H, n_features=N_FEATURES)


@pytest.fixture(scope="module")
def stereo_both(scene_pair):
    """(JAX fields, port fields) of extract_stereo_pair on the pair."""
    left, right = (im.astype(np.uint8) for im in scene_pair)
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    bf = BASELINE * FX
    jf, jm = jfrontend.extract_stereo_pair(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(sf),
        jnp.float32(bf), jnp.float32(FX), n_features=N_FEATURES)
    tf, tm = frontend.extract_stereo_pair(
        _t(left), _t(right), _t(sf), bf, FX, n_features=N_FEATURES)
    return convert.features_to_numpy(jf, jm), convert.features_to_numpy(tf, tm)


def test_stereo_pair_xy_octave_valid_equal(stereo_both):
    a, b = stereo_both
    assert a["valid"].sum() > 250
    for k in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(b[k], a[k])


def test_stereo_pair_angles_close(stereo_both):
    """atol 1e-3 deg: float32 vs float64 moment sums and the two
    frameworks' atan2 (measured max 3.1e-5 deg)."""
    a, b = stereo_both
    v = a["valid"]
    d = np.abs(a["angle"] - b["angle"])[v]
    assert np.minimum(d, 360 - d).max() <= 1e-3


def test_stereo_pair_descriptors_identical(stereo_both):
    """Bit-identical on >= 99% of valid keypoints; a tap rounding at .5
    under the frameworks' cos/sin may flip a bit (measured: 100% here,
    99.88% at 376x1240 with 2000 features)."""
    a, b = stereo_both
    v = a["valid"]
    assert b["desc"].dtype == np.uint32
    same = (a["desc"] == b["desc"]).all(1)[v]
    assert same.mean() >= 0.99, same.mean()


def test_stereo_pair_depths_close(stereo_both):
    """Matched sets equal on >= 99% of keypoints; u_right and depth within
    rtol 1e-5 where both matched (measured: equal sets, equal values)."""
    a, b = stereo_both
    ma, mb = a["depth"] > 0, b["depth"] > 0
    assert ma.sum() > 100
    assert (ma == mb).mean() >= 0.99
    both = ma & mb
    np.testing.assert_allclose(b["u_right"][both], a["u_right"][both],
                               rtol=1e-5)
    np.testing.assert_allclose(b["depth"][both], a["depth"][both], rtol=1e-5)


def test_kitti_shape_stereo_pair_matches_jax():
    """The slice at the size users run: 376x1240, 2000 features (KITTI
    00-02 geometry, as __graft_entry__.entry and bench.py).  xy, octave
    and valid equal; descriptors identical on >= 99% of valid keypoints
    (measured 99.88%: 2 of 1731); depths rtol 1e-5 on equal matched sets
    (measured: equal)."""
    h, w, fx, bf = 376, 1240, 718.856, 386.1448
    K = np.array([[fx, 0, 607.19], [0, fx, 185.22], [0, 0, 1]])
    scene = CylinderScene(K, h, w, radius=8.0, tex_h=2048)
    T = circle_trajectory(5, orbit_r=3.0)[1]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -bf / fx
    left = scene.render(T).astype(np.uint8)
    right = scene.render(Trl @ T).astype(np.uint8)
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    jf, jm = jfrontend.extract_stereo_pair(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(sf),
        jnp.float32(bf), jnp.float32(fx), n_features=2000)
    tf, tm = frontend.extract_stereo_pair(_t(left), _t(right), _t(sf), bf,
                                          fx, n_features=2000)
    a = convert.features_to_numpy(jf, jm)
    b = convert.features_to_numpy(tf, tm)
    for k in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(b[k], a[k])
    v = a["valid"]
    assert v.sum() >= 500
    assert (a["desc"] == b["desc"]).all(1)[v].mean() >= 0.99
    ma, mb = a["depth"] > 0, b["depth"] > 0
    assert ma.sum() >= 100 and (ma == mb).mean() >= 0.99
    np.testing.assert_allclose(b["depth"][ma & mb], a["depth"][ma & mb],
                               rtol=1e-5)


def _builder_fields(ff):
    return {k: getattr(ff, k) for k in
            ("xy", "xy_raw", "ur", "depth", "octave", "angle", "desc",
             "valid")}


def _compare_frames(jframe, tframe):
    a, b = _builder_fields(jframe.feats), _builder_fields(tframe.feats)
    for k in ("xy", "xy_raw", "octave", "valid"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    v = a["valid"]
    assert b["desc"].dtype == np.uint32
    assert (a["desc"] == b["desc"]).all(1)[v].mean() >= 0.99
    np.testing.assert_allclose(b["angle"][v], a["angle"][v], atol=1e-3)
    np.testing.assert_allclose(b["depth"], a["depth"], rtol=1e-5)
    np.testing.assert_allclose(b["ur"], a["ur"], rtol=1e-5)


def test_frame_builder_stereo_pair_matches_jax(scene_pair, settings):
    jb = JFrameBuilder(settings)
    tb = FrameBuilder(convert.settings_from_jax(settings), device="cpu")
    jframe = jb.stereo_pair(*scene_pair, 0.5)
    tframe = tb.stereo_pair(*scene_pair, 0.5)
    assert tframe.frame_id == jframe.frame_id == 0
    assert tframe.timestamp == 0.5
    assert tframe.bindings.shape == jframe.bindings.shape
    _compare_frames(jframe, tframe)
    assert (tframe.feats.depth > 0).sum() > 100
    desc = tframe.feats.device("desc")
    assert desc.dtype == torch.int32 and desc.device.type == "cpu"


def test_frame_builder_monocular_and_rgbd_match_jax(scene_pair, settings):
    jb = JFrameBuilder(settings)
    tb = FrameBuilder(convert.settings_from_jax(settings), device="cpu")
    img = scene_pair[0]
    _compare_frames(jb.monocular(img, 0.0), tb.monocular(img, 0.0))
    depth = np.random.default_rng(2).uniform(1, 10, (H, W)).astype(
        np.float32)
    tb.prefetch(img, depth=depth)
    _compare_frames(jb.rgbd(img, depth, 0.1), tb.rgbd(img, depth, 0.1))


# ------------------------------------------------------------------------
# The OpenCV goldens of tests/test_frontend.py, against the port.


@pytest.fixture(scope="module")
def img():
    """Synthetic textured test image (deterministic)."""
    rng = np.random.default_rng(42)
    base = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    big = cv2.resize(base, (320, 240), interpolation=cv2.INTER_CUBIC)
    big = cv2.GaussianBlur(big, (5, 5), 1.0)
    return np.clip(big, 0, 255).astype(np.uint8)


class TestPyramid:
    def test_resize_matches_opencv(self, img):
        out_h, out_w = 200, 267
        ours = pyramid.resize_bilinear(_t(img.astype(np.float32)), out_h,
                                       out_w).numpy()
        cv = cv2.resize(img.astype(np.float32), (out_w, out_h),
                        interpolation=cv2.INTER_LINEAR)
        # OpenCV uses fixed-point arithmetic internally; allow ~1 step
        assert np.abs(ours - cv).max() < 1.0
        assert np.abs(ours - cv).mean() < 0.1

    def test_level_sizes(self):
        sizes = pyramid.level_sizes(480, 640, 8, 1.2)
        assert sizes[0] == (480, 640)
        for (h1, w1), (h0, w0) in zip(sizes[1:], sizes[:-1]):
            assert 1.19 < w0 / w1 < 1.21 or (w0 - w1) <= 2

    def test_pyramid_shapes(self, img):
        levels = pyramid.compute_pyramid(_t(img), 8, 1.2)
        assert len(levels) == 8
        assert tuple(levels[0].shape) == img.shape
        assert levels[7].shape[0] < img.shape[0] / 3


class TestGaussian:
    def test_blur_matches_opencv(self, img):
        f = img.astype(np.float32)
        ours = gaussian.blur7x7(_t(f)).numpy()
        cv = cv2.GaussianBlur(f, (7, 7), 2.0,
                              borderType=cv2.BORDER_REFLECT_101)
        np.testing.assert_allclose(ours, cv, atol=1e-2)


class TestFAST:
    def test_corners_match_opencv(self, img):
        th = 20
        score = fast.nms3x3(fast.fast_score_map(_t(img).float(), th)).numpy()
        ours = set(zip(*np.nonzero(score > 0)))
        det = cv2.FastFeatureDetector_create(
            threshold=th, nonmaxSuppression=True,
            type=cv2.FastFeatureDetector_TYPE_9_16,
        )
        cv_pts = set((int(round(k.pt[1])), int(round(k.pt[0])))
                     for k in det.detect(img))
        inter = len(ours & cv_pts)
        assert inter / max(len(cv_pts), 1) > 0.85
        assert inter / max(len(ours), 1) > 0.85

    def test_scores_match_opencv(self, img):
        th = 20
        score = fast.nms3x3(fast.fast_score_map(_t(img).float(), th)).numpy()
        det = cv2.FastFeatureDetector_create(threshold=th,
                                             nonmaxSuppression=True)
        checked = 0
        for k in det.detect(img):
            x, y = int(round(k.pt[0])), int(round(k.pt[1]))
            if score[y, x] > 0:
                assert abs(score[y, x] - k.response) <= 1.0
                checked += 1
        assert checked > 20

    def test_fallback_adds_corners(self, img):
        flat = _t((img.astype(np.float32) * 0.15 + 100).astype(np.float32))
        hi_only = fast.nms3x3(fast.fast_score_map(flat, 20))
        both = fast.detect_with_fallback(flat, 20, 7, 16)
        assert int((both > 0).sum()) > int((hi_only > 0).sum())

    def test_select_topk_grid_budget_and_spread(self, img):
        score = fast.detect_with_fallback(_t(img).float(), 20, 7, 16)
        xy, resp, valid = fast.select_topk_grid(score, 200, cell=24)
        assert tuple(xy.shape) == (200, 2)
        nv = int(valid.sum())
        assert nv > 100
        v = xy.numpy()[valid.numpy()]
        cells = set(zip(v[:, 0] // 24, v[:, 1] // 24))
        assert len(cells) > nv / 4


class TestOrientation:
    def test_gradient_image_angle(self):
        ramp = np.tile(np.arange(64, dtype=np.float32), (64, 1))
        xy = torch.tensor([[32, 32]], dtype=torch.int32)
        ang = orientation.ic_angles(_t(ramp), xy, torch.tensor([True]))
        assert ang[0] < 5 or ang[0] > 355
        ang2 = orientation.ic_angles(_t(ramp.T), xy, torch.tensor([True]))
        assert 85 < ang2[0] < 95

    def test_rotation_consistency_with_opencv_orb(self, img):
        orb = cv2.ORB_create(nfeatures=100, nlevels=1, edgeThreshold=19)
        kps = orb.detect(img)
        pts = [(int(round(k.pt[0])), int(round(k.pt[1]))) for k in kps[:50]]
        assert pts
        ours = orientation.ic_angles(
            _t(img).float(), _t(np.array(pts, np.int32)),
            torch.ones(len(pts), dtype=torch.bool)).numpy()
        cv_ang = np.array([k.angle for k in kps[:50]])
        diff = np.abs(((ours - cv_ang) + 180) % 360 - 180)
        assert np.median(diff) < 10.0, np.median(diff)


def _u32(d: torch.Tensor) -> np.ndarray:
    return d.numpy().view(np.uint32)


class TestBRIEF:
    def test_descriptor_determinism_and_packing(self, img):
        blurred = gaussian.blur7x7(_t(img).float())
        xy = torch.tensor([[50, 50], [100, 80], [200, 150]],
                          dtype=torch.int32)
        ang = torch.tensor([0.0, 45.0, 180.0])
        valid = torch.ones(3, dtype=torch.bool)
        d1 = _u32(brief.describe(blurred, xy, ang, valid))
        d2 = _u32(brief.describe(blurred, xy, ang, valid))
        assert d1.shape == (3, 8) and d1.dtype == np.uint32
        np.testing.assert_array_equal(d1, d2)
        assert not (d1[0] == d1[1]).all()

    def test_rotation_invariance(self, img):
        f = img.astype(np.float32)
        h, w = f.shape
        M = cv2.getRotationMatrix2D((w / 2, h / 2), 30, 1.0)
        rot = cv2.warpAffine(f, M, (w, h), flags=cv2.INTER_LINEAR)
        pt = np.array([140.0, 120.0])
        pt_r = M[:, :2] @ pt + M[:, 2]
        one = torch.tensor([True])
        p0 = _t(pt.astype(np.int32)[None])
        p1 = _t(pt_r.astype(np.int32)[None])
        a0 = orientation.ic_angles(_t(f), p0, one)
        a1 = orientation.ic_angles(_t(rot), p1, one)
        d0 = brief.describe(gaussian.blur7x7(_t(f)), p0, a0, one)
        d1 = brief.describe(gaussian.blur7x7(_t(rot)), p1, a1, one)
        dist = int(hamming.distance(d0, d1)[0])
        orb = cv2.ORB_create(nlevels=1, edgeThreshold=19)
        _, c0 = orb.compute(img, [cv2.KeyPoint(float(pt[0]), float(pt[1]),
                                               31)])
        _, c1 = orb.compute(rot.astype(np.uint8),
                            [cv2.KeyPoint(float(pt_r[0]), float(pt_r[1]),
                                          31)])
        cv_dist = cv2.norm(c0, c1, cv2.NORM_HAMMING)
        assert dist <= cv_dist + 15, (dist, cv_dist)
        assert dist < 110, dist

    def test_descriptors_match_opencv_orb(self, img):
        orb = cv2.ORB_create(nfeatures=150, nlevels=1, edgeThreshold=31)
        kps, cv_desc = orb.compute(img, orb.detect(img))
        assert len(kps) > 30
        xy = np.array([[round(k.pt[0]), round(k.pt[1])] for k in kps],
                      np.int32)
        ang = np.array([k.angle for k in kps], np.float32)
        ours = brief.describe(gaussian.blur7x7(_t(img).float()), _t(xy),
                              _t(ang), torch.ones(len(kps), dtype=torch.bool))
        cv_i32 = np.ascontiguousarray(cv_desc).view("<i4")
        dist = hamming.distance(ours, _t(cv_i32)).numpy()
        assert np.median(dist) <= 4, (np.median(dist), dist[:10])
        assert dist.mean() <= 8, dist.mean()

    def test_random_pair_distance_is_high(self):
        rng = np.random.default_rng(3)
        a = rng.integers(0, 2**32, (100, 8), dtype=np.uint32).view(np.int32)
        b = rng.integers(0, 2**32, (100, 8), dtype=np.uint32).view(np.int32)
        d = hamming.distance(_t(a), _t(b)).numpy()
        assert 100 < d.mean() < 156


class TestHamming:
    def test_distance_matrix_matches_elementwise(self):
        rng = np.random.default_rng(4)
        a = _t(rng.integers(0, 2**32, (17, 8), dtype=np.uint32).view(
            np.int32))
        b = _t(rng.integers(0, 2**32, (23, 8), dtype=np.uint32).view(
            np.int32))
        dm = hamming.distance_matrix(a, b).numpy()
        for i in [0, 5, 16]:
            for j in [0, 11, 22]:
                assert dm[i, j] == int(hamming.distance(a[i], b[j]))

    def test_distance_zero_self(self):
        rng = np.random.default_rng(5)
        a = _t(rng.integers(0, 2**32, (10, 8), dtype=np.uint32).view(
            np.int32))
        assert (hamming.distance(a, a) == 0).all()

    def test_masked_argmin_and_ratio(self):
        dist = torch.tensor([[5, 2, 9], [1, 1, 1]], dtype=torch.int32)
        mask = torch.tensor([[True, True, False], [False, True, True]])
        idx, best, second = hamming.masked_argmin(dist, mask)
        assert idx.tolist() == [1, 1]
        assert best.tolist() == [2, 1]
        assert second.tolist() == [5, 1]


class TestExtract:
    def test_full_extraction(self, img):
        feats = frontend.extract(_t(img), n_features=300, n_levels=4,
                                 ini_th=20, min_th=7)
        v = feats.valid.numpy()
        assert v.sum() > 150
        xy = feats.xy.numpy()[v]
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < img.shape[1]).all()
        assert feats.octave.numpy()[v].max() >= 1
        d = feats.desc.numpy()[v]
        assert np.unique(d, axis=0).shape[0] > len(d) * 0.9

    def test_extraction_repeatability_under_shift(self, img):
        from scipy.spatial import cKDTree

        f0 = frontend.extract(_t(img), n_features=200, n_levels=2)
        f1 = frontend.extract(_t(np.roll(img, 5, axis=1)), n_features=200,
                              n_levels=2)
        xy0 = f0.xy.numpy()[f0.valid.numpy()]
        xy1 = f1.xy.numpy()[f1.valid.numpy()] - np.array([5.0, 0.0])
        dd, _ = cKDTree(xy1).query(xy0, k=1)
        interior = (xy0[:, 0] > 30) & (xy0[:, 0] < img.shape[1] - 30)
        assert (dd[interior] < 1.5).mean() > 0.6
