"""The port's ops against the JAX package's, on the same numpy inputs.

JAX runs as tests/conftest.py sets it up (CPU, highest matmul precision),
so it takes its XLA paths; the FAST kernel of the JAX package also runs
in Pallas interpret mode.  On CPU tensors the port's kernel wrappers take
their plain PyTorch versions, which are what these tests reach.

Tolerances: exact where the computation has no rounding to differ or the
port reproduces JAX's (pyramid, blur, FAST, top-K, SAD on integer
images, Hamming, medians); stated beside each test otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.geometry import camera as jcam
from orb_slam2_tpu.ops import brief as jbrief
from orb_slam2_tpu.ops import fast as jfast
from orb_slam2_tpu.ops import fast_pallas as jfast_pallas
from orb_slam2_tpu.ops import frontend as jfrontend
from orb_slam2_tpu.ops import gaussian as jgaussian
from orb_slam2_tpu.ops import hamming as jhamming
from orb_slam2_tpu.ops import orientation as jorientation
from orb_slam2_tpu.ops import pyramid as jpyramid
from orb_slam2_tpu.ops import stereo as jstereo
from orb_slam2_tpu_torch.geometry import camera as tcam
from orb_slam2_tpu_torch.ops import brief as tbrief
from orb_slam2_tpu_torch.ops import fast as tfast
from orb_slam2_tpu_torch.ops import fast_cuda, orb_cuda, stereo_cuda
from orb_slam2_tpu_torch.ops import frontend as tfrontend
from orb_slam2_tpu_torch.ops import gaussian as tgaussian
from orb_slam2_tpu_torch.ops import hamming as thamming
from orb_slam2_tpu_torch.ops import orientation as torientation
from orb_slam2_tpu_torch.ops import pyramid as tpyramid
from orb_slam2_tpu_torch.ops import stereo as tstereo

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _image(kind: str) -> np.ndarray:
    """Deterministic test images: textured with flat and bright blocks,
    an odd-sized noise image, and a rendered KITTI-like scene crop."""
    rng = np.random.default_rng(11)
    if kind == "blocks":
        img = rng.uniform(0, 255, (200, 300)).astype(np.float32)
        k = np.array([0.25, 0.5, 0.25], np.float32)
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
        img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
        img[40:80, 40:90] = 10.0
        img[120:160, 150:260] = 240.0
        return np.rint(img).astype(np.float32)
    if kind == "odd":
        return rng.integers(0, 256, (97, 131)).astype(np.float32)
    from synthetic import CylinderScene, circle_trajectory

    K = np.array([[220.0, 0, 192], [0, 220.0, 64], [0, 0, 1]])
    scene = CylinderScene(K, 128, 384, radius=8.0, tex_h=2048)
    T = circle_trajectory(4, orbit_r=3.0)[1]
    return scene.render(T).astype(np.uint8).astype(np.float32)


IMAGES = ["blocks", "odd", "scene"]


# ---------------------------------------------------------------- pyramid


@pytest.mark.parametrize("cfg", [(376, 1240, 8, 1.2), (128, 384, 8, 1.2),
                                 (480, 640, 4, 1.5)])
def test_level_sizes_and_budgets_match_jax(cfg):
    h, w, n_levels, sf = cfg
    assert tpyramid.level_sizes(h, w, n_levels, sf) == jpyramid.level_sizes(
        h, w, n_levels, sf)
    for nf in (500, 2000):
        assert tfrontend.level_budgets(nf, n_levels, sf) == \
            jfrontend.level_budgets(nf, n_levels, sf)
        assert tfrontend.padded_total(nf, n_levels, sf) == \
            jfrontend.padded_total(nf, n_levels, sf)


@pytest.mark.parametrize("kind", IMAGES + ["kitti"])
def test_pyramid_levels_equal_jax(kind):
    """Bit-exact: XLA on the CPU fuses the resize's multiply-adds, and the
    port rounds them the same way (pyramid._fma).  With separately
    rounded products instead, about a quarter of each level differs from
    JAX in the last bits.

    One exception, measured: on the odd 97x131 image XLA does not fuse
    the row coordinates of level 5 (47x63 -> 39x53), so two of its rows
    sit one coordinate ulp away; those pixels differ by < 1e-4."""
    if kind == "kitti":
        img = np.random.default_rng(0).integers(0, 256, (376, 1240))
        img = img.astype(np.float32)
    else:
        img = _image(kind)
    ref = jpyramid.compute_pyramid(jnp.asarray(img), 8, 1.2)
    out = tpyramid.compute_pyramid(_t(img), 8, 1.2)
    for r, o in zip(ref, out):
        if kind == "odd":
            np.testing.assert_allclose(_np(o), np.asarray(r), rtol=0,
                                       atol=1e-4)
        else:
            np.testing.assert_array_equal(_np(o), np.asarray(r))


@pytest.mark.parametrize("kind", IMAGES)
def test_blur_equals_jax(kind):
    """Bit-exact (measured): the blur's accumulation order is the same."""
    img = _image(kind)
    lvl = np.asarray(jpyramid.compute_pyramid(jnp.asarray(img), 3, 1.2)[2])
    for x in (img, lvl):
        np.testing.assert_array_equal(
            _np(tgaussian.blur7x7(_t(x))),
            np.asarray(jgaussian.blur7x7(jnp.asarray(x))))


# ------------------------------------------------------------------ FAST


@pytest.mark.parametrize("kind", IMAGES)
def test_fast_detect_equals_jax_xla_and_pallas_interpret(kind):
    """Exact: FAST is subtractions, min/max and comparisons.  Held against
    both the JAX XLA path and the Pallas kernel in interpret mode, and
    through the port's kernel wrapper, which takes the plain version on a
    CPU tensor."""
    img = _image(kind)
    ref = np.asarray(jfast.detect_with_fallback(jnp.asarray(img), 20, 7, 16))
    ref_pallas = np.asarray(jfast_pallas.detect_with_fallback(
        jnp.asarray(img), 20.0, 7.0, 16, interpret=True))
    out = _np(tfast.detect_with_fallback(_t(img), 20, 7, 16))
    via_wrapper = _np(fast_cuda.detect_with_fallback(_t(img), 20, 7, 16))
    assert (ref > 0).sum() > 20
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, ref_pallas)
    np.testing.assert_array_equal(via_wrapper, ref)


def test_fast_parts_equal_jax():
    img = _image("blocks")
    np.testing.assert_array_equal(
        _np(tfast.raw_score_map(_t(img))),
        np.asarray(jfast.raw_score_map(jnp.asarray(img))))
    s = np.asarray(jfast.fast_score_map(jnp.asarray(img), 9))
    np.testing.assert_array_equal(
        _np(tfast.fast_score_map(_t(img), 9)), s)
    np.testing.assert_array_equal(
        _np(tfast.nms3x3(_t(s))), np.asarray(jfast.nms3x3(jnp.asarray(s))))


def _tie_map():
    """Integer-valued scores drawn from a few values: ties everywhere,
    within cells (argmax) and across cells (top-K)."""
    rng = np.random.default_rng(5)
    s = rng.choice([0.0, 0.0, 7.0, 8.0, 9.0], size=(100, 150))
    return s.astype(np.float32)


@pytest.mark.parametrize("case", ["detected", "ties", "over_budget"])
def test_select_topk_grid_equals_jax(case):
    """Exact, ties included: the lower index wins, as in jnp.argmax and
    jax.lax.top_k (torch.topk promises no order among equal values; the
    port sorts stably)."""
    if case == "detected":
        score = np.asarray(jfast.detect_with_fallback(
            jnp.asarray(_image("scene")), 20, 7, 16))
        n, cell = 300, 24
    elif case == "ties":
        score, n, cell = _tie_map(), 120, 24
    else:   # budget above the candidates: the zero padding path
        score, n, cell = _tie_map(), 200, 50
    ref = jfast.select_topk_grid(jnp.asarray(score), n, cell)
    out = tfast.select_topk_grid(_t(score), n, cell)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(_np(o), np.asarray(r))
    if case == "ties":
        vals = np.asarray(ref[1])
        assert len(np.unique(vals[vals > 0])) < (vals > 0).sum()


# ------------------------------------------------------ angle + descriptor


def _keypoints(img, n, seed=2):
    rng = np.random.default_rng(seed)
    h, w = img.shape
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
    valid = rng.uniform(size=n) > 0.1
    return xy.astype(np.int32), valid


def _detected(img, n):
    """The frontend's keypoints on `img`, plus its four corners (centre
    clipping); the last keypoint invalid."""
    xy, _, valid = jfast.select_topk_grid(
        jfast.detect_with_fallback(jnp.asarray(img), 20, 7, 16), n, 24)
    h, w = img.shape
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]])
    xy = np.concatenate([np.asarray(xy), corners]).astype(np.int32)
    valid = np.concatenate([np.asarray(valid), [True, True, True, False]])
    return xy, valid


@pytest.mark.parametrize("kind", IMAGES)
def test_ic_angles_match_jax(kind):
    """atol 1e-3 deg at the detector's keypoints: JAX sums the moments in
    float32 in its own order and XLA's atan2 differs from torch's in the
    last ulps; the port sums in float64 (orientation.py).  (At a point of
    a flat patch the moments nearly cancel and JAX's float32 rounding
    alone moves the angle by more.)"""
    img = np.asarray(jpyramid.compute_pyramid(
        jnp.asarray(_image(kind)), 2, 1.2)[1])     # a resized level
    xy, valid = _detected(img, 300)
    ref = np.asarray(jorientation.ic_angles(
        jnp.asarray(img), jnp.asarray(xy), jnp.asarray(valid)))
    out = _np(torientation.ic_angles(_t(img), _t(xy), _t(valid)))
    d = np.abs(out - ref)
    d = np.minimum(d, 360.0 - d)
    assert d.max() <= 1e-3, d.max()
    assert (out[~valid] == 0).all()


@pytest.mark.parametrize("kind", IMAGES)
def test_describe_matches_jax(kind):
    """Given the same angles, descriptors are bit-identical on >= 99% of
    keypoints: a tap whose rotated offset lands within an ulp of .5 can
    round the other way, because XLA's and torch's cos/sin differ in the
    last ulps and XLA fuses x*cos - y*sin.  Measured: 100% here."""
    img = _image(kind)
    blurred = np.asarray(jgaussian.blur7x7(jnp.asarray(img)))
    xy, valid = _keypoints(img, 300, seed=3)
    ang = np.random.default_rng(4).uniform(0, 360, 300).astype(np.float32)
    ref = np.asarray(jbrief.describe(jnp.asarray(blurred), jnp.asarray(xy),
                                     jnp.asarray(ang), jnp.asarray(valid)))
    out = _np(tbrief.describe(_t(blurred), _t(xy), _t(ang), _t(valid)))
    same = (out.view(np.uint32) == ref).all(1)
    assert same.mean() >= 0.99, same.mean()
    assert (out[~valid] == 0).all()


def test_describe_oriented_wrapper_is_plain_on_cpu():
    img = _image("scene")
    blurred = tgaussian.blur7x7(_t(img))
    xy, valid = _keypoints(img, 64)
    a, d = orb_cuda.describe_oriented(_t(img), blurred, _t(xy), _t(valid))
    pa, pd = orb_cuda.describe_oriented_plain(_t(img), blurred, _t(xy),
                                              _t(valid))
    assert torch.equal(a, pa) and torch.equal(d, pd)


def test_pack_bits_top_bit_and_uint32_round_trip():
    """int32 words hold the uint32 bits: a word with bit 31 set is
    negative in the port and reads back as the JAX uint32 value."""
    rng = np.random.default_rng(9)
    bits = rng.uniform(size=(40, 256)) > 0.5
    bits[0] = True                     # all ones: 0xFFFFFFFF words
    bits[1, 31::32] = True             # top bit of every word
    # brief.describe's packing: bit j of word k is bit 32k+j
    expect = (bits.reshape(40, 8, 32).astype(np.uint64)
              << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    out = _np(tbrief.pack_bits(_t(bits)))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out.view(np.uint32), expect)
    assert (out[0] == -1).all() and (out[1] < 0).all()


def test_generate_pattern_equals_jax():
    np.testing.assert_array_equal(tbrief.generate_pattern(7),
                                  jbrief.generate_pattern(7))
    np.testing.assert_array_equal(tbrief.get_pattern(), jbrief.get_pattern())


def test_umax_table_and_mask_equal_jax():
    np.testing.assert_array_equal(torientation._umax_table(),
                                  jorientation._umax_table())
    np.testing.assert_array_equal(torientation._MASK, jorientation._MASK)


# ---------------------------------------------------------------- Hamming


def _descs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    d[0] = 0xFFFFFFFF
    d[1] = 0x80000000
    return d


def test_distance_and_matrix_equal_jax():
    """Exact: popcounts, and a float32 matmul of 0/1 bits whose partial
    sums are integers <= 256."""
    a, b = _descs(37, 1), _descs(23, 2)
    ta, tb = _t(a.view(np.int32)), _t(b.view(np.int32))
    np.testing.assert_array_equal(
        _np(thamming.distance_matrix(ta, tb)),
        np.asarray(jhamming.distance_matrix(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        _np(thamming.distance(ta[:23], tb)),
        np.asarray(jhamming.distance(jnp.asarray(a[:23]), jnp.asarray(b))))
    np.testing.assert_array_equal(
        _np(thamming.unpack_bits(ta)),
        np.asarray(jhamming.unpack_bits(jnp.asarray(a))))


def test_masked_argmin_ties_equal_jax():
    """Exact: with equal distances the first column wins in both."""
    rng = np.random.default_rng(3)
    dist = rng.integers(0, 4, (50, 30)).astype(np.int32)   # many ties
    mask = rng.uniform(size=(50, 30)) > 0.3
    mask[0] = False                                        # all masked
    ref = jhamming.masked_argmin(jnp.asarray(dist), jnp.asarray(mask))
    out = thamming.masked_argmin(_t(dist), _t(mask))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(_np(o), np.asarray(r))


# ----------------------------------------------------------------- stereo


def _sad_inputs(integer: bool, n=96, seed=3):
    rng = np.random.default_rng(seed)
    h, w = 128, 384
    il = rng.uniform(0, 255, (h, w)).astype(np.float32)
    ir = rng.uniform(0, 255, (h, w)).astype(np.float32)
    if integer:
        il, ir = np.rint(il), np.rint(ir)
    lo = stereo_cuda.W + stereo_cuda.L
    yc = rng.integers(stereo_cuda.W, h - stereo_cuda.W, n).astype(np.int32)
    xl = rng.integers(lo, w - lo, n).astype(np.int32)
    xr = rng.integers(lo, w - lo, n).astype(np.int32)
    return il, ir, yc, xl, xr


@pytest.mark.parametrize("integer", [True, False])
def test_sad_search_matches_jax(integer):
    """Exact on integer-valued images, where every partial sum is an
    integer below 2^24; rtol 1e-5 on float images, whose 121-term sums
    are added in another order."""
    args = _sad_inputs(integer)
    ref = np.asarray(jstereo._sad_search(*map(jnp.asarray, args)))
    out = _np(stereo_cuda.sad_strips_plain(*map(_t, args)))
    via_wrapper = _np(stereo_cuda.sad_strips(*map(_t, args)))
    np.testing.assert_array_equal(via_wrapper, out)
    if integer:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5)


@pytest.mark.parametrize("n_finite", [0, 1, 6, 7])
def test_median_sad_filter_equals_jax(n_finite):
    """Exact: an even count takes the mean of the two middle values, as
    jnp.nanmedian does (torch.nanmedian would take the lower one)."""
    rng = np.random.default_rng(n_finite)
    n = 12
    sad = np.full(n, np.inf, np.float32)
    idx = rng.permutation(n)[:n_finite]
    sad[idx] = rng.integers(10, 400, n_finite).astype(np.float32)
    sad[idx[:1]] = 1000.0                       # an outlier to sweep
    ur = rng.uniform(0, 300, n).astype(np.float32)
    depth = rng.uniform(1, 20, n).astype(np.float32)
    ref = jstereo.median_sad_filter(jstereo.StereoMatches(
        jnp.asarray(ur), jnp.asarray(depth), jnp.asarray(sad)))
    out = tstereo.median_sad_filter(tstereo.StereoMatches(
        _t(ur), _t(depth), _t(sad)))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(_np(o), np.asarray(r))


def test_stereo_match_equals_jax():
    """The whole row match on features the JAX frontend extracted from a
    rendered pair, fed to both: u_right and depth rtol 1e-5 (measured
    exact) and the same matched set."""
    from synthetic import CylinderScene, circle_trajectory

    fx = 220.0
    K = np.array([[fx, 0, 192], [0, fx, 64], [0, 0, 1]])
    scene = CylinderScene(K, 128, 384, radius=8.0, tex_h=2048)
    T = circle_trajectory(4, orbit_r=3.0)[1]
    Trl = np.eye(4, dtype=np.float32)
    Trl[0, 3] = -0.5
    imgs = [scene.render(T).astype(np.uint8),
            scene.render(Trl @ T).astype(np.uint8)]
    fl, fr = [jfrontend.extract(jnp.asarray(im), n_features=400)
              for im in imgs]
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    bf = 0.5 * fx
    lv = [im.astype(np.float32) for im in imgs]
    ref = jstereo.match(fl.xy, fl.octave, fl.desc, fl.valid,
                        fr.xy, fr.octave, fr.desc, fr.valid,
                        jnp.asarray(lv[0]), jnp.asarray(lv[1]),
                        jnp.asarray(sf), jnp.float32(bf), 0.0, jnp.float32(fx))

    def tt(a):
        a = np.asarray(a)
        return _t(a.view(np.int32) if a.dtype == np.uint32 else a)

    out = tstereo.match(tt(fl.xy), tt(fl.octave), tt(fl.desc), tt(fl.valid),
                        tt(fr.xy), tt(fr.octave), tt(fr.desc), tt(fr.valid),
                        _t(lv[0]), _t(lv[1]), _t(sf), bf, 0.0, fx)
    m_ref = np.asarray(ref.depth) > 0
    m_out = _np(out.depth) > 0
    assert m_ref.sum() > 50
    np.testing.assert_array_equal(m_out, m_ref)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(_np(o)[m_ref], np.asarray(r)[m_ref],
                                   rtol=1e-5)


def test_depth_from_rgbd_equals_jax():
    rng = np.random.default_rng(8)
    depth_img = rng.uniform(0, 5000, (60, 80)).astype(np.float32)
    depth_img[:10] = 0.0
    xy = rng.uniform(-2, 82, (50, 2)).astype(np.float32)
    valid = rng.uniform(size=50) > 0.2
    ref = jstereo.depth_from_rgbd(jnp.asarray(xy), jnp.asarray(valid),
                                  jnp.asarray(depth_img), 1 / 5000.0, 40.0)
    out = tstereo.depth_from_rgbd(_t(xy), _t(valid), _t(depth_img),
                                  1 / 5000.0, 40.0)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(_np(o), np.asarray(r), rtol=1e-6)


# ----------------------------------------------------------------- camera


def test_camera_undistort_remap_bounds_match_jax():
    """rtol 1e-5: the fixed-point undistortion runs 8 float32 iterations
    whose multiply-adds XLA fuses (measured: 2.5e-6 at most)."""
    from orb_slam2_tpu.config import Settings as JSettings

    from orb_slam2_tpu_torch.convert import settings_from_jax

    js = JSettings(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                   k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                   p2=1.76187114e-05, width=752, height=480)
    ts = settings_from_jax(js)
    ji = jcam.Intrinsics.from_settings(js)
    ti = tcam.Intrinsics.from_settings(ts)
    rng = np.random.default_rng(1)
    uv = rng.uniform(0, 480, (64, 2)).astype(np.float32)
    dist = js.dist_coeffs.astype(np.float32)
    np.testing.assert_allclose(
        _np(tcam.undistort_points(_t(uv), ti, _t(dist))),
        np.asarray(jcam.undistort_points(jnp.asarray(uv), ji,
                                         jnp.asarray(dist))), rtol=1e-5)
    np.testing.assert_allclose(
        tcam.compute_image_bounds(752, 480, ti, ts.dist_coeffs),
        jcam.compute_image_bounds(752, 480, ji, js.dist_coeffs), rtol=1e-5)
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    mx = rng.uniform(-2, 52, (40, 50)).astype(np.float32)
    my = rng.uniform(-2, 42, (40, 50)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tcam.remap_bilinear(_t(img), _t(mx), _t(my))),
        np.asarray(jcam.remap_bilinear(jnp.asarray(img), jnp.asarray(mx),
                                       jnp.asarray(my))), rtol=1e-5,
        atol=1e-3)
