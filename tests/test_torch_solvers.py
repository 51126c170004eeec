"""The port's pose LM, matchers, rotation filter and bucket helpers
against the JAX package's on the same seeded inputs (numpy), both on the
CPU (JAX on its XLA path, as tests/conftest.py sets it).

Tolerances, each with its measured value in the test's docstring: pose
within 1e-4 (float32 sums taken in another order, and a 6x6 solve by
Gauss-Jordan against LAPACK's LU), inlier masks, counts, matches and
predicted levels equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import utils as jutils
from orb_slam2_tpu.ops import hamming as jhamming
from orb_slam2_tpu.ops import matching as jmatching
from orb_slam2_tpu.solvers import pose_lm as jpose_lm
from orb_slam2_tpu_torch import utils
from orb_slam2_tpu_torch.ops import hamming, matching
from orb_slam2_tpu_torch.solvers import pose_lm
from test_solvers import CX, CY, FX, FY, cam_pose, make_world, project

torch.set_num_threads(2)


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# pose LM: the three problems of tests/test_solvers.py::TestPoseLM, and one
# at the KITTI scale (fx 718.856) where the normal matrix's diagonal spans
# 1e5-4e8
# ---------------------------------------------------------------------------

def _problem(kind):
    """(T0, pts, uv3, fx, fy, cx, cy, bf) as TestPoseLM builds them."""
    if kind == "perturbed":
        rng = np.random.default_rng(0)
        pts = make_world(rng)
        T_true = cam_pose(rng)
        pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
        uv = project(pc) + rng.normal(0, 0.5, (len(pts), 2))
        uv3 = np.concatenate([uv, -np.ones((len(pts), 1))], -1)
        T0 = cam_pose(rng, rot_deg=3.0, trans=0.15) @ T_true
        return T0, pts, uv3, FX, FY, CX, CY, 40.0
    if kind == "outliers":
        rng = np.random.default_rng(1)
        pts = make_world(rng)
        T_true = cam_pose(rng)
        pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
        uv = project(pc) + rng.normal(0, 0.3, (len(pts), 2))
        uv[:50] += rng.uniform(20, 80, (50, 2))
        uv3 = np.concatenate([uv, -np.ones((len(pts), 1))], -1)
        T0 = cam_pose(rng, rot_deg=1.5, trans=0.08) @ T_true
        return T0, pts, uv3, FX, FY, CX, CY, 40.0
    if kind == "stereo":
        rng = np.random.default_rng(2)
        bf = 40.0
        pts = make_world(rng)
        T_true = cam_pose(rng)
        pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
        uv = project(pc)
        ur = uv[:, 0] - bf / pc[:, 2]
        uv3 = np.concatenate([uv, ur[:, None]], -1)
        T0 = cam_pose(rng, rot_deg=4.0, trans=0.2) @ T_true
        return T0, pts, uv3, FX, FY, CX, CY, bf
    # KITTI-scaled stereo: 1000 points, 0.3 px noise, 10% outliers
    rng = np.random.default_rng(3)
    fx, cx, cy, bf = 718.856, 607.19, 185.22, 386.1448
    pts = make_world(rng, 1000)
    T_true = cam_pose(rng, rot_deg=2.0, trans=0.1)
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                   fx * pc[:, 1] / pc[:, 2] + cy], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    ur = uv[:, 0] - bf / pc[:, 2] + rng.normal(0, 0.3, len(pts))
    uv[:100] += rng.uniform(10, 40, (100, 2))
    ur[500:] = -1.0                       # half of them mono
    uv3 = np.concatenate([uv, ur[:, None]], -1)
    T0 = cam_pose(rng, rot_deg=0.3, trans=0.02) @ T_true
    return T0, pts, uv3, fx, fx, cx, cy, bf


def _run_both(kind):
    T0, pts, uv3, fx, fy, cx, cy, bf = _problem(kind)
    n = len(pts)
    rng = np.random.default_rng(7)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 3, n)).astype(np.float32)
    T0 = T0.astype(np.float32)
    pts = pts.astype(np.float32)
    uv3 = uv3.astype(np.float32)
    mask = np.ones(n, bool)
    jo = jpose_lm.PoseObs(jnp.asarray(pts), jnp.asarray(uv3),
                          jnp.asarray(inv_s2), jnp.asarray(mask))
    jT, jin, jn = jpose_lm.optimize_pose(jnp.asarray(T0), jo, np.float32(fx),
                                         np.float32(fy), np.float32(cx),
                                         np.float32(cy), np.float32(bf))
    to = pose_lm.PoseObs(_t(pts), _t(uv3), _t(inv_s2), _t(mask))
    tT, tin, tn = pose_lm.optimize_pose(_t(T0), to, fx, fy, cx, cy, bf)
    return (np.asarray(jT), np.asarray(jin), int(jn)), (tT.numpy(),
                                                         tin.numpy(), int(tn))


@pytest.mark.parametrize("kind", ["perturbed", "outliers", "stereo",
                                  "kitti_scale"])
def test_optimize_pose_matches_jax(kind):
    """Pose within 1e-4, inlier masks and counts equal (measured: max
    pose difference <= 8.9e-7, 5.3e-7 at KITTI scale; masks equal)."""
    (jT, jin, jn), (tT, tin, tn) = _run_both(kind)
    np.testing.assert_allclose(tT, jT, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tin, jin)
    assert tn == jn


def test_optimize_pose_moves_from_the_start():
    """The KITTI-scale solve converges: the pose moves off its start and
    keeps the 900 good points (a solve that loses float32 precision
    rejects every step and returns the start)."""
    T0 = _problem("kitti_scale")[0]
    _, (tT, tin, tn) = _run_both("kitti_scale")
    assert np.abs(tT - T0).max() > 1e-3
    assert tin[100:].mean() > 0.95 and tn > 850


def test_solve_spd6_on_an_ill_scaled_system():
    """Against a float64 solve, on H = J^T J with a diagonal spanning
    1e5-2e8 (as a KITTI-scale pose problem): relative error <= 1e-4
    (measured 9.4e-8)."""
    rng = np.random.default_rng(4)
    J = rng.normal(size=(600, 6)) * np.array([30, 30, 15, 600, 600, 50])
    H = (J.T @ J).astype(np.float32)
    g = rng.normal(size=6).astype(np.float32) * 1e3
    ref = np.linalg.solve(H.astype(np.float64), g.astype(np.float64))
    x = pose_lm.solve_spd6(_t(H), _t(g)).numpy()
    assert np.abs(x - ref).max() <= 1e-4 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# rotation histogram filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(4))
def test_rotation_histogram_filter_ties(case):
    """Masks equal, with counts tied across the top bins (four bins of 5,
    three of 7, four of 4) so the lower-bin rule of jax.lax.top_k decides
    which bins survive."""
    rng = np.random.default_rng(case)
    # bins of 12 degrees; counts per bin with deliberate ties at the top
    counts = [np.array([5, 5, 5, 5, 1, 0, 2]),
              np.array([3, 0, 7, 7, 0, 7, 1]),
              np.array([10, 1, 1, 1, 1, 1, 1]),
              np.array([0, 0, 4, 0, 4, 0, 4, 4])][case]
    bins = rng.permutation(30)[:len(counts)]
    rot = np.concatenate([np.full(c, b * 12.0 + 6.0) for b, c in
                          zip(bins, counts)])
    rot += rng.uniform(-5, 5, len(rot))
    n = len(rot)
    angle_t = rng.uniform(0, 360, n).astype(np.float32)
    angle_q = ((angle_t + rot) % 360.0).astype(np.float32)
    matched = np.ones(n, bool)
    ref = np.asarray(jhamming.rotation_histogram_filter(
        jnp.asarray(angle_q), jnp.asarray(angle_t), jnp.asarray(matched)))
    out = hamming.rotation_histogram_filter(_t(angle_q), _t(angle_t),
                                            _t(matched)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 0 < out.sum() < n


# ---------------------------------------------------------------------------
# matchers on a synthetic frame
# ---------------------------------------------------------------------------

SF = (1.2 ** np.arange(4)).astype(np.float32)
BF = 40.0
BOUNDS = np.array([0.0, 640.0, 0.0, 480.0], np.float32)


def _match_scene(seed):
    """M map points, N features: the first 80 features observe points
    0..79 (1 px noise, descriptors with a few flipped bits, octaves +/-1,
    angles rotated by 30 deg), the rest random."""
    rng = np.random.default_rng(seed)
    M, N, K = 96, 128, 80
    pts = make_world(rng, M)
    T = cam_pose(rng, rot_deg=2.0, trans=0.1)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = project(pc)
    xy = np.concatenate([uv[:K] + rng.normal(0, 1.0, (K, 2)),
                         rng.uniform([0, 0], [640, 480], (N - K, 2))])
    ur = np.where(rng.uniform(size=N) < 0.5, -1.0,
                  xy[:, 0] - BF / np.concatenate(
                      [pc[:K, 2], rng.uniform(4, 10, N - K)]))
    pt_oct = rng.integers(0, 4, M).astype(np.int32)
    f_oct = np.concatenate([
        np.clip(pt_oct[:K] + rng.integers(-1, 2, K), 0, 3),
        rng.integers(0, 4, N - K)]).astype(np.int32)
    pt_desc = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(
        np.uint32)
    f_desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(
        np.uint32)
    f_desc[:K] = pt_desc[:K]
    for i in range(K):                    # flip 0..90 bits
        for b in rng.integers(0, 256, rng.integers(0, 90)):
            f_desc[i, b // 32] ^= np.uint32(1 << (b % 32))
    pt_angle = rng.uniform(0, 360, M).astype(np.float32)
    f_angle = np.concatenate([
        (pt_angle[:K] + 30.0 + rng.normal(0, 3, K)) % 360.0,
        rng.uniform(0, 360, N - K)]).astype(np.float32)
    centre = -T[:3, :3].T @ T[:3, 3]
    ray = pts - centre
    dist = np.linalg.norm(ray, axis=1)
    normals = ray / dist[:, None] + rng.normal(0, 0.05, (M, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    max_dist = dist * SF[pt_oct] * rng.uniform(0.9, 1.1, M)
    T_est = cam_pose(rng, rot_deg=0.1, trans=0.01) @ T
    return dict(
        pts=pts.astype(np.float32), T=T_est.astype(np.float32),
        xy=xy.astype(np.float32), ur=ur.astype(np.float32), f_oct=f_oct,
        pt_oct=pt_oct, pt_desc=pt_desc, f_desc=f_desc,
        pt_angle=pt_angle, f_angle=f_angle,
        normals=normals.astype(np.float32),
        max_dist=max_dist.astype(np.float32),
        min_dist=(max_dist / SF[-1]).astype(np.float32),
        mask=rng.uniform(size=M) < 0.95, free=rng.uniform(size=N) < 0.9,
        valid=rng.uniform(size=N) < 0.95, has=rng.uniform(size=M) < 0.9,
    )


def _projections(d):
    log_sf = float(np.log(1.2))
    jp = jmatching.project_points(
        *[jnp.asarray(d[k]) for k in ("pts", "normals", "min_dist",
                                      "max_dist", "mask", "T")],
        np.float32(FX), np.float32(FY), np.float32(CX), np.float32(CY),
        np.float32(BF), jnp.asarray(BOUNDS), log_sf, 4)
    tp = matching.project_points(
        *[_t(d[k]) for k in ("pts", "normals", "min_dist", "max_dist",
                             "mask", "T")],
        FX, FY, CX, CY, BF, _t(BOUNDS), log_sf, 4)
    return jp, tp


@pytest.mark.parametrize("seed", [0, 1])
def test_project_points_matches_jax(seed):
    """uv, ur, depth, dist, view_cos within 1e-4 relative (measured:
    uv, ur, depth equal, dist and view_cos <= 2.4e-7); level and
    in_frustum equal."""
    jp, tp = _projections(_match_scene(seed))
    for k in ("uv", "ur", "depth", "dist", "view_cos"):
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(tp.level.numpy(), np.asarray(jp.level))
    np.testing.assert_array_equal(tp.in_frustum.numpy(),
                                  np.asarray(jp.in_frustum))
    assert tp.in_frustum.sum() > 40


def _assert_same_matches(jm, tm, min_ok):
    ok = np.asarray(jm.ok)
    np.testing.assert_array_equal(tm.ok.numpy(), ok)
    np.testing.assert_array_equal(tm.idx.numpy()[ok], np.asarray(jm.idx)[ok])
    np.testing.assert_array_equal(tm.dist.numpy()[ok],
                                  np.asarray(jm.dist)[ok])
    assert ok.sum() >= min_ok, ok.sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_search_local_points_matches_jax(seed):
    """ok equal, idx and dist equal where ok (measured: equal)."""
    d = _match_scene(seed)
    jp, tp = _projections(d)
    jm = jmatching.search_local_points(
        jp, jnp.asarray(d["pt_desc"]), jnp.asarray(d["xy"]),
        jnp.asarray(d["ur"]), jnp.asarray(d["f_oct"]),
        jnp.asarray(d["f_desc"]), jnp.asarray(d["free"]), jnp.asarray(SF),
        2.0)
    tm = matching.search_local_points(
        tp, _t(d["pt_desc"]), _t(d["xy"]), _t(d["ur"]), _t(d["f_oct"]),
        _t(d["f_desc"]), _t(d["free"]), _t(SF), 2.0)
    _assert_same_matches(jm, tm, 10)


@pytest.mark.parametrize("forward,backward,check_rotation", [
    (False, False, True), (True, False, True), (False, True, True),
    (False, False, False)])
def test_search_last_frame_matches_jax(forward, backward, check_rotation):
    """Forward, backward and band octave gates, rotation check on and off:
    ok equal, idx and dist equal where ok (measured: equal)."""
    d = _match_scene(2)
    args = ("pts", "has", "pt_oct", "pt_desc", "pt_angle", "T", "xy", "ur",
            "f_oct", "f_desc", "f_angle", "valid")
    jm = jmatching.search_last_frame(
        *[jnp.asarray(d[k]) for k in args],
        np.float32(FX), np.float32(FY), np.float32(CX), np.float32(CY),
        np.float32(BF), jnp.asarray(BOUNDS), jnp.asarray(SF), 7.0,
        forward=forward, backward=backward, check_rotation=check_rotation)
    tm = matching.search_last_frame(
        *[_t(d[k]) for k in args], FX, FY, CX, CY, BF, _t(BOUNDS), _t(SF),
        7.0, forward=forward, backward=backward,
        check_rotation=check_rotation)
    _assert_same_matches(jm, tm, 10)


def test_resolve_duplicates_and_to_host():
    """Ties by query index, as the JAX package; to_host packs one copy."""
    idx = np.array([3, 3, 1, 3, 1, 0], np.int32)
    dist = np.array([10, 7, 9, 7, 9, 50], np.int32)
    ok = np.array([1, 1, 1, 1, 1, 0], bool)
    ref = np.asarray(jmatching.resolve_duplicates(
        jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(ok), 5))
    out = matching.resolve_duplicates(_t(idx), _t(dist), _t(ok), 5)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ref, [0, 1, 1, 0, 0, 0])
    h_idx, h_dist, h_ok = matching.to_host(
        matching.Matches(_t(idx).long(), _t(dist), out))
    np.testing.assert_array_equal(h_idx, idx)
    np.testing.assert_array_equal(h_dist, dist)
    np.testing.assert_array_equal(h_ok, ref)


# ---------------------------------------------------------------------------
# bucket helpers (copied, framework-free)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,minimum", [(0, 128), (1, 128), (128, 128),
                                       (129, 128), (1338, 512), (5000, 64)])
def test_bucket_size_equal(n, minimum):
    assert utils.bucket_size(n, minimum) == jutils.bucket_size(n, minimum)


def test_sticky_buckets_and_pad_rows_equal():
    a, b = utils.StickyBuckets(local=512), jutils.StickyBuckets(local=512)
    for name, n in [("local", 100), ("local", 3000), ("local", 10),
                    ("ba", 300), ("ba", 100)]:
        assert a(name, n) == b(name, n)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    for n in (4, 6, 9):
        np.testing.assert_array_equal(utils.pad_rows(x, n, fill=-1),
                                      jutils.pad_rows(x, n, fill=-1))


def test_stage_timers_report():
    t = utils.StageTimers()
    for _ in range(3):
        with t("a"):
            pass
    assert t.counts["a"] == 3 and "median" in t.report()
